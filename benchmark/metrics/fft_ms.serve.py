"""Device ms a step or batch of the FFT library's kernels (cuFFT), and of
torch's kernels that complete a real transform's spectrum."""

from benchmark import layers

PATTERNS = ("fft",)  # cuFFT's regular_fft, prime_fft, vector_fft ...; torch's _fft_*


def read(r):
    return layers.device_ms(r, PATTERNS)
