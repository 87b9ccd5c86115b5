"""The spectrum remap (``ops/kernels/remap.py``) and the 3-D FFT path built
on it (``ops/spectral.py``), on the CPU; JAX-free.

``remap_plain`` against a direct loop over a tiny spectrum, with two
sources an index, absent sources, scales and Hermitian planes; ``plan``'s
refusals; ``REMAPS``, two a conv and one a truncation in a forward and the
same again in the backward; a float64 ``gradcheck`` of the truncation's
hand-written backward, upsampling and downsampling; and every half
spectrum that the path hands to a c2r, forward and backward, Hermitian on
its DC and Nyquist planes, so that cuFFT's c2r answers as pocketfft's
(the card's kernel against the plain version: tests/test_torch_cuda.py).
The 3-D ops against ``uno_tpu`` are tests/test_torch_spectral_3d.py's.
"""

import itertools

import pytest
import torch

from uno_tpu_torch.ops import spectral
from uno_tpu_torch.ops.kernels import remap as R


def _loop(src, rows, cols, bins, scale, herm):
    """The remap's definition, element by element."""
    b, c = src.shape[:2]
    d1, d2, d3 = len(rows), len(cols), len(bins)

    def t(i, j, k):
        if bins[k] is None:
            return torch.zeros(b, c, dtype=src.dtype)
        acc = torch.zeros(b, c, dtype=src.dtype)
        for q in cols[j]:
            for p in rows[i]:
                acc = acc + src[:, :, p, q, bins[k]]
        return acc

    out = torch.zeros(b, c, d1, d2, d3, dtype=src.dtype)
    for i, j, k in itertools.product(range(d1), range(d2), range(d3)):
        v = t(i, j, k)
        if k in herm:
            v = (v + t(-i % d1, -j % d2, k).conj()) / 2
        out[:, :, i, j, k] = v * scale[k]
    return out


@pytest.mark.parametrize("herm", [(), (0, 3)])
def test_plain_remap_matches_a_loop(herm):
    g = torch.Generator().manual_seed(0)
    src = torch.randn(2, 3, 5, 4, 6, dtype=torch.complex128, generator=g)
    rows = [(0,), (4, 1), (), (3,), (2, 2)]           # two sources, none, one twice
    cols = [(1, 3), (0,), (2,), ()]
    bins = [0, 5, None, 2]
    scale = [1.0, 2.0, 0.5, -1.5]
    got = R.remap(src, R.plan(rows, cols, bins, scale, herm))
    assert got.shape == (2, 3, 5, 4, 4)
    want = _loop(src, rows, cols, bins, scale, herm)
    assert torch.allclose(got, want, rtol=0, atol=1e-13)


def test_plan_refuses_three_sources_and_bad_bins():
    with pytest.raises(ValueError, match="at most two sources"):
        R.plan([(0, 1, 2)], [(0,)], [0])
    with pytest.raises(ValueError, match="scales"):
        R.plan([(0,)], [(0,)], [0, 1], scale=[1.0])
    with pytest.raises(ValueError, match="herm"):
        R.plan([(0,)], [(0,)], [0], herm=(1,))
    # one object for each value: its tables are made once per device
    assert R.plan([(0,)], [(1,)], [0]) is R.plan([[0]], [[1]], [0])


def test_remaps_counted_by_pass():
    x = torch.randn(1, 2, 8, 8, 6, requires_grad=True)
    w = torch.randn(4, 2, 3, 6, 6, 3, dtype=torch.complex64, requires_grad=True)
    spectral.REMAPS.update(forward=0, backward=0)
    y = spectral.spectral_conv_3d(x, w, (12, 12, 6), (6, 6, 3))
    assert spectral.REMAPS == {"forward": 2, "backward": 0}
    y.sum().backward()
    assert spectral.REMAPS == {"forward": 2, "backward": 2}
    spectral.REMAPS.update(forward=0, backward=0)
    spectral.fourier_truncate_3d(x, (4, 4, 6)).sum().backward()
    assert spectral.REMAPS == {"forward": 1, "backward": 1}
    with torch.no_grad():  # no gradient: the forward alone
        spectral.spectral_conv_3d(x, w, (12, 12, 6), (6, 6, 3))
    assert spectral.REMAPS == {"forward": 3, "backward": 1}


@pytest.mark.parametrize("grid,out_size", [((3, 4, 4), (5, 5, 6)), ((5, 4, 5), (4, 3, 4))])
def test_fft_truncate_3d_gradcheck_float64(grid, out_size):
    """The FFT path's hand-written backward, upsampling and downsampling
    (even and odd time lengths on both sides)."""
    x = torch.randn((1, 1) + grid, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1)).requires_grad_()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # pocketfft's threads cost ms a tiny multi-axis c2r
    try:
        assert torch.autograd.gradcheck(lambda a: spectral.fourier_truncate_3d(a, out_size),
                                        (x,))
    finally:
        torch.set_num_threads(threads)


def test_every_c2r_input_is_hermitian_on_its_dc_and_nyquist_planes(monkeypatch):
    seen = []
    irfftn = torch.fft.irfftn

    def checked(spec, s=None, dim=None, norm=None):
        n = s[-1]
        for k in (0, n // 2) if n % 2 == 0 else (0,):
            sl = spec[..., k]
            seen.append(torch.equal(sl, sl.flip((-2, -1)).roll((1, 1), (-2, -1)).conj()))
        return irfftn(spec, s=s, dim=dim, norm=norm)

    monkeypatch.setattr(torch.fft, "irfftn", checked)
    x = torch.randn(1, 2, 8, 8, 6, requires_grad=True)
    w = torch.randn(4, 2, 2, 6, 6, 3, dtype=torch.complex64, requires_grad=True)
    for out_size, modes in (((12, 12, 6), (6, 6, 3)), ((7, 6, 9), (4, 4, 3))):
        spectral.spectral_conv_3d(x, w[..., : modes[0], : modes[1], :], out_size,
                                  modes).square().sum().backward()
        spectral.fourier_truncate_3d(x, out_size).square().sum().backward()
    # two c2r a pass of each op, the even lengths with a Nyquist plane too
    assert len(seen) == 14 and all(seen)


def test_channel_slices_fill_the_card_and_stay_in_the_grid():
    """The kernel's blocks along y: about ``FILL`` threads an SM over the
    destination's plane, never more slices than channels, never past the
    grid's limit, at least one."""
    sms = 132
    assert R.slices(256, 64 * 64 * 27, sms) == -(-sms * R.FILL // (64 * 64 * 27))
    assert R.slices(3, 10, sms) == 3  # a tiny plane: a slice a channel
    assert R.slices(10**6, 1, sms) == R.GRID_MAX
    assert R.slices(5, 10**9, sms) == 1
