"""The spectrum remap (``ops/kernels/remap.py``) and the FFT path of the
1-, 2- and 3-D ops built on it (``ops/spectral.py``), on the CPU; JAX-free.

``remap_plain`` against a direct loop over a tiny spectrum, with two
sources an index, absent sources, maps that read a prefix, the identity,
scales and Hermitian planes; ``plan``'s
refusals; ``REMAPS`` in every rank, two a conv and one a truncation in a
forward and the same again in the backward; a float64 ``gradcheck`` of
the 3-D truncation's and the 2-D conv's hand-written backward, upsampling
and downsampling, the 2-D conv also on one grid, with overlapping corners
and on two channel pieces; and every half spectrum that the path hands to
a c2r in every rank, forward and backward, Hermitian on its DC and
Nyquist planes, so that cuFFT's c2r answers as pocketfft's (the card's
kernel against the plain version: tests/test_torch_cuda.py).  The ops
against ``uno_tpu`` are tests/test_torch_spectral*.py's.
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


MAPS = {  # rows, cols, bins
    "sources": ([(0,), (4, 1), (), (3,), (2, 2)], [(1, 3), (0,), (2,), ()], [0, 5, None, 2]),
    "slices": ([(0,), (1,), (), ()], [(0, 1), (1,), (2,), (3,)], [0, 1, 2, 3]),  # zero-padded
    "identity": ([(i,) for i in range(5)], [(j,) for j in range(4)], list(range(6))),
}


@pytest.mark.parametrize("maps", list(MAPS))
@pytest.mark.parametrize("herm", [(), (0, 3)])
def test_plain_remap_matches_a_loop(herm, maps):
    """Two sources, none and one twice; maps that read a prefix, zero-padded;
    every map the identity, whose destination is a new tensor all the same."""
    g = torch.Generator().manual_seed(0)
    src = torch.randn(2, 3, 5, 4, 6, dtype=torch.complex128, generator=g)
    rows, cols, bins = MAPS[maps]
    scale = [1.0] * len(bins) if maps == "identity" else [1.0, 2.0, 0.5, -1.5]
    got = R.remap(src, R.plan(rows, cols, bins, scale, herm))
    assert got.shape == (2, 3, len(rows), len(cols), len(bins))
    want = _loop(src, rows, cols, bins, scale, herm)
    assert torch.allclose(got, want, rtol=0, atol=1e-13)
    assert got.untyped_storage().data_ptr() != src.untyped_storage().data_ptr()


def test_plan_refuses_three_sources_and_bad_bins():
    with pytest.raises(ValueError, match="at most two sources"):
        R.plan([(0, 1, 2)], [(0,)], [0])
    with pytest.raises(ValueError, match="scales"):
        R.plan([(0,)], [(0,)], [0, 1], scale=[1.0])
    with pytest.raises(ValueError, match="herm"):
        R.plan([(0,)], [(0,)], [0], herm=(1,))
    # one object for each value: its tables are made once per device
    assert R.plan([(0,)], [(1,)], [0]) is R.plan([[0]], [[1]], [0])


# rank -> (the conv, its input, weights, output grid and modes)
CONVS = {
    1: (lambda x, w, out, m: spectral.spectral_conv_1d(x, w, out[0], m[0]), (1, 2, 12),
        (1, 2, 3, 5), (16,), (5,)),
    2: (spectral.spectral_conv_2d, (1, 2, 8, 8), (2, 2, 3, 6, 4), (12, 10), (6, 4)),
    3: (spectral.spectral_conv_3d, (1, 2, 8, 8, 6), (4, 2, 3, 6, 6, 3), (12, 12, 6), (6, 6, 3)),
}


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_remaps_counted_by_pass(rank):
    conv, xs, ws, out, modes = CONVS[rank]
    x = torch.randn(xs, requires_grad=True)
    w = torch.randn(ws, dtype=torch.complex64, requires_grad=True)
    spectral.REMAPS.update(forward=0, backward=0)
    y = conv(x, w, out, modes)
    assert spectral.REMAPS == {"forward": 2, "backward": 0}
    y.sum().backward()
    assert spectral.REMAPS == {"forward": 2, "backward": 2}
    with torch.no_grad():  # no gradient: the forward alone
        conv(x, w, out, modes)
    assert spectral.REMAPS == {"forward": 4, "backward": 2}
    if rank == 3:
        spectral.REMAPS.update(forward=0, backward=0)
        spectral.fourier_truncate_3d(x, (4, 4, 6)).sum().backward()
        assert spectral.REMAPS == {"forward": 1, "backward": 1}


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


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_every_c2r_input_is_hermitian_on_its_dc_and_nyquist_planes(monkeypatch, rank):
    """Every c2r's DC and Nyquist planes equal their mirror's conjugate along
    the c2r's other axes (in 1-D: are real), in the forward and the
    backward of the conv (and in 3-D of the truncation), at an even and an
    odd output length."""
    seen = []
    irfftn = torch.fft.irfftn

    def checked(spec, s=None, dim=None, norm=None):
        n, axes = s[-1], tuple(d + 1 for d in dim[:-1])  # the slice's c2c axes
        for k in (0, n // 2) if n % 2 == 0 else (0,):
            sl = spec[..., k]
            mirror = sl.flip(axes).roll((1,) * len(axes), axes) if axes else sl
            seen.append(torch.equal(sl, mirror.conj()))
        return irfftn(spec, s=s, dim=dim, norm=norm)

    monkeypatch.setattr(torch.fft, "irfftn", checked)
    conv, xs, ws, (*lead, d), modes = CONVS[rank]
    x = torch.randn(xs, requires_grad=True)
    w = torch.randn(ws, dtype=torch.complex64, requires_grad=True)
    for last in (d, d + 3):
        conv(x, w, (*lead, last), modes).square().sum().backward()
        if rank == 3:
            spectral.fourier_truncate_3d(x, (*lead, last)).square().sum().backward()
    # two c2r a pass of each op (the backward's at the input's even length),
    # the even lengths with a Nyquist plane too
    want = {1: 7, 2: 7, 3: 14}[rank]
    assert len(seen) == want and all(seen)


@pytest.mark.parametrize("grid,out_size,modes,channels", [
    ((6, 5), (6, 5), (2, 2), (2,)),      # one grid
    ((5, 6), (5, 6), (3, 2), (2,)),      # overlapping corners: 2 * m1 > d1
    ((4, 5), (7, 8), (2, 3), (2,)),      # up-sampling
    ((7, 8), (4, 6), (2, 3), (2,)),      # down-sampling, odd input
    ((6, 6), (5, 7), (2, 2), (1, 2)),    # two channel pieces
])
def test_fft_conv_2d_gradcheck_complex128(grid, out_size, modes, channels):
    """The 2-D conv's hand-written backward on the FFT path, the input's
    pieces and the weight; gradcheck differentiates the real and imaginary
    parts of the weight apart, so a conjugated gradient fails it."""
    g = torch.Generator().manual_seed(2)
    xs = [torch.randn((1, c) + grid, dtype=torch.float64, generator=g).requires_grad_()
          for c in channels]
    w = torch.randn((2, sum(channels), 2) + modes, dtype=torch.complex128,
                    generator=g).requires_grad_()

    def conv(w, *pieces):
        return spectral.spectral_conv_2d(list(pieces) if len(pieces) > 1 else pieces[0], w,
                                         out_size, modes)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert torch.autograd.gradcheck(conv, (w, *xs))
    finally:
        torch.set_num_threads(threads)


def test_channel_slices_fill_the_card_and_stay_in_the_grid():
    """The kernel's blocks along y: about ``FILL`` threads an SM over the
    destination's plane, never more slices than channels, never past the
    grid's limit, at least one."""
    sms = 132
    assert R.slices(256, 64 * 64 * 27, sms) == -(-sms * R.FILL // (64 * 64 * 27))
    assert R.slices(3, 10, sms) == 3  # a tiny plane: a slice a channel
    assert R.slices(10**6, 1, sms) == R.GRID_MAX
    assert R.slices(5, 10**9, sms) == 1
