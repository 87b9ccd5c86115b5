"""The port's CUDA kernels and model on the card, against their plain PyTorch
versions, forward and backward, at the Darcy (darcy_s211, darcy_s421 and
its super-resolution evaluation), NS-2D and NS-3D paths' shapes; uno11, the
NS-2D rollout, the NS-3D model, the partial-DFT spectral path (2-D and
3-D), the Darcy and NS solvers and checkpoints on the card against the
CPU; the kernels' custom ops (``torch.library``) and an exported program
served on the card.  Every case needs a CUDA device and skips without one.

Since PR 11 also: the contractions at the TP shard shapes, the split
spectral convs over a world of one, and ``remat_blocks`` on the card.  And
the shape families of the other U-NO variants: the contraction at the
largest M (uno3d_t40_256), at uno_demo's 512 x 512 bottleneck, at batch 4
(uno_s256 and the uno3d_*_256 family), and the head at darcy_s85's and
uno_demo's shapes.

Also: the spectrum remap kernel against its plain version at
every remap of a uno3d_t40, a uno3d_t40_256, a uno9 (bf16, and f32 with its
skips as channel pieces) and a 1-D block's forward and backward, its
custom op, and one ns3d_t40 training step's loss and gradients on the card
against the CPU.

This file imports no JAX, so it runs where the port runs; tests/conftest.py
imports JAX, so on a machine without it run

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from uno_tpu_torch.models import build_model
from uno_tpu_torch.ops.kernels import cmul as C
from uno_tpu_torch.ops.kernels import mlp_head as H
from uno_tpu_torch.ops.kernels import remap as R

# (B, Ci, Co, M) of the five uno9 contractions at darcy_s211, batch 16
DARCY_S211 = [(16, 32, 64, 648), (16, 64, 128, 128), (16, 128, 128, 128),
              (16, 128, 64, 128), (16, 128, 32, 648)]
# (B, Ci, Co, M) of the seven uno contractions at ns2d (64x64, width 32), batch 16
NS2D = [(16, 32, 48, 968), (16, 48, 96, 392), (16, 96, 192, 72), (16, 192, 192, 72),
        (16, 192, 96, 72), (16, 192, 48, 392), (16, 96, 32, 968)]
# (B, Ci, Co, M) of the seven uno3d_t40 contractions at ns3d_t40 (64x64, T 10 -> 40,
# width 8), batch 16: M up to 22,400 (a grid of 5,600 blocks along x)
NS3D = [(16, 8, 16, 6400), (16, 16, 32, 3136), (16, 32, 64, 576), (16, 64, 128, 1008),
        (16, 128, 32, 1008), (16, 64, 16, 7840), (16, 32, 16, 22400)]
# (B, Ci, Co, M) of the seven uno11 contractions at darcy_s421 (width 32), batch 4:
# dw's channels (the batch) are a quarter of its 16-row tile
UNO11_S421 = [(4, 32, 64, 648), (4, 64, 128, 128), (4, 128, 256, 18), (4, 256, 256, 18),
              (4, 256, 128, 18), (4, 256, 64, 128), (4, 128, 32, 648)]
# uno9's five forward contractions in the super-resolution evaluation, batch 8
SUPERRES = [(8, 32, 64, 648), (8, 64, 128, 128), (8, 128, 128, 128), (8, 128, 64, 128),
            (8, 128, 32, 648)]
# uno9's five contractions at darcy_s211 under 2-way channel TP: each rank's
# Co/2 shard of every weight
DARCY_S211_TP2 = [(b, ci, co // 2, m) for b, ci, co, m in DARCY_S211]
# (B, Ci, Co, M) of the variants' new shape families: uno3d_t40_256's last
# block, the largest M (65,536 modes: 268 MB of weight, a grid of 16,384
# blocks along x) and its 128 x 128 bottleneck at batch 4; uno_demo's 512 x
# 512 bottleneck at 8 modes (a grid of 64 blocks) and the 256 -> 512 block
# before it; uno_s256's first and last blocks at batch 4 (dw's channels: a
# quarter of its 16-row tile)
VARIANTS = [(4, 32, 16, 65536), (4, 128, 128, 512), (16, 512, 512, 8), (16, 256, 512, 8),
            (4, 32, 64, 2112), (4, 128, 32, 2048)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-12))


def _rand_c(g, *shape):
    return torch.complex(torch.randn(shape, generator=g), torch.randn(shape, generator=g))


# Shapes at every edge of the contraction kernel's plan (B, Ci, Co, M): one
# batch row; 9, 17 and 33 rows (a partial tile, row tiles along the grid's
# z); odd M (8-byte copies) and M not a multiple of the block's 4 modes; Ci
# or Co of 1; channel counts that the split does not divide, or (dw, whose
# rows are Ci and whose channels are the batch) not a multiple of the 16-row
# tile.  Then the five Darcy and the seven NS-2D path shapes.
EDGES = [(2, 3, 5, 7), (4, 8, 8, 128), (2, 4, 6, 200), (3, 6, 7, 200), (9, 5, 3, 33),
         (1, 1, 1, 1), (1, 7, 1, 33), (17, 1, 40, 7), (16, 9, 17, 64), (17, 128, 64, 128),
         (33, 9, 19, 33), (33, 130, 70, 40), (16, 37, 1, 648), (1, 20, 33, 9),
         (9, 33, 1, 65), (17, 1, 18, 31), (33, 17, 20, 31)]


def _misaligned(t):
    """The same values at an address one element past a 16-byte boundary
    (8 bytes for complex64, 2 for bf16)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == t.element_size()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b,ci,co,m", EDGES + DARCY_S211 + NS2D + NS3D + UNO11_S421 + SUPERRES
                         + DARCY_S211_TP2 + VARIANTS)
def test_cmul_kernel_matches_plain(cuda, b, ci, co, m):
    g = torch.Generator().manual_seed(1)
    x = _rand_c(g, b, ci, m).to(cuda)
    w = (_rand_c(g, ci, co, m) / (2 * ci) ** 0.5).to(cuda)  # the init's scale
    before = C.LAUNCHES["fwd"]
    got = C.cmul(x, w)
    again = C.cmul(x, w)
    torch.cuda.synchronize()
    assert C.LAUNCHES["fwd"] == before + 2
    torch.testing.assert_close(got, C.cmul_plain(x, w), rtol=0, atol=1e-4)
    assert torch.equal(got, again)  # the split's partial sums add in a fixed order
    # an operand off a 16-byte boundary takes the 8-byte copies
    torch.testing.assert_close(C.cmul(_misaligned(x), w), got, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("b,ci,co,m", EDGES + DARCY_S211 + NS2D + NS3D + UNO11_S421
                         + DARCY_S211_TP2 + VARIANTS)
def test_cmul_backward_kernels_match_plain(cuda, b, ci, co, m):
    g_ = torch.Generator().manual_seed(3)
    x = _rand_c(g_, b, ci, m).to(cuda)
    w = (_rand_c(g_, ci, co, m) / (2 * ci) ** 0.5).to(cuda)
    g = _rand_c(g_, b, co, m).to(cuda)
    before = dict(C.LAUNCHES)
    gx, gw = C.cmul_bwd_x(g, w), C.cmul_bwd_w(x, g)
    gx2, gw2 = C.cmul_bwd_x(g, w), C.cmul_bwd_w(x, g)
    torch.cuda.synchronize()
    assert C.LAUNCHES["bwd_x"] == before["bwd_x"] + 2
    assert C.LAUNCHES["bwd_w"] == before["bwd_w"] + 2
    torch.testing.assert_close(gx, C.cmul_bwd_x_plain(g, w), rtol=0, atol=1e-4)
    torch.testing.assert_close(gw, C.cmul_bwd_w_plain(x, g), rtol=0, atol=1e-4)
    assert torch.equal(gx, gx2) and torch.equal(gw, gw2)  # the split adds in a fixed order
    torch.testing.assert_close(C.cmul_bwd_x(g, _misaligned(w)), gx, rtol=0, atol=1e-6)
    torch.testing.assert_close(C.cmul_bwd_w(_misaligned(x), _misaligned(g)), gw, rtol=0,
                               atol=1e-6)
    # autograd through the Function reaches the same kernels
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    (C.cmul(xr, wr) * g.conj()).real.sum().backward()
    torch.testing.assert_close(xr.grad, gx, rtol=0, atol=1e-5)
    torch.testing.assert_close(wr.grad, gw, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cmul_wrapper_raises_on_the_card(cuda):
    x = torch.zeros(2, 3, 8, dtype=torch.complex64, device=cuda)
    w = torch.zeros(3, 4, 8, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        C.cmul(x.transpose(0, 1).contiguous().transpose(0, 1), w)
    with pytest.raises(ValueError):
        C.cmul(x, w.cpu())
    n = C.TILE_N * C.GRID_Y_MAX + 1  # past the grid's y limit: raises, launches nothing
    before = dict(C.LAUNCHES)
    with pytest.raises(ValueError, match="grid"):
        C.cmul(x[:1, :1, :1].contiguous(), torch.zeros(1, n, 1, dtype=torch.complex64,
                                                        device=cuda))
    assert C.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape,h,o", [((2, 8, 37, 45), 32, 1), ((1, 16, 64, 64), 64, 3),
                                       ((16, 64, 211, 211), 32, 1), ((3, 5, 7, 300), 40, 4),
                                       ((16, 64, 64, 64), 128, 1),  # the ns2d head
                                       # darcy_s421 (uno11) and its super-resolution batch
                                       ((4, 64, 421, 421), 32, 1), ((8, 64, 421, 421), 32, 1),
                                       # darcy_s85 (uno9) and uno_demo at 211 x 211
                                       ((16, 64, 85, 85), 32, 1), ((16, 32, 211, 211), 64, 1)])
def test_mlp_head_kernel_matches_plain(cuda, shape, h, o):
    g = torch.Generator().manual_seed(2)
    c = shape[1]
    x = torch.randn(shape, generator=g).to(cuda, torch.bfloat16)
    w = [t.to(cuda) for t in (torch.randn(c, h, generator=g) / c**0.5,
                              torch.randn(h, generator=g),
                              torch.randn(h, o, generator=g) / h**0.5,
                              torch.randn(o, generator=g))]
    before = H.LAUNCHES["fwd"]
    got = H.mlp_head(x, *w)
    torch.cuda.synchronize()
    assert H.LAUNCHES["fwd"] == before + 1
    assert got.shape == (shape[0], o) + shape[2:] and got.dtype == torch.float32
    want = H.mlp_head_plain(x.reshape(shape[0], c, -1), *w).reshape(got.shape)
    assert _rel(got, want) <= 1e-5
    assert torch.equal(H.mlp_head(x, *w), got)  # the shuffles add in a fixed order


# (B, C, N, H, O) at the edges of the forward's plan: N of 1, N shorter than
# one tile, odd N with B*N ending inside a tile, C of 1, 5, 8 and 128, H of
# 1, 40 (padded to 64), 64 and 128, O of 1 to 4; then the heads of uno9 at
# width 64, uno at 32 and 64 (C 128, H 256: 32-point tiles, each thread two
# hidden groups) and uno_demo at 32 and 64
HEAD_FWD_EDGES = [(1, 1, 1, 1, 1), (1, 5, 7, 40, 2), (3, 8, 131, 64, 3), (2, 128, 257, 128, 4),
                  (5, 5, 99, 1, 4), (2, 8, 127, 40, 1), (1, 1, 300, 128, 2), (4, 64, 4001, 32, 1),
                  (2, 128, 4097, 64, 1), (2, 64, 4097, 128, 1), (2, 128, 4097, 256, 1),
                  (2, 32, 4097, 64, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,n,h,o", HEAD_FWD_EDGES)
def test_mlp_head_kernel_at_the_plans_edges(cuda, b, c, n, h, o):
    g = torch.Generator().manual_seed(6)
    x = torch.randn(b, c, n, generator=g).to(cuda, torch.bfloat16)
    w = [t.to(cuda) for t in (torch.randn(c, h, generator=g) / c**0.5,
                              torch.randn(h, generator=g),
                              torch.randn(h, o, generator=g) / h**0.5,
                              torch.randn(o, generator=g))]
    before = H.LAUNCHES["fwd"]
    got = H.mlp_head(x, *w)
    again = H.mlp_head(x, *w)
    torch.cuda.synchronize()
    assert H.LAUNCHES["fwd"] == before + 2
    assert got.shape == (b, o, n) and got.dtype == torch.float32
    assert _rel(got, H.mlp_head_plain(x, *w)) <= 1e-5
    assert torch.equal(got, again)
    # x off a 16-byte boundary: the wrapper copies it, the same bits come out
    assert torch.equal(H.mlp_head(_misaligned(x), *w), got)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,h,o", [((2, 8, 37 * 45), 32, 1), ((1, 16, 4096), 64, 3),
                                       ((3, 5, 2100), 40, 4), ((16, 64, 211 * 211), 32, 1),
                                       ((4, 64, 421 * 421), 32, 1),  # darcy_s421
                                       # darcy_s85 (uno9) and uno_demo at 211 x 211
                                       ((16, 64, 85 * 85), 32, 1), ((16, 32, 211 * 211), 64, 1)])
def test_mlp_head_backward_kernel_matches_plain(cuda, shape, h, o):
    g_ = torch.Generator().manual_seed(4)
    b, c, n = shape
    x = torch.randn(shape, generator=g_).to(cuda, torch.bfloat16)
    k1, b1, k2 = [t.to(cuda) for t in (torch.randn(c, h, generator=g_) / c**0.5,
                                       torch.randn(h, generator=g_),
                                       torch.randn(h, o, generator=g_) / h**0.5)]
    g = torch.randn(b, o, n, generator=g_).to(cuda)
    before = H.LAUNCHES["bwd"]
    got = H.mlp_head_bwd(x, g, k1, b1, k2)
    torch.cuda.synchronize()
    assert H.LAUNCHES["bwd"] == before + 1
    want = H.mlp_head_bwd_plain(x, g, k1, b1, k2)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == x.shape
    assert _rel(got[0], want[0]) <= 4e-3
    for gk, wk in zip(got[1:], want[1:]):
        assert gk.shape == wk.shape and _rel(gk, wk) <= 1e-5
    # the weight-gradient reduction is deterministic: the same bits again
    again = H.mlp_head_bwd(x, g, k1, b1, k2)
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)


# (B, C, N, H, O) at the edges of the backward's plan: N shorter than one
# tile, odd N, B*N ending inside a tile, C of 5 (odd: a zero pad row), 8
# and 64 (two gk1 shares per thread at H 64, four at H 128: one block per
# SM), H of 32, 40 (padded to 64), 64 and 128, O of 1 to 4; the last is the
# ns2d head's
HEAD_BWD_EDGES = [(1, 5, 7, 32, 1), (3, 8, 131, 40, 2), (2, 64, 257, 64, 3),
                  (1, 64, 100, 32, 4), (5, 5, 99, 64, 4), (2, 8, 127, 40, 1), (4, 64, 4001, 32, 1),
                  (2, 64, 4097, 128, 1), (16, 64, 4096, 128, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,n,h,o", HEAD_BWD_EDGES)
def test_mlp_head_backward_kernel_at_the_plans_edges(cuda, b, c, n, h, o):
    """The cotangent is that of a mean-like loss, 1 plus noise: gb2 is then
    not a sum of random signs that cancels to near 0, whose rel-L2 would
    measure f32 cancellation rather than the kernel."""
    g_ = torch.Generator().manual_seed(5)
    x = torch.randn(b, c, n, generator=g_).to(cuda, torch.bfloat16)
    k1, b1, k2 = [t.to(cuda) for t in (torch.randn(c, h, generator=g_) / c**0.5,
                                       torch.randn(h, generator=g_),
                                       torch.randn(h, o, generator=g_) / h**0.5)]
    g = (1 + torch.randn(b, o, n, generator=g_)).to(cuda)
    before = H.LAUNCHES["bwd"]
    got = H.mlp_head_bwd(x, g, k1, b1, k2)
    again = H.mlp_head_bwd(x, g, k1, b1, k2)
    torch.cuda.synchronize()
    assert H.LAUNCHES["bwd"] == before + 2
    want = H.mlp_head_bwd_plain(x, g, k1, b1, k2)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == x.shape
    assert _rel(got[0], want[0]) <= 4e-3
    for gk, wk in zip(got[1:], want[1:]):
        assert gk.shape == wk.shape and _rel(gk, wk) <= 1e-5
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)
    # x off a 16-byte boundary: the wrapper copies it, the same bits come out
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xm = buf[1:].view(x.shape)
    xm.copy_(x)
    for a, b_ in zip(H.mlp_head_bwd(xm, g, k1, b1, k2), got):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_uno9_gradients_on_the_card_match_the_cpu(cuda, dtype, bound):
    """One training loss through the kernels on the card and the plain
    versions on the CPU; all gradients concatenated."""
    from uno_tpu_torch.losses import relative_lp_loss

    kw = dict(in_width=3, width=8, pad=1)
    cpu = build_model("uno9", dtype=dtype, generator=torch.Generator().manual_seed(0), **kw)
    gpu = build_model("uno9", dtype=dtype, generator=torch.Generator().manual_seed(0),
                      device=cuda, **kw)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 85, 85, 1)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 85, 85)).astype(np.float32))
    before = dict(C.LAUNCHES), dict(H.LAUNCHES)
    losses = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        loss = relative_lp_loss(model(x.to(dev)).reshape(2, 85, 85), y.to(dev))
        loss.backward()
        losses.append(loss.detach().cpu())
    assert C.LAUNCHES["bwd_x"] - before[0]["bwd_x"] == 5
    assert C.LAUNCHES["bwd_w"] - before[0]["bwd_w"] == 5
    assert H.LAUNCHES["bwd"] - before[1]["bwd"] == (1 if dtype == "bfloat16" else 0)
    flat = [torch.cat([torch.view_as_real(p.grad).flatten() if p.is_complex()
                       else p.grad.flatten() for p in m.parameters()]) for m in (cpu, gpu)]
    assert torch.isfinite(flat[1]).all()
    assert _rel(losses[1], losses[0]) <= bound
    assert _rel(flat[1], flat[0]) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_uno9_on_the_card_matches_the_cpu(cuda, dtype, bound):
    """The same weights on the card (through the kernels) and on the CPU
    (through the plain versions)."""
    kw = dict(in_width=3, width=8, pad=1)
    cpu = build_model("uno9", dtype=dtype, generator=torch.Generator().manual_seed(0), **kw)
    gpu = build_model("uno9", dtype=dtype, generator=torch.Generator().manual_seed(0),
                      device=cuda, **kw)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 85, 85, 1))
                         .astype(np.float32))
    c0, h0 = dict(C.LAUNCHES), dict(H.LAUNCHES)
    with torch.inference_mode():
        want = cpu(x)
        got = gpu(x.to(cuda))
    assert C.LAUNCHES["fwd"] - c0["fwd"] == 5
    assert H.LAUNCHES["fwd"] - h0["fwd"] == (1 if dtype == "bfloat16" else 0)
    # inference launches the forward kernels only
    assert (C.LAUNCHES["bwd_x"], C.LAUNCHES["bwd_w"], H.LAUNCHES["bwd"]) == (
        c0["bwd_x"], c0["bwd_w"], h0["bwd"])
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_ns2d_rollout_on_the_card_matches_the_cpu(cuda, dtype, bound):
    """The 2-step rollout's loss, trajectory and all gradients of uno (width
    8, 64x64) through the kernels on the card and the plain versions on the
    CPU; every step is checkpointed, so its forward runs twice."""
    from uno_tpu_torch.train.ns2d import make_rollout

    kw = dict(in_width=14, width=8, pad=0)
    rng = np.random.default_rng(3)
    xx = torch.from_numpy(rng.standard_normal((2, 64, 64, 10)).astype(np.float32))
    yy = torch.from_numpy(rng.standard_normal((2, 64, 64, 2)).astype(np.float32))
    res = []
    c0, h0 = dict(C.LAUNCHES), dict(H.LAUNCHES)
    for dev in ("cpu", cuda):
        model = build_model("uno", dtype=dtype, generator=torch.Generator().manual_seed(0),
                            device=dev, **kw)
        loss, pred = make_rollout(model, 2)(xx.to(dev), yy.to(dev))
        loss.backward()
        grads = torch.cat([torch.view_as_real(p.grad).flatten() if p.is_complex()
                           else p.grad.flatten() for p in model.parameters()])
        res.append((loss.detach(), pred.detach(), grads))
    bf16 = dtype == "bfloat16"
    assert C.LAUNCHES["fwd"] - c0["fwd"] == 2 * 2 * 7
    assert C.LAUNCHES["bwd_x"] - c0["bwd_x"] == C.LAUNCHES["bwd_w"] - c0["bwd_w"] == 2 * 7
    assert H.LAUNCHES["fwd"] - h0["fwd"] == (4 if bf16 else 0)
    assert H.LAUNCHES["bwd"] - h0["bwd"] == (2 if bf16 else 0)
    assert res[1][1].dtype == torch.float32 and torch.isfinite(res[1][2]).all()
    for got, want in zip(res[1], res[0]):
        assert _rel(got, want) <= bound


@pytest.mark.cuda
def test_navier_stokes_on_the_card_matches_the_cpu(cuda):
    """100 steps of the solver from one w0 on both devices."""
    from uno_tpu_torch.data.grf import GaussianRF
    from uno_tpu_torch.data.ns_solver import default_forcing, navier_stokes_2d

    w0 = GaussianRF(2, 64, alpha=2.5, tau=7.0).sample(torch.Generator().manual_seed(0), 4)
    f = default_forcing(64)
    want, t_cpu = navier_stokes_2d(w0, f, visc=1e-3, T=0.1, delta_t=1e-3, record_steps=4)
    got, t_gpu = navier_stokes_2d(w0.to(cuda), f, visc=1e-3, T=0.1, delta_t=1e-3,
                                  record_steps=4)
    assert got.device.type == "cuda" and torch.isfinite(got).all()
    assert torch.equal(t_cpu, t_gpu) and _rel(got, want) <= 1e-5


@pytest.fixture
def dft_path():
    from uno_tpu_torch.ops.spectral import set_dft_mode

    set_dft_mode(True)
    yield
    set_dft_mode(None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape,out_size,modes", [
    ((2, 4, 6, 32, 32), (16, 16), (5, 4)), ((2, 3, 5, 16, 16), (10, 10), (6, 5)),
    ((16, 32, 64, 247, 247), (123, 123), (18, 18))])  # the last: block 0 at darcy_s211
def test_dft_conv_on_the_card_matches_the_cpu(cuda, dft_path, shape, out_size, modes, dtype,
                                              bound):
    """Forward and the gradients of x and the weights: cuBLAS einsums on the
    card against the CPU's; no contraction kernel runs on this path."""
    from uno_tpu_torch.ops.spectral import spectral_conv_2d

    b, ci, co, h, w = shape
    g = torch.Generator().manual_seed(2)
    x = torch.randn(b, ci, h, w, generator=g).to(getattr(torch, dtype))
    wt = _rand_c(g, 2, ci, co, *modes) / (2 * ci) ** 0.5
    cot = torch.randn((b, co) + out_size, generator=g)
    c0 = dict(C.LAUNCHES)
    res = []
    for dev in ("cpu", cuda):
        xt = x.to(dev).detach().requires_grad_()
        wtt = wt.to(dev).detach().requires_grad_()
        y = spectral_conv_2d(xt, wtt, out_size, modes)
        (y.float() * cot.to(dev)).sum().backward()
        res.append((y, xt.grad, wtt.grad))
    assert C.LAUNCHES == c0
    assert res[1][0].dtype == x.dtype and res[1][1].dtype == x.dtype
    for got, want in zip(res[1], res[0]):
        assert torch.isfinite(torch.view_as_real(got) if got.is_complex() else got).all()
        got, want = (torch.view_as_real(t) if t.is_complex() else t for t in (got, want))
        assert _rel(got, want) <= bound


@pytest.mark.cuda
def test_solve_darcy_on_the_card_matches_the_cpu(cuda):
    from uno_tpu_torch.data.darcy_solver import generate_darcy_batch, solve_darcy

    a, _ = generate_darcy_batch(torch.Generator().manual_seed(0), 2, 33, maxiter=1)
    f = torch.ones_like(a)
    info_cpu, info_gpu = {}, {}
    want = solve_darcy(a, f, info=info_cpu)
    got = solve_darcy(a.to(cuda), f.to(cuda), info=info_gpu)
    assert got.device.type == "cuda" and torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4
    assert info_gpu["residual"] < 1e-5
    # the same draw on the card: xi comes from the CPU generator
    a2, p2 = generate_darcy_batch(torch.Generator().manual_seed(0), 2, 33, device=cuda)
    assert torch.equal(a2.cpu(), a) and _rel(p2, want) <= 1e-4


@pytest.mark.cuda
def test_a_checkpoint_saved_on_the_card_restores_on_the_cpu(cuda, tmp_path):
    from uno_tpu_torch.optim import ComplexAdam
    from uno_tpu_torch.train.checkpoint import CheckpointManager

    kw = dict(in_width=3, width=8, pad=1)
    gpu = build_model("uno9", generator=torch.Generator().manual_seed(0), device=cuda, **kw)
    opt = ComplexAdam(gpu.parameters(), lr=1e-3)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 85, 85, 1))
                         .astype(np.float32))
    gpu(x.to(cuda)).square().mean().backward()
    opt.step()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save("train_state", {"params": gpu.state_dict(), "optimizer": opt.state_dict()["state"],
                             "step": 1, "epoch": 0, "best_val": 0.5})
    got = mgr.restore("train_state")
    cpu = build_model("uno9", generator=torch.Generator().manual_seed(5), **kw)
    cpu.load_state_dict(got["params"])
    ocpu = ComplexAdam(cpu.parameters(), lr=1e-3)
    ocpu.load_state_dict({"state": got["optimizer"],
                          "param_groups": ocpu.state_dict()["param_groups"]})
    for (n, p1), (_, p2) in zip(gpu.named_parameters(), cpu.named_parameters()):
        assert p2.device.type == "cpu" and torch.equal(p1.cpu(), p2), n
    for st in ocpu.state.values():
        assert st["step"] == 1 and st["exp_avg"].device.type == "cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound,grad_bound", [("float32", 1e-4, 1e-4),
                                                    ("bfloat16", 3e-2, 5e-2)])
def test_uno3d_t40_on_the_card_matches_the_cpu(cuda, dtype, bound, grad_bound):
    """uno3d_t40 (width 4, 64x64, T_in 10 -> T_f 40, one sample): the
    forward, then the loss and all gradients, through the kernels on the
    card and the plain versions on the CPU; 7 forward contractions, no head
    kernel (a 3-D model takes the unfused Dense head)."""
    from uno_tpu_torch.losses import relative_lp_loss
    from uno_tpu_torch.train.ns3d import forecast

    kw = dict(in_width=6, width=4, pad=3)
    rng = np.random.default_rng(4)
    xx = torch.from_numpy(rng.standard_normal((1, 64, 64, 10)).astype(np.float32))
    yy = torch.from_numpy(rng.standard_normal((1, 64, 64, 40)).astype(np.float32))
    res = []
    c0, h0 = dict(C.LAUNCHES), dict(H.LAUNCHES)
    for dev in ("cpu", cuda):
        model = build_model("uno3d_t40", dtype=dtype, device=dev,
                            generator=torch.Generator().manual_seed(0), **kw)
        with torch.no_grad():
            out = forecast(model, xx.to(dev), 40)
        loss = relative_lp_loss(forecast(model, xx.to(dev), 40), yy.to(dev))
        loss.backward()
        grads = torch.cat([torch.view_as_real(p.grad).flatten() if p.is_complex()
                           else p.grad.flatten() for p in model.parameters()])
        res.append((out, loss.detach(), grads))
    assert C.LAUNCHES["fwd"] - c0["fwd"] == 2 * 7
    assert C.LAUNCHES["bwd_x"] - c0["bwd_x"] == C.LAUNCHES["bwd_w"] - c0["bwd_w"] == 7
    assert H.LAUNCHES == h0
    assert res[1][0].shape == (1, 64, 64, 40) and res[1][0].dtype == torch.float32
    assert torch.isfinite(res[1][0]).all() and torch.isfinite(res[1][2]).all()
    assert _rel(res[1][0], res[0][0]) <= bound
    assert _rel(res[1][1], res[0][1]) <= grad_bound
    assert _rel(res[1][2], res[0][2]) <= grad_bound


def _remap_steps(name: str, size: int, device) -> dict:
    """One forward and backward of each form of ``name`` that the test
    holds (width 2, one sample), by the dtype it runs in: ``1d`` a 1-D
    OperatorBlock (4 -> 6 channels, ``size`` -> size/2 points, 64 modes);
    uno9 in bf16 (its skips concatenated) and f32 (its skips carried as
    channel pieces); a uno3d model in f32."""
    from uno_tpu_torch.losses import relative_lp_loss
    from uno_tpu_torch.nn.layers import OperatorBlock
    from uno_tpu_torch.train.ns3d import forecast

    g = torch.Generator().manual_seed(2)
    if name == "1d":
        blk = OperatorBlock(4, 6, (64,), normalize=True, device=device,
                            generator=torch.Generator().manual_seed(1))
        x = torch.randn((1, 4, size), generator=g).to(device).requires_grad_()
        return {"float32": lambda: blk(x, (size // 2,)).square().sum().backward()}
    if name == "uno9":
        x = torch.randn((1, size, size, 1), generator=g).to(device)
        y = torch.randn((1, size, size), generator=g).to(device)
        steps = {}
        for dtype in ("bfloat16", "float32"):
            model = build_model(name, dtype=dtype, device=device, width=2,
                                generator=torch.Generator().manual_seed(1))
            steps[dtype] = (lambda m: lambda: relative_lp_loss(
                m(x).reshape(y.shape), y).backward())(model)
        return steps
    model = build_model(name, device=device, generator=torch.Generator().manual_seed(1),
                        in_width=6, width=2)
    xx = torch.randn((1, size, size, 10), generator=g).to(device)
    yy = torch.randn((1, size, size, 40), generator=g).to(device)
    return {"float32": lambda: relative_lp_loss(forecast(model, xx, 40), yy).backward()}


@pytest.mark.cuda
@pytest.mark.parametrize("name,size,blocks", [("uno3d_t40", 64, 7), ("uno3d_t40_256", 256, 9),
                                              ("uno9", 211, 5), ("1d", 1024, 1)])
def test_remap_kernel_matches_plain_at_every_block(cuda, monkeypatch, name, size, blocks):
    """Every remap of one forward and backward of the model on the card, in
    every rank (``_remap_steps``): the kernel's output equal, bit for bit,
    to the plain version's of the same source and plan on the CPU; one
    kernel launch a remap, as many in the backward as in the forward: three
    a 3-D block (its conv and truncation), two a 1-D or 2-D conv, and one
    more for the conv that takes uno9's skip as a second channel piece."""
    from uno_tpu_torch.ops import spectral

    launch = R.remap
    for dtype, step in _remap_steps(name, size, cuda).items():
        calls = []

        def spy(src, p):
            out = launch(src, p)
            calls.append((src.cpu(), p, out.cpu()))
            return out

        monkeypatch.setattr(R, "remap", spy)
        n0, counted = R.LAUNCHES["remap"], dict(spectral.REMAPS)
        step()
        torch.cuda.synchronize()
        monkeypatch.setattr(R, "remap", launch)
        per_pass = (3 * blocks if name.startswith("uno3d") else
                    2 * blocks + (dtype == "float32" and name == "uno9"))
        moved = {k: spectral.REMAPS[k] - counted[k] for k in counted}
        assert moved == {"forward": per_pass, "backward": per_pass}, (dtype, moved)
        assert len(calls) == R.LAUNCHES["remap"] - n0 == 2 * per_pass
        for src, p, got in calls:
            want = R.remap_plain(src, p)
            assert got.shape == want.shape == src.shape[:2] + p.shape
            assert torch.equal(got, want), (dtype, p.shape, float((got - want).abs().max()))


@pytest.mark.cuda
def test_remap_custom_op_launches_the_kernel(cuda):
    """``uno_tpu_torch::remap`` on the card: one launch, equal to the plain
    version; the kernel takes complex64 alone."""
    g = torch.Generator().manual_seed(3)
    src = _rand_c(g, 2, 3, 8, 8, 5)
    p = R.plan([(0,), (7, 1), (), (3,)], [(1, 6), (0,), (2,)], [0, 4, None],
               scale=[1.0, 2.0, 0.5], herm=(0,))
    n0 = R.LAUNCHES["remap"]
    got = torch.ops.uno_tpu_torch.remap(src.to(cuda), list(p.tab), list(p.scale), list(p.shape))
    assert R.LAUNCHES["remap"] == n0 + 1
    assert torch.equal(got.cpu(), R.remap_plain(src, p))
    with pytest.raises(TypeError, match="complex64"):
        R.remap(src.to(torch.complex128).to(cuda), p)


@pytest.mark.cuda
def test_ns3d_t40_training_step_on_the_card_matches_the_cpu(cuda):
    """One ns3d_t40 training step's loss and gradients (uno3d_t40 width 4,
    two samples, the summed relative L2 as the trainer takes it) on the
    card and on the CPU: the loss and all gradients together within 1e-4
    (the biases before an instance norm have gradients of rounding alone,
    so no leaf is held by itself); 42 remap launches on the card, three a
    block each way."""
    from uno_tpu_torch.losses import relative_lp_loss
    from uno_tpu_torch.train.ns3d import forecast

    g = torch.Generator().manual_seed(4)
    xx, yy = torch.randn((2, 64, 64, 10), generator=g), torch.randn((2, 64, 64, 40), generator=g)
    res = []
    for dev in ("cpu", cuda):
        model = build_model("uno3d_t40", device=dev, generator=torch.Generator().manual_seed(0),
                            in_width=6, width=4, pad=3)
        n0 = R.LAUNCHES["remap"]
        loss = relative_lp_loss(forecast(model, xx.to(dev), 40), yy.to(dev), reduction="sum")
        loss.backward()
        if dev != "cpu":
            assert R.LAUNCHES["remap"] - n0 == 42
        res.append((loss.detach(), torch.cat([
            torch.view_as_real(p.grad).flatten() if p.is_complex() else p.grad.flatten()
            for p in model.parameters()])))
    (l0, g0), (l1, g1) = res
    assert _rel(l1, l0) <= 1e-4 and _rel(g1, g0) <= 1e-4, (_rel(l1, l0), _rel(g1, g0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_uno11_on_the_card_matches_the_cpu(cuda, dtype, bound):
    """uno11 (width 4, 85x85, the residual block included): the forward,
    then one training loss and all gradients, through the kernels on the
    card and the plain versions on the CPU; 7 contractions of each use and,
    under bf16, the fused head forward and backward."""
    from uno_tpu_torch.losses import relative_lp_loss

    kw = dict(in_width=3, width=4, pad=1)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 85, 85, 1)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 85, 85)).astype(np.float32))
    c0, h0 = dict(C.LAUNCHES), dict(H.LAUNCHES)
    res = []
    for dev in ("cpu", cuda):
        model = build_model("uno11", dtype=dtype, device=dev,
                            generator=torch.Generator().manual_seed(0), **kw)
        with torch.no_grad():
            out = model(x.to(dev))
        loss = relative_lp_loss(model(x.to(dev)).reshape(2, 85, 85), y.to(dev))
        loss.backward()
        grads = torch.cat([torch.view_as_real(p.grad).flatten() if p.is_complex()
                           else p.grad.flatten() for p in model.parameters()])
        res.append((out, loss.detach(), grads))
    assert C.LAUNCHES["fwd"] - c0["fwd"] == 2 * 7
    assert C.LAUNCHES["bwd_x"] - c0["bwd_x"] == C.LAUNCHES["bwd_w"] - c0["bwd_w"] == 7
    fused = 1 if dtype == "bfloat16" else 0
    assert (H.LAUNCHES["fwd"] - h0["fwd"], H.LAUNCHES["bwd"] - h0["bwd"]) == (2 * fused, fused)
    assert torch.isfinite(res[1][0]).all() and torch.isfinite(res[1][2]).all()
    assert _rel(res[1][0], res[0][0]) <= (1e-4 if dtype == "float32" else 3e-2)
    assert _rel(res[1][1], res[0][1]) <= bound
    assert _rel(res[1][2], res[0][2]) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_dft_conv_3d_and_truncation_on_the_card_match_the_cpu(cuda, dft_path, dtype, bound):
    """uno3d_t40's block 0 at width 4 (Ci 4, Co 8, 64x64x13 to 48x48x13,
    modes (20, 20, 4)) on the partial-DFT path: the conv's forward and the
    gradients of x and the weights, and the truncation's forward and
    gradient, cuBLAS einsums on the card against the CPU's; no contraction
    kernel runs on this path."""
    from uno_tpu_torch.ops.spectral import fourier_truncate_3d, spectral_conv_3d

    out_size, modes = (48, 48, 13), (20, 20, 4)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 4, 64, 64, 13, generator=g).to(getattr(torch, dtype))
    wt = _rand_c(g, 4, 4, 8, *modes) / 8**0.5
    cot = torch.randn((2, 8) + out_size, generator=g)
    cot_t = torch.randn((2, 4) + out_size, generator=g)
    c0 = dict(C.LAUNCHES)
    res = []
    for dev in ("cpu", cuda):
        xt = x.to(dev).detach().requires_grad_()
        wtt = wt.to(dev).detach().requires_grad_()
        y = spectral_conv_3d(xt, wtt, out_size, modes)
        (y.float() * cot.to(dev)).sum().backward()
        gx_conv = xt.grad
        xt.grad = None
        t = fourier_truncate_3d(xt, out_size)
        (t.float() * cot_t.to(dev)).sum().backward()
        res.append((y, gx_conv, wtt.grad, t, xt.grad))
    assert C.LAUNCHES == c0
    assert res[1][0].dtype == res[1][3].dtype == x.dtype
    for got, want in zip(res[1], res[0]):
        got, want = (torch.view_as_real(t) if t.is_complex() else t for t in (got, want))
        assert torch.isfinite(got).all()
        assert _rel(got, want) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("b,ci,co,m", DARCY_S211[:2] + NS3D[-1:])
def test_contract_custom_op_launches_the_kernel(cuda, b, ci, co, m):
    """``uno_tpu_torch::contract`` on the card: the kernel (one launch),
    equal to the wrapper's launch bit for bit and to the plain version
    within the kernel's bound."""
    g = torch.Generator().manual_seed(b * ci + m)
    x = _rand_c(g, b, ci, m).to(cuda)
    w = (_rand_c(g, ci, co, m) / ci**0.5).to(cuda)
    n0 = C.LAUNCHES["fwd"]
    got = torch.ops.uno_tpu_torch.contract(x, w)
    assert C.LAUNCHES["fwd"] == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, C.cmul(x, w))
    assert float((got - C.cmul_plain(x, w)).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape,h,o", [((16, 64, 211 * 211), 32, 1), ((16, 64, 4096), 128, 1)])
def test_mlp_head_fwd_custom_op_launches_the_kernel(cuda, shape, h, o):
    g = torch.Generator().manual_seed(h)
    b, c, n = shape
    x = torch.randn(shape, generator=g).to(cuda, torch.bfloat16)
    k1, b1 = torch.randn(c, h, generator=g) / c**0.5, torch.randn(h, generator=g) / c**0.5
    k2, b2 = torch.randn(h, o, generator=g) / h**0.5, torch.randn(o, generator=g) / h**0.5
    args = [t.to(cuda) for t in (k1, b1, k2, b2)]
    n0 = H.LAUNCHES["fwd"]
    got = torch.ops.uno_tpu_torch.mlp_head_fwd(x, *args)
    assert H.LAUNCHES["fwd"] == n0 + 1 and got.is_contiguous()
    torch.cuda.synchronize()
    assert torch.equal(got, H.mlp_head(x, *args))
    assert _rel(got, H.mlp_head_plain(x, *args)) <= 1e-5


@pytest.mark.cuda
def test_exported_uno9_serves_through_the_kernels_on_the_card(cuda, tmp_path):
    """uno9 bf16 exported on the CPU, moved to the card on load: it launches
    the kernels (5 contractions, 10 remaps and the head per call) and
    matches the eager model on the card."""
    from uno_tpu_torch.export import export_forward, load_forward

    kw = dict(in_width=3, width=8, pad=1)
    cpu = build_model("uno9", dtype="bfloat16", generator=torch.Generator().manual_seed(0), **kw)
    x = torch.randn(2, 85, 85, 1, generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "m.pt2")
    export_forward(cpu, x, path=path)
    served = load_forward(path, device=cuda)
    card = build_model("uno9", dtype="bfloat16", device=cuda, **kw)
    card.load_state_dict(cpu.state_dict())
    c0, h0, r0 = C.LAUNCHES["fwd"], H.LAUNCHES["fwd"], R.LAUNCHES["remap"]
    got = served(x.to(cuda))
    assert (C.LAUNCHES["fwd"] - c0, H.LAUNCHES["fwd"] - h0, R.LAUNCHES["remap"] - r0) == (5, 1, 10)
    with torch.no_grad():
        want = card.eval()(x.to(cuda))
    assert _rel(got, want) <= 1e-6


@pytest.mark.cuda
def test_all_reduce_sum_of_cuda_tensors_over_a_world_of_one(cuda):
    """The data-parallel bucket path on the card (NCCL, one rank): the loss
    and a complex and a real gradient come back unchanged, bit for bit."""
    import torch.distributed as dist

    from uno_tpu_torch.parallel import all_reduce_sum, initialize_from_env, make_mesh

    assert initialize_from_env("nccl", world_size=1, rank=0)
    try:
        dp = make_mesh(device=cuda)
        g = torch.Generator().manual_seed(0)
        ts = [torch.randn((), generator=g), _rand_c(g, 3, 4, 5), torch.randn(7, generator=g)]
        ts = [t.to(dp.device) for t in ts]
        want = [t.clone() for t in ts]
        all_reduce_sum(dp, ts)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(ts, want))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fft", "dft"])
def test_split_spectral_convs_over_a_world_of_one(cuda, path):
    """The split 2-D and 3-D convs and the truncation on the card, one rank
    holding every row (NCCL): a partial DFT of all rows and an all-reduce
    over one rank, against the unsplit op on the card; the FFT path's
    contraction is the kernel."""
    import torch.distributed as dist

    from uno_tpu_torch.ops import spectral
    from uno_tpu_torch.parallel import Split, initialize_from_env

    assert initialize_from_env("nccl", world_size=1, rank=0)
    spectral.set_dft_mode(path == "dft")
    try:
        g = torch.Generator().manual_seed(4)
        sp = Split(dist.group.WORLD, 0, 1, 247)
        x = torch.randn(4, 32, 247, 247, generator=g).to(cuda)
        w = (_rand_c(g, 2, 32, 64, 18, 18) / 8.0).to(cuda)
        before = C.LAUNCHES["fwd"]
        got = spectral.spectral_conv_2d(x, w, (123, 123), (18, 18), sp)
        want = spectral.spectral_conv_2d(x, w, (123, 123), (18, 18))
        x3 = torch.randn(2, 8, 64, 64, 13, generator=g).to(cuda)
        w3 = (_rand_c(g, 4, 8, 16, 8, 8, 7) / 4.0).to(cuda)
        got3 = spectral.spectral_conv_3d(x3, w3, (32, 32, 13), (8, 8, 7), sp.at(64))
        want3 = spectral.spectral_conv_3d(x3, w3, (32, 32, 13), (8, 8, 7))
        got_t = spectral.fourier_truncate_3d(x3, (32, 32, 13), sp.at(64))
        want_t = spectral.fourier_truncate_3d(x3, (32, 32, 13))
        torch.cuda.synchronize()
        assert C.LAUNCHES["fwd"] == before + (4 if path == "fft" else 0)
        assert _rel(got, want) <= 1e-5 and _rel(got3, want3) <= 1e-5
        assert _rel(got_t, want_t) <= 1e-5
    finally:
        spectral.set_dft_mode(None)
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_blocks_on_the_card(cuda, dtype):
    """uno9 with and without ``remat_blocks`` on the card: the same output
    and gradients, bit for bit (the recompute runs the same kernels on the
    same inputs), and the recompute's extra forward contractions."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 85, 85, 1, generator=g).to(cuda)
    runs = []
    for remat in (False, True):
        model = build_model("uno9", dtype=dtype, remat_blocks=remat, device=cuda,
                            generator=torch.Generator().manual_seed(0), in_width=3, width=32,
                            pad=5)
        before = C.LAUNCHES["fwd"]
        out = model(x)
        out.square().sum().backward()
        torch.cuda.synchronize()
        runs.append((out.detach(), {n: p.grad for n, p in model.named_parameters()},
                     C.LAUNCHES["fwd"] - before))
    (o0, g0, n0), (o1, g1, n1) = runs
    assert torch.equal(o0, o1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert (n0, n1) == (5, 10)


# (dims, input grid, output grid, modes): convs and truncations whose inverse
# FFT runs at 128 and 256 points, where cuFFT's c2r took the non-Hermitian
# part of the DC and Nyquist slices that the CPU's drops (uno_s256's last
# block: 64 -> 256, modes 32; the uno3d_*_256 family's last blocks)
C2R_CASES = [(1, (256,), (128,), 65), (2, (64, 64), (256, 256), (32, 32)),
             (2, (128, 128), (128, 128), (32, 33)), (3, (32, 32, 12), (128, 128, 8), (8, 8, 4)),
             (3, (64, 64, 12), (256, 256, 16), (8, 8, 5))]


@pytest.mark.cuda
@pytest.mark.parametrize("dims,grid,out,modes", C2R_CASES)
def test_spectral_conv_at_cuffts_sizes_matches_the_cpu(cuda, dims, grid, out, modes):
    """The spectral conv (and, in 3-D, the Fourier truncation) forward and
    gradients on the card against the CPU, f32, within 1e-5."""
    from uno_tpu_torch.ops.spectral import (fourier_truncate_3d, spectral_conv_1d,
                                            spectral_conv_2d, spectral_conv_3d)

    g = torch.Generator().manual_seed(9)
    fn = {1: spectral_conv_1d, 2: spectral_conv_2d, 3: spectral_conv_3d}[dims]
    mshape = modes if dims > 1 else (modes,)
    out_t = out if dims > 1 else out[0]
    x = torch.randn((2, 3) + grid, generator=g)
    w = _rand_c(g, 2 ** (dims - 1), 3, 4, *mshape) / 6**0.5
    cot = torch.randn((2, 4) + out, generator=g)
    cot_t = torch.randn((2, 3) + out, generator=g)
    res = []
    for d in ("cpu", cuda):
        xt, wt = (t.to(d).detach().requires_grad_() for t in (x, w))
        y = fn(xt, wt, out_t, modes)
        loss = (y * cot.to(d)).sum()
        trunc = fourier_truncate_3d(xt, out) if dims == 3 else None
        if trunc is not None:
            loss = loss + (trunc * cot_t.to(d)).sum()
        loss.backward()
        res.append([y.detach(), xt.grad, wt.grad] + ([trunc.detach()] if dims == 3 else []))
    for got, want in zip(res[1], res[0]):
        got, want = (torch.view_as_real(t) if t.is_complex() else t for t in (got, want))
        assert _rel(got, want) <= 1e-5, _rel(got, want)


@pytest.mark.cuda
def test_uno_s256_on_the_card_matches_the_cpu(cuda):
    """ns2d_s256's model at width 4: the forward, the loss and every gradient
    with the same weights on the card and the CPU, f32."""
    kw = dict(in_width=14, width=4, pad=0)
    cpu = build_model("uno_s256", generator=torch.Generator().manual_seed(0), **kw)
    gpu = build_model("uno_s256", device=cuda, **kw)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(10)
    x, y = torch.randn(1, 256, 256, 10, generator=g), torch.randn(1, 256, 256, 1, generator=g)
    res = []
    for model, d in ((cpu, "cpu"), (gpu, cuda)):
        out = model(x.to(d))
        ((out - y.to(d)) ** 2).sum().backward()
        res.append((out.detach(), *[p.grad for p in model.parameters()]))
    for got, want in zip(res[1], res[0]):
        got, want = (torch.view_as_real(t) if t.is_complex() else t for t in (got, want))
        assert _rel(got, want) <= 1e-4, _rel(got, want)



@pytest.mark.cuda
def test_fused_skips_on_the_card_match_the_materialized_form(cuda, monkeypatch):
    """uno9 f32 at full width on the card with the skips carried as channel
    pieces (the f32 default) and materialized
    (``UNO_TPU_TORCH_NO_FUSED_SKIPS=1``): the output and all the gradients
    (one vector: a bias that an instance norm follows has a gradient of
    rounding noise about 0) within rel-L2 1e-5, and the same five
    contraction launches."""
    g = torch.Generator().manual_seed(11)
    x, y = torch.randn(2, 85, 85, 1, generator=g).to(cuda), torch.randn(2, 85, 85, 1, generator=g)
    runs = []
    for env in (None, "UNO_TPU_TORCH_NO_FUSED_SKIPS"):
        monkeypatch.delenv("UNO_TPU_TORCH_NO_FUSED_SKIPS", raising=False)
        monkeypatch.delenv("UNO_TPU_TORCH_FUSED_SKIPS", raising=False)
        if env:
            monkeypatch.setenv(env, "1")
        model = build_model("uno9", device=cuda, generator=torch.Generator().manual_seed(0),
                            in_width=3, width=32, pad=5)
        before = C.LAUNCHES["fwd"]
        out = model(x)
        ((out - y.to(cuda)) ** 2).sum().backward()
        torch.cuda.synchronize()
        grads = torch.cat([torch.view_as_real(p.grad).flatten() if p.is_complex()
                           else p.grad.flatten() for p in model.parameters()])
        runs.append((out.detach(), grads, C.LAUNCHES["fwd"] - before))
    (out_f, grads_f, n_fused), (out_m, grads_m, n_mat) = runs
    assert n_fused == n_mat == 5
    assert _rel(out_f, out_m) <= 1e-5, _rel(out_f, out_m)
    assert _rel(grads_f, grads_m) <= 1e-5, _rel(grads_f, grads_m)


def _adam_against_plain(cuda, wd: float, amsgrad: bool, steps: int):
    """uno9's darcy_s211 parameters stepped by ``ComplexAdam`` (the kernel)
    and by the plain sequence on the card, on the same gradients, under
    StepLR with 7 steps an epoch: (kernel params, optimizer, plain params,
    plain states)."""
    from uno_tpu_torch.ops.kernels import adam as A
    from uno_tpu_torch.optim import ComplexAdam, _zero_state, step_lr

    model = build_model("uno9", device=cuda, generator=torch.Generator().manual_seed(0),
                        in_width=3, width=32, pad=12)
    kern = [torch.nn.Parameter(p.detach().clone()) for p in model.parameters()]
    plain = [p.detach().clone() for p in model.parameters()]
    states = [_zero_state(p, amsgrad) for p in plain]
    opt = ComplexAdam(kern, lr=step_lr(1e-3, 1, 0.5, steps_per_epoch=7), weight_decay=wd,
                      amsgrad=amsgrad)
    group = opt.param_groups[0]
    g = torch.Generator(device=cuda).manual_seed(1)
    for k in range(1, steps + 1):
        for p in kern:  # magnitudes from 1e-5 to 1, as a step's gradients spread
            scale = 10.0 ** -torch.randint(0, 6, (), generator=g, device=cuda).float()
            p.grad = torch.randn(p.shape, dtype=p.dtype, device=cuda, generator=g) * scale
        A.adam_plain(group, [A.Slot(q, p.grad, s["exp_avg"], s["exp_avg_sq"],
                                    s.get("max_exp_avg_sq"), k)
                             for p, q, s in zip(kern, plain, states)])
        opt.step()
    torch.cuda.synchronize()
    return kern, opt, plain, states


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 1e-3])
@pytest.mark.parametrize("amsgrad", [False, True])
def test_adam_kernel_against_the_plain_sequence(cuda, wd, amsgrad):
    """20 steps: every element of p, mu, nu and max_nu within 2 ulp of the
    plain sequence's, and in fact bit-equal (PERF.md §6): the kernel rounds
    each operation as torch's CUDA kernels round it."""
    from uno_tpu_torch.ops.kernels.adam import ulps

    kern, opt, plain, states = _adam_against_plain(cuda, wd, amsgrad, 20)
    keys = ("exp_avg", "exp_avg_sq") + (("max_exp_avg_sq",) if amsgrad else ())
    for i, (p, q, s) in enumerate(zip(kern, plain, states)):
        assert opt.state[p]["step"] == 20
        gaps = {"p": ulps(p, q), **{k: ulps(opt.state[p][k], s[k]) for k in keys}}
        assert max(gaps.values()) <= 2, (i, p.dtype, gaps)
        assert torch.equal(p, q) and all(torch.equal(opt.state[p][k], s[k]) for k in keys), i


@pytest.mark.cuda
def test_adam_kernel_launches_once_a_group_a_step(cuda):
    from uno_tpu_torch.ops.kernels import adam as A
    from uno_tpu_torch.optim import ComplexAdam

    ps = [torch.nn.Parameter(torch.randn(n, device=cuda)) for n in (5, 70000, 3)]
    ps.append(torch.nn.Parameter(torch.randn(9, 4, dtype=torch.complex64, device=cuda)))
    opt = ComplexAdam([{"params": ps[:2]}, {"params": ps[2:], "lr": 1e-2}], lr=1e-3)
    for _ in range(3):
        for p in ps:
            p.grad = torch.randn_like(p)
        before = A.LAUNCHES["step"]
        opt.step()
        assert A.LAUNCHES["step"] - before == 2


@pytest.mark.cuda
def test_adam_kernel_skips_a_parameter_without_gradient(cuda):
    from uno_tpu_torch.optim import ComplexAdam

    ps = [torch.nn.Parameter(torch.randn(40, device=cuda)),
          torch.nn.Parameter(torch.randn(6, 7, dtype=torch.complex64, device=cuda)),
          torch.nn.Parameter(torch.randn(5, device=cuda))]
    before = [p.detach().clone() for p in ps]
    opt = ComplexAdam(ps, lr=1e-2, weight_decay=1e-3)
    ps[0].grad, ps[2].grad = torch.randn_like(ps[0]), torch.randn_like(ps[2])
    opt.step()
    torch.cuda.synchronize()
    assert torch.equal(ps[1].detach(), before[1]) and not opt.state[ps[1]]
    for i in (0, 2):
        assert not torch.equal(ps[i].detach(), before[i]) and opt.state[ps[i]]["step"] == 1


@pytest.mark.cuda
def test_adam_kernel_refuses_float64_and_a_non_contiguous_gradient(cuda):
    from uno_tpu_torch.optim import ComplexAdam

    p64 = torch.nn.Parameter(torch.randn(8, dtype=torch.float64, device=cuda))
    p64.grad = torch.randn_like(p64)
    with pytest.raises(TypeError, match="float64"):
        ComplexAdam([p64], lr=1e-3).step()
    p = torch.nn.Parameter(torch.randn(4, 6, device=cuda))
    opt = ComplexAdam([p], lr=1e-3)
    p.grad = torch.randn(6, 4, device=cuda).t()
    with pytest.raises(ValueError, match="gradient of parameter 0 .* not contiguous"):
        opt.step()
    assert opt.state[p]["step"] == 0  # the refused step is not counted


@pytest.mark.cuda
def test_adam_kernel_splits_a_long_table_with_the_same_bits(cuda):
    """100 parameters, complex and real, from 1 to 9,000 elements: one
    optimizer (three launches a step), one optimizer a parameter, and
    ``adam_step`` on moments that are views into one flat buffer per dtype,
    at offsets that are not 16-byte aligned (the element-by-element path),
    give the same bits over 5 steps."""
    from uno_tpu_torch.ops.kernels import adam as A
    from uno_tpu_torch.optim import ComplexAdam

    gen = torch.Generator().manual_seed(3)
    sizes = torch.randint(1, 9000, (100,), generator=gen).tolist()
    init = [torch.randn(n, dtype=torch.complex64 if i % 3 == 0 else torch.float32,
                        generator=gen) for i, n in enumerate(sizes)]
    runs = {form: [torch.nn.Parameter(t.to(cuda)) for t in init]
            for form in ("table", "single", "flat")}
    kw = dict(lr=1e-3, weight_decay=1e-3, amsgrad=True)
    opts = {"table": [ComplexAdam(runs["table"], **kw)],
            "single": [ComplexAdam([p], **kw) for p in runs["single"]]}
    group = opts["table"][0].param_groups[0]
    moments = {}  # dtype -> one flat buffer a moment
    for p in runs["flat"]:
        moments.setdefault(p.dtype, []).append(p)
    views = {}
    for dt, ps in moments.items():
        bufs = [torch.zeros(sum(p.numel() for p in ps), dtype=d, device=cuda)
                for d in (dt, torch.float32, torch.float32)]
        for p, *vs in zip(ps, *(b.split([q.numel() for q in ps]) for b in bufs)):
            views[p] = vs
    g = torch.Generator(device=cuda).manual_seed(4)
    for step in range(1, 6):
        grads = [torch.randn(p.shape, dtype=p.dtype, device=cuda, generator=g)
                 for p in runs["table"]]
        for form, ps in runs.items():
            for p, gr in zip(ps, grads):
                p.grad = gr.clone()
        before = A.LAUNCHES["step"]
        opts["table"][0].step()
        assert A.LAUNCHES["step"] - before == 3
        for opt in opts["single"]:
            opt.step()
        with torch.no_grad():
            A.adam_step(group, [A.Slot(p, p.grad, *views[p], step) for p in runs["flat"]])
    torch.cuda.synchronize()
    for a, b, c in zip(*runs.values()):
        assert torch.equal(a, b) and torch.equal(a, c)
