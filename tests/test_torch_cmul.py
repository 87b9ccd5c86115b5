"""The port's complex mode contraction (uno_tpu_torch/ops/kernels/cmul.py).

On the CPU the wrapper runs its plain versions, held against uno_tpu's Pallas
kernel in interpret mode at atol 1e-4 (the bound of tests/test_pallas.py),
forward and backward.  The backward is compared through a real loss
``L = sum(re(conj(c) * y))``: torch's gradient of a complex input is the
conjugate of ``jax.grad``'s, so the JAX gradients are conjugated first.  The
CUDA kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py; here the launch plan of the forward and dx kernel
is checked against the kernel's index map.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.ops.pallas.cmul import complex_mode_matmul_pallas
from uno_tpu_torch.ops.kernels import cmul as K

SHAPES = [(2, 3, 5, 7), (4, 8, 8, 128), (2, 4, 6, 200)]


def _rand_c(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("b,ci,co,m", SHAPES)
def test_plain_matches_pallas_interpret(b, ci, co, m):
    rng = np.random.default_rng(0)
    x, w = _rand_c(rng, b, ci, m), _rand_c(rng, ci, co, m)
    want = np.asarray(complex_mode_matmul_pallas(jnp.asarray(x), jnp.asarray(w), True))
    before = dict(K.LAUNCHES)
    got = K.cmul(torch.from_numpy(x), torch.from_numpy(w))
    assert K.LAUNCHES == before  # a CPU tensor never reaches the kernel
    assert got.dtype == torch.complex64 and got.shape == (b, co, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 3, 8, dtype=torch.complex64)
    w = torch.zeros(3, 4, 8, dtype=torch.complex64)
    with pytest.raises(TypeError):
        K.cmul(x.real.contiguous(), w)
    with pytest.raises(ValueError, match="mismatch"):
        K.cmul(x, w[:2].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        K.cmul(x.transpose(0, 1).contiguous().transpose(0, 1), w)
    with pytest.raises(ValueError):
        K.cmul(x[:0], w)
    with pytest.raises(ValueError, match="mismatch"):
        K.cmul_bwd_x(torch.zeros(2, 5, 8, dtype=torch.complex64), w)
    with pytest.raises(ValueError, match="mismatch"):
        K.cmul_bwd_w(x, torch.zeros(3, 4, 8, dtype=torch.complex64))
    # inputs that require grad train: the gradients flow through the Function
    y = K.cmul(x, w.requires_grad_())
    assert y.requires_grad and y.grad_fn is not None
    y.real.sum().backward()
    assert w.grad is not None and w.grad.shape == w.shape
    with torch.no_grad():
        assert K.cmul(x, w).grad_fn is None


@pytest.mark.parametrize("b,ci,co,m", SHAPES)
def test_gradients_match_pallas_interpret(b, ci, co, m):
    rng = np.random.default_rng(1)
    x, w, c = _rand_c(rng, b, ci, m), _rand_c(rng, ci, co, m), _rand_c(rng, b, co, m)

    def loss(x, w):
        y = complex_mode_matmul_pallas(x, w, True)
        return jnp.sum(jnp.real(jnp.conj(jnp.asarray(c)) * y))

    jgx, jgw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    torch.real(torch.from_numpy(c).conj() * K.cmul(xt, wt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.conj(np.asarray(jgx)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.conj(np.asarray(jgw)), rtol=0, atol=1e-4)


def test_gradcheck_complex128():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_rand_c(rng, 2, 3, 5).astype(np.complex128)).requires_grad_()
    w = torch.from_numpy(_rand_c(rng, 3, 4, 5).astype(np.complex128)).requires_grad_()
    assert torch.autograd.gradcheck(K.cmul, (x, w))


def test_backward_computes_only_the_gradients_asked_for():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_rand_c(rng, 2, 3, 5))
    w = torch.from_numpy(_rand_c(rng, 3, 4, 5)).requires_grad_()
    K.cmul(x, w).abs().sum().backward()
    assert x.grad is None and w.grad is not None


# (rows, K, N, M) of the three uses at the five darcy_s211 shapes: (B, Ci,
# Co) for the forward, (B, Co, Ci) for dx, (Ci, B, Co) for dw; then edges:
# one row, 17 and 33 rows (row tiles along the grid's z), odd M (the 8-byte
# copies), K or N of 1, K not a multiple of the split, dw's batch of 1, 9,
# 17 and 33 contracted over Ci or Co of 1
PATH_SHAPES = [(16, 32, 64, 648), (16, 64, 128, 128), (16, 128, 128, 128),
               (16, 128, 64, 128), (16, 128, 32, 648)]
PLAN_SHAPES = ([(b, k, n, m) for b, ci, co, m in PATH_SHAPES for k, n in ((ci, co), (co, ci))]
               + [(1, 3, 5, 7), (9, 5, 3, 33), (17, 128, 64, 128), (33, 9, 19, 33),
                  (16, 1, 40, 7), (1, 40, 1, 33), (16, 130, 70, 40), (33, 17, 16, 2)])
DW_SHAPES = ([(ci, b, co, m) for b, ci, co, m in PATH_SHAPES]
             + [(1, 1, 1, 1), (7, 9, 1, 33), (1, 17, 40, 7), (37, 33, 19, 33), (9, 16, 17, 64),
                (130, 16, 70, 40), (5, 2, 3, 7)])


@pytest.mark.parametrize("b,k,n,m", PLAN_SHAPES + DW_SHAPES)
def test_contract_plan_covers_each_term_once(b, k, n, m):
    """Every product a[r,k,m] * w[k,n,m] falls in exactly one (block, warp)
    of the plan, as contract_kernel maps them."""
    p = K.contract_plan(b, k, n, m)
    count = np.zeros((b, k, n, m), np.uint8)
    for gx in range(p.grid[0]):
        for gy in range(p.grid[1]):
            for gz in range(p.grid[2]):
                for kg in range(p.split):
                    assert kg * p.k_per_warp < k  # no warp without channels
                    count[gz * K.TILE_B:(gz + 1) * K.TILE_B,
                          kg * p.k_per_warp:(kg + 1) * p.k_per_warp,
                          gy * K.TILE_N:(gy + 1) * K.TILE_N,
                          gx * K.TILE_M:(gx + 1) * K.TILE_M] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("b,k,n,m", PLAN_SHAPES + DW_SHAPES)
def test_contract_plan_fits_the_card(b, k, n, m):
    p = K.contract_plan(b, k, n, m)
    assert 1 <= p.split <= K.MAX_SPLIT and p.split * p.k_per_warp >= k
    assert p.smem == K.contract_smem(p.split) and 2 * p.smem <= K.MAX_SMEM  # two blocks fit
    assert p.grid == (-(-m // K.TILE_M), -(-n // K.TILE_N), -(-b // K.TILE_B))
    assert p.grid[0] < 2**31 and max(p.grid[1:]) <= K.GRID_Y_MAX
    assert p.vec == (16 if m % 2 == 0 else 8)
    assert K.contract_plan(b, k, n, m, aligned=False).vec == 8


def test_contract_plan_splits_to_fill_the_card():
    """At the path's shapes, each use's grid holds WARPS_PER_SM warps per
    H100 SM, or the split has reached its limit or its least channels per
    warp."""
    for b, k, n, m in PLAN_SHAPES[:10] + DW_SHAPES[:5]:
        p = K.contract_plan(b, k, n, m)
        warps = p.grid[0] * p.grid[1] * p.grid[2] * p.split
        assert (warps >= K.SMS * K.WARPS_PER_SM or p.split == K.MAX_SPLIT
                or k < 2 * p.split * K.MIN_K_PER_WARP), (b, k, n, m, p)


def test_contract_plan_of_dw_runs_one_block_per_row_tile():
    """dw contracts the batch of 16: its Ci rows go along the grid's z, one
    16-row tile per block, and its split stays within the 16 channels."""
    for b, ci, co, m in PATH_SHAPES:
        p = K.contract_plan(ci, b, co, m)
        assert p.grid[2] == ci // K.TILE_B >= 2
        assert p.split * p.k_per_warp == b and p.k_per_warp >= K.MIN_K_PER_WARP
        fwd = K.contract_plan(b, ci, co, m)
        assert fwd.grid[2] == 1  # the forward's batch of 16 is one row tile


def test_contract_plan_follows_the_cards_limits(monkeypatch):
    """A launch plans for its own card: with half an H100's SMs the split
    that fills them is smaller; with less shared memory per block the split
    stops where its partial sums still fit; with too little the plan
    raises."""
    h100 = K.contract_plan(16, 64, 128, 128)
    assert h100.split == K.MAX_SPLIT
    monkeypatch.setattr(K, "device_limits", lambda index: (K.SMS // 2, K.MAX_SMEM))
    assert K.contract_plan(16, 64, 128, 128, device=0).split == K.MAX_SPLIT // 2
    monkeypatch.setattr(K, "device_limits", lambda index: (K.SMS, 20 * 1024))
    small = K.contract_plan(16, 64, 128, 128, device=0)
    assert small.split == 2 and small.smem == K.contract_smem(2) <= 20 * 1024
    monkeypatch.setattr(K, "device_limits", lambda index: (K.SMS, 4 * 1024))
    with pytest.raises(ValueError, match="shared memory"):
        K.contract_plan(16, 64, 128, 128, device=0)


def test_contract_plan_constants_match_the_kernel_source():
    src = (Path(K.__file__).resolve().parents[2] / "csrc" / "cmul.cu").read_text()
    for name, value in (("CB", K.TILE_B), ("TN", K.TILE_N), ("TM2", K.TILE_M),
                        ("STAGES", K.STAGES), ("MAX_SPLIT", K.MAX_SPLIT)):
        assert re.search(rf"constexpr int {name} = {value};", src), name


def test_wrapper_raises_where_the_plan_cannot_launch():
    n = K.TILE_N * K.GRID_Y_MAX + 1  # one block row past the grid's y limit
    with pytest.raises(ValueError, match="grid"):
        K.contract_plan(1, 1, n, 1)
    with pytest.raises(ValueError, match="grid"):  # one row tile past its z limit
        K.contract_plan(K.TILE_B * K.GRID_Y_MAX + 1, 1, 1, 1)
    with pytest.raises(ValueError, match="empty"):
        K.contract_plan(0, 1, 1, 1)
    # the wrapper's CUDA path plans before it reaches the library
    x = torch.zeros(1, 1, 1, dtype=torch.complex64)
    w = torch.zeros(1, n, 1, dtype=torch.complex64)
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="grid"):
        K._launch("uno_cmul_fwd", "fwd", x, w, (1, n, 1), 1, 1, n, 1)
    with pytest.raises(ValueError, match="grid"):
        K._launch("uno_cmul_bwd_x", "bwd_x", x.expand(1, n, 1).contiguous(),
                  w.reshape(n, 1, 1), (1, n, 1), 1, n, 1, 1)
    ci = K.TILE_B * K.GRID_Y_MAX + 1  # dw's rows are Ci
    with pytest.raises(ValueError, match="grid"):
        K._launch("uno_cmul_bwd_w", "bwd_w", torch.zeros(1, ci, 1, dtype=torch.complex64),
                  x, (ci, 1, 1), 1, ci, 1, 1)
    assert K.LAUNCHES == before


# (B, Ci, Co, M) of uno3d_t40's seven contractions at ns3d_t40 (64x64, T 10 ->
# 40, width 8), batch 16, and the (rows, K, N, M) of their three uses: M up to
# 22,400 (5,600 blocks along the grid's x), dw's 32-128 rows over a batch of 16
NS3D_SHAPES = [(16, 8, 16, 6400), (16, 16, 32, 3136), (16, 32, 64, 576), (16, 64, 128, 1008),
               (16, 128, 32, 1008), (16, 64, 16, 7840), (16, 32, 16, 22400)]
NS3D_PLANS = [(use, plan) for b, ci, co, m in NS3D_SHAPES
              for use, plan in (("fwd", (b, ci, co, m)), ("dx", (b, co, ci, m)),
                                ("dw", (ci, b, co, m)))]


def _covered_once(tile: int, count: int, n: int) -> bool:
    """``count`` tiles of ``tile`` from 0 cover [0, n) once each, and none
    starts past it."""
    hits = np.zeros(count * tile, np.int64)
    for i in range(count):
        hits[i * tile:(i + 1) * tile] += 1
    return (hits[:n] == 1).all() and (count - 1) * tile < n


@pytest.mark.parametrize("use,plan", NS3D_PLANS, ids=[f"{u}-{'x'.join(map(str, p))}"
                                                      for u, p in NS3D_PLANS])
def test_contract_plan_at_the_ns3d_shapes(use, plan):
    """The plan at each NS-3D use covers every term once (a block's terms
    are a product of one range per axis, so per axis suffices), fits an
    H100 two blocks to an SM within CUDA's grid limits, and fills the card
    as its rule says."""
    rows, k, n, m = plan
    p = K.contract_plan(rows, k, n, m)
    assert _covered_once(K.TILE_B, p.grid[2], rows)
    assert _covered_once(p.k_per_warp, p.split, k)
    assert _covered_once(K.TILE_N, p.grid[1], n)
    assert _covered_once(K.TILE_M, p.grid[0], m)
    assert 1 <= p.split <= K.MAX_SPLIT and p.smem == K.contract_smem(p.split)
    assert 2 * p.smem <= K.MAX_SMEM and max(p.grid[1:]) <= K.GRID_Y_MAX and p.vec == 16
    warps = p.grid[0] * p.grid[1] * p.grid[2] * p.split
    assert (warps >= K.SMS * K.WARPS_PER_SM or p.split == K.MAX_SPLIT
            or k < 2 * p.split * K.MIN_K_PER_WARP), p
    if use == "dw":  # the batch of 16 is dw's K: its Ci rows run one 16-row tile per block
        assert p.grid[2] == -(-rows // K.TILE_B) and p.split * p.k_per_warp == k
