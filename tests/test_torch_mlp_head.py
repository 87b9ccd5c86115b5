"""The port's fused projection head (uno_tpu_torch/ops/kernels/mlp_head.py).

On the CPU the wrapper runs its plain version, held against uno_tpu's fused
head in interpret mode with the same bf16 x (both sides round the same f32
values to nearest-even).  Bound: rel-L2 <= 1e-5; the one difference in the
math is uno_tpu's polynomial erf (|err| <= 1.5e-7) against the exact erf.

The gradients are held against ``jax.grad`` of uno_tpu's fused head, which
runs its backward kernel in interpret mode, with the fixed cotangent of
tests/test_fused_head.py.  Bounds: rel-L2 <= 1e-5 for the f32 weight
gradients; <= 4e-3 for the bf16 input gradient (one bf16 ulp: the two sides
round f32 values that differ in the last bits).  The CUDA kernels are held
against the plain versions on the card by tests/test_torch_cuda.py; here the
launch plans of the forward and the backward are checked against the
kernels' index maps.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.ops.pallas.mlp_head import fused_mlp_head
from uno_tpu_torch.ops.kernels import mlp_head as K

SHAPES = [
    ((2, 8, 37, 45), 32, 1),   # uneven grid: a masked tail
    ((1, 16, 64, 64), 64, 3),  # several outputs, 16 hidden groups of 4
]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _inputs(shape, h, o, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = rng.standard_normal(shape).astype(np.float32)
    k1 = (rng.standard_normal((c, h)) / np.sqrt(c)).astype(np.float32)
    b1 = rng.standard_normal(h).astype(np.float32)
    k2 = (rng.standard_normal((h, o)) / np.sqrt(h)).astype(np.float32)
    b2 = rng.standard_normal(o).astype(np.float32)
    return x, k1, b1, k2, b2


@pytest.mark.parametrize("shape,h,o", SHAPES)
def test_plain_matches_fused_head_interpret(shape, h, o):
    x, *w = _inputs(shape, h, o)
    want = np.asarray(fused_mlp_head(jnp.asarray(x, jnp.bfloat16),
                                     *map(jnp.asarray, w), True))
    before = dict(K.LAUNCHES)
    got = K.mlp_head(torch.from_numpy(x).bfloat16(), *map(torch.from_numpy, w))
    assert K.LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == want.shape == (shape[0], o) + shape[2:]
    assert _rel(got.numpy(), want) <= 1e-5, _rel(got.numpy(), want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, k1, b1, k2, b2 = map(torch.from_numpy, _inputs((1, 4, 5, 6), 8, 1))
    xb = x.bfloat16()
    with pytest.raises(TypeError, match="bf16"):
        K.mlp_head(x, k1, b1, k2, b2)
    with pytest.raises(TypeError, match="f32"):
        K.mlp_head(xb, k1.double(), b1, k2, b2)
    with pytest.raises(ValueError, match="shapes"):
        K.mlp_head(xb, k1[:3].contiguous(), b1, k2, b2)
    with pytest.raises(ValueError, match="contiguous"):
        K.mlp_head(xb.transpose(2, 3), k1, b1, k2, b2)
    with pytest.raises(ValueError, match="outputs"):
        K.mlp_head(xb, k1, b1, torch.zeros(8, 5), torch.zeros(5))
    with pytest.raises(ValueError, match="shared memory"):  # k1 alone needs 256 KB
        K.mlp_head(torch.zeros(1, 512, 4, dtype=torch.bfloat16),
                   torch.zeros(512, 128), torch.zeros(128), torch.zeros(128, 1), b2)
    with pytest.raises(ValueError, match="flat"):
        K.mlp_head_bwd(xb, torch.zeros(1, 1, 5, 6), k1, b1, k2)
    with pytest.raises(ValueError, match="f32 g"):
        K.mlp_head_bwd(xb.reshape(1, 4, 30), torch.zeros(1, 1, 30).double(), k1, b1, k2)
    # inputs that require grad train: the gradients flow through the Function
    out = K.mlp_head(xb, k1.requires_grad_(), b1, k2, b2)
    assert out.grad_fn is not None
    out.sum().backward()
    assert k1.grad is not None and k1.grad.shape == k1.shape
    with torch.no_grad():
        assert K.mlp_head(xb, k1, b1, k2, b2).grad_fn is None


@pytest.mark.parametrize("shape,h,o", SHAPES)
def test_gradients_match_fused_head_interpret(shape, h, o):
    x, *w = _inputs(shape, h, o, seed=1)
    cot = np.random.default_rng(2).standard_normal((shape[0], o) + shape[2:]).astype(np.float32)

    def loss(*a):
        return jnp.sum(fused_mlp_head(*a, True) * jnp.asarray(cot))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, w))
    args = [torch.from_numpy(x).bfloat16()] + [torch.from_numpy(a) for a in w]
    for a in args:
        a.requires_grad_()
    (K.mlp_head(*args) * torch.from_numpy(cot)).sum().backward()
    assert args[0].grad.dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    for name, a, wj in zip(["gx", "gk1", "gb1", "gk2", "gb2"], args, want):
        bound = 4e-3 if name == "gx" else 1e-5
        assert a.grad.shape == wj.shape, name
        assert _rel(a.grad.float().numpy(), np.asarray(wj, np.float32)) <= bound, name


@pytest.mark.parametrize("shape,h,o", SHAPES)
def test_plain_backward_matches_autograd_of_plain_forward(shape, h, o):
    x, *w = _inputs(shape, h, o, seed=3)
    b, c = shape[:2]
    xb = torch.from_numpy(x).bfloat16().reshape(b, c, -1)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal((b, o, xb.shape[2]))
                         .astype(np.float32))
    got = K.mlp_head_bwd_plain(xb, g, *map(torch.from_numpy, w[:3]))
    args = [xb.clone().requires_grad_()] + [torch.from_numpy(a).requires_grad_() for a in w]
    (K.mlp_head_plain(*args) * g).sum().backward()
    assert got[0].dtype == torch.bfloat16
    for gp, a in zip(got, args):
        assert _rel(gp.float().numpy(), a.grad.float().numpy()) <= (4e-3 if gp is got[0] else 1e-5)


# (B, C, N, H, O) of the backward's launch plan: the darcy_s211 path shape,
# the card tests' shapes, then edges: N shorter than a tile, odd N with B*N
# ending inside a tile, H padded to a power-of-two group count (40 -> 64),
# C odd (a zero pad row), two and four gk1 shares per thread, a smaller tile
BWD_PLAN_SHAPES = [(16, 64, 211 * 211, 32, 1), (2, 8, 37 * 45, 32, 1), (1, 16, 4096, 64, 3),
                   (3, 5, 2100, 40, 4), (1, 5, 7, 32, 2), (3, 8, 131, 40, 1),
                   (2, 64, 257, 64, 4), (1, 64, 100, 128, 4), (3, 128, 50, 64, 1)]


@pytest.mark.parametrize("b,c,n,h,o", BWD_PLAN_SHAPES)
def test_bwd_plan_covers_each_point_once(b, c, n, h, o):
    """As the kernel maps them: every grid point falls in exactly one tile
    of one block; within a tile every (point, hidden group) of Z, every
    (point, channel group) of GX and every gk1 entry has exactly one
    thread; the gx store writes each point of a row once, whatever the
    row's offset in a 16-byte vector."""
    p = K.bwd_plan(b, c, n, h, o)
    tpr = -(-n // p.tile)
    count = np.zeros((b, n), np.int32)
    for blk in range(p.blocks):
        for t in range(blk, b * tpr, p.blocks):
            n0 = t % tpr * p.tile
            count[t // tpr, n0:n0 + p.tile] += 1
    assert (count == 1).all()
    nhq, npq, nco, nrq = p.hidden // 4, p.tile // 4, -(-c // 8), -(-c // 4)
    z, gx = np.zeros((npq, nhq)), np.zeros((npq, nco))
    gk1 = np.zeros((2, 4 * nrq, p.hidden))  # per half of the tile's points
    for tid in range(p.threads):
        hq = tid % nhq
        for pq in range(tid // nhq, npq, p.threads // nhq):
            z[pq, hq] += 1
        for it in range(tid, npq * nco, p.threads):
            gx[it // nco, it % nco] += 1
        half, u = divmod(tid, p.threads // 2)
        for j in range(p.shares):
            rq = (u + j * (p.threads // 2)) // nhq
            assert (u + j * (p.threads // 2)) % nhq == hq
            if rq < nrq:
                for r in range(4):
                    for k in range(4):
                        gk1[half, rq + nrq * r, hq + nhq * k] += 1
    assert (z == 1).all() and (gx == 1).all() and (gk1 == 1).all()
    for s in range(8):
        for length in {1, 2, 7, 8, 9, min(n, p.tile), p.tile - 1, p.tile}:
            end, last = s + length, (s + length - 1) // 8
            written = np.zeros(p.tile + 8, np.int32)
            for lane in range(32):  # whole vectors, then the first and last vectors' rest
                lo = 8 * lane
                if lo >= s and lo + 8 <= end:
                    written[lo:lo + 8] += 1
                q = lane if lane < 8 else 8 * last + lane - 8
                v = q // 8
                if (lane < 16 and s <= q < end and (lane < 8 or v > 0)
                        and (8 * v < s or 8 * v + 8 > end)):
                    written[q] += 1
            assert (written[s:end] == 1).all() and written.sum() == length, (s, length)


@pytest.mark.parametrize("b,c,n,h,o", BWD_PLAN_SHAPES)
def test_bwd_plan_fits_the_card(b, c, n, h, o):
    p = K.bwd_plan(b, c, n, h, o)
    assert p.hidden >= h and (p.hidden // 4) & (p.hidden // 4 - 1) == 0
    assert p.shares in (1, 2, K.BWD_MAX_MT)
    assert p.shares * p.threads // 2 * 16 >= -(-c // 4) * 4 * p.hidden
    assert p.smem == K.bwd_smem(c, p.hidden, p.tile, p.shares) <= K.CARD_SMEM
    assert 1 <= p.blocks <= min(b * -(-n // p.tile), 2 * K.SMS) and p.blocks < 2**31
    if p.shares < K.BWD_MAX_MT and 2 * p.smem <= K.CARD_SMEM:
        assert p.blocks == min(b * -(-n // p.tile), 2 * K.SMS)


def test_bwd_plan_of_the_path_fills_the_card():
    """At the darcy_s211 head (C 64, H 32, O 1) two blocks of 8 warps fit
    on each H100 SM, each thread holds one 4 x 4 share of gk1 over half the
    points (2048 entries over each half's 128 threads), and the grid has
    two blocks per SM."""
    p = K.bwd_plan(16, 64, 211 * 211, 32, 1)
    assert (p.tile, p.threads, p.hidden, p.shares) == (128, 256, 32, 1)
    assert 2 * p.smem <= K.CARD_SMEM and p.blocks == 2 * K.SMS


def test_bwd_plan_follows_the_cards_limits(monkeypatch):
    """A launch plans for its own card: half the SMs give half the blocks;
    less shared memory gives a smaller tile and one block per SM; too
    little raises."""
    path = (16, 64, 211 * 211, 32, 1)
    monkeypatch.setattr(K, "device_limits", lambda index: (K.SMS // 2, K.CARD_SMEM))
    assert K.bwd_plan(*path, device=0).blocks == K.SMS
    monkeypatch.setattr(K, "device_limits", lambda index: (K.SMS, 100 * 1024))
    small = K.bwd_plan(*path, device=0)
    assert small.tile == 64 and small.smem <= 100 * 1024 and small.blocks == K.SMS
    monkeypatch.setattr(K, "device_limits", lambda index: (K.SMS, 16 * 1024))
    with pytest.raises(ValueError, match="shared memory"):
        K.bwd_plan(*path, device=0)


def test_bwd_constants_match_the_kernel_source():
    src = (Path(K.__file__).resolve().parents[2] / "csrc" / "mlp_head.cu").read_text()
    for name, value in (("BT", K.BWD_THREADS), ("MAX_MT", K.BWD_MAX_MT),
                        ("MAX_NHQ", K.BWD_MAX_NHQ), ("OMAX", K.MAX_OUT)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "NS = 4 + 4 * OMAX + OMAX;" in src and K.BWD_SMALL_SUMS == 4 + 5 * K.MAX_OUT
    for h, want in ((1, 4), (4, 4), (5, 8), (32, 32), (33, 64), (40, 64), (128, 128)):
        assert K.bwd_hidden(h) == want


def test_bwd_wrapper_raises_where_the_plan_cannot_launch():
    def launch(c, h, o=1):
        x = torch.zeros(1, c, 5, dtype=torch.bfloat16)
        return K._bwd_launch(x, torch.zeros(1, o, 5), torch.zeros(c, h), torch.zeros(h),
                             torch.zeros(h, o))

    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="hidden units"):
        launch(8, 129)
    with pytest.raises(ValueError, match="register shares"):
        launch(96, 96)
    with pytest.raises(ValueError, match="outputs"):
        launch(8, 32, 5)
    assert K.LAUNCHES == before


# (B, C, N, H, O) of the forward's launch plan: every shape of the
# backward's, then edges (N of 1, N under one tile, odd N with B*N ending
# inside a tile, C of 1 and 128, H of 1 (one hidden group), 40 (padded to
# 64) and 128, O of 1 to 4), then the heads the port's bf16 2-D models
# build at widths 32 and 64 (uno9 and uno11 (64, 32) and (128, 64), uno
# (64, 128) and (128, 256), uno_demo (32, 64) and (64, 128)) at 211 x 211
FWD_PLAN_SHAPES = BWD_PLAN_SHAPES + [
    (1, 1, 1, 1, 1), (1, 5, 7, 40, 2), (3, 8, 131, 64, 3), (2, 128, 257, 128, 4),
    (5, 5, 99, 1, 4), (1, 128, 300, 1, 2)]
MODEL_HEADS = [(64, 32), (128, 64), (64, 128), (128, 256), (32, 64)]


def _lanes(p):
    """Threads that share a point group (csrc/mlp_head.cu: lanes)."""
    return min(p.hidden // 4, 32)


def _fwd_items(p):
    """As the kernel maps them: per (point group, hidden group) item of a
    tile, the compute threads that compute it; per (point group, output
    entry), the lane that stores it; and the xor partners of each shuffle
    step."""
    pts = 4 * K.FWD_POINT_GROUPS
    nhq, npg, lanes = p.hidden // 4, p.tile // pts, _lanes(p)
    items = np.zeros((npg, nhq), np.int32)
    stores = np.zeros((npg, pts * K.MAX_OUT), np.int32)
    for tid in range(K.FWD_COMPUTE):
        hl, slot = tid % lanes, tid // lanes
        for pg in range(slot, npg, K.FWD_COMPUTE // lanes):
            for hq in range(hl, nhq, lanes):
                items[pg, hq] += 1
            for e in range(pts * K.MAX_OUT):  # entry e = pts o + p
                stores[pg, e] += e % lanes == hl
        m = 1
        while m < lanes:  # each partner shares this thread's point groups and warp
            partner = tid ^ m
            assert partner // lanes == slot and partner // 32 == tid // 32
            m *= 2
    return items, stores


@pytest.mark.parametrize("b,c,n,h,o", FWD_PLAN_SHAPES)
def test_fwd_plan_covers_each_point_once(b, c, n, h, o):
    """Every grid point falls in exactly one tile of one block; each row of
    a tile is staged and unpacked by one producer warp; every (point group,
    hidden group) item has exactly one compute thread, the lanes that add
    their partial outputs by shuffles share a point group and a warp, and
    each output of a point group is stored by one lane."""
    p = K.fwd_plan(b, c, n, h, o)
    tpr = -(-n // p.tile)
    count = np.zeros((b, n), np.int32)
    for blk in range(p.blocks):
        for t in range(blk, b * tpr, p.blocks):
            n0 = t % tpr * p.tile
            count[t // tpr, n0:n0 + p.tile] += 1
    assert (count == 1).all()
    assert 32 % _lanes(p) == 0 and p.threads == K.FWD_COMPUTE + 32 * K.FWD_PRODUCERS
    assert p.tile % (4 * K.FWD_POINT_GROUPS) == 0 and K.FWD_COMPUTE % 32 == 0
    rows = np.zeros(c, np.int32)
    for w in range(K.FWD_PRODUCERS):
        rows[w::K.FWD_PRODUCERS] += 1
    assert (rows == 1).all()
    items, stores = _fwd_items(p)
    assert (items == 1).all() and (stores == 1).all()


@pytest.mark.parametrize("b,c,n,h,o", FWD_PLAN_SHAPES)
def test_fwd_plan_fits_the_card(b, c, n, h, o):
    p = K.fwd_plan(b, c, n, h, o)
    assert p.hidden >= h and (p.hidden // 4) & (p.hidden // 4 - 1) == 0
    assert p.tile in K.TILES and p.threads == K.FWD_COMPUTE + 32 * K.FWD_PRODUCERS
    assert p.smem == K.fwd_smem(c, p.hidden, p.tile) <= K.CARD_SMEM
    assert all(K.fwd_smem(c, p.hidden, t) > K.CARD_SMEM for t in K.TILES if t > p.tile)
    tiles = b * -(-n // p.tile)
    assert 1 <= p.blocks <= min(tiles, 2 * K.SMS) and p.blocks < 2**31
    assert p.blocks == min(tiles, (2 if 2 * p.smem <= K.CARD_SMEM else 1) * K.SMS)


@pytest.mark.parametrize("c,h", MODEL_HEADS)
def test_fwd_plan_takes_every_head_of_the_models(c, h):
    """The bf16 2-D models' heads at widths 32 and 64 launch: uno9 at
    width 64 (C 128, H 64) with 64-point tiles, uno at width 64 (C 128, H
    256) with 32, the others with 128."""
    p = K.fwd_plan(16, c, 211 * 211, h, 1)
    assert p.smem <= K.CARD_SMEM and p.hidden == K.bwd_hidden(h)
    assert p.tile == {(128, 64): 64, (128, 256): 32}.get((c, h), 128)


def test_fwd_plan_of_the_path_fills_the_card():
    """At the darcy_s211 head (C 64, H 32, O 1): 128-point tiles, 8 lanes
    per group of 8 points (one item per compute thread), two blocks of 4
    compute and 4 producer warps per H100 SM in 109 KB of shared memory
    each."""
    p = K.fwd_plan(16, 64, 211 * 211, 32, 1)
    assert (p.tile, p.threads, p.hidden, _lanes(p)) == (128, 256, 32, 8)
    assert p.smem == 111760 and 2 * p.smem <= K.CARD_SMEM and p.blocks == 2 * K.SMS


def test_fwd_plan_follows_the_cards_limits(monkeypatch):
    """A launch plans for its own card: half the SMs give half the blocks;
    less shared memory gives one block per SM, then a smaller tile; too
    little raises."""
    path = (16, 64, 211 * 211, 32, 1)
    monkeypatch.setattr(K, "device_limits", lambda index: (K.SMS // 2, K.CARD_SMEM))
    assert K.fwd_plan(*path, device=0).blocks == K.SMS
    monkeypatch.setattr(K, "device_limits", lambda index: (K.SMS, 160 * 1024))
    one = K.fwd_plan(*path, device=0)
    assert one.tile == 128 and one.blocks == K.SMS
    monkeypatch.setattr(K, "device_limits", lambda index: (K.SMS, 64 * 1024))
    small = K.fwd_plan(*path, device=0)
    assert small.tile == 64 and small.smem <= 64 * 1024 and small.blocks == K.SMS
    monkeypatch.setattr(K, "device_limits", lambda index: (K.SMS, 16 * 1024))
    with pytest.raises(ValueError, match="shared memory"):
        K.fwd_plan(*path, device=0)


def test_fwd_constants_match_the_kernel_source():
    """The tiles the entry point takes, the block (compute threads and
    producer warps), the shared-memory layout and the lanes of a point
    group are the plan's."""
    src = (Path(K.__file__).resolve().parents[2] / "csrc" / "mlp_head.cu").read_text()
    entry = src[src.index('extern "C" int uno_mlp_head_fwd'):src.index('extern "C" int uno_mlp_head_bwd')]
    assert sorted(int(t) for t in re.findall(r"tile != (\d+)", entry)) == sorted(K.TILES)
    assert "threads != FT" in entry and "smem != FwdSmem(C, hp, tile).bytes" in entry
    for name, value in (("CT", K.FWD_COMPUTE), ("PW", K.FWD_PRODUCERS),
                        ("FNP", K.FWD_POINT_GROUPS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "constexpr int FT = CT + 32 * PW;" in src
    layout = src[src.index("struct FwdSmem"):src.index("struct BwdSmem")]
    for line in ("b1 = k1 + 4 * C * hp;", "k2 = b1 + 4 * hp;", "b2 = k2 + 4 * OMAX * hp;",
                 "sh = b2 + 4 * OMAX;", "raw = sh + round_up(2 * 4 * C, 16);",
                 "xf = raw + 2 * 2 * C * (tp + 8);", "bytes = xf + 2 * 4 * C * (tp + 4);"):
        assert line in layout, line
    assert "const int lanes = nhq < 32 ? nhq : 32;" in src


def test_fwd_wrapper_raises_where_the_plan_cannot_launch():
    """On the CPU too, for an H100: a head whose padded k1 and x tiles do
    not fit the card's shared memory, more outputs than the accumulators
    cover, an empty x; nothing launches."""
    def head(c, h, o=1, n=5):
        return K.mlp_head(torch.zeros(1, c, n, dtype=torch.bfloat16), torch.zeros(c, h),
                          torch.zeros(h), torch.zeros(h, o), torch.zeros(o))

    before = dict(K.LAUNCHES)
    assert head(128, 256).shape == (1, 1, 5)  # uno at width 64 fits
    with pytest.raises(ValueError, match="shared memory"):
        head(256, 256)
    with pytest.raises(ValueError, match="outputs"):
        head(8, 32, 5)
    with pytest.raises(ValueError, match="non-empty"):
        head(8, 32, n=0)
    assert K.LAUNCHES == before
