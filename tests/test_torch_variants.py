"""The U-NO variants that no other test holds numerically against uno_tpu:
uno_p, uno_s256, uno_demo and the uno3d_*_256 family.

Each has code that no other held path runs: the lift activations
concatenated into an unfused head (``proj_concat_lift``: uno_p, uno_s256),
``pad_mode="end"`` and 13 blocks with a skip from block 2 (uno_demo), the
9-block 3-D stacks at the 256 family's modes (``pad=1`` on t40_256).  The
same numpy input goes through both packages on the CPU with the same
weights, carried by uno_tpu_torch.bridge.

* uno_p: a flax init into the port (``params_from_flax``); the forward, then
  the loss and every gradient against ``jax.value_and_grad`` (torch's
  complex gradient is the conjugate of ``jax.grad``'s); f32, rel-L2 <= 1e-4
  per leaf (uno_p has no instance norm, so no gradient is zero by
  construction).
* uno_s256 at 256x256 (its modes need 256 points), uno_demo at the
  tutorial's 64x64: flax inits, the forward in f32 within rel-L2 1e-4.
* uno_demo under the bf16 policy with the fused head on both sides
  (uno_tpu's Pallas head in interpret mode): within rel-L2 2e-2 of
  uno_tpu's, and no further from the f32 model than twice uno_tpu's own bf16
  drift (tests/test_torch_model.py's ratio, at two seeds).
* uno3d_t40_256 and uno3d_t9_256 at 128x128, width 2: the port's init carried
  into flax (a flax init of a 3-D model compiles for seconds), the forward
  in f32 within rel-L2 1e-4.
* The inverse FFTs' input: where the card's c2r needs it, the FFT path
  makes the DC and Nyquist slices of a half spectrum Hermitian, which
  leaves the CPU's c2r as it was (tests/test_torch_cuda.py holds the card
  against the CPU at the sizes where cuFFT's c2r took those slices
  otherwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.losses import relative_lp_loss as j_relative_lp_loss
from uno_tpu.models import build_model as jax_build_model
from uno_tpu.ops.pallas.mlp_head import set_fused_head_mode
from uno_tpu_torch import bridge
from uno_tpu_torch.losses import relative_lp_loss
from uno_tpu_torch.models import build_model
from _threads import worker_share_of_threads  # noqa: F401,E402

W = 4  # the 2-D models' width
F32 = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _input(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _flax(name, x, seed=0, **kw):
    """(flax model, its init for x as numpy)."""
    jm = jax_build_model(name, **kw)
    tree = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    return jm, jax.tree.map(np.asarray, tree)


def _port(name, tree, dtype=None, **kw):
    model = build_model(name, dtype=dtype, generator=torch.Generator().manual_seed(1), **kw)
    return bridge.params_from_flax(model, tree)


def _forward(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def _apply(jm, tree, x, fused=False):
    set_fused_head_mode(fused)
    try:
        return np.asarray(jax.jit(jm.apply)(tree, jnp.asarray(x)), np.float32)
    finally:
        set_fused_head_mode(None)


@pytest.fixture(scope="module")
def uno_p():
    """uno_p at 64x64 (its first block's 14 modes need 28 columns at half
    the grid): a flax init, the input and a target."""
    kw = dict(in_width=14, width=W, pad=0)
    x = _input(0, 2, 64, 64, 10)
    jm, tree = _flax("uno_p", x, **kw)
    return jm, tree, kw, x, _input(1, 2, 64, 64)


def test_uno_p_forward_matches_uno_tpu(uno_p):
    jm, tree, kw, x, _ = uno_p
    got, want = _forward(_port("uno_p", tree, **kw), x), _apply(jm, tree, x)
    assert got.shape == want.shape == (2, 64, 64, 1) and got.dtype == np.float32
    assert _rel(got, want) <= F32, _rel(got, want)


def test_uno_p_loss_and_gradients_match_uno_tpu(uno_p):
    """The lift concatenated into the unfused head: its activations' path
    carries gradient to fc and fc0 twice (through the blocks and the head)."""
    jm, tree, kw, x, y = uno_p

    def loss(p):
        out = jm.apply(p, jnp.asarray(x)).reshape(y.shape)
        return j_relative_lp_loss(out, jnp.asarray(y), reduction="sum")

    jl, jg = jax.jit(jax.value_and_grad(loss))(tree)
    model = _port("uno_p", tree, **kw)
    tl = relative_lp_loss(model(torch.from_numpy(x)).reshape(y.shape), torch.from_numpy(y),
                          reduction="sum")
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 1e-5 * abs(float(jl))
    want = {tuple(k.key for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_leaves_with_path(jg["params"])}
    got = {}
    for name, p in model.named_parameters():
        path, transpose = bridge._flax_path(name)
        g = p.grad.detach().numpy()
        got[path] = g.T if transpose else g
    assert set(got) == set(want) and {"fc", "fc0", "fc1", "fc2"} <= {k[0] for k in got}
    assert model.fc2.weight.shape[1] == 3 * W + W // 2  # the lift concatenated in
    for path, g in got.items():
        w = np.conj(want[path])  # no-op on real leaves
        assert g.shape == w.shape, path
        assert _rel(g, w) <= F32, (path, _rel(g, w))


def test_uno_s256_forward_matches_uno_tpu():
    kw = dict(in_width=14, width=W, pad=0)
    x = _input(2, 1, 256, 256, 10)
    jm, tree = _flax("uno_s256", x, **kw)
    got, want = _forward(_port("uno_s256", tree, **kw), x), _apply(jm, tree, x)
    assert got.shape == want.shape == (1, 256, 256, 1)
    assert _rel(got, want) <= F32, _rel(got, want)


DEMO_KW = dict(in_width=3, width=W, pad=8)


def _demo(dtype, seed):
    """(port, uno_tpu, uno_tpu f32) uno_demo outputs at 64x64 for one flax
    init; under bf16 both run the fused head."""
    x = _input(seed, 2, 64, 64, 1)
    jm, tree = _flax("uno_demo", x, seed, dtype=dtype, **DEMO_KW)
    want = _apply(jm, tree, x, fused=dtype == "bfloat16")
    got = _forward(_port("uno_demo", tree, dtype, **DEMO_KW), x)
    f32 = _apply(jax_build_model("uno_demo", **DEMO_KW), tree, x)
    return got, want, f32


def test_uno_demo_forward_matches_uno_tpu_f32():
    got, want, _ = _demo("float32", 0)
    assert got.shape == want.shape == (2, 64, 64, 1)
    assert _rel(got, want) <= F32, _rel(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_uno_demo_bf16_matches_uno_tpu_with_the_fused_head(seed):
    """Within 2e-2 of uno_tpu's bf16 output, and no further from the f32
    model than twice uno_tpu's own bf16 drift."""
    got, want, f32 = _demo("bfloat16", seed)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert _rel(got, want) <= 2e-2, _rel(got, want)
    assert _rel(got, f32) <= 2 * _rel(want, f32), (_rel(got, f32), _rel(want, f32))


@pytest.mark.parametrize("name,t_in,t_f", [("uno3d_t40_256", 10, 40), ("uno3d_t9_256", 6, 9)])
def test_uno3d_256_forward_matches_uno_tpu(name, t_in, t_f):
    """At 128x128 (the first block keeps 32 modes at a quarter of the grid),
    width 2, the factories' pads (1 for t40_256, 2 for t9_256)."""
    kw = dict(in_width=6, width=2)
    x = _input(3, 1, 128, 128, t_in, 1)
    model = build_model(name, generator=torch.Generator().manual_seed(0), **kw)
    tree = bridge.params_to_flax(model)
    got = _forward(model, x)
    want = _apply(jax_build_model(name, **kw), tree, x)
    assert got.shape == want.shape == (1, 128, 128, t_f, 1)
    assert _rel(got, want) <= F32, _rel(got, want)


@pytest.mark.parametrize("n,n_other,axes", [(16, (), ()), (15, (), ()), (16, (10,), (-1,)),
                                           (16, (6, 7), (-2, -1))])
def test_the_c2r_input_is_what_the_cpus_c2r_takes(n, n_other, axes):
    """Where a device's c2r would take them otherwise (cuFFT at 128 and 256
    points: uno_s256's last block), the FFT path replaces the DC slice and
    (n even) the Nyquist slice of the half spectrum's last axis by their
    Hermitian parts along the other axes: the CPU's c2r gives the output it
    gave before (it drops the rest), and those slices' c2c inverses are
    real, so every c2r takes them alike; the projection is its own adjoint
    (complex128 gradcheck through the inverse)."""
    from uno_tpu_torch.ops.spectral import _hermitian_c2r

    rng = np.random.default_rng(4)
    shape = (2, 3, *n_other, n // 2 + 1)
    spec = torch.from_numpy(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    got = _hermitian_c2r(spec.clone(), n, axes)
    s, dims = (*n_other, n), tuple(range(-len(n_other) - 1, 0))
    np.testing.assert_allclose(torch.fft.irfftn(got, s=s, dim=dims).numpy(),
                               torch.fft.irfftn(spec, s=s, dim=dims).numpy(), rtol=0, atol=1e-12)
    edges = [0] + ([n // 2] if n % 2 == 0 else [])
    assert torch.equal(got[..., 1 : n // 2], spec[..., 1 : n // 2])
    for k in edges:
        sl = torch.fft.ifftn(got[..., k], dim=axes) if axes else got[..., k]
        assert sl.imag.abs().max() <= 1e-15 and (spec[..., k] - got[..., k]).abs().max() > 0.1
    leaf = spec[:1, :1].clone().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda t: torch.fft.irfftn(_hermitian_c2r(t * 1, n, axes), s=s, dim=dims), (leaf,))
