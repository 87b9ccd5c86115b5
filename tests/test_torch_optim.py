"""The port's ComplexAdam and StepLR schedule against uno_tpu's optax
transforms (uno_tpu/optim.py).

The same numpy parameters and gradients go to both.  The JAX side takes the
conjugated gradients: ``jax.grad``'s complex convention is the conjugate of
torch autograd's, and ``complex_adam`` conjugates them back while the port's
optimizer takes torch's as they are.  Bound: rel <= 1e-6 per parameter after
5 steps (both run the update in f32).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.optim import complex_adam, step_lr as j_step_lr
from uno_tpu.train.common import TrainConfig as JTrainConfig, lr_at as j_lr_at
from uno_tpu_torch.optim import ComplexAdam, step_lr
from uno_tpu_torch.train.common import TrainConfig, lr_at


def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.mark.parametrize("wd", [0.0, 1e-3])
@pytest.mark.parametrize("amsgrad", [False, True])
def test_complex_adam_matches_uno_tpu(wd, amsgrad):
    rng = np.random.default_rng(0)
    shapes = {"r": ((4, 3), np.float32), "c": ((2, 3, 5), np.complex64)}

    def draw(shape, dt):
        a = rng.standard_normal(shape)
        if dt == np.complex64:
            a = a + 1j * rng.standard_normal(shape)
        return a.astype(dt)

    p0 = {k: draw(*v) for k, v in shapes.items()}
    grads = [{k: draw(*v) for k, v in shapes.items()} for _ in range(5)]
    lr = 1e-2

    opt = complex_adam(lr, weight_decay=wd, amsgrad=amsgrad)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    topt = ComplexAdam(tp.values(), lr=lr, weight_decay=wd, amsgrad=amsgrad)
    for g in grads:
        jg = {k: jnp.asarray(np.conj(v)) for k, v in g.items()}
        updates, state = opt.update(jg, state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
    for k in shapes:
        assert tp[k].dtype == torch.from_numpy(p0[k]).dtype
        assert _rel(tp[k].detach().numpy(), jp[k]) <= 1e-6, (k, _rel(tp[k].detach().numpy(), jp[k]))
    st = topt.state[tp["c"]]
    assert st["exp_avg"].dtype == torch.complex64  # mu takes the param's dtype
    assert st["exp_avg_sq"].dtype == torch.float32  # nu is real, |g|^2


def test_schedule_matches_uno_tpu_over_three_epochs():
    spe = 4
    sched, jsched = step_lr(1e-3, 1, 0.5, spe), j_step_lr(1e-3, 1, 0.5, spe)
    for count in range(0, 3 * spe + 2):
        want = float(jsched(jnp.asarray(count, jnp.int32)))
        assert sched(count) == pytest.approx(want, rel=1e-6), count
    for kw in ({}, dict(scheduler_step=1), dict(scheduler_step=1, compat_even_epoch_scheduler=True)):
        cfg, jcfg = TrainConfig(**kw), JTrainConfig(**kw)
        for step in range(0, 3 * spe + 2):
            assert lr_at(cfg, spe, step) == pytest.approx(j_lr_at(jcfg, spe, step), rel=1e-12)


def test_complex_descent_both_components():
    """Minimising |w|^2 with torch autograd's gradients must shrink BOTH the
    real and imaginary parts (the counterpart of tests/test_optim.py's test:
    an optimizer that conjugated here would train only the real part)."""
    w = torch.nn.Parameter(torch.tensor([3.0 + 4.0j], dtype=torch.complex64))
    opt = ComplexAdam([w], lr=5e-2)
    for _ in range(100):
        opt.zero_grad()
        (w.abs() ** 2).sum().backward()
        opt.step()
    assert abs(w.detach()[0].real) < 1.0, w
    assert abs(w.detach()[0].imag) < 1.5, w


def test_complex_second_moment_is_shared():
    """nu is |g|^2, one real moment per complex weight, not one per part."""
    w = torch.nn.Parameter(torch.tensor([1.0 + 1.0j], dtype=torch.complex64))
    opt = ComplexAdam([w], lr=1e-3)
    w.grad = torch.tensor([3.0 + 4.0j], dtype=torch.complex64)
    opt.step()
    nu = opt.state[w]["exp_avg_sq"]
    assert nu.dtype == torch.float32
    assert float(nu[0]) == pytest.approx((1 - 0.999) * 25.0, rel=1e-6)


def _draw_params(rng):
    """A real matrix, a complex tensor and a real vector, as uno_tpu's
    tests/test_optim.py:125-175 draws them."""
    return [rng.standard_normal((3, 4)).astype(np.float32),
            (rng.standard_normal((2, 5)) + 1j * rng.standard_normal((2, 5))).astype(np.complex64),
            rng.standard_normal((7,)).astype(np.float32)]


def _draw_grads(rng, params):
    return [(rng.standard_normal(p.shape) + (1j * rng.standard_normal(p.shape)
                                              if np.iscomplexobj(p) else 0)).astype(p.dtype)
            for p in params]


def _run(opt, params, grads):
    for g in grads:
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi.copy())
        opt.step()


@pytest.mark.parametrize("amsgrad", [False, True])
def test_fused_is_bit_equal_to_per_parameter(amsgrad):
    """uno_tpu's tests/test_optim.py:125-175 for the port: 12 steps across
    StepLR boundaries with weight decay, every parameter and every moment
    the same bits in both forms."""
    rng = np.random.default_rng(3)
    p0 = _draw_params(rng)
    grads = [_draw_grads(rng, p0) for _ in range(12)]
    runs = []
    for fused in (False, True):
        params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
        opt = ComplexAdam(params, lr=step_lr(1e-3, 2, 0.5, steps_per_epoch=3),
                          weight_decay=1e-3, amsgrad=amsgrad, fused=fused)
        _run(opt, params, grads)
        runs.append((params, opt))
    (ref, ref_opt), (fus, fus_opt) = runs
    for a, b in zip(ref, fus):
        assert a.dtype == b.dtype and torch.equal(a, b)
    flat = fus_opt.state["flat0"]
    assert flat["step"] == 12
    for dt in ("torch.float32", "torch.complex64"):
        ps = [p for p in ref if str(p.dtype) == dt]
        for key in ("exp_avg", "exp_avg_sq") + (("max_exp_avg_sq",) if amsgrad else ()):
            want = torch.cat([ref_opt.state[p][key].reshape(-1) for p in ps])
            assert torch.equal(flat[dt][key], want), (dt, key)
    assert flat["torch.complex64"]["exp_avg_sq"].dtype == torch.float32  # nu is real


@pytest.mark.parametrize("amsgrad", [False, True])
def test_fused_matches_uno_tpu_fused(amsgrad):
    """Against uno_tpu's complex_adam(fused=True), the bound of
    test_complex_adam_matches_uno_tpu, jax.grad's conjugate convention on
    the JAX side."""
    rng = np.random.default_rng(0)
    p0 = _draw_params(rng)
    grads = [_draw_grads(rng, p0) for _ in range(5)]
    opt = complex_adam(1e-2, weight_decay=1e-3, amsgrad=amsgrad, fused=True)
    jp = [jnp.asarray(p) for p in p0]
    state = opt.init(jp)
    for g in grads:
        updates, state = opt.update([jnp.asarray(np.conj(gi)) for gi in g], state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    _run(ComplexAdam(tp, lr=1e-2, weight_decay=1e-3, amsgrad=amsgrad, fused=True), tp, grads)
    for a, b in zip(tp, jp):
        assert _rel(a.detach().numpy(), b) <= 1e-6, _rel(a.detach().numpy(), b)


def test_fused_state_dict_resumes_bit_for_bit():
    """5 steps, the state saved and loaded into a fresh optimizer over a copy
    of the parameters, then 5 more steps on both: the same bits.  The flat
    state does not load into a per-parameter optimizer, nor the other way."""
    rng = np.random.default_rng(5)
    p0 = _draw_params(rng)
    grads = [_draw_grads(rng, p0) for _ in range(10)]
    sched = step_lr(1e-3, 1, 0.5, steps_per_epoch=3)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = ComplexAdam(params, lr=sched, weight_decay=1e-3, amsgrad=True, fused=True)
    _run(opt, params, grads[:5])
    buf = io.BytesIO()  # the state alone, as the trainers save it: the schedule does not pickle
    torch.save(opt.state_dict()["state"], buf)
    resumed = [torch.nn.Parameter(p.detach().clone()) for p in params]
    opt2 = ComplexAdam(resumed, lr=sched, weight_decay=1e-3, amsgrad=True, fused=True)
    opt2.load_state_dict({"state": torch.load(io.BytesIO(buf.getvalue()), weights_only=True),
                          "param_groups": opt2.state_dict()["param_groups"]})
    _run(opt, params, grads[5:])
    _run(opt2, resumed, grads[5:])
    for a, b in zip(params, resumed):
        assert torch.equal(a, b)
    assert opt2.state["flat0"]["step"] == 10
    per_param = ComplexAdam([torch.nn.Parameter(p.detach().clone()) for p in params],
                            lr=sched, amsgrad=True)
    with pytest.raises(ValueError, match="fused"):
        per_param.load_state_dict(opt.state_dict())
    _run(per_param, per_param.param_groups[0]["params"], grads[:1])
    with pytest.raises(ValueError, match="fused"):
        opt2.load_state_dict(per_param.state_dict())
