"""The port's ComplexAdam and StepLR schedule against uno_tpu's optax
transforms (uno_tpu/optim.py).

The same numpy parameters and gradients go to both.  The JAX side takes the
conjugated gradients: ``jax.grad``'s complex convention is the conjugate of
torch autograd's, and ``complex_adam`` conjugates them back while the port's
optimizer takes torch's as they are.  Bound: rel <= 1e-6 per parameter after
5 steps (both run the update in f32).
"""

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
