"""The plain reference against the program on the CPU at a small width, in
float32: the forward of both configurations, the loss and every gradient,
an Adam step, and the rollout.  The reference imports nothing of the
program; this test imports both."""

from __future__ import annotations

import pytest
import torch

from benchmark import common, inputs
from benchmark.reference import uno2d
from benchmark.tests import tiny

# float32 on both sides, the same operations in another order: rounding
F32 = 1e-5


def _rel(a, b):
    return float((a - b).detach().norm() / b.detach().norm())


def _pair(name, seed):
    cfg = tiny.tiny_config(name)
    cfg["program"]["dtype"] = cfg["model"]["precision"] = "float32"
    w = inputs.weights(cfg, seed, "cpu")
    return cfg, w, common.program_model(cfg, w, torch.device("cpu"))


@pytest.mark.parametrize("name", ["darcy_s211-uno9-bf16", "ns2d-uno-bf16"])
def test_forward_loss_and_gradients(name):
    cfg, w, model = _pair(name, 5)
    x = inputs.serve_inputs(cfg, inputs.generator(5, "serve", "cpu"), 2, "cpu")
    y = torch.randn(x.shape[:3])
    out = model(x)
    ref_p = {k: v.clone().requires_grad_() for k, v in w.items()}
    ref = uno2d.forward(cfg["model"], ref_p, x)
    assert _rel(out, ref) < F32
    from uno_tpu_torch.losses import relative_lp_loss

    loss = relative_lp_loss(out.reshape(y.shape), y, reduction="sum")
    ref_loss = uno2d.rel_l2_sum(ref, y)
    assert abs(float(loss) - float(ref_loss)) < F32 * float(ref_loss)
    loss.backward()
    ref_loss.backward()
    for n, p in model.named_parameters():
        g, rg = p.grad, ref_p[n].grad
        # a bias before an instance norm has a gradient of rounding noise
        if float(rg.norm()) > 1e-4:
            assert _rel(g, rg) < 1e-4, n


def test_adam_step_equals_complex_adam():
    from uno_tpu_torch.optim import ComplexAdam

    cfg, w, model = _pair("darcy_s211-uno9-bf16", 6)
    opt = ComplexAdam(model.parameters(), lr=1e-3, weight_decay=1e-3)
    ref_p = {k: v.clone() for k, v in w.items()}
    adam = uno2d.Adam(ref_p, lambda n: 1e-3, 1e-3)
    for step in range(2):
        grads = {n: torch.randn_like(p) for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        opt.step()
        adam.step(grads)
    for n, p in model.named_parameters():
        assert _rel(p.detach(), ref_p[n]) < 1e-6, n


def test_rollout_equals_make_rollout():
    from uno_tpu_torch.train.ns2d import make_rollout

    cfg, w, model = _pair("ns2d-uno-bf16", 7)
    x = inputs.serve_inputs(cfg, inputs.generator(7, "serve", "cpu"), 2, "cpu")
    with torch.no_grad():
        out = make_rollout(model, 3)(x, torch.ones(x.shape[:3] + (3,)))[1]
        ref = uno2d.rollout(cfg["model"], w, x, 3)
    assert out.shape == ref.shape == (2, 64, 64, 3)
    assert _rel(out, ref) < F32


def test_c2r_takes_the_real_part_of_dc():
    """The inverse drops the imaginary part of the column transform's DC
    bin, as a real transform's inverse does."""
    spec = torch.randn(1, 1, 6, 4, dtype=torch.complex64)
    got = uno2d._irfft2(spec, 6, 6)
    z = torch.fft.ifft(spec, dim=-2, norm="forward")
    z[..., 0] = z[..., 0].real
    z[..., 3] = z[..., 3].real
    want = torch.fft.irfft(z, n=6, dim=-1, norm="forward")
    assert torch.allclose(got, want, atol=1e-6)
