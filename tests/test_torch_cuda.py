"""The port's CUDA kernels and model on the card, against their plain PyTorch
versions.  Every case needs a CUDA device and skips without one.

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

# (B, Ci, Co, M) of the five uno9 contractions at darcy_s211, batch 16
DARCY_S211 = [(16, 32, 64, 648), (16, 64, 128, 128), (16, 128, 128, 128),
              (16, 128, 64, 128), (16, 128, 32, 648)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-12))


def _rand_c(g, *shape):
    return torch.complex(torch.randn(shape, generator=g), torch.randn(shape, generator=g))


@pytest.mark.cuda
@pytest.mark.parametrize("b,ci,co,m", [(2, 3, 5, 7), (4, 8, 8, 128), (2, 4, 6, 200),
                                       (9, 5, 3, 33)] + DARCY_S211)
def test_cmul_kernel_matches_plain(cuda, b, ci, co, m):
    g = torch.Generator().manual_seed(1)
    x = _rand_c(g, b, ci, m).to(cuda)
    w = (_rand_c(g, ci, co, m) / (2 * ci) ** 0.5).to(cuda)  # the init's scale
    before = C.LAUNCHES
    got = C.cmul(x, w)
    torch.cuda.synchronize()
    assert C.LAUNCHES == before + 1
    torch.testing.assert_close(got, C.cmul_plain(x, w), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cmul_wrapper_raises_on_the_card(cuda):
    x = torch.zeros(2, 3, 8, dtype=torch.complex64, device=cuda)
    w = torch.zeros(3, 4, 8, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        C.cmul(x.transpose(0, 1).contiguous().transpose(0, 1), w)
    with pytest.raises(ValueError):
        C.cmul(x, w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,h,o", [((2, 8, 37, 45), 32, 1), ((1, 16, 64, 64), 64, 3),
                                       ((16, 64, 211, 211), 32, 1), ((3, 5, 7, 300), 40, 4)])
def test_mlp_head_kernel_matches_plain(cuda, shape, h, o):
    g = torch.Generator().manual_seed(2)
    c = shape[1]
    x = torch.randn(shape, generator=g).to(cuda, torch.bfloat16)
    w = [t.to(cuda) for t in (torch.randn(c, h, generator=g) / c**0.5,
                              torch.randn(h, generator=g),
                              torch.randn(h, o, generator=g) / h**0.5,
                              torch.randn(o, generator=g))]
    before = H.LAUNCHES
    got = H.mlp_head(x, *w)
    torch.cuda.synchronize()
    assert H.LAUNCHES == before + 1
    assert got.shape == (shape[0], o) + shape[2:] and got.dtype == torch.float32
    want = H.mlp_head_plain(x.reshape(shape[0], c, -1), *w).reshape(got.shape)
    assert _rel(got, want) <= 1e-5


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
    c0, h0 = C.LAUNCHES, H.LAUNCHES
    with torch.inference_mode():
        want = cpu(x)
        got = gpu(x.to(cuda))
    assert C.LAUNCHES - c0 == 5
    assert H.LAUNCHES - h0 == (1 if dtype == "bfloat16" else 0)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= bound
