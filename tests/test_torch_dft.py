"""The port's partial-DFT transforms (uno_tpu_torch/ops/dft.py) against
uno_tpu's, and their transposes against the transforms.

The same numpy input goes through each transform of both packages.  Bounds:
rel-L2 <= 1e-5 at f32 (the einsums sum in different orders); <= 1e-2 under
bf16 (bf16 operands and output, f32 accumulation: one bf16 rounding of the
output, 2**-9, plus the operands' roundings).  The transposes satisfy the
adjoint identity <T x, y> = <x, T^T y> in float64 to 1e-12.  Odd and even n,
and the Nyquist bin of ``inv_real`` (even n, m - 1 == n // 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.ops import dft as jdft
from uno_tpu_torch.ops import dft

FNS = ["fwd_real", "fwd_cplx", "inv_cplx", "inv_real",
       "t_fwd_real", "t_fwd_cplx", "t_inv_cplx", "t_inv_real"]
# functions whose input carries the (re, im) plane axis
PACKED_IN = {"fwd_cplx", "inv_cplx", "inv_real", "t_fwd_real", "t_fwd_cplx", "t_inv_cplx"}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _bins(n, kind):
    """'corners': the conv's +/- kx rows (3 each); 'half': the whole
    half spectrum, which for even n ends on the Nyquist bin."""
    if kind == "corners":
        return tuple(range(3)) + tuple(range(n - 3, n))
    return tuple(range(n // 2 + 1))


def _case(name, n, kind, axis, rng, dtype=np.float32):
    """(input array, call(module, x)) of one transform along ``axis``."""
    idx = _bins(n, kind)
    m = len(idx) if kind == "half" else 3  # inv_real's leading bins
    length = {"fwd_real": n, "fwd_cplx": n, "inv_cplx": len(idx), "inv_real": m,
              "t_fwd_real": len(idx), "t_fwd_cplx": len(idx), "t_inv_cplx": n,
              "t_inv_real": n}[name]
    shape = [2, 3, 5, 7]
    shape[axis] = length
    if name in PACKED_IN:
        shape.insert(2, 2)
    x = rng.standard_normal(shape).astype(dtype)

    def call(mod, xx):
        fn = getattr(mod, name)
        if name == "inv_real":
            return fn(xx, axis, n)
        if name == "t_inv_real":
            return fn(xx, axis, m, n)
        return fn(xx, axis, n, idx)

    return x, call


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("kind", ["corners", "half"])
@pytest.mark.parametrize("n", [15, 16])
@pytest.mark.parametrize("name", FNS)
def test_transform_matches_uno_tpu_f32(name, n, kind, axis):
    x, call = _case(name, n, kind, axis, np.random.default_rng(0))
    want = np.asarray(call(jdft, jnp.asarray(x)))
    got = call(dft, torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= 1e-5, _rel(got.numpy(), want)


@pytest.mark.parametrize("kind", ["corners", "half"])
@pytest.mark.parametrize("n", [15, 16])
@pytest.mark.parametrize("name", FNS)
def test_transform_matches_uno_tpu_bf16(name, n, kind):
    x, call = _case(name, n, kind, -1, np.random.default_rng(1))
    want = np.asarray(call(jdft, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = call(dft, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= 1e-2, _rel(got.float().numpy(), want)


@pytest.mark.parametrize("name", FNS)
def test_scaled_flag_matches_uno_tpu(name):
    """The other normalisation of each transform (the 3-D truncation uses it)."""
    x, _ = _case(name, 16, "half", -1, np.random.default_rng(2))
    idx, fn, jfn = _bins(16, "half"), getattr(dft, name), getattr(jdft, name)
    if name == "inv_real":
        args = (-1, 16, True)
    elif name == "t_inv_real":
        args = (-1, 9, 16, True)
    else:
        args = (-1, 16, idx, not name.startswith(("fwd", "t_fwd")))
    want = np.asarray(jfn(jnp.asarray(x), *args))
    assert _rel(fn(torch.from_numpy(x), *args).numpy(), want) <= 1e-5


PAIRS = [("fwd_real", "t_fwd_real"), ("fwd_cplx", "t_fwd_cplx"),
         ("inv_cplx", "t_inv_cplx"), ("inv_real", "t_inv_real")]


@pytest.mark.parametrize("kind", ["corners", "half"])
@pytest.mark.parametrize("n", [15, 16])
@pytest.mark.parametrize("fwd,tr", PAIRS)
def test_transposes_are_adjoint_in_float64(fwd, tr, n, kind):
    rng = np.random.default_rng(3)
    x, call = _case(fwd, n, kind, -2, rng, np.float64)
    tx = call(dft, torch.from_numpy(x))
    assert tx.dtype == torch.float64
    y, tcall = _case(tr, n, kind, -2, rng, np.float64)
    y = torch.from_numpy(y)
    assert y.shape == tx.shape
    tty = tcall(dft, y)
    lhs, rhs = float((tx * y).sum()), float((torch.from_numpy(x) * tty).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0), (lhs, rhs)


def test_inv_real_is_irfft_with_the_nyquist_bin():
    """The whole half spectrum of an even n, Nyquist bin included: inv_real
    equals numpy's irfft (norm 'forward'), which drops the imaginary parts
    of the DC and Nyquist bins."""
    rng = np.random.default_rng(4)
    spec = rng.standard_normal((2, 3, 9)) + 1j * rng.standard_normal((2, 3, 9))
    packed = dft.pack(torch.from_numpy(spec.real), torch.from_numpy(spec.imag))
    got = dft.inv_real(packed, -1, 16)
    np.testing.assert_allclose(got.numpy(), np.fft.irfft(spec, n=16, norm="forward"),
                               rtol=0, atol=1e-5)


def test_pack_unpack_round_trip():
    re, im = torch.randn(2, 3, 4, 5), torch.randn(2, 3, 4, 5)
    p = dft.pack(re, im)
    assert p.shape == (2, 3, 2, 4, 5)
    r2, i2 = dft.unpack(p)
    assert torch.equal(r2, re) and torch.equal(i2, im)
    jr, ji = jdft.unpack(jdft.pack(jnp.asarray(re.numpy()), jnp.asarray(im.numpy())))
    assert np.array_equal(np.asarray(jr), re.numpy()) and np.array_equal(np.asarray(ji), im.numpy())


def test_device_tables_are_cached_per_dtype():
    x = torch.randn(2, 3, 16)
    dft.fwd_real(x, -1, 16, range(4))
    dft.fwd_real(x.bfloat16(), -1, 16, range(4))
    t32 = dft._device_table(dft._fwd_real_T, (16, tuple(range(4)), True), torch.float32,
                            x.device)
    assert t32 is dft._device_table(dft._fwd_real_T, (16, tuple(range(4)), True),
                                    torch.float32, x.device)
    t16 = dft._device_table(dft._fwd_real_T, (16, tuple(range(4)), True), torch.bfloat16,
                            x.device)
    assert t16.dtype == torch.bfloat16 and not t32.is_inference()
