"""norm_matmul / matmul_residual of the port (their plain versions, which
CPU tensors take) against the JAX kernels in interpret mode and against
the unfused JAX chain ``rms_norm(x, g) @ w`` / ``res + x @ w``.
Tolerances: f32 atol 1e-5; bf16 atol = rtol = 2e-2 (one bf16 rounding of
outputs of magnitude ~1 differs by up to 2^-7)."""

import jax.numpy as jnp
import numpy as np
import pytest

from distributed_inference_engine_tpu.ops import fused_decode as jfd
from distributed_inference_engine_tpu.ops.norms import rms_norm as jrms
from distributed_inference_engine_tpu_torch.bridge import (
    tensor_from_numpy,
    tensor_to_numpy,
)
from distributed_inference_engine_tpu_torch.ops import fused_decode as tfd

pytestmark = pytest.mark.torch_port

TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-2, 2e-2)}
B, D, N = 3, 256, 384          # B not a multiple of 16: the JAX pad path


def _inputs(seed, dtype):
    rs = np.random.RandomState(seed)
    cast = (lambda a: jnp.asarray(a, dtype))
    x = cast(rs.randn(B, D).astype(np.float32))
    g = cast((1.0 + 0.1 * rs.randn(D)).astype(np.float32))
    w = cast((0.05 * rs.randn(D, N)).astype(np.float32))
    res = cast(rs.randn(B, N).astype(np.float32))
    return x, g, w, res


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(tensor_to_numpy(got.float()),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plus_one", [False, True])
def test_norm_matmul(dtype, plus_one):
    x, g, w, _ = _inputs(0, dtype)
    got = tfd.norm_matmul(_t(x), _t(g), _t(w), eps=1e-5, plus_one=plus_one)
    assert got.dtype == _t(x).dtype and tuple(got.shape) == (B, N)
    kernel = jfd.norm_matmul(x, g, w, eps=1e-5, plus_one=plus_one,
                             interpret=True)
    _close(got, kernel, dtype)
    gain = g.astype(jnp.float32) + 1.0 if plus_one else g
    _close(got, jrms(x, gain, 1e-5) @ w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_residual(dtype):
    x, _, w, res = _inputs(1, dtype)
    got = tfd.matmul_residual(_t(x), _t(w), _t(res))
    kernel = jfd.matmul_residual(x, w, res, interpret=True)
    _close(got, kernel, dtype)
    _close(got, res + x @ w, dtype)


def test_wants_gate():
    x = _t(np.zeros((2, 8), np.float32))
    assert tfd.norm_matmul_wants(x, _t(np.zeros((8, 6), np.float32)))
    assert not tfd.norm_matmul_wants(x, _t(np.zeros((8, 5), np.float32)))
    assert not tfd.norm_matmul_wants(x, _t(np.zeros((7, 6), np.float32)))
    assert not tfd.norm_matmul_wants(
        x, _t(np.zeros((8, 6), np.float32)).to(dtype=x.dtype).half())
    assert not tfd.matmul_residual_wants(x, _t(np.zeros((2, 8, 6),
                                                         np.float32)))
