"""norm_matmul / matmul_residual of the port (their plain versions, which
CPU tensors take) against the JAX kernels in interpret mode and against
the unfused JAX chain ``rms_norm(x, g) @ w`` / ``res + x @ w``.
Tolerances: f32 atol 1e-5; bf16 atol = rtol = 2e-2 (one bf16 rounding of
outputs of magnitude ~1 differs by up to 2^-7). The launch plan both
kernels share (``gemv_plan``, a plain function of the shapes) is checked
here too: every contraction row, column and token in exactly one block;
so is the cluster policy it shares with the int4 GEMV's plan
(``_cuda.cluster_split``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu.ops import fused_decode as jfd
from distributed_inference_engine_tpu.ops.norms import rms_norm as jrms
from distributed_inference_engine_tpu_torch.bridge import (
    tensor_from_numpy,
    tensor_to_numpy,
)
from distributed_inference_engine_tpu_torch.ops import _cuda
from distributed_inference_engine_tpu_torch.ops import fused_decode as tfd

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

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


# the decode batches (8 slots, up to 40), N off the 128-column tile and an
# odd N / 2, D off the 32-row stage: against the unfused JAX chain, and
# against the interpreted kernel where its tiling takes the shape
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,d,n", [(8, 256, 384), (40, 256, 130),
                                   (1, 688, 1002)])
@pytest.mark.parametrize("plus_one", [False, True])
def test_norm_matmul_shapes(dtype, b, d, n, plus_one):
    rs = np.random.RandomState(b + d + n)
    cast = (lambda a: jnp.asarray(a, dtype))
    x = cast(rs.randn(b, d).astype(np.float32))
    g = cast((0.1 * rs.randn(d)).astype(np.float32))
    w = cast((0.05 * rs.randn(d, n)).astype(np.float32))
    got = tfd.norm_matmul(_t(x), _t(g), _t(w), eps=1e-5, plus_one=plus_one)
    assert tuple(got.shape) == (b, n)
    gain = g.astype(jnp.float32) + 1.0 if plus_one else g
    _close(got, jrms(x, gain, 1e-5) @ w, dtype)
    if jfd.norm_matmul_wants(x, w):
        _close(got, jfd.norm_matmul(x, g, w, eps=1e-5, plus_one=plus_one,
                                    interpret=True), dtype)


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


H100_SMS = 132


# the decode batches the engine gives (8 slots; up to 40 in the card
# tests), the Llama-3-8B contractions (wo 4096, w_down 14336) and a small
# one, N = d_model and two N off the 128-column tile
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [688, 4096, 14336])
@pytest.mark.parametrize("n", [4096, 1000, 1002])
def test_residual_plan_covers_every_row_once(dtype, d, n):
    for b in (1, 2, 7, 8, 9, 16, 32, 40):
        pl = tfd.gemv_plan(b, d, n, dtype, H100_SMS)
        ks, chunk, depth = pl["ks"], pl["chunk"], pl["depth"]
        assert ks in (1, 2, 4, 8) and chunk % depth == 0
        assert depth == (32 if dtype == torch.bfloat16 else 16)
        rows = np.zeros(d, int)                 # each K row: one rank
        for rank in range(ks):
            rows[rank * chunk:min(d, (rank + 1) * chunk)] += 1
        assert (rows == 1).all() and ks * chunk >= d
        cols = np.zeros(n, int)
        for ct in range(pl["col_tiles"]):
            cols[ct * 128:min(n, (ct + 1) * 128)] += 1
        assert (cols == 1).all()
        assert pl["tokens"] in (8, 16, 32) and pl["tokens"] >= min(b, 32)
        assert pl["tok_tiles"] * pl["tokens"] >= b
        assert (pl["tok_tiles"] - 1) * pl["tokens"] < b
        assert pl["blocks"] == pl["col_tiles"] * pl["tok_tiles"] * ks
        # at most ~4 blocks an SM, unless the contraction is not split
        assert ks == 1 or pl["blocks"] <= 4 * H100_SMS


@pytest.mark.parametrize("k_tiles", [1, 2, 3, 7, 8, 9, 32, 128, 448])
@pytest.mark.parametrize("blocks", [1, 8, 64, 66, 132, 264, 448, 1008])
def test_cluster_split_is_the_largest_that_fits(k_tiles, blocks):
    """The cluster policy both GEMV plans share: ks is 1, 2, 4 or 8, every
    stage of the contraction lies in exactly one block's chunk, and ks is
    the largest count that keeps the grid within 4 blocks an SM and gives
    each block at least one stage."""
    ks, chunk = _cuda.cluster_split(k_tiles, blocks, H100_SMS)
    assert ks in (1, 2, 4, 8) and chunk >= 1
    stages = np.zeros(k_tiles, int)
    for rank in range(ks):
        stages[rank * chunk:min(k_tiles, (rank + 1) * chunk)] += 1
    assert (stages == 1).all()
    assert ks <= k_tiles
    assert ks == 1 or blocks * ks <= 4 * H100_SMS
    assert (ks == 8 or 2 * ks > k_tiles
            or blocks * 2 * ks > 4 * H100_SMS)


def test_residual_plan_at_the_llama3_8b_decode_shapes():
    """B 8, N 4096: 32 column tiles; an 8-block cluster at both
    contractions (256 blocks, about two an SM on 132 SMs)."""
    bf = torch.bfloat16
    for d, chunk in ((4096, 512), (14336, 1792)):
        pl = tfd.gemv_plan(8, d, 4096, bf, H100_SMS)
        assert (pl["ks"], pl["chunk"], pl["blocks"]) == (8, chunk, 256)
    assert tfd.gemv_instance(bf) == "mma"
    assert tfd.gemv_instance(torch.float32) == "simt"


@pytest.mark.parametrize("n,plan", [
    (1024, (8, 512, 64)),      # wk, wv: 8 column tiles, clusters of 8
    (4096, (8, 512, 256)),     # wq: 32 column tiles
    (14336, (4, 1024, 448)),   # w_gate, w_up: 112 column tiles
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gemv_plan_at_the_llama3_8b_norm_matmul_shapes(n, plan, dtype):
    """norm_matmul's calls at B 8, D 4096 (ks, chunk, blocks): the
    largest cluster within four blocks an SM; fp32's 16-row stages give
    the same chunks."""
    pl = tfd.gemv_plan(8, 4096, n, dtype, H100_SMS)
    assert (pl["ks"], pl["chunk"], pl["blocks"]) == plan
    assert pl["blocks"] <= 4 * H100_SMS and pl["tokens"] == 8
