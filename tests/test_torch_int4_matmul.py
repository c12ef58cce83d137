"""The port's int4 matmul (``ops/int4_matmul.py``) against the JAX package's
TPU kernel ``_kernel_stacked`` run in interpret mode on the CPU, on the same
numpy inputs: the plain version (which the kernel of
``csrc/int4_matmul.cu`` is held to on the card) for the 2-D and the
layer-stacked wrappers, fp32 (rtol = atol = 2e-5) and bf16 (rtol = atol =
1e-2, the JAX test's own band: the TPU kernel rounds once after the fp32
sum and the scale, as the plain version does); and the port's
``forward_train`` logits against JAX's with the kernel on, on a tileable
tiny int4 tree, in fp32 (atol 1e-4); and the CUDA kernel's instance
choice, from shapes, dtype and alignment alone, and the GEMV instance's
launch plan (``int4_gemv_plan``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu.models import base as jb
from distributed_inference_engine_tpu.models.llama import llama_spec as jspec
from distributed_inference_engine_tpu.ops import quant as jq
from distributed_inference_engine_tpu.ops.int4_matmul import (
    _int4_matmul_2d,
    _int4_matmul_stacked,
    set_kernel_mode,
)
from distributed_inference_engine_tpu_torch.bridge import params_from_numpy
from distributed_inference_engine_tpu_torch.models import base as tb
from distributed_inference_engine_tpu_torch.models.llama import (
    llama_spec as tspec,
)
from distributed_inference_engine_tpu_torch.ops import _cuda
from distributed_inference_engine_tpu_torch.ops import quant as tq
from distributed_inference_engine_tpu_torch.ops.int4_matmul import (
    int4_gemv_plan,
    int4_instance,
    int4_matmul,
    int4_matmul_plain,
    wgmma_tile,
)

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 1e-2}
K, N = 512, 384                     # K/2 and N tile the TPU kernel


@pytest.fixture
def kernel_on():
    set_kernel_mode("on")
    yield
    set_kernel_mode("auto")


def _quantized(rs, shape, axis):
    w = jnp.asarray(rs.randn(*shape).astype(np.float32) * 0.05)
    return jq.quantize_weight(w, (axis,), bits=4)


def _torch(a, dtype=None):
    t = torch.from_numpy(np.array(a, dtype=np.float32 if dtype else None))
    return t.to(getattr(torch, dtype)) if dtype else t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 5, 8, 16, 37, 128])
def test_plain_matches_interpreted_kernel(m, dtype):
    rs = np.random.RandomState(m)
    qt = _quantized(rs, (K, N), 0)
    x = rs.randn(m, K).astype(np.float32)
    want = _int4_matmul_2d(jnp.asarray(x, dtype), qt.q, qt.s,
                           interpret=True)
    got = int4_matmul_plain(_torch(x, dtype), _torch(qt.q),
                            _torch(qt.s).reshape(-1))
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, N)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_interpreted_stacked_kernel_per_layer(dtype):
    """Each layer of a stacked payload: the JAX kernel picks the layer in
    its grid, the port takes the layer view through ``matmul_any``."""
    rs = np.random.RandomState(7)
    n_layers = 3
    qt = _quantized(rs, (n_layers, K, N), 1)
    tqt = tq.QuantizedTensor(q=_torch(qt.q), s=_torch(qt.s), bits=4,
                             pack_axis=qt.pack_axis)
    x = rs.randn(5, K).astype(np.float32)
    for layer in range(n_layers):
        want = _int4_matmul_stacked(jnp.asarray(x, dtype), qt.q, qt.s,
                                    jnp.int32(layer), interpret=True)
        got = tq.matmul_any(_torch(x, dtype), tqt[layer])
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def test_cpu_tensors_take_the_plain_version():
    rs = np.random.RandomState(3)
    qt = _quantized(rs, (64, 40), 0)
    x = torch.from_numpy(rs.randn(6, 64).astype(np.float32))
    before = dict(_cuda.LAUNCHES)
    got = int4_matmul(x, _torch(qt.q), _torch(qt.s).reshape(-1))
    assert torch.equal(got, int4_matmul_plain(x, _torch(qt.q),
                                              _torch(qt.s).reshape(-1)))
    assert dict(_cuda.LAUNCHES) == before


def test_forward_train_logits_match_jax_kernel_on(kernel_on):
    """A tileable tiny int4 tree (d_model 256, d_ff 512), fused by the JAX
    engine preparation with the kernel on: JAX's forward_train runs every
    projection through the interpreted TPU kernel; the port's, through its
    plain version on the bridged tree."""
    js = jspec("llama-tiny", dtype="float32").replace(d_ff=512)
    ts = tspec("llama-tiny", dtype="float32").replace(d_ff=512)
    jp = jq.prepare_params(jq.random_quantized_params(
        js, jax.random.key(3), bits=4))
    assert "w_qkv" in jp["blocks"] and "w_gate_up" in jp["blocks"]
    tp = params_from_numpy(jax.device_get(jp), ts, "cpu")
    rs = np.random.RandomState(4)
    tokens = rs.randint(1, ts.vocab_size, size=(2, 19)).astype(np.int32)
    lens = np.array([19, 11], np.int32)
    want = jb.forward_train(js, jp, jnp.asarray(tokens), jnp.asarray(lens))
    got = tb.forward_train(ts, tp, torch.from_numpy(tokens), lens)
    assert got.shape == (2, 19, ts.vocab_size)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n].numpy(),
                                   np.asarray(want)[b, :n], rtol=0,
                                   atol=1e-4)


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("m,k2,n,dtype,aligned,want", [
    (1, 2048, 28672, BF16, True, "gemv"),       # decode, one slot
    (16, 2048, 129024, F32, True, "gemv"),      # the head, fp32 rows
    (17, 2048, 28672, BF16, True, "wgmma"),     # smallest tiled M
    (2560, 7168, 4096, BF16, True, "wgmma"),    # the mixed step's lattice
    (2560, 2048, 129024, F32, True, "simt"),    # fp32 parity engines
    (37, 2000, 4100, BF16, True, "wmma"),       # N % 16 != 0
    (40, 1004, 4096, BF16, True, "wmma"),       # K/2 % 8 != 0
    (40, 2048, 4096, BF16, False, "wmma"),      # x or payload off 16 bytes
])
def test_int4_instance_choice(m, k2, n, dtype, aligned, want):
    assert int4_instance(m, k2, n, dtype, aligned) == want


# (M, N) -> tokens per block at 132 SMs; the cost is waves x (tile + 160)
@pytest.mark.parametrize("m,n,want", [
    (17, 4096, 64),        # a small mixed step: one wave whatever the tile
    (64, 28672, 64),       # 224 blocks: two waves of 64 beat two of 128
    (65, 28672, 128),      # 64: four waves (896); 128: two (576)
    (65, 4096, 64),        # one wave either way
    (200, 4096, 64),       # 64: 128 blocks, one wave
    (200, 6144, 128),      # 64: 192 blocks, two waves (448); 128: one (288)
    (200, 28672, 256),     # 256: two waves (832); 128: four (1152)
    (512, 4096, 128),      # 128: one wave (288); 64: two (448)
    (512, 6144, 256),      # 256: one wave of 96 blocks (416)
    (512, 28672, 256),     # an admission prefill's gate|up
    (2560, 4096, 256),     # the lattice's o and down: 320 blocks
    (2560, 6144, 256),
    (2560, 28672, 256),
])
def test_wgmma_token_tile(m, n, want):
    """The wgmma instance's tokens per block, from the shapes and the SM
    count (132 on an H100 SXM) alone."""
    assert wgmma_tile(m, n, 132) == want


H100_SMS = 132


# the Llama-3-8B products (fused q|k|v, o, gate|up, down, the padded head)
# and shapes off every tile, at one and two 8-token tiles
@pytest.mark.parametrize("k2,n", [(2048, 6144), (2048, 4096), (2048, 28672),
                                  (7168, 4096), (2048, 129024), (36, 24),
                                  (100, 1040), (1002, 1000), (200, 4100),
                                  (64, 130)])
@pytest.mark.parametrize("m", [1, 8, 9, 16])
def test_int4_gemv_plan_covers_every_row_once(m, k2, n):
    pl = int4_gemv_plan(m, k2, n, H100_SMS)
    ks, chunk = pl["ks"], pl["chunk"]
    assert ks in (1, 2, 4, 8) and chunk % 64 == 0 and pl["depth"] == 64
    rows = np.zeros(k2, int)                    # each packed row: one rank
    for rank in range(ks):
        rows[rank * chunk:min(k2, (rank + 1) * chunk)] += 1
    assert (rows == 1).all() and ks * chunk >= k2
    assert (ks - 1) * chunk < k2                # every rank but maybe the
    cols = np.zeros(n, int)                     # last has rows
    for ct in range(pl["col_tiles"]):
        cols[ct * 128:min(n, (ct + 1) * 128)] += 1
    assert (cols == 1).all()
    assert pl["tokens"] == (8 if m <= 8 else 16)
    assert pl["blocks"] == pl["col_tiles"] * ks
    # at most ~4 blocks an SM, unless the packed rows are not split
    assert ks == 1 or pl["blocks"] <= 4 * H100_SMS


@pytest.mark.parametrize("k2,n,plan", [
    (2048, 6144, (8, 256, 384)),      # w_qkv: 48 column tiles
    (2048, 4096, (8, 256, 256)),      # wo: 32 column tiles, clusters of 8
    (2048, 28672, (2, 1024, 448)),    # w_gate_up: 224 column tiles
    (7168, 4096, (8, 896, 256)),      # w_down
    (2048, 129024, (1, 2048, 1008)),  # the head: 1,008 column tiles
])
def test_int4_gemv_plan_at_the_llama3_8b_decode_shapes(k2, n, plan):
    """(ks, chunk, blocks) at the 8 decode rows on 132 SMs."""
    pl = int4_gemv_plan(8, k2, n, H100_SMS)
    assert (pl["ks"], pl["chunk"], pl["blocks"]) == plan
