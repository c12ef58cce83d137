"""The port's weight-only quantization (``ops/quant.py``) against the JAX
package's on the same numpy inputs: quantize_weight's payload and scale
bits (rounding half to even), the nibble packing, the vocab-padded int4
head, the q|k|v and gate|up payload fusion, the born-quantized init's
statistics, int8 ``matmul_any``, and the weight bridge carrying
JAX-quantized trees (fused and unfused, int4 and int8) bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu.models import base as jb
from distributed_inference_engine_tpu.models.llama import llama_spec as jspec
from distributed_inference_engine_tpu.ops import quant as jq
from distributed_inference_engine_tpu.ops.int4_matmul import set_kernel_mode
from distributed_inference_engine_tpu_torch.bridge import (
    params_from_numpy,
    params_to_numpy,
)
from distributed_inference_engine_tpu_torch.models import base as tb
from distributed_inference_engine_tpu_torch.models.llama import (
    llama_spec as tspec,
)
from distributed_inference_engine_tpu_torch.ops import quant as tq
from distributed_inference_engine_tpu_torch.ops.int4_matmul import (
    unpack_int4,
)

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)


def _weights(shape, seed):
    rs = np.random.RandomState(seed)
    w = (rs.randn(*shape) * 0.05).astype(np.float32)
    # exact ties after scaling: the scale is max|w| / (7 or 127), so put a
    # max-magnitude entry and some x.5 multiples of the int4 step in row 0
    step = np.abs(w).max() / 7.0
    flat = w.reshape(-1)
    flat[:6] = np.float32(step) * np.array([7.0, 2.5, -1.5, 0.5, -0.5, 3.5],
                                            np.float32)
    return w


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape,axes", [((256, 384), (0,)),
                                        ((3, 128, 96), (1,)),
                                        ((2, 64, 48), (1, 2))])
def test_quantize_weight_bits_match_jax(bits, shape, axes):
    w = _weights(shape, seed=len(shape) + bits)
    j = jq.quantize_weight(jnp.asarray(w), axes, bits=bits)
    t = tq.quantize_weight(torch.from_numpy(w), axes, bits=bits)
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(t.s.numpy().view(np.uint32),
                                  np.asarray(j.s).view(np.uint32))
    assert (t.bits, t.pack_axis) == (j.bits, j.pack_axis)
    assert t.shape == tuple(j.shape) == shape
    np.testing.assert_array_equal(t.dequantize().numpy(),
                                  np.asarray(j.dequantize()))


def test_pack_round_trip():
    rs = np.random.RandomState(1)
    lo = torch.from_numpy(rs.randint(-8, 8, size=(64, 40)).astype(np.int8))
    hi = torch.from_numpy(rs.randint(-8, 8, size=(64, 40)).astype(np.int8))
    packed = tq.pack_int4(lo, hi)
    assert packed.dtype == torch.int8
    ulo, uhi = unpack_int4(packed)
    assert torch.equal(ulo.to(torch.int8), lo)
    assert torch.equal(uhi.to(torch.int8), hi)
    # the JAX payload unpacks to the same values at the original shape
    w = _weights((128, 40), seed=2)
    j = jq.quantize_weight(jnp.asarray(w), (0,), bits=4)
    t = tq.quantize_weight(torch.from_numpy(w), (0,), bits=4)
    np.testing.assert_array_equal(t.unpacked().numpy(),
                                  np.asarray(j._unpacked_int8()))
    assert torch.equal(tq.pack_int4(*t.unpacked().chunk(2, dim=0)), t.q)


@pytest.fixture(scope="module")
def tiny():
    js = jspec("llama-tiny", dtype="float32")
    ts = tspec("llama-tiny", dtype="float32")
    jp = jb.init_params(js, jax.random.key(0))
    return js, ts, jp, params_from_numpy(jax.device_get(jp), ts, "cpu")


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_params_matches_jax_and_pads_the_head(tiny, bits):
    js, ts, jp, tp = tiny
    jtree = jax.device_get(jq.quantize_params(js, jp, bits=bits))
    ttree = tq.quantize_params(ts, tp, bits=bits)
    back = params_to_numpy(ttree)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(back["blocks"][name].q,
                                      jtree["blocks"][name].q)
        np.testing.assert_array_equal(back["blocks"][name].s,
                                      jtree["blocks"][name].s)
    head = ttree["lm_head"]
    v = ts.vocab_size
    assert head.shape == ((ts.d_model, 2048) if bits == 4
                          else (ts.d_model, v))
    np.testing.assert_array_equal(back["lm_head"].q, jtree["lm_head"].q)
    h = torch.from_numpy(np.random.RandomState(3).randn(
        5, ts.d_model).astype(np.float32))
    full = tq.matmul_any(h, head)
    if bits == 4:
        assert float(full[:, v:].abs().max()) == 0.0     # pad columns
    logits = tb.unembed(ts, ttree, h[:, None])[:, 0]
    assert logits.shape == (5, v)
    want = jb.unembed(js, jq.quantize_params(js, jp, bits=bits),
                      jnp.asarray(h.numpy())[:, None])[:, 0]
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_fuse_block_weights():
    ts = tspec("llama-tiny", dtype="float32")
    tp = tb.init_params(ts, torch.Generator().manual_seed(0))
    q4 = tq.quantize_params(ts, tp, bits=4)
    fused = tq.fuse_block_weights(q4)
    blk = fused["blocks"]
    assert "w_qkv" in blk and "w_gate_up" in blk
    assert not {"wq", "wk", "wv", "w_gate", "w_up"} & set(blk)
    L, D, F = ts.n_layers, ts.d_model, ts.d_ff
    qkv_n = (ts.n_heads + 2 * ts.n_kv_heads) * ts.head_dim
    assert blk["w_qkv"].q.shape == (L, D // 2, qkv_n)
    assert blk["w_qkv"].s.shape == (L, 1, qkv_n)
    assert blk["w_gate_up"].q.shape == (L, D // 2, 2 * F)
    assert tq.fuse_block_weights(fused) is fused            # idempotent
    # int8 and plain trees are left as they are
    assert tq.fuse_block_weights(tp) is tp
    q8 = tq.quantize_params(ts, tp, bits=8)
    assert tq.fuse_block_weights(q8) is q8
    x = torch.from_numpy(np.random.RandomState(4).randn(
        3, D).astype(np.float32))
    for layer in (0, L - 1):
        one = tb.layer_view(q4, layer)
        got = tq.matmul_any(x, tb.layer_view(fused, layer)["w_gate_up"])
        want = torch.cat([tq.matmul_any(x, one["w_gate"]),
                          tq.matmul_any(x, one["w_up"])], dim=-1)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        got = tq.matmul_any(x, tb.layer_view(fused, layer)["w_qkv"])
        want = torch.cat([tq.matmul_any(x, one[m])
                          for m in ("wq", "wk", "wv")], dim=-1)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bits", [4, 8])
def test_random_quantized_params_statistics(bits):
    ts = tspec("llama-tiny", dtype="float32")
    p = tb.random_quantized_params(ts, torch.Generator().manual_seed(5),
                                   bits=bits)
    ref = tb.init_params(ts, torch.Generator().manual_seed(0))
    assert set(p["blocks"]) == set(ref["blocks"]) and set(p) == set(ref)
    bound = 7 if bits == 4 else 127
    for name in ("wq", "wo", "w_gate", "w_down"):
        qt = p["blocks"][name]
        assert isinstance(qt, tq.QuantizedTensor) and qt.bits == bits
        assert qt.shape == tuple(ref["blocks"][name].shape)
        vals = qt.unpacked()
        assert int(vals.min()) >= -bound and int(vals.max()) <= bound
        std = float(qt.dequantize().std())
        assert abs(std / 0.02 - 1.0) < 0.05, (name, std)
    head = p["lm_head"]
    assert head.shape == ((ts.d_model, 2048) if bits == 4
                          else (ts.d_model, ts.vocab_size))
    assert torch.equal(p["blocks"]["ln1_scale"],
                       torch.ones_like(ref["blocks"]["ln1_scale"]))
    assert tq.param_bytes(p) < tq.param_bytes(ref)


def _jax_tree(js, bits, fused):
    tree = jq.random_quantized_params(js, jax.random.key(2), bits=bits)
    if fused:
        set_kernel_mode("on")
        try:
            tree = jq.prepare_params(tree)
        finally:
            set_kernel_mode("auto")
    return jax.device_get(tree)


@pytest.mark.parametrize("bits,fused", [(4, True), (4, False), (8, False)])
def test_bridge_carries_jax_quantized_trees(bits, fused):
    """The JAX engine's trees — fused where its kernel is on (a tileable
    tiny variant), unfused under "auto" — cross bit for bit, the padded
    int4 head included, and come back unchanged."""
    js = jspec("llama-tiny", dtype="float32").replace(d_ff=512)
    ts = tspec("llama-tiny", dtype="float32").replace(d_ff=512)
    tree = _jax_tree(js, bits, fused)
    assert ("w_qkv" in tree["blocks"]) == fused
    assert ("w_gate_up" in tree["blocks"]) == fused
    tp = params_from_numpy(tree, ts, "cpu")
    back = params_to_numpy(tp)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == (14 if fused else 20)
    for path, leaf in flat:
        node = back
        for k in path:         # dict keys, then (q, s) of a quantized leaf
            node = ((node.q, node.s)[k.key]
                    if isinstance(node, tq.QuantizedTensor) else node[k.key])
        np.testing.assert_array_equal(node, np.asarray(leaf))
    if bits == 4:
        assert tp["lm_head"].q.shape == (js.d_model // 2, 2048)
    # the port's own preparation fuses the unfused int4 tree the same way
    prepared = tq.prepare_params(tp)
    assert ("w_qkv" in prepared["blocks"]) == (bits == 4)
    if bits == 4 and not fused:
        jf = _jax_tree(js, bits, True)["blocks"]
        for name in ("w_qkv", "w_gate_up"):
            np.testing.assert_array_equal(
                prepared["blocks"][name].q.numpy(), jf[name].q)
            np.testing.assert_array_equal(
                prepared["blocks"][name].s.numpy(), jf[name].s)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_int8_matmul_any_matches_jax(dtype, atol):
    w = _weights((256, 96), seed=8)
    j = jq.quantize_weight(jnp.asarray(w), (0,), bits=8)
    t = tq.quantize_weight(torch.from_numpy(w), (0,), bits=8)
    x = np.random.RandomState(9).randn(2, 7, 256).astype(np.float32)
    want = jq.matmul_any("btd,df->btf", jnp.asarray(x, dtype), j)
    got = tq.matmul_any(torch.from_numpy(x).to(getattr(torch, dtype)), t)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=atol,
                               atol=atol)
