"""Mixtral (mixture-of-experts) in the port against the JAX package, with
weights bridged through numpy and inputs from a numpy seed.

Held: the spec tables equal to JAX's; ``ops/moe.py:moe_mlp`` equal to the
JAX ``moe_mlp(exact=True)`` within 1e-5 in fp32 and 3e-2 in bf16 (O(1)
outputs), its routing indices equal to ``lax.top_k``'s (two identical
router columns included: the lower index first), no row dropped under a
skewed router; int8 and int4 expert payloads and scales byte-equal to JAX
``quantize_params``, and the born-quantized tree's shapes and pack axes
equal to JAX's; ``forward_train`` within 1e-5 (fp32) and 2e-2 (bf16);
the engine's greedy tokens equal to the JAX ``ContinuousEngine``'s (XLA
attention) on the window decode (flash-decode's plain version), its
fused form and the ragged chunked prefill, and int8 and int4 trees
teacher-forced through the JAX ``utils/parity.py``; an HF Mixtral
directory loaded bit-equal through both loaders (and quantized a layer
at a time as it is read, bit-equal to JAX ``quantize_params``); a native
checkpoint and an int4 artifact round-tripping with the golden probe
replayed; a Mixtral behind the port worker giving the JAX
``WorkerClient`` the factory engine's tokens. The shapes are
``mixtral-tiny`` (4 layers, d 256, 4 experts, top 2) and the JAX MoE
tests' ``MOE_SPEC`` (d 64, F 96)."""

import asyncio
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import safetensors.numpy as stnp
import torch
from jax import lax

from distributed_inference_engine_tpu.cluster.worker import (
    WorkerClient as JClient,
)
from distributed_inference_engine_tpu.config import EngineConfig as JCfg
from distributed_inference_engine_tpu.engine.continuous import (
    ContinuousEngine as JEngine,
)
from distributed_inference_engine_tpu.engine.types import (
    GenerationRequest as JReq,
)
from distributed_inference_engine_tpu.models import base as jb
from distributed_inference_engine_tpu.models import llama as jllama
from distributed_inference_engine_tpu.models import loader as jl
from distributed_inference_engine_tpu.ops import moe as jmoe
from distributed_inference_engine_tpu.ops import quant as jq
from distributed_inference_engine_tpu.utils.parity import (
    assert_greedy_parity,
)
from distributed_inference_engine_tpu_torch import models as tmodels
from distributed_inference_engine_tpu_torch.bridge import (
    params_from_numpy,
    tensor_from_numpy,
    tensor_to_numpy,
)
from distributed_inference_engine_tpu_torch.cluster.worker import (
    WorkerServer,
)
from distributed_inference_engine_tpu_torch.config import (
    EngineConfig,
    ModelConfig,
    ServerConfig,
)
from distributed_inference_engine_tpu_torch.engine.artifact import (
    load_manifest,
    tree_checksum,
)
from distributed_inference_engine_tpu_torch.engine.continuous import (
    ContinuousEngine,
)
from distributed_inference_engine_tpu_torch.engine.types import (
    GenerationRequest,
)
from distributed_inference_engine_tpu_torch.models import base as tb
from distributed_inference_engine_tpu_torch.models import llama as tllama
from distributed_inference_engine_tpu_torch.models import loader as tl
from distributed_inference_engine_tpu_torch.ops import moe as tmoe
from distributed_inference_engine_tpu_torch.ops import quant as tq
from distributed_inference_engine_tpu_torch.utils import checkpoint as tck
from tests.test_torch_loader import assert_trees_bit_equal

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

VOCAB = 1024
# the JAX MoE tests' spec (tests/test_moe.py), in both packages
MOE_KW = dict(dtype="float32", max_seq_len=64, n_layers=2, d_model=64,
              n_heads=8, n_kv_heads=4, d_ff=96, vocab_size=128, n_experts=4,
              experts_per_token=2)
KW = dict(max_slots=4, max_seq_len=128, prefill_buckets=[16, 64],
          page_size=16, num_pages=48, decode_steps_per_call=4,
          kv_dtype="float32")


def _specs(size="mixtral-tiny", **kw):
    return jllama.mixtral_spec(size, **kw), tllama.mixtral_spec(size, **kw)


def _weights(seed=0, **kw):
    js, ts = _specs(**dict(dict(dtype="float32"), **kw))
    tree = jax.device_get(jb.init_params(js, jax.random.key(seed)))
    return js, ts, jax.tree_util.tree_map(jnp.asarray, tree), \
        params_from_numpy(tree, ts, "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x.float())
    return np.asarray(jnp.asarray(x, jnp.float32))


def _block(spec, seed, dtype):
    """One layer's MoE weights at 0.1 scale (O(1) outputs): a numpy tree
    in ``dtype``."""
    rs = np.random.RandomState(seed)
    D, F, E = spec.d_model, spec.d_ff, spec.n_experts

    def w(*shape):
        return (rs.randn(*shape) * 0.1).astype(np.float32).astype(dtype)

    return {"w_router": w(D, E), "w_gate": w(E, D, F), "w_up": w(E, D, F),
            "w_down": w(E, F, D)}


def _both(blk):
    return ({k: jnp.asarray(v) for k, v in blk.items()},
            {k: tensor_from_numpy(v, "cpu") for k, v in blk.items()})


def _jax_routes(spec, blk, x):
    """``lax.top_k``'s expert indices on the JAX router's probabilities."""
    xf = jnp.asarray(x, jnp.float32).reshape(-1, spec.d_model)
    probs = jax.nn.softmax(xf @ jnp.asarray(blk["w_router"], jnp.float32),
                           axis=-1)
    return np.asarray(lax.top_k(probs, spec.experts_per_token)[1])


# ------------------------------------------------------------------ specs


@pytest.mark.parametrize("size", sorted(jllama._MOE_FAMILY))
def test_spec_tables_match_jax(size):
    js, ts = _specs(size)
    assert ts.to_dict() == js.to_dict()
    assert tllama._MOE_FAMILY == jllama._MOE_FAMILY


def test_param_shapes_are_the_jax_tree():
    js, ts = _specs()
    want = jax.eval_shape(lambda: jb.init_params(js, jax.random.key(0)))
    got = tb.param_shapes(ts)
    assert {k: tuple(v.shape) for k, v in want["blocks"].items()} == \
        got["blocks"]
    assert got["blocks"]["w_router"] == (4, 256, 4)
    assert got["blocks"]["w_down"] == (4, 4, 256, 256)


# ----------------------------------------------------------------- moe_mlp


@pytest.mark.parametrize("shape,dtype,atol", [
    ("mixtral-tiny", "float32", 1e-5), ("mixtral-tiny", "bfloat16", 3e-2),
    ("moe-spec", "float32", 1e-5), ("moe-spec", "bfloat16", 3e-2)])
def test_moe_mlp_matches_jax_exact_path(shape, dtype, atol):
    """The drop-free path on the same O(1) inputs: outputs within
    ``atol`` and every row's experts equal to ``lax.top_k``'s."""
    kw = MOE_KW if shape == "moe-spec" else {}
    js, ts = _specs(**dict(kw, dtype=dtype))
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    jblk, tblk = _both(_block(js, 1, np_dt))
    x = np.random.RandomState(2).randn(3, 7, js.d_model).astype(
        np.float32).astype(np_dt)
    want, _ = jmoe.moe_mlp(js, jblk, jnp.asarray(x), exact=True)
    got = tmoe.moe_mlp(ts, tblk, tensor_from_numpy(x, "cpu"))
    assert got.dtype == tb.torch_dtype(dtype) and got.shape == x.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)
    _, _, idx = tmoe.route(tblk["w_router"], tensor_from_numpy(
        x, "cpu").reshape(-1, js.d_model), ts.experts_per_token)
    np.testing.assert_array_equal(idx.numpy(), _jax_routes(js, jblk, x))


@pytest.mark.parametrize("cols", [(1, 2), (0, 3)])
def test_router_ties_pick_the_lower_expert_as_lax_top_k(cols):
    """Two identical router columns score every row exactly alike: both
    packages rank the lower index first (and with a large column pair,
    both tied experts are the top 2)."""
    js, ts = _specs()
    blk = _block(js, 3, np.float32)
    a, b = cols
    blk["w_router"][:, b] = blk["w_router"][:, a]
    blk["w_router"][:, a] += 0.5      # the pair outranks the other experts
    blk["w_router"][:, b] = blk["w_router"][:, a]
    jblk, tblk = _both(blk)
    x = np.abs(np.random.RandomState(4).randn(2, 5, 256)).astype(np.float32)
    _, gate, idx = tmoe.route(tblk["w_router"],
                              torch.from_numpy(x).reshape(-1, 256), 2)
    want = _jax_routes(js, jblk, x)
    np.testing.assert_array_equal(want, np.broadcast_to([a, b], want.shape))
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(gate.numpy(), np.full(gate.shape, 0.5))
    out_j, _ = jmoe.moe_mlp(js, jblk, jnp.asarray(x), exact=True)
    out_t = tmoe.moe_mlp(ts, tblk, torch.from_numpy(x))
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=0, atol=1e-5)


def test_exact_never_drops_under_skew():
    """32 identical tokens route to the same experts (the JAX capacity
    path drops some at this skew); the drop-free path gives each the same
    non-zero output, equal to the JAX exact path's."""
    js, ts = _specs()
    jblk, tblk = _both(_block(js, 5, np.float32))
    x = np.broadcast_to(np.random.RandomState(6).randn(1, 1, 256),
                        (1, 32, 256)).astype(np.float32)
    got = tmoe.moe_mlp(ts, tblk, torch.from_numpy(x.copy())).numpy()
    want, _ = jmoe.moe_mlp(js, jblk, jnp.asarray(x), exact=True)
    assert np.abs(got).max() > 0
    assert np.abs(got[0] - got[0, :1]).max() == 0.0
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_capacity_dispatch_raises_naming_a13():
    ts = tllama.mixtral_spec("mixtral-tiny", n_layers=1)
    tp = tb.init_params(ts, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="A13"):
        tmoe.moe_mlp(ts, tb.layer_view(tp, 0), torch.zeros(1, 2, 256),
                     exact=False)
    assert tmoe.moe_capacity(64, 4, 2, 1.25) == jmoe.moe_capacity(
        64, 4, 2, 1.25) == 40
    assert tmoe.moe_capacity(2, 8, 2, 1.0) == 2


# ------------------------------------------------------------ quantization


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_experts_byte_equal_to_jax(bits):
    """``quantize_params`` on the same tree: every quantized leaf's
    payload, scales, bits and pack axis equal to JAX's (experts over
    their D_in, packed there for int4); the router stays full precision.
    The born-quantized tree has JAX's shapes and pack axes."""
    js, ts, jp, tp = _weights(seed=7)
    want = jax.device_get(jq.quantize_params(js, jp, bits=bits))
    got = tq.quantize_params(ts, tp, bits=bits)
    assert_trees_bit_equal(got, want)
    for name in ("w_gate", "w_up", "w_down"):
        q = got["blocks"][name]
        assert (q.bits, q.pack_axis) == (bits, want["blocks"][name].pack_axis)
        assert q.s.shape == (4, 4, 1, 256)
    assert isinstance(got["blocks"]["w_router"], torch.Tensor)
    born = tb.random_quantized_params(ts, torch.Generator().manual_seed(0),
                                      bits=bits)
    shapes = jax.eval_shape(lambda: jq.random_quantized_params(
        js, jax.random.key(0), bits=bits))
    for name, leaf in shapes["blocks"].items():
        mine = born["blocks"][name]
        if hasattr(leaf, "q"):
            assert (tuple(mine.q.shape), tuple(mine.s.shape),
                    mine.pack_axis) == (tuple(leaf.q.shape),
                                        tuple(leaf.s.shape), leaf.pack_axis)
        else:
            assert tuple(mine.shape) == tuple(leaf.shape), name
    # an int4 tree fuses q|k|v and leaves the experts' 4-D payloads alone
    prepared = tq.prepare_params(born)["blocks"]
    assert ("w_qkv" in prepared) == (bits == 4)
    assert "w_gate_up" not in prepared and "w_gate" in prepared


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_forward_train_logits(dtype, atol):
    js, ts, jp, tp = _weights(seed=8, dtype=dtype)
    rs = np.random.RandomState(9)
    toks = rs.randint(0, VOCAB, size=(2, 24)).astype(np.int32)
    lens = np.array([24, 17], np.int32)
    want = jb.forward_train(js, jp, jnp.asarray(toks), jnp.asarray(lens))
    got = tb.forward_train(ts, tp, torch.from_numpy(toks),
                           torch.from_numpy(lens))
    np.testing.assert_allclose(_np(got)[0], _np(want)[0], rtol=0, atol=atol)
    np.testing.assert_allclose(_np(got)[1, :17], _np(want)[1, :17], rtol=0,
                               atol=atol)


# ----------------------------------------------------------------- engine


def _waves():
    """Staggered waves: prompts of 9 to 45 tokens (16-token chunks
    straddle), a 45-token owner of a 2-page prefix, then a prefix hit on
    it whose 20-token tail exceeds a chunk."""
    rs = np.random.RandomState(12)
    shared = rs.randint(1, VOCAB, size=32).tolist()
    first = [dict(prompt=rs.randint(1, VOCAB, size=n).tolist(),
                  max_new_tokens=m, request_id=f"a{i}")
             for i, (n, m) in enumerate(((9, 6), (28, 4)))]
    first.append(dict(prompt=shared + rs.randint(1, VOCAB, size=13).tolist(),
                      max_new_tokens=4, request_id="owner"))
    second = [dict(prompt=shared + rs.randint(1, VOCAB, size=20).tolist(),
                   max_new_tokens=5, request_id="hit")]
    return [first, second]


def _drive(engine, req_cls, steps=3):
    out = {}
    for wave in _waves():
        for kw in wave:
            engine.submit(req_cls(**kw))
        for _ in range(steps):
            engine.step()
            out.update({r.request_id: r for r in engine.drain_finished()})
    out.update({r.request_id: r for r in engine.run_until_idle()})
    return out


@pytest.fixture(scope="module")
def served():
    """``mixtral-tiny``'s bridged fp32 weights and the JAX engine's
    results on them (XLA attention, whole prompts)."""
    js, ts, jp, tp = _weights(seed=10)
    je = JEngine(js, params=jp, config=JCfg(attention_impl="xla", **KW))
    want = _drive(je, JReq)
    assert je.get_metrics()["prefix_hit_admissions"] >= 1
    return ts, tp, want


@pytest.mark.parametrize("label,cfg", [
    ("window", dict(attention_impl="pallas-decode")),
    ("fused", dict(attention_impl="pallas-decode", decode_fused=True)),
    ("ragged chunked", dict(attention_impl="pallas-ragged",
                            prefill_chunk=16))])
def test_engine_matches_jax_engine(served, label, cfg):
    """The window decode (flash-decode's plain version), its fused form
    (the MoE MLP unfused) and the ragged mixed step with chunked prefill
    emit the JAX engine's tokens, logprobs within 1e-4."""
    ts, tp, want = served
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(
        **dict(KW, **cfg)), device="cpu")
    got = _drive(te, GenerationRequest)
    assert sorted(got) == sorted(want) and len(got) == 4
    for rid, w in want.items():
        assert got[rid].tokens == w.tokens, rid
        assert got[rid].finish_reason == w.finish_reason, rid
        np.testing.assert_allclose(got[rid].logprobs, w.logprobs, rtol=0,
                                   atol=1e-4)
    m = te.get_metrics()
    assert m["prefix_hit_admissions"] >= 1
    if label == "ragged chunked":
        assert m["mixed_steps"] > 0 and m["chunked_admissions"] >= 2


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_engine_matches_jax(bits):
    """A JAX born-quantized fp32 tree (int4 or int8), bridged: the port's
    engines (the window decode, and the ragged mixed step with chunked
    prefill) emit the JAX forward's greedy tokens on the same tree,
    teacher-forced through the JAX package's ``utils/parity.py``."""
    js, ts = _specs(dtype="float32", n_layers=2)
    jp = jq.random_quantized_params(js, jax.random.key(2), bits=bits)
    tp = params_from_numpy(jax.device_get(jp), ts, "cpu")
    rs = np.random.RandomState(13)
    # one length, so the JAX forward traces once
    prompts = [rs.randint(1, VOCAB, size=20).tolist() for _ in range(2)]
    for p, cfg in zip(prompts, (
            dict(attention_impl="pallas-decode"),
            dict(attention_impl="pallas-ragged", prefill_chunk=16))):
        te = ContinuousEngine(ts, params=tp, config=EngineConfig(
            **dict(KW, **cfg)), device="cpu")
        assert ("w_qkv" in te.params["blocks"]) == (bits == 4)
        r, = te.generate([GenerationRequest(prompt=p, max_new_tokens=8)])
        assert len(r.tokens) == 8
        assert_greedy_parity(js, jp, p, r.tokens,
                             label=f"mixtral int{bits} {cfg}")


# -------------------------------------------------------- checkpoints


def _hf_config(E=4, k=2):
    # n_kv_heads * head_dim = 128 (the JAX paged cache's rule)
    return {"architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
            "vocab_size": 300, "hidden_size": 128, "num_hidden_layers": 2,
            "num_attention_heads": 4, "num_key_value_heads": 4,
            "intermediate_size": 96, "num_local_experts": E,
            "num_experts_per_tok": k, "max_position_embeddings": 64,
            "rope_theta": 1e6, "rms_norm_eps": 1e-5}


def write_hf_mixtral(path, cfg, dtype=np.float32, seed=0):
    """An HF Mixtral-named checkpoint of ``cfg``'s widths (the router
    ``block_sparse_moe.gate`` and each expert's ``w1``/``w2``/``w3``, as
    the JAX MoE tests build one), drawn from ``seed``, plus
    ``config.json``."""
    rs = np.random.RandomState(seed)
    D, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    E, Hq = cfg["num_local_experts"], cfg["hidden_size"]
    Hkv = cfg["num_key_value_heads"] * D // cfg["num_attention_heads"]

    def w(*shape):
        return (rs.randn(*shape) * 0.05).astype(np.float32).astype(dtype)

    raw = {"model.embed_tokens.weight": w(V, D),
           "model.norm.weight": (1 + w(D)).astype(dtype),
           "lm_head.weight": w(V, D)}
    for layer in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{layer}."
        raw[p + "input_layernorm.weight"] = (1 + w(D)).astype(dtype)
        raw[p + "post_attention_layernorm.weight"] = (1 + w(D)).astype(dtype)
        raw[p + "self_attn.q_proj.weight"] = w(Hq, D)
        raw[p + "self_attn.k_proj.weight"] = w(Hkv, D)
        raw[p + "self_attn.v_proj.weight"] = w(Hkv, D)
        raw[p + "self_attn.o_proj.weight"] = w(D, Hq)
        raw[p + "block_sparse_moe.gate.weight"] = w(E, D)
        for e in range(E):
            pe = p + f"block_sparse_moe.experts.{e}."
            raw[pe + "w1.weight"] = w(F, D)
            raw[pe + "w2.weight"] = w(D, F)
            raw[pe + "w3.weight"] = w(F, D)
    stnp.save_file(raw, str(path / "model.safetensors"),
                   metadata={"format": "pt"})
    (path / "config.json").write_text(json.dumps(cfg))
    return raw


@pytest.mark.parametrize("case", ["f32", "bf16", "f32-to-bf16"])
def test_hf_mixtral_loads_bit_equal_to_jax(tmp_path, case):
    """The port's loader against the JAX loader on one HF Mixtral
    directory: equal specs and trees bit for bit (router ``[L, D, E]``,
    experts ``[L, E, ...]``, casts included); with ``bits`` each layer
    quantized as it is read, bit-equal to JAX ``quantize_params`` of its
    loaded tree once the head is quantized too."""
    raw = write_hf_mixtral(tmp_path, _hf_config(), dtype=(
        ml_dtypes.bfloat16 if case == "bf16" else np.float32))
    dtype = "float32" if case == "f32" else "bfloat16"
    js = jl.spec_from_hf_config(str(tmp_path)).replace(dtype=dtype)
    ts = tl.spec_from_hf_config(str(tmp_path)).replace(dtype=dtype)
    assert ts.to_dict() == js.to_dict()
    assert (ts.n_experts, ts.experts_per_token) == (4, 2)
    want = jl.load_checkpoint(str(tmp_path), js)
    stats = {}
    got = tl.load_checkpoint(str(tmp_path), ts, device="cpu", stats=stats)
    assert_trees_bit_equal(got, want)
    assert stats["bytes_read"] == sum(a.nbytes for a in raw.values())
    assert tuple(got["blocks"]["w_gate"].shape) == (2, 4, 128, 96)
    for bits in (4, 8):
        q = tl.load_checkpoint(str(tmp_path), ts, device="cpu", bits=bits)
        assert isinstance(q["blocks"]["w_down"], tq.QuantizedTensor)
        assert isinstance(q["blocks"]["w_router"], torch.Tensor)
        assert_trees_bit_equal(tq.quantize_params(ts, q, bits=bits),
                               jq.quantize_params(js, want, bits=bits))


def test_engine_from_hf_mixtral_dir_int4(tmp_path):
    """``quantized=1,weight_bits=4`` from an HF Mixtral directory through
    the factory: its tokens held teacher-forced to the JAX reference on
    the JAX loader's tree quantized by JAX."""
    write_hf_mixtral(tmp_path, _hf_config(), seed=5)
    eng = tmodels.engine_from_config(ModelConfig(
        name="mx", architecture="mixtral", path=str(tmp_path),
        dtype="float32", max_seq_len=64, max_batch_size=2, quantized=True,
        metadata={"continuous": True, "weight_bits": 4, "page_size": 16,
                  "num_pages": 32, "prefill_buckets": "[16, 32]"}),
        device="cpu")
    assert eng.load_info["source"] == "hf"
    js = jl.spec_from_hf_config(str(tmp_path)).replace(dtype="float32",
                                                       max_seq_len=64)
    jp = jq.quantize_params(js, jl.load_checkpoint(str(tmp_path), js), bits=4)
    rs = np.random.RandomState(6)
    prompts = [rs.randint(1, 300, size=17).tolist() for _ in range(2)]
    for p, r in zip(prompts, eng.generate(
            [GenerationRequest(prompt=p, max_new_tokens=8)
             for p in prompts])):
        assert_greedy_parity(js, jp, p, r.tokens, min_matched=2,
                             label="port mixtral int4 from HF")


def test_native_checkpoint_and_int4_artifact_round_trip(tmp_path):
    """A ``mixtral-tiny`` tree (plain and int4, 4-D expert payloads with
    their layout marker) through ``save_params``/``load_params`` bit for
    bit; an int4 artifact written by a slow-path build cold-starts the
    next one, its golden probe replayed, with the slow path's tokens."""
    ts = tllama.mixtral_spec("mixtral-tiny", dtype="float32", max_seq_len=64)
    params = tb.init_params(ts, torch.Generator().manual_seed(3))
    for tree in (params, tq.quantize_params(ts, params, bits=4)):
        path = tck.save_params(str(tmp_path / "ck"), ts, tree)
        back = tck.load_params(path, device="cpu")
        assert tck.load_spec(path).to_dict() == ts.to_dict()
        a, b = dict(tck.tree_leaves(tree)), dict(tck.tree_leaves(back))
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
        if tree is not params:
            assert back["blocks"]["w_up"].pack_axis == -2
    art = tmp_path / "art"
    cfg = ModelConfig(
        name="mx", architecture="mixtral", dtype="float32", max_seq_len=64,
        max_batch_size=2, quantized=True,
        metadata={"continuous": "1", "size": "mixtral-tiny", "seed": "3",
                  "weight_bits": "4", "page_size": "16", "num_pages": "32",
                  "prefill_buckets": "[16, 32]", "artifact": str(art)})
    slow = tmodels.engine_from_config(cfg, device="cpu")
    assert slow.artifact_manifest is None
    manifest = load_manifest(str(art))
    # w_qkv, wo, the three experts and the head
    assert manifest["quant"]["int4"] == 6
    fast = tmodels.engine_from_config(cfg, device="cpu")
    assert fast.artifact_manifest is not None
    assert "golden_probe_s" in fast.load_info
    assert tree_checksum(fast.params) == tree_checksum(slow.params)
    prompts = [[4, 9, 2], list(range(1, 30))]

    def greedy(engine):
        return [r.tokens for r in engine.generate(
            [GenerationRequest(prompt=p, max_new_tokens=6)
             for p in prompts])]

    assert greedy(fast) == greedy(slow)


# ------------------------------------------------------------- the worker


async def test_worker_serves_mixtral_through_jax_client():
    """``architecture=mixtral,size=mixtral-tiny`` through the worker's
    factory (the JAX spec): the JAX WorkerClient gets the tokens of the
    factory's engine on the same seed."""
    md = {"size": "mixtral-tiny", "continuous": "1", "seed": "4",
          "page_size": "16", "num_pages": "48",
          "prefill_buckets": "[16, 64]", "kv_dtype": "float32"}
    cfg = ModelConfig(name="mx", architecture="mixtral", dtype="float32",
                      max_seq_len=128, max_batch_size=4, metadata=md)
    ref = tmodels.engine_from_config(cfg, device="cpu")
    assert ref.spec.to_dict() == jllama.mixtral_spec(
        "mixtral-tiny", dtype="float32", max_seq_len=128).to_dict()
    assert {"w_router", "w_gate", "w_up", "w_down"} <= set(
        ref.params["blocks"])
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, VOCAB, size=n).tolist() for n in (7, 30)]
    want = ref.generate([GenerationRequest(prompt=p, max_new_tokens=6)
                         for p in prompts])
    server = WorkerServer(ServerConfig(worker_id="w0", port=0), device="cpu")
    server.load_model(cfg)
    host, port = await server.start()
    client = JClient(host, port, timeout=60.0)
    try:
        outs = await asyncio.gather(*[
            client.generate("mx", [JReq(prompt=p, max_new_tokens=6,
                                        request_id=f"m{i}")])
            for i, p in enumerate(prompts)])
        for o, w in zip(outs, want):
            assert o[0].tokens == w.tokens
    finally:
        await client.close()
        await server.stop()
