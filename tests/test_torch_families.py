"""The dense families beyond Llama and Mistral in the port (Qwen2, Gemma,
GPT-2, with the logit softcap) against the JAX package, with weights
bridged through numpy and inputs from a numpy seed.

The tiny specs keep each family's quirks and meet the JAX paged cache's
rule (``n_kv_heads * head_dim % 128 == 0``): a Qwen with 14 query heads
over 2 KV heads of 64 (G = 7, as Qwen2-7B), ``gemma-tiny`` with 4 KV
heads, and a GPT-2 of 2 layers at ``d_model`` 128 with 4 heads. Biases,
LayerNorm shifts and norm scales are drawn away from their init values
(zeros and ones), so every bias and scale reaches the logits.

Held: every spec table equal to JAX's; ``layer_norm`` within 1e-6 in
fp32; ``forward_train`` logits within 1e-5 in fp32 and 2e-2 in bf16;
the softcap bounding the logits as JAX's does; learned positions past
the table clamped as JAX clamps; the engine's greedy tokens (and
logprobs within 1e-4) equal to the JAX ``ContinuousEngine``'s (XLA
attention) on the window decode (fused off and on), the writeback
decode, the inline paged decode, the window scheme through the paged
kernel and the ragged chunked prefill, and with int8 and int4 weights on
Qwen and Gemma; the fused decode seams taking the unfused chain for
biases and LayerNorm, and for a MoE (Mixtral) MLP; the factory and the
worker selecting each architecture as JAX does, Mixtral included."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu import models as jmodels
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
from distributed_inference_engine_tpu.models import gemma as jgemma
from distributed_inference_engine_tpu.models import gpt2 as jgpt2
from distributed_inference_engine_tpu.models import llama as jllama
from distributed_inference_engine_tpu.models import qwen as jqwen
from distributed_inference_engine_tpu.ops import norms as jnorms
from distributed_inference_engine_tpu.ops import quant as jq
from distributed_inference_engine_tpu.utils.parity import (
    assert_greedy_parity,
)
from distributed_inference_engine_tpu_torch import models as tmodels
from distributed_inference_engine_tpu_torch.bridge import (
    params_from_numpy,
    params_to_numpy,
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
from distributed_inference_engine_tpu_torch.engine.continuous import (
    ContinuousEngine,
)
from distributed_inference_engine_tpu_torch.engine.types import (
    GenerationRequest,
)
from distributed_inference_engine_tpu_torch.models import base as tb
from distributed_inference_engine_tpu_torch.models import gemma as tgemma
from distributed_inference_engine_tpu_torch.models import gpt2 as tgpt2
from distributed_inference_engine_tpu_torch.models import llama as tllama
from distributed_inference_engine_tpu_torch.models import qwen as tqwen
from distributed_inference_engine_tpu_torch.ops import norms as tnorms
from distributed_inference_engine_tpu_torch.ops import quant as tq

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

# family -> (JAX factory, port factory, tiny size, overrides)
TINY = {
    "qwen": (jqwen.qwen_spec, tqwen.qwen_spec, "qwen-tiny",
             dict(n_heads=14, n_kv_heads=2, head_dim_override=64)),
    "gemma": (jgemma.gemma_spec, tgemma.gemma_spec, "gemma-tiny",
              dict(n_kv_heads=4)),
    "gpt2": (jgpt2.gpt2_spec, tgpt2.gpt2_spec, "gpt2",
             dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                  d_ff=512, vocab_size=1024, max_seq_len=128)),
}
FAMILIES = sorted(TINY)
VOCAB = 1024

KW = dict(max_slots=4, max_seq_len=128, prefill_buckets=[16, 64],
          page_size=16, num_pages=48, decode_steps_per_call=4,
          kv_dtype="float32")


def _specs(family, dtype="float32", **extra):
    jf, tf, size, over = TINY[family]
    kw = dict(over, dtype=dtype, **extra)
    return jf(size, **kw), tf(size, **kw)


def _perturb(tree, seed):
    """Biases and LayerNorm shifts drawn at 0.1 scale, norm scales at
    1 +- 0.1 (numpy leaves, in the leaf's dtype)."""
    rs = np.random.RandomState(seed)

    def leaf(name, a):
        a = np.asarray(a)
        if "bias" in name or name in ("bq", "bk", "bv", "bo", "b_up",
                                      "b_down"):
            return (rs.randn(*a.shape) * 0.1).astype(a.dtype)
        if name.endswith("_scale"):
            return (1.0 + rs.randn(*a.shape) * 0.1).astype(a.dtype)
        return a

    out = {k: leaf(k, v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = {k: leaf(k, v) for k, v in tree["blocks"].items()}
    return out


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _weights(family, dtype="float32", seed=0, **extra):
    js, ts = _specs(family, dtype, **extra)
    tree = _perturb(jax.device_get(jb.init_params(js, jax.random.key(seed))),
                    seed + 1)
    return js, ts, _jax_tree(tree), params_from_numpy(tree, ts, "cpu")


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x.float())
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ specs


@pytest.mark.parametrize("family,size", [
    (f, s) for f, mod in (("qwen", jqwen), ("gemma", jgemma),
                          ("gpt2", jgpt2)) for s in sorted(mod._FAMILY)])
def test_spec_tables_match_jax(family, size):
    jf, tf = TINY[family][:2]
    assert tf(size).to_dict() == jf(size).to_dict()
    assert tf(size, max_seq_len=64).to_dict() == jf(
        size, max_seq_len=64).to_dict()


def test_spec_for_architecture_selects_as_jax():
    for arch, size in (("qwen", ""), ("qwen2-0.5b", ""), ("qwen", "qwen2-1.5b"),
                       ("gemma", ""), ("gemma-2b", ""), ("gpt2", ""),
                       ("gpt2-medium", ""), ("gpt2", "gpt2-xl"),
                       ("llama", ""), ("mistral-7b-v01", ""), ("mixtral", ""),
                       ("mixtral-8x7b", ""), ("mixtral-tiny", ""),
                       ("mixtral", "mixtral-small")):
        want = jmodels.spec_for_architecture(arch, size=size,
                                             max_seq_len=512)
        got = tmodels.spec_for_architecture(arch, size=size, max_seq_len=512)
        assert got.to_dict() == want.to_dict(), (arch, size)
    for bad in ("gpt2-huge", "falcon"):
        with pytest.raises(ValueError):
            jmodels.spec_for_architecture(bad)
        with pytest.raises(ValueError):
            tmodels.spec_for_architecture(bad)
    assert tmodels.spec_for_architecture("mixtral-tiny").n_experts == 4


def test_layer_norm_matches_jax():
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 7, 128) * 3 + 1).astype(np.float32)
    g = rs.randn(128).astype(np.float32)
    b = rs.randn(128).astype(np.float32)
    got = tnorms.layer_norm(_t(x), _t(g), _t(b), 1e-5)
    want = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                             1e-5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6)
    got16 = tnorms.layer_norm(_t(x).bfloat16(), _t(g), _t(b), 1e-5)
    want16 = jnorms.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g),
                               jnp.asarray(b), 1e-5)
    np.testing.assert_allclose(_np(got16), _np(want16), rtol=0, atol=2e-2)


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_train_logits(family, dtype, atol):
    js, ts, jp, tp = _weights(family, dtype, seed=3)
    rs = np.random.RandomState(4)
    toks = rs.randint(1, VOCAB, size=(2, 21)).astype(np.int32)
    lens = np.array([21, 12], np.int32)
    want = _np(jb.forward_train(js, jp, jnp.asarray(toks),
                                jnp.asarray(lens)))
    got = _np(tb.forward_train(ts, tp, _t(toks), lens))
    np.testing.assert_allclose(got[0], want[0], rtol=atol, atol=atol)
    np.testing.assert_allclose(got[1, :12], want[1, :12], rtol=atol,
                               atol=atol)


def test_bridge_round_trip_and_trees():
    """Each family's JAX tree bridges bit for bit (no ``lm_head`` where
    the embeddings are tied), and the port's own init and born-quantized
    trees have the JAX trees' leaves and shapes."""
    for family in FAMILIES:
        js, ts = _specs(family, "bfloat16")
        tree = jax.device_get(jb.init_params(js, jax.random.key(1)))
        back = params_to_numpy(params_from_numpy(tree, ts, "cpu"))
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            node = back
            for k in path:
                node = node[k.key]
            want = np.asarray(leaf)
            if want.dtype.name == "bfloat16":
                want = want.view(np.uint16)
            np.testing.assert_array_equal(node, want)
        assert ("lm_head" in tree) == (not js.tie_embeddings)

        def shapes(t):
            return {k: shapes(v) if isinstance(v, dict) else tuple(
                v.q.shape if hasattr(v, "q") else v.shape)
                for k, v in t.items()}

        ours = tb.init_params(ts, torch.Generator().manual_seed(0))
        assert shapes(params_to_numpy(ours)) == shapes(tree)
        for bits in (4, 8):
            jqt = jax.eval_shape(lambda: jq.random_quantized_params(
                js, jax.random.key(0), bits=bits))
            tqt = tb.random_quantized_params(
                ts, torch.Generator().manual_seed(0), bits=bits)
            assert shapes(params_to_numpy(tqt)) == shapes(jqt)
            zero = [k for k in tqt["blocks"] if k.startswith("b")
                    or "bias" in k]
            assert all(not tqt["blocks"][k].any() for k in zero)


def test_softcap_bounds_the_logits_as_jax():
    cap = 0.5
    js, ts, jp, tp = _weights("gemma", logit_softcap=cap, seed=5)
    rs = np.random.RandomState(6)
    h = (rs.randn(3, 4, js.d_model) * 4).astype(np.float32)
    want = _np(jb.unembed(js, jp, jnp.asarray(h)))
    got = _np(tb.unembed(ts, tp, _t(h)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got).max() <= cap and np.abs(got).max() > 0.9 * cap
    toks = rs.randint(1, VOCAB, size=(1, 9)).astype(np.int32)
    np.testing.assert_allclose(
        _np(tb.forward_train(ts, tp, _t(toks), np.array([9], np.int32))),
        _np(jb.forward_train(js, jp, jnp.asarray(toks),
                             jnp.asarray([9], jnp.int32))),
        rtol=0, atol=1e-6)


def test_learned_positions_past_the_table_clamp_as_jax():
    js, ts, jp, tp = _weights("gpt2", seed=7)
    toks = np.array([[1, 2, 3, 4, 5]], np.int32)
    pos = np.array([[0, 126, 127, 128, 4000]], np.int32)
    want = _np(jb.embed(js, jp, jnp.asarray(toks), jnp.asarray(pos)))
    got = _np(tb.embed(ts, tp, _t(toks), _t(pos)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[0, 3] - got[0, 2],
                               _np(tp["tok_emb"][4] - tp["tok_emb"][3]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("family", FAMILIES)
def test_fused_seams_take_the_unfused_chain(family, monkeypatch):
    """decode_fused on a window step takes each fused seam only where the
    JAX seam does: Qwen's q/k/v biases keep ln1 + QKV unfused (its output
    projection and MLP fuse), GPT-2's LayerNorm and biases keep every
    seam unfused (logits equal to the unfused step's), Gemma (RMSNorm
    over 1 + w, no bias) fuses all three; the unfused step's logits are
    the JAX step's."""
    js, ts, jp, tp = _weights(family, seed=8)
    calls = {"norm_matmul": 0, "matmul_residual": 0}
    for name in calls:
        real = getattr(tb, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tb, name, spy)
    rs = np.random.RandomState(9)
    b, w, n, p = 3, 4, 12, 16
    L, fused_w = ts.n_layers, ts.n_kv_heads * ts.head_dim
    step = (rs.randint(1, VOCAB, size=(b,)).astype(np.int32),     # tokens
            np.array([0, 6, 42], np.int32),                         # lengths
            np.array([0, 5, 40], np.int32),                         # start
            rs.randn(L, n, p, fused_w).astype(np.float32),          # pools
            rs.randn(L, n, p, fused_w).astype(np.float32),
            rs.randint(0, n, size=(b, 4)).astype(np.int32),         # table
            rs.randn(L, b, w, ts.n_kv_heads, ts.head_dim).astype(np.float32),
            rs.randn(L, b, w, ts.n_kv_heads, ts.head_dim).astype(np.float32),
            np.array([True, True, False]))                          # active
    outs = []
    for fused in (False, True):
        x, _, _ = tb.forward_decode_window(
            ts, tp, *(torch.from_numpy(a.copy()) for a in step),
            fused=fused)
        outs.append(_np(tb.unembed(ts, tp, x)))
    per_layer = {"gemma": (5, 2), "qwen": (2, 2), "gpt2": (0, 0)}[family]
    assert (calls["norm_matmul"], calls["matmul_residual"]) == tuple(
        n * L for n in per_layer)
    if family == "gpt2":
        np.testing.assert_array_equal(outs[1], outs[0])
    else:
        np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-5)
    # and the JAX step's logits, on its XLA path
    jx, _, _ = jb.forward_decode_window(
        js, jp, *(jnp.asarray(a) for a in step), attn_impl="xla")
    np.testing.assert_allclose(outs[0], _np(jb.unembed(js, jp, jx)),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("tree", ["plain", "int4"])
def test_fused_seams_leave_the_moe_mlp_unfused(tree, monkeypatch):
    """decode_fused with experts (``mixtral-tiny``): the MoE MLP takes no
    fused seam (JAX ``models/base.py``'s ``not spec.n_experts``); a plain
    tree still folds ln1 into q/k/v (3 ``norm_matmul`` a layer) and the
    residual into the output projection (1 ``matmul_residual``), as JAX
    does, and an int4 tree (q|k|v fused, the experts' 4-D payloads) takes
    neither. The fused step's logits equal the unfused one's, and an int4
    ``decode_fused=True`` engine emits the unfused engine's tokens with no
    fused launch."""
    js = jllama.mixtral_spec("mixtral-tiny", dtype="float32")
    ts = tllama.mixtral_spec("mixtral-tiny", dtype="float32")
    jp = (jb.init_params(js, jax.random.key(8)) if tree == "plain" else
          jq.random_quantized_params(js, jax.random.key(8), bits=4))
    tp = tq.prepare_params(params_from_numpy(jax.device_get(jp), ts, "cpu"))
    calls = {"norm_matmul": 0, "matmul_residual": 0}
    for name in calls:
        real = getattr(tb, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tb, name, spy)
    rs = np.random.RandomState(9)
    b, w, n, p = 3, 4, 12, 16
    L, fused_w = ts.n_layers, ts.n_kv_heads * ts.head_dim
    step = (rs.randint(1, VOCAB, size=(b,)).astype(np.int32),
            np.array([0, 6, 42], np.int32), np.array([0, 5, 40], np.int32),
            rs.randn(L, n, p, fused_w).astype(np.float32),
            rs.randn(L, n, p, fused_w).astype(np.float32),
            rs.randint(0, n, size=(b, 4)).astype(np.int32),
            rs.randn(L, b, w, ts.n_kv_heads, ts.head_dim).astype(np.float32),
            rs.randn(L, b, w, ts.n_kv_heads, ts.head_dim).astype(np.float32),
            np.array([True, True, False]))
    outs = []
    for fused in (False, True):
        x, _, _ = tb.forward_decode_window(
            ts, tp, *(torch.from_numpy(a.copy()) for a in step),
            fused=fused)
        outs.append(_np(tb.unembed(ts, tp, x)))
    per_layer = (3, 1) if tree == "plain" else (0, 0)
    assert (calls["norm_matmul"], calls["matmul_residual"]) == tuple(
        k * L for k in per_layer)
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-5)
    if tree == "plain":
        jx, _, _ = jb.forward_decode_window(
            js, jp, *(jnp.asarray(a) for a in step), attn_impl="xla")
        np.testing.assert_allclose(outs[0], _np(jb.unembed(js, jp, jx)),
                                   rtol=0, atol=1e-4)
        return
    prompts = [rs.randint(1, VOCAB, size=n).tolist() for n in (9, 30)]
    tokens = []
    for fused in (False, True):
        te = ContinuousEngine(ts, params=tp, config=EngineConfig(
            attention_impl="pallas-decode", decode_fused=fused, **KW),
            device="cpu")
        before = dict(calls)
        tokens.append([r.tokens for r in te.generate(
            [GenerationRequest(prompt=q, max_new_tokens=6)
             for q in prompts])])
        assert calls == before
    assert tokens[1] == tokens[0]


# ----------------------------------------------------------------- engine


def _waves():
    """Staggered waves: prompts of 9 to 45 tokens (16-token chunks
    straddle), a 45-token owner of a 2-page prefix, then a prefix hit on
    it whose 20-token tail exceeds a chunk (after the owner's last
    chunk)."""
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


@pytest.fixture(scope="module", params=FAMILIES)
def served(request):
    """A family's bridged fp32 weights (Gemma with a softcap of 30) and
    the JAX engine's results on them (XLA attention, whole prompts)."""
    family = request.param
    extra = dict(logit_softcap=30.0) if family == "gemma" else {}
    js, ts, jp, tp = _weights(family, seed=10, **extra)
    je = JEngine(js, params=jp, config=JCfg(attention_impl="xla", **KW))
    want = _drive(je, JReq)
    assert je.get_metrics()["prefix_hit_admissions"] >= 1
    return family, ts, tp, want


@pytest.mark.parametrize("label,cfg", [
    ("window", dict()),
    ("fw", dict(attention_impl="pallas-decode-fw")),
    ("inline", dict(decode_mode="inline")),
    ("ragged chunked", dict(attention_impl="pallas-ragged",
                            prefill_chunk=16))])
def test_engine_matches_jax_engine(served, label, cfg):
    """The window decode (flash-decode), its writeback form, the inline
    paged decode and the ragged mixed step with chunked prefill (the
    kernels' plain versions on the CPU) emit the JAX engine's tokens,
    logprobs within 1e-4: G = 7 (Qwen), Gemma's quirks and softcap,
    GPT-2's learned positions, LayerNorm and biases."""
    family, ts, tp, want = served
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
    assert m["decode_mode"] == ("inline" if label == "inline" else "window")
    if label == "ragged chunked":
        assert m["mixed_steps"] > 0 and m["chunked_admissions"] >= 2


@pytest.mark.parametrize("family,bits", [
    (f, bits) for f in ("qwen", "gemma") for bits in (4, 8)])
def test_quantized_engine_matches_jax(family, bits):
    """A JAX born-quantized fp32 tree (int4 or int8) of tiny Qwen (G = 7)
    or Gemma, bridged: the port's engine (flash-decode, the int4 matmul's
    plain version) emits the JAX forward's greedy tokens on the same tree,
    teacher-forced through the JAX package's ``utils/parity.py``."""
    js, ts = _specs(family)
    jp = jq.random_quantized_params(js, jax.random.key(2), bits=bits)
    tp = params_from_numpy(jax.device_get(jp), ts, "cpu")
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(
        attention_impl="pallas-decode", **KW), device="cpu")
    # Qwen's q/k/v biases block the q|k|v int4 fusion, as in JAX
    assert ("w_qkv" in te.params["blocks"]) == (bits == 4
                                                and family == "gemma")
    assert ("w_gate_up" in te.params["blocks"]) == (bits == 4)
    # one length, so the JAX forward compiles once
    rs = np.random.RandomState(13)
    prompts = [rs.randint(1, VOCAB, size=20).tolist() for _ in range(2)]
    for p, r in zip(prompts, te.generate([
            GenerationRequest(prompt=p, max_new_tokens=8) for p in prompts])):
        assert len(r.tokens) == 8
        assert_greedy_parity(js, jp, p, r.tokens, label=f"{family} int{bits}")


# ------------------------------------------------------------ the factory


def test_engine_from_config_builds_each_family():
    """The factory builds each family from its architecture string as
    JAX does (the spec, the tree without ``lm_head`` when tied); JAX's
    paged-layout rule refuses ``gemma-tiny`` (1 KV head of 32) in both;
    Mixtral (``mixtral-tiny``) builds, plain and born int4."""
    base = dict(max_seq_len=64, max_batch_size=2, dtype="bfloat16")
    md = {"continuous": "1", "num_pages": "8", "page_size": "16",
          "prefill_buckets": "[16, 64]"}
    for arch, size in (("qwen", "qwen-tiny"), ("gpt2", "")):
        cfg = ModelConfig(name="m", architecture=arch,
                          metadata=dict(md, size=size), **base)
        eng = tmodels.engine_from_config(cfg, device="cpu")
        want = jmodels.spec_for_architecture(arch, size=size, max_seq_len=64)
        assert eng.spec.to_dict() == dict(want.to_dict(), dtype="bfloat16")
        assert ("lm_head" in eng.params) == (not want.tie_embeddings)
    cfg = ModelConfig(name="m", architecture="gemma",
                      metadata=dict(md, size="gemma-tiny"), **base)
    with pytest.raises(ValueError, match="multiple of 128"):
        tmodels.engine_from_config(cfg, device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        JEngine(jmodels.spec_for_architecture("gemma", "gemma-tiny"),
                config=JCfg(**dict(KW, num_pages=8)))
    for arch, size, quantized in (("mixtral", "mixtral-tiny", False),
                                  ("mixtral-tiny", "", True)):
        cfg = ModelConfig(name="m", architecture=arch, quantized=quantized,
                          metadata=dict(md, size=size, weight_bits="4"),
                          **base)
        eng = tmodels.engine_from_config(cfg, device="cpu")
        want = jmodels.spec_for_architecture(arch, size=size, max_seq_len=64)
        assert eng.spec.to_dict() == dict(want.to_dict(), dtype="bfloat16")
        up = eng.params["blocks"]["w_up"]
        # born quantized: the experts' int4 payload packed on each D_in
        assert (up.q.shape if quantized else up.shape) == (
            (4, 4, 128, 256) if quantized else (4, 4, 256, 256))


async def test_worker_serves_qwen_through_jax_client():
    """``architecture=qwen,size=qwen-tiny`` through the worker's factory
    (the JAX spec, q/k/v biases): the JAX WorkerClient gets the tokens of
    the factory's engine on the same seed."""
    md = {"size": "qwen-tiny", "continuous": "1", "seed": "4",
          "page_size": "16", "num_pages": "48",
          "prefill_buckets": "[16, 64]", "kv_dtype": "float32"}
    cfg = ModelConfig(name="qw", architecture="qwen", dtype="float32",
                      max_seq_len=128, max_batch_size=4, metadata=md)
    ref = tmodels.engine_from_config(cfg, device="cpu")
    assert {"bq", "bk", "bv"} <= set(ref.params["blocks"])
    assert ref.spec.to_dict() == jqwen.qwen_spec(
        "qwen-tiny", dtype="float32", max_seq_len=128).to_dict()
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
            client.generate("qw", [JReq(prompt=p, max_new_tokens=6,
                                        request_id=f"q{i}")])
            for i, p in enumerate(prompts)])
        for o, w in zip(outs, want):
            assert o[0].tokens == w.tokens
    finally:
        await client.close()
        await server.stop()
