"""The port's speculative decoding (A12) against the JAX package, on the
CPU: the counterpart of ``tests/test_speculative.py``.

The contract: greedy speculative output is the target's own greedy chain
for any draft and any k. So the port's ``SpeculativeEngine`` (llama-tiny
fp32, bridged weights, k 1-4, ``rounds_per_call`` 1 and 4) emits the port's
and the JAX static engines' tokens, and the JAX ``SpeculativeEngine``'s
with the same draft (its metrics keys too); an identical draft accepts
everything but the last round's clip; ``truncated_draft`` and
``scale_top_blocks`` give the JAX functions' trees leaf for leaf (plain
and quantized). Also: eos, int4 target with its truncated self-draft,
e4m3 caches against the JAX speculative engine, bf16 held teacher-forced
through the JAX ``assert_greedy_parity``, one packed host read per call,
sampled runs seeded (top-k 1 is the greedy chain, a small top-p keeps
the target's support), the JAX engine's errors, and the factory's
speculative branch with its errors (sp/dp as JAX, tp naming A13, an
artifact refused).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu.config import EngineConfig as JCfg
from distributed_inference_engine_tpu.engine import speculative as jspec_mod
from distributed_inference_engine_tpu.engine.engine import Engine as JEngine
from distributed_inference_engine_tpu.engine.types import (
    GenerationRequest as JReq,
)
from distributed_inference_engine_tpu.models import base as jb
from distributed_inference_engine_tpu.models.llama import llama_spec as jspec
from distributed_inference_engine_tpu.ops import quant as jq
from distributed_inference_engine_tpu.utils.parity import (
    assert_greedy_parity,
)
from distributed_inference_engine_tpu_torch import bridge
from distributed_inference_engine_tpu_torch.config import (
    EngineConfig,
    ModelConfig,
)
from distributed_inference_engine_tpu_torch.engine import speculative as tsm
from distributed_inference_engine_tpu_torch.engine.engine import Engine
from distributed_inference_engine_tpu_torch.engine.speculative import (
    SpeculativeEngine,
    scale_top_blocks,
    truncated_draft,
)
from distributed_inference_engine_tpu_torch.engine.types import (
    GenerationRequest,
)
from distributed_inference_engine_tpu_torch.models import base as tb
from distributed_inference_engine_tpu_torch.models import engine_from_config
from distributed_inference_engine_tpu_torch.models.llama import (
    llama_spec as tspec,
)
from distributed_inference_engine_tpu_torch.ops.quant import QuantizedTensor
from distributed_inference_engine_tpu_torch.ops.sampling import (
    SamplingParams,
    masked_sampling_probs,
)

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

DRAFT_KW = dict(max_seq_len=128, n_layers=2, d_model=128, n_heads=4,
                n_kv_heads=2, d_ff=256)
CFG = dict(max_slots=4, max_seq_len=128, kv_dtype="float32")


def _reqs(cls, **kw):
    return [cls(prompt=[1, 2, 3, 4, 5], max_new_tokens=16, request_id="a",
                **kw),
            cls(prompt=[9, 8, 7], max_new_tokens=12, request_id="b", **kw)]


def _toks(results):
    return {r.request_id: r.tokens for r in results}


@pytest.fixture(scope="module")
def w():
    """llama-tiny fp32 target and an independent 2-layer d128 draft: JAX
    specs and params, port specs and bridged params; and the JAX static
    engine's greedy tokens."""
    js = jspec("llama-tiny", max_seq_len=128, dtype="float32")
    ts = tspec("llama-tiny", max_seq_len=128, dtype="float32")
    jds = jspec("llama-tiny", dtype="float32", **DRAFT_KW)
    tds = tspec("llama-tiny", dtype="float32", **DRAFT_KW)
    jp = jb.init_params(js, jax.random.key(0))
    jdp = jb.init_params(jds, jax.random.key(100))
    tp = bridge.params_from_numpy(jax.device_get(jp), ts, "cpu")
    tdp = bridge.params_from_numpy(jax.device_get(jdp), tds, "cpu")
    want = _toks(JEngine(js, params=jp, config=JCfg(**CFG)).generate(
        _reqs(JReq)))
    return dict(js=js, ts=ts, jds=jds, tds=tds, jp=jp, jdp=jdp, tp=tp,
                tdp=tdp, want=want)


def _spec(w, k, rounds=4, draft=None, **kw):
    ds, dp = draft or (w["tds"], w["tdp"])
    return SpeculativeEngine(w["ts"], ds, params=w["tp"], draft_params=dp,
                             config=EngineConfig(**CFG), speculate_k=k,
                             rounds_per_call=rounds, device="cpu", **kw)


@pytest.mark.parametrize("rounds", [1, 4])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_greedy_speculative_matches_static_engines(w, k, rounds):
    se = _spec(w, k, rounds)
    out = _toks(se.generate(_reqs(GenerationRequest)))
    assert out == w["want"]
    port_static = Engine(w["ts"], params=w["tp"], config=EngineConfig(**CFG),
                         device="cpu")
    assert _toks(port_static.generate(_reqs(GenerationRequest))) == out
    m = se.get_metrics()
    assert m["speculate_k"] == k and m["rounds"] > 0


def test_matches_jax_speculative_engine(w):
    """The same draft in both frameworks: the same greedy tokens and
    logprobs (1e-4), and the JAX engine's metrics keys."""
    je = jspec_mod.SpeculativeEngine(w["js"], w["jds"], params=w["jp"],
                                     draft_params=w["jdp"],
                                     config=JCfg(**CFG), speculate_k=3)
    te = _spec(w, 3)
    jr = je.generate(_reqs(JReq))
    tr = te.generate(_reqs(GenerationRequest))
    for a, b in zip(tr, jr):
        assert a.tokens == b.tokens and a.finish_reason == b.finish_reason
        np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=0,
                                   atol=1e-4)
    assert set(te.get_metrics()) == set(je.get_metrics())
    assert {e["name"] for e in te.timeline.events()} == {
        "spec_prefill", "spec_rounds"}


def test_identical_draft_accepts_everything(w):
    k, n = 4, 20
    se = _spec(w, k, draft=(w["ts"], w["tp"]))
    se.generate([GenerationRequest(prompt=[1, 2, 3, 4, 5],
                                   max_new_tokens=n)])
    m = se.get_metrics()
    # the only loss is the last round's clip at max_new_tokens
    rounds = m["rounds"]
    proposed = rounds * k
    assert m["draft_acceptance_rate"] >= (proposed - (k - 1)) / proposed
    rounds_ceiling = -(-n // (k + 1)) + 1
    assert rounds <= rounds_ceiling
    assert m["tokens_per_round"] >= n / rounds_ceiling


def test_eos_respected(w):
    base = w["want"]["a"]
    se = _spec(w, 4, draft=(w["ts"], w["tp"]))
    out = se.generate([GenerationRequest(prompt=[1, 2, 3, 4, 5],
                                         max_new_tokens=10,
                                         eos_id=base[2])])[0]
    assert out.tokens == base[: base.index(base[2]) + 1]
    assert out.finish_reason == "stop"


def test_one_packed_read_per_call(w, monkeypatch):
    """One host read for the prefill and one per call of
    ``rounds_per_call`` rounds: accept counts and lengths stay on the
    device between rounds."""
    reads = []
    real = tsm._cuda.HostRead

    def counting(t):
        reads.append(tuple(t.shape))
        return real(t)

    monkeypatch.setattr(tsm._cuda, "HostRead", counting)
    se = _spec(w, 2, rounds=4)
    se.generate(_reqs(GenerationRequest))
    assert reads[0] == (2, 2)          # the prefill's, batch bucket 2
    calls = reads[1:]
    assert calls and all(s == (4, 2, 2 * 3 + 2) for s in calls)
    assert len(calls) <= -(-se.get_metrics()["rounds"] // 4) + 1


def test_int4_target_with_truncated_self_draft(w):
    """An int4 target (JAX-quantized, bridged; the port fuses its q|k|v and
    gate|up payloads) with ``truncated_draft(..., 2)`` of its prepared
    tree: the JAX static engine's tokens on the same tree."""
    jq4 = jq.quantize_params(w["js"], w["jp"], bits=4)
    tq4 = bridge.params_from_numpy(jax.device_get(jq4), w["ts"], "cpu")
    se = SpeculativeEngine(w["ts"], w["ts"], params=tq4,
                           draft_params=tq4, config=EngineConfig(**CFG),
                           speculate_k=4, device="cpu")
    ds, dp = truncated_draft(w["ts"], se.params, 2)
    se = SpeculativeEngine(w["ts"], ds, params=se.params, draft_params=dp,
                           config=EngineConfig(**CFG), speculate_k=4,
                           device="cpu")
    assert "w_qkv" in se.params["blocks"] and "w_qkv" in dp["blocks"]
    assert dp["blocks"]["w_qkv"].q.shape[0] == 2
    want = _toks(JEngine(w["js"], params=jq4, config=JCfg(**CFG)).generate(
        _reqs(JReq)))
    assert _toks(se.generate(_reqs(GenerationRequest))) == want


def test_fp8_cache_matches_jax_speculative_engine(w):
    cfg = dict(CFG, kv_dtype="float8_e4m3fn")
    jd, jdp = jspec_mod.truncated_draft(w["js"], w["jp"], 2)
    td, tdp = truncated_draft(w["ts"], w["tp"], 2)
    je = jspec_mod.SpeculativeEngine(w["js"], jd, params=w["jp"],
                                     draft_params=jdp, config=JCfg(**cfg),
                                     speculate_k=3)
    te = SpeculativeEngine(w["ts"], td, params=w["tp"], draft_params=tdp,
                           config=EngineConfig(**cfg), speculate_k=3,
                           device="cpu")
    assert _toks(te.generate(_reqs(GenerationRequest))) == _toks(
        je.generate(_reqs(JReq)))


def test_bf16_teacher_forced():
    js = jspec("llama-tiny", max_seq_len=128)
    ts = tspec("llama-tiny", max_seq_len=128)
    jp = jb.init_params(js, jax.random.key(0))
    tp = bridge.params_from_numpy(jax.device_get(jp), ts, "cpu")
    ds, dp = truncated_draft(ts, tp, 2)
    se = SpeculativeEngine(ts, ds, params=tp, draft_params=dp,
                           config=EngineConfig(max_slots=4, max_seq_len=128),
                           speculate_k=4, device="cpu")
    for r, q in zip(se.generate(_reqs(GenerationRequest)),
                    _reqs(GenerationRequest)):
        assert len(r.tokens) == q.max_new_tokens
        assert_greedy_parity(js, jp, q.prompt, r.tokens, eps=2e-2,
                             min_matched=2)


# ---------------------------------------------------------------- sampled


def test_sampled_runs_seeded_and_respect_max_new(w):
    def run(seed):
        se = _spec(w, 3, seed=seed)
        return [r.tokens for r in se.generate([GenerationRequest(
            prompt=[4, 5, 6], max_new_tokens=9, temperature=0.9,
            request_id=f"s{i}") for i in range(3)])]

    a = run(7)
    assert a == run(7)
    for toks in a:
        assert len(toks) == 9
        assert all(0 <= t < w["ts"].vocab_size for t in toks)


def test_topk1_sampled_matches_greedy_chain(w):
    req = [GenerationRequest(prompt=[1, 2, 3, 4, 5], max_new_tokens=14,
                             temperature=0.8, top_k=1)]
    base = w["want"]["a"][:14]
    assert _spec(w, 3, seed=11).generate(req)[0].tokens == base


def test_topp_keeps_the_target_support(w):
    """Every emitted token lies in the masked target distribution's
    support given its prefix (the port's forward)."""
    se = _spec(w, 3, seed=3)
    prompt = [1, 2, 3, 4, 5]
    knobs = dict(temperature=0.9, top_p=0.3)
    out = se.generate([GenerationRequest(prompt=prompt, max_new_tokens=8,
                                         **knobs)])[0].tokens
    sp = SamplingParams.make(1, **knobs)
    ctx = list(prompt)
    for tok in out:
        logits = tb.forward_train(w["ts"], w["tp"],
                                  torch.tensor([ctx], dtype=torch.int32),
                                  np.asarray([len(ctx)], np.int32))
        probs = masked_sampling_probs(logits[:, len(ctx) - 1], sp)
        assert float(probs[0, tok]) > 0.0, f"{tok} outside the nucleus"
        ctx.append(tok)


# --------------------------------------------------------------- errors


def test_engine_errors_match_jax(w):
    bad = tspec("llama-tiny", max_seq_len=128, vocab_size=999)
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeEngine(w["ts"], bad, config=EngineConfig(**CFG),
                          device="cpu")
    for kw in (dict(speculate_k=0), dict(rounds_per_call=0)):
        with pytest.raises(ValueError):
            SpeculativeEngine(w["ts"], w["tds"], config=EngineConfig(**CFG),
                              device="cpu", **kw)
    for kw in (dict(shard_fn=lambda p: p), dict(kv_sharding=object())):
        with pytest.raises(NotImplementedError, match="A13"):
            SpeculativeEngine(w["ts"], w["tds"], config=EngineConfig(**CFG),
                              device="cpu", **kw)


# ---------------------------------------------------- draft construction


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (QuantizedTensor, jq.QuantizedTensor)):
        yield f"{prefix}.q", tree.q
        yield f"{prefix}.s", tree.s
    else:
        yield prefix, tree


def _assert_trees_equal(port, jtree):
    got, want = dict(_leaves(port)), dict(_leaves(jtree))
    assert set(got) == set(want)
    for k, v in want.items():
        w_np = np.asarray(v)
        if w_np.dtype.name == "bfloat16":
            w_np = w_np.view(np.uint16)
        np.testing.assert_array_equal(bridge.tensor_to_numpy(got[k]), w_np,
                                      err_msg=k)


@pytest.mark.parametrize("bits", [0, 8, 4], ids=["plain", "int8", "int4"])
def test_draft_trees_equal_jax_leaf_for_leaf(w, bits):
    """``truncated_draft`` and ``scale_top_blocks`` of the bridged target
    against the JAX functions on the JAX tree: equal leaf for leaf; the
    non-block leaves shared (no copy); a quantized tree slices payload and
    scales together and scales only its scales."""
    js, ts = w["js"], w["ts"]
    jp = w["jp"] if not bits else jq.quantize_params(js, w["jp"], bits=bits)
    tp = bridge.params_from_numpy(jax.device_get(jp), ts, "cpu")
    jd_spec, jd = jspec_mod.truncated_draft(js, jp, 3)
    td_spec, td = truncated_draft(ts, tp, 3)
    assert dataclasses.asdict(td_spec) == dataclasses.asdict(jd_spec)
    _assert_trees_equal(td, jd)
    assert td["tok_emb"] is tp["tok_emb"]
    with pytest.raises(ValueError, match="draft layers"):
        truncated_draft(ts, tp, ts.n_layers)
    jt = jspec_mod.scale_top_blocks(js, jp, 1, 0.25)
    tt = scale_top_blocks(ts, tp, 1, 0.25)
    _assert_trees_equal(tt, jt)
    if bits:
        assert tt["blocks"]["wo"].q is tp["blocks"]["wo"].q
        assert isinstance(td["blocks"]["wq"], QuantizedTensor)
        assert td["blocks"]["wq"].s.shape[0] == 3


def test_truncated_draft_parity_and_acceptance(w):
    """The truncated self-draft: greedy output is the target's chain, with
    nonzero acceptance at random init."""
    ds, dp = truncated_draft(w["ts"], w["tp"], 2)
    se = _spec(w, 3, draft=(ds, dp))
    assert _toks(se.generate(_reqs(GenerationRequest))) == w["want"]
    assert se.get_metrics()["draft_acceptance_rate"] > 0.0


def test_scale_top_blocks_eps0_matches_draft_logits(w):
    ts, tp = w["ts"], w["tp"]
    ds, dp = truncated_draft(ts, tp, 1)
    toks = torch.tensor([[1, 2, 3, 4, 5, 6]], dtype=torch.int32)
    lens = np.asarray([6], np.int32)
    full = tb.forward_train(ts, scale_top_blocks(ts, tp, 1, 0.0), toks,
                            lens)
    draft = tb.forward_train(ds, dp, toks, lens)
    np.testing.assert_allclose(full.numpy(), draft.numpy(), rtol=1e-5,
                               atol=1e-5)
    full2 = tb.forward_train(ts, scale_top_blocks(ts, tp, 1, 0.5), toks,
                             lens)
    assert float((full2 - draft).abs().max()) > 1e-3


# ---------------------------------------------------------------- factory


def _cfg(**md):
    return ModelConfig(name="s", architecture="llama", dtype="float32",
                       max_seq_len=64, max_batch_size=2,
                       metadata={"size": "llama-tiny", **md})


def test_factory_speculative_branch_and_errors(tmp_path):
    eng = engine_from_config(_cfg(speculative=3, draft_size="llama-tiny"),
                             device="cpu")
    assert isinstance(eng, SpeculativeEngine)
    out = eng.generate([GenerationRequest(prompt=[1, 2, 3],
                                          max_new_tokens=5)])
    assert len(out[0].tokens) == 5
    assert eng.get_metrics()["speculate_k"] == 3
    assert eng.draft_spec.dtype == "float32"
    with pytest.raises(ValueError, match="draft_size"):
        engine_from_config(_cfg(speculative=2), device="cpu")
    with pytest.raises(ValueError, match="not a directory"):
        engine_from_config(_cfg(speculative=2,
                                draft_path=str(tmp_path / "none")),
                           device="cpu")
    for md in ({"sp": 2}, {"dp": 2}):
        with pytest.raises(ValueError, match="composes with tp only"):
            engine_from_config(_cfg(speculative=2, draft_size="llama-tiny",
                                    **md), device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        engine_from_config(_cfg(speculative=2, draft_size="llama-tiny",
                                tp=2), device="cpu")
    # a speculative deploy is not artifact-eligible: ignored, or refused
    # with artifact_required
    art = str(tmp_path / "art")
    eng = engine_from_config(_cfg(speculative=2, draft_size="llama-tiny",
                                  artifact=art), device="cpu")
    assert isinstance(eng, SpeculativeEngine)
    assert not (tmp_path / "art").exists()
    with pytest.raises(ValueError, match="artifact-eligible"):
        engine_from_config(_cfg(speculative=2, draft_size="llama-tiny",
                                artifact=art, artifact_required=1),
                           device="cpu")
