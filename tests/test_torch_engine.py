"""The port's ContinuousEngine (device cpu) against the JAX
ContinuousEngine (attention_impl="xla") on the same bridged llama-tiny
f32 weights: greedy tokens identical under staggered admissions, a
prefix-cache hit, stop ids, eos_id and max_new_tokens (decode_fused off
and on, and the fw decode), at the max_seq_len cap and under page-pool
pressure; with chunked prefill, the port's ragged mixed step (with and
without a token budget) and its split path against the JAX split path;
the paged-attention kernel's routes (``decode_mode="inline"`` and
``attention_impl="pallas"``); and the port's chain passes the JAX
package's teacher-forced ``assert_greedy_parity``. Logprobs within
1e-4."""

import jax
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu.config import EngineConfig as JCfg
from distributed_inference_engine_tpu.engine.continuous import (
    ContinuousEngine as JEngine,
)
from distributed_inference_engine_tpu.engine.types import (
    GenerationRequest as JReq,
)
from distributed_inference_engine_tpu.models.base import init_params
from distributed_inference_engine_tpu.models.llama import llama_spec as jspec
from distributed_inference_engine_tpu.utils.parity import (
    assert_greedy_parity,
)
from distributed_inference_engine_tpu_torch.bridge import params_from_numpy
from distributed_inference_engine_tpu_torch.config import EngineConfig
from distributed_inference_engine_tpu_torch.engine.continuous import (
    ContinuousEngine,
)
from distributed_inference_engine_tpu_torch.engine.types import (
    GenerationRequest,
)
from distributed_inference_engine_tpu_torch.models.llama import (
    llama_spec as tspec,
)

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

ENGINE_KW = dict(max_slots=4, max_seq_len=128, prefill_buckets=[16, 64],
                 page_size=16, num_pages=48, decode_steps_per_call=4,
                 kv_dtype="float32")


@pytest.fixture(scope="module")
def weights():
    js = jspec("llama-tiny", dtype="float32")
    ts = tspec("llama-tiny", dtype="float32")
    jp = init_params(js, jax.random.key(0))
    return js, ts, jp, params_from_numpy(jax.device_get(jp), ts, "cpu")


def _engines(weights, fused):
    js, ts, jp, tp = weights
    je = JEngine(js, params=jp, config=JCfg(attention_impl="xla",
                                            decode_fused=fused, **ENGINE_KW))
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(
        attention_impl="auto", decode_fused=fused, **ENGINE_KW),
        device="cpu")
    return je, te


def _drive(engine, req_cls, waves, steps=2):
    """Submit each wave, then step ``steps`` times before the next — the
    same call sequence on both engines, so admissions interleave
    identically."""
    out = {}
    for wave in waves:
        for kw in wave:
            engine.submit(req_cls(**kw))
        for _ in range(steps):
            engine.step()
            out.update({r.request_id: r for r in engine.drain_finished()})
    out.update({r.request_id: r for r in engine.run_until_idle()})
    return out


def _waves():
    rs = np.random.RandomState(0)
    shared = rs.randint(1, 1024, size=40).tolist()     # 2 full pages + 8

    def req(i, n, **kw):
        return dict(prompt=rs.randint(1, 1024, size=n).tolist(),
                    max_new_tokens=kw.pop("max_new_tokens", 10),
                    request_id=f"r{i}", **kw)

    first = [req(0, 9), req(1, 30, max_new_tokens=1), req(2, 45),
             dict(prompt=shared + [7, 8, 9], max_new_tokens=10,
                  request_id="p0")]
    second = [req(3, 12, max_new_tokens=5), req(4, 60),
              dict(prompt=shared + [11, 12], max_new_tokens=9,
                   request_id="p1")]
    third = [req(5, 20, max_new_tokens=14), req(6, 3)]
    return [first, second, third]


@pytest.mark.parametrize("fused", [False, True])
def test_greedy_tokens_match_jax_engine(weights, fused):
    """Staggered waves with a prefix hit and several max_new_tokens, then
    stop ids, eos_id and a stop sequence picked from the unstopped chains:
    both engines emit the same tokens and finish reasons."""
    je, te = _engines(weights, fused)
    waves = _waves()
    want = _drive(je, JReq, waves)
    got = _drive(te, GenerationRequest, waves)
    assert sorted(got) == sorted(want) and len(got) == 9
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason, rid
        np.testing.assert_allclose(got[rid].logprobs, want[rid].logprobs,
                                   rtol=0, atol=1e-4)
    assert te.get_metrics()["prefix_hit_admissions"] >= 1
    assert je.get_metrics()["prefix_hit_admissions"] >= 1

    by_id = {kw["request_id"]: kw for wave in waves for kw in wave}
    base = {rid: want[rid].tokens for rid in ("r0", "r2", "r4")}
    cases = [dict(prompt=by_id["r0"]["prompt"], max_new_tokens=10,
                  stop_ids=[base["r0"][3]], request_id="s0"),
             dict(prompt=by_id["r2"]["prompt"], max_new_tokens=10,
                  eos_id=base["r2"][5], request_id="s1"),
             dict(prompt=by_id["r4"]["prompt"], max_new_tokens=10,
                  stop_ids=list(range(2000, 2009)) + [base["r4"][6]],
                  request_id="s2"),
             dict(prompt=by_id["r4"]["prompt"], max_new_tokens=10,
                  stop_sequences=[base["r4"][2:4]], request_id="s3")]
    want = {r.request_id: r for r in je.generate([JReq(**c) for c in cases])}
    got = {r.request_id: r for r in te.generate(
        [GenerationRequest(**c) for c in cases])}
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason == "stop"


# requests shed at step start for their own deadline_s: 0 expires at once,
# 1e6 never does
DEADLINES = {"r1": 0.0, "p1": 0.0, "r6": 0.0, "r5": 1e6}


def test_request_deadline_sheds_like_jax_engine(weights):
    """A request's own ``deadline_s``: both engines resolve the expired
    ones at step start with finish_reason "deadline" and no tokens, and
    the rest (one with a far deadline) emit the same greedy tokens; the
    engines count the same expiries."""
    je, te = _engines(weights, False)
    waves = _waves()
    for wave in waves:
        for kw in wave:
            kw["deadline_s"] = DEADLINES.get(kw["request_id"])
    want = _drive(je, JReq, waves)
    got = _drive(te, GenerationRequest, waves)
    assert sorted(got) == sorted(want) and len(got) == 9
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason, rid
    shed = {rid for rid in want if want[rid].finish_reason == "deadline"}
    assert shed == {"r1", "p1", "r6"}
    for rid in shed:
        r = got[rid]
        assert r.tokens == [] and r.decode_s == 0.0 and r.ttft_s >= 0.0
        assert r.metadata == {"deadline_s": 0.0}
        assert r.prompt_tokens == want[rid].prompt_tokens
    assert te.get_metrics()["deadline_expired"] == 3
    assert je.get_metrics()["deadline_expired"] == 3
    assert te.get_metrics()["waiting"] == 0


def test_shed_only_step_hands_over_results(weights):
    """A step that sheds every queued request and admits nothing still
    hands the results over through ``run_until_idle``."""
    _, te = _engines(weights, False)
    res = te.generate([GenerationRequest(prompt=[5, 6, 7], max_new_tokens=4,
                                         deadline_s=0.0) for _ in range(3)])
    assert [r.finish_reason for r in res] == ["deadline"] * 3
    m = te.get_metrics()
    assert m["deadline_expired"] == 3 and m["engine_steps"] == 0
    assert m["total_generated_tokens"] == 0 and m["prefill_calls"] == 0


def test_jax_teacher_forced_parity_on_port_chain(weights):
    js, ts, jp, tp = weights
    _, te = _engines(weights, True)
    prompt = np.random.RandomState(2).randint(1, 1024, size=21).tolist()
    res = te.generate([GenerationRequest(prompt=prompt, max_new_tokens=16)])
    assert len(res[0].tokens) == 16
    matched, _ = assert_greedy_parity(js, jp, prompt, res[0].tokens,
                                      label="torch port")
    assert matched >= 3


def test_capacity_length_finish_matches(weights):
    """A request running into max_seq_len finishes "length" at the same
    token on both engines."""
    je, te = _engines(weights, False)
    prompt = np.random.RandomState(3).randint(1, 1024, size=120).tolist()
    want = je.generate([JReq(prompt=prompt, max_new_tokens=30)])[0]
    got = te.generate([GenerationRequest(prompt=prompt,
                                         max_new_tokens=30)])[0]
    assert got.tokens == want.tokens and len(got.tokens) < 30
    assert got.finish_reason == want.finish_reason == "length"


def test_page_pressure_matches(weights):
    """A pool too small for every slot's full generation: capacity grants
    stop slots mid-chunk (paused and revived, or finished "length") in the
    same places on both engines."""
    _page_pressure(weights)


def test_page_pressure_inline_matches(weights):
    """The same under the per-step paged decode, where a slot stopped
    mid-chunk must write nothing for the rest of the chunk."""
    _page_pressure(weights, decode_mode="inline")


def _page_pressure(weights, **extra):
    js, ts, jp, tp = weights
    kw = dict(ENGINE_KW, num_pages=9, **extra)
    je = JEngine(js, params=jp, config=JCfg(attention_impl="xla", **kw))
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(**kw),
                          device="cpu")
    rs = np.random.RandomState(4)
    cases = [dict(prompt=rs.randint(1, 1024, size=n).tolist(),
                  max_new_tokens=26, request_id=f"c{i}")
             for i, n in enumerate((14, 20, 31, 9, 25))]
    want = {r.request_id: r for r in je.generate([JReq(**c) for c in cases])}
    got = {r.request_id: r for r in te.generate(
        [GenerationRequest(**c) for c in cases])}
    assert te.get_metrics()["capacity_finishes"] + sum(
        r.finish_reason == "length" and len(r.tokens) < 26
        for r in got.values()) > 0
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason, rid


def test_unported_features_raise():
    for kw in (dict(kv_offload=True),):
        with pytest.raises(NotImplementedError):
            EngineConfig(**kw).check_supported()
    # async speculation is ported (A12)
    EngineConfig(spec_async=True).check_supported()
    # the host paths are ported: defer_admission is on by default, as in
    # JAX, and so is the step timeline, at the JAX default capacity
    assert EngineConfig().defer_admission
    assert EngineConfig().timeline_capacity == 4096
    # e5m2 KV pools are ported (A5f-e5m2), as e4m3 ones are
    for kw in (dict(kv_dtype="float8_e5m2"), dict(kv_dtype="float8_e4m3fn"),
               dict(defer_sync=True), dict(stream_chunk_steps=2),
               dict(defer_admission=False), dict(max_waiting=4),
               dict(queue_deadline_s=1.0), dict(timeline_capacity=16),
               dict(timeline_capacity=0)):
        EngineConfig(**kw).check_supported()
    for impl in ("xla", "pallas-ragged_interpret", "pallas-decode_interpret",
                 "pallas_interpret"):
        with pytest.raises(ValueError):
            EngineConfig(attention_impl=impl).check_supported()
    # an unknown decode mode raises the JAX engine's ValueError
    with pytest.raises(ValueError, match="is not 'window'"):
        EngineConfig(decode_mode="scatter").check_supported()
    for kw in (dict(decode_mode="inline"), dict(attention_impl="pallas")):
        EngineConfig(**kw).check_supported()


def _assert_same(got, want, n):
    assert sorted(got) == sorted(want) and len(got) == n
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason, rid
        np.testing.assert_allclose(got[rid].logprobs, want[rid].logprobs,
                                   rtol=0, atol=1e-4)


def test_decode_fw_matches_jax_engine(weights):
    """attention_impl="pallas-decode-fw" (the writeback kernel's plain
    version on the CPU) emits the JAX engine's tokens."""
    js, ts, jp, tp = weights
    je = JEngine(js, params=jp, config=JCfg(attention_impl="xla",
                                            **ENGINE_KW))
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(
        attention_impl="pallas-decode-fw", **ENGINE_KW), device="cpu")
    waves = _waves()
    _assert_same(_drive(te, GenerationRequest, waves),
                 _drive(je, JReq, waves), 9)


@pytest.mark.parametrize("label,jkw,tkw", [
    ("inline", dict(decode_mode="inline"), dict(decode_mode="inline")),
    ("pallas", dict(), dict(attention_impl="pallas")),
    ("inline fused", dict(decode_mode="inline", decode_fused=True),
     dict(decode_mode="inline", decode_fused=True))])
def test_paged_attention_paths_match_jax_engine(weights, label, jkw, tkw):
    """The paged-attention kernel's two routes (its plain version on the
    CPU): the per-step paged decode (``decode_mode="inline"``, fused off
    and on) and the window scheme with ``attention_impl="pallas"``. Both
    emit the JAX engine's tokens (JAX on its XLA path)."""
    js, ts, jp, tp = weights
    je = JEngine(js, params=jp, config=JCfg(attention_impl="xla",
                                            **dict(ENGINE_KW, **jkw)))
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(
        **dict(ENGINE_KW, **tkw)), device="cpu")
    waves = _waves()
    _assert_same(_drive(te, GenerationRequest, waves),
                 _drive(je, JReq, waves), 9)
    m = te.get_metrics()
    assert m["decode_mode"] == ("window" if label == "pallas" else "inline")
    assert m["decode_steps"] > 0 and m["prefix_hit_admissions"] >= 1


def _chunk_waves():
    """The JAX ragged engine test's prompts (two 28-token prompts and a
    3-token one), a 45-token prompt owning a 2-page prefix, a staggered
    wave, then a prefix hit on the owner whose 40-token uncached tail
    exceeds the chunk (submitted after the owner's last chunk: a chunked
    admission registers its pages only then)."""
    rs = np.random.RandomState(6)
    shared = rs.randint(1, 1024, size=32).tolist()
    first = [dict(prompt=[(3 * i + j) % 250 + 1 for j in range(28)],
                  max_new_tokens=8, request_id=f"long{i}") for i in range(2)]
    first += [dict(prompt=[5, 9, 13], max_new_tokens=8, request_id="short"),
              dict(prompt=shared + rs.randint(1, 1024, size=13).tolist(),
                   max_new_tokens=6, request_id="owner")]
    second = [dict(prompt=rs.randint(1, 1024, size=n).tolist(),
                   max_new_tokens=m, request_id=f"w{i}")
              for i, (n, m) in enumerate(((20, 5), (37, 7)))]
    third = [dict(prompt=shared + rs.randint(1, 1024, size=40).tolist(),
                  max_new_tokens=8, request_id="hit")]
    return [first, second, third]


@pytest.fixture(scope="module")
def jax_chunked(weights):
    """The JAX split path (attention_impl="xla", prefill_chunk=16)."""
    js, _, jp, _ = weights
    je = JEngine(js, params=jp, config=JCfg(
        attention_impl="xla", prefill_chunk=16, **ENGINE_KW))
    out = _drive(je, JReq, _chunk_waves(), steps=3)
    m = je.get_metrics()
    assert m["chunked_admissions"] >= 4 and m["prefix_hit_admissions"] >= 1
    return out


@pytest.mark.parametrize("impl,budget", [("pallas-ragged", 0),
                                         ("pallas-ragged", 12),
                                         ("auto", 0)])
def test_chunked_prefill_matches_jax_engine(weights, jax_chunked, impl,
                                            budget):
    """Chunked prefill through the port's ragged mixed step (with and
    without a 12-token budget, which forces one prefill row per step) and
    through its split path: the JAX split path's tokens, finish reasons
    and logprobs, the prefix hit resuming chunked after its cached
    pages."""
    _, ts, _, tp = weights
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(
        attention_impl=impl, prefill_chunk=16, mixed_step_tokens=budget,
        **ENGINE_KW), device="cpu")
    got = _drive(te, GenerationRequest, _chunk_waves(), steps=3)
    _assert_same(got, jax_chunked, 7)
    m = te.get_metrics()
    assert m["chunked_admissions"] >= 4 and m["prefix_hit_admissions"] >= 1
    assert m["prefilling_slots"] == 0 and m["live_slots"] == 0
    if impl == "auto":
        assert m["mixed_steps"] == 0
    else:
        assert m["mixed_steps"] >= (2 if budget else 1)
        assert m["mixed_prefill_tokens"] > 0
        assert 0 < m["mixed_programs"] <= m["mixed_steps"]
