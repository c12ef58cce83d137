"""The port's host serving paths against the JAX package's, on the CPU with
bridged llama-tiny f32 weights: deferred admission (the default),
``defer_sync`` with the stream ring, sub-chunk streaming and
``submit(on_tokens=)``, overload shedding (``max_waiting``,
``queue_deadline_s``) through the engine and the pump, the worker's
``generate_stream`` (a JAX client against the port's worker and the
reverse) and load-time ``warmup``. Greedy tokens are held to the JAX
engine's exactly, finish reasons and shed reasons too; logprobs within
1e-4."""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu.cluster.worker import (
    WorkerClient as JClient,
)
from distributed_inference_engine_tpu.cluster.worker import (
    WorkerServer as JServer,
)
from distributed_inference_engine_tpu.config import EngineConfig as JCfg
from distributed_inference_engine_tpu.config import ModelConfig as JModel
from distributed_inference_engine_tpu.config import ServerConfig as JSrvCfg
from distributed_inference_engine_tpu.engine import types as jtypes
from distributed_inference_engine_tpu.engine.continuous import (
    ContinuousEngine as JEngine,
)
from distributed_inference_engine_tpu.engine.types import (
    GenerationRequest as JReq,
)
from distributed_inference_engine_tpu.models.base import init_params
from distributed_inference_engine_tpu.models.llama import llama_spec as jspec
from distributed_inference_engine_tpu.utils import framing as jframing
from distributed_inference_engine_tpu_torch.bridge import params_from_numpy
from distributed_inference_engine_tpu_torch.cluster.worker import (
    WorkerClient as TClient,
)
from distributed_inference_engine_tpu_torch.cluster.worker import (
    WorkerServer,
)
from distributed_inference_engine_tpu_torch.config import (
    EngineConfig,
    ModelConfig,
    ServerConfig,
)
from distributed_inference_engine_tpu_torch.engine import types as ttypes
from distributed_inference_engine_tpu_torch.engine.continuous import (
    ContinuousEngine,
)
from distributed_inference_engine_tpu_torch.engine.types import (
    EngineOverloadedError,
    GenerationRequest,
)
from distributed_inference_engine_tpu_torch.models.llama import (
    llama_spec as tspec,
)
from distributed_inference_engine_tpu_torch.ops import _cuda
from distributed_inference_engine_tpu_torch.serving.pump import EnginePump

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

# 4 slots x 8 pages of 16: a fully backed pool (defer_sync's requirement)
KW = dict(max_slots=4, max_seq_len=128, prefill_buckets=[16, 64],
          page_size=16, num_pages=32, decode_steps_per_call=4,
          kv_dtype="float32")


@pytest.fixture(scope="module")
def weights():
    js = jspec("llama-tiny", dtype="float32")
    ts = tspec("llama-tiny", dtype="float32")
    jp = init_params(js, jax.random.key(0))
    return js, ts, jp, params_from_numpy(jax.device_get(jp), ts, "cpu")


@pytest.fixture(scope="module")
def jref(weights):
    """One JAX engine (XLA path, ``KW``, its defaults) for every reference
    in this file: a JAX engine compiles its programs per instance, so each
    test borrows this one, leaves it idle, and restores any knob it
    turns (``max_waiting`` and ``queue_deadline_s`` are read from its
    config at each submit and step)."""
    js, _, jp, _ = weights
    return JEngine(js, params=jp, config=JCfg(attention_impl="xla", **KW))


def _knobs(engine, **kw):
    """Set config knobs on ``engine``; returns a function restoring them."""
    old = {k: getattr(engine.config, k) for k in kw}
    for k, v in kw.items():
        setattr(engine.config, k, v)
    return lambda: [setattr(engine.config, k, v) for k, v in old.items()]


def _port(weights, **kw):
    _, ts, _, tp = weights
    return ContinuousEngine(ts, params=tp, config=EngineConfig(
        **dict(KW, **kw)), device="cpu")


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, 1024, size=n).tolist()


def _same(got, want):
    assert [r.request_id for r in got] == [r.request_id for r in want]
    for g, w in zip(got, want):
        assert g.tokens == w.tokens, g.request_id
        assert g.finish_reason == w.finish_reason, g.request_id
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=0, atol=1e-4)


# ------------------------------------------------- the five host paths


def _staggered(engine, req_cls, cbs):
    """Two requests, one step, three more (admitted under decode
    pressure, so deferred by default), then to completion; ``cbs``
    attaches a stream callback to every request and returns the frames."""
    frames = {}
    reqs = [req_cls(prompt=_prompt(i, n), max_new_tokens=m,
                    request_id=f"h{i}")
            for i, (n, m) in enumerate(((9, 12), (30, 7), (45, 10),
                                        (12, 5), (20, 14)))]

    def submit(r):
        if cbs:
            frames[r.request_id] = []
            engine.submit(r, on_tokens=frames[r.request_id].extend)
        else:
            engine.submit(r)

    for r in reqs[:2]:
        submit(r)
    engine.step()
    for r in reqs[2:]:
        submit(r)
    out = {r.request_id: r for r in engine.run_until_idle()}
    return [out[r.request_id] for r in reqs], frames


@pytest.fixture(scope="module")
def jax_staggered(jref):
    before = jref.get_metrics()["deferred_admissions"]
    out, _ = _staggered(jref, JReq, False)
    assert jref.get_metrics()["deferred_admissions"] - before == 3
    return out


@pytest.mark.parametrize("label,kw,cbs", [
    ("default", {}, False),
    ("sync admission", dict(defer_admission=False), False),
    ("defer_sync", dict(defer_sync=True), False),
    ("sub-chunk streaming", dict(stream_chunk_steps=2), True),
    ("defer_sync streaming", dict(defer_sync=True, stream_chunk_steps=1),
     True)])
def test_host_paths_emit_jax_tokens(weights, jax_staggered, label, kw, cbs):
    """The default config (deferred admission), sync admission,
    ``defer_sync``, and sub-chunk streaming with a callback on every
    request (alone and under ``defer_sync``): the JAX default engine's
    greedy tokens, and every stream equals its result."""
    te = _port(weights, **kw)
    got, frames = _staggered(te, GenerationRequest, cbs)
    _same(got, jax_staggered)
    m = te.get_metrics()
    assert m["deferred_admissions"] == (
        0 if kw.get("defer_admission") is False else 3)
    if cbs:
        assert m["stream_clamped_chunks"] >= 1
        for r in got:
            assert frames[r.request_id] == r.tokens, label
    if kw.get("defer_sync"):
        assert m["stream_ring_pushes"] >= 1
    assert m["live_slots"] == 0 and m["kv"]["live_slots"] == 0


def test_shedding_matches_jax(weights, jref):
    """``max_waiting`` refusals through ``generate`` and a
    ``queue_deadline_s`` shed at step start: the same finish reasons and
    overload reasons as the JAX engine, and the served requests' tokens."""
    te = _port(weights, max_waiting=2)
    reqs = [dict(prompt=_prompt(i, 6 + i), max_new_tokens=4,
                 request_id=f"o{i}") for i in range(6)]
    before = jref.get_metrics()["rejected_queue_full"]
    restore = _knobs(jref, max_waiting=2)
    try:
        want = jref.generate([JReq(**r) for r in reqs])
    finally:
        restore()
    got = te.generate([GenerationRequest(**r) for r in reqs])
    _same(got, want)
    assert [r.finish_reason for r in got].count("overloaded") == 4
    for g, w in zip(got, want):
        assert g.metadata == w.metadata
    assert te.get_metrics()["rejected_queue_full"] == \
        jref.get_metrics()["rejected_queue_full"] - before == 4

    out = []
    for eng, req in ((jref, JReq), (_port(weights, queue_deadline_s=0.05),
                                    GenerationRequest)):
        shed0 = eng.get_metrics()["shed_deadline"]
        restore = _knobs(eng, queue_deadline_s=0.05)
        try:
            for i in range(4):                  # every slot busy
                eng.submit(req(prompt=_prompt(i, 9), max_new_tokens=16,
                               request_id=f"run{i}"))
            eng.step()
            for i in (1, 2):
                eng.submit(req(prompt=_prompt(10 + i, 5),
                               request_id=f"late{i}"))
            time.sleep(0.08)
            eng.step()
            res = {r.request_id: r for r in eng.drain_finished()}
            res.update({r.request_id: r for r in eng.run_until_idle()})
        finally:
            restore()
        assert eng.get_metrics()["shed_deadline"] - shed0 == 2
        out.append(res)
    want, got = out
    for rid in ("late1", "late2"):
        assert got[rid].finish_reason == want[rid].finish_reason == \
            "overloaded"
        assert got[rid].metadata == want[rid].metadata == \
            {"overload_reason": "deadline"}
        assert got[rid].tokens == [] and got[rid].ttft_s >= 0.05
    for i in range(4):
        assert got[f"run{i}"].tokens == want[f"run{i}"].tokens
        assert len(got[f"run{i}"].tokens) == 16


def test_typed_errors_match_jax():
    for mod in (jtypes, ttypes):
        e = mod.EngineOverloadedError("x", reason="deadline",
                                      retry_after_s=1.5)
        assert (e.reason, e.retry_after_s, e.rpc_error_detail,
                e.rpc_error_kind) == ("deadline", 1.5, "deadline",
                                      "overloaded")
        d = mod.DeadlineExceededError("late", request_id="r9")
        assert (d.request_id, d.rpc_error_detail, d.rpc_error_kind) == \
            ("r9", "r9", "deadline")
    assert ttypes.DEADLINE == jtypes.DEADLINE == "deadline"


# ----------------------------------------------------- defer_sync (A5b)


def test_defer_sync_matches_synchronous_output(weights, jref):
    """``defer_sync`` reads each chunk after queueing the next: the JAX
    synchronous engine's tokens, with a mid-flight admission and a
    host-side stop sequence (found a chunk late, trimmed the same)."""
    probe = jref.generate([JReq(prompt=_prompt(9, 10),
                              max_new_tokens=12)])[0].tokens
    reqs = [dict(prompt=_prompt(i, 10), max_new_tokens=14,
                 request_id=f"d{i}") for i in range(2)]
    reqs[1]["stop_sequences"] = [probe[:1]]
    reqs[1]["prompt"] = _prompt(9, 10)
    late = dict(prompt=_prompt(5, 10), max_new_tokens=10, request_id="late")

    def run(eng, req):
        for r in reqs:
            eng.submit(req(**r))
        eng.step()
        eng.submit(req(**late))
        out = {r.request_id: (r.tokens, r.finish_reason)
               for r in eng.run_until_idle()}
        return [out[i] for i in ("d0", "d1", "late")]

    want = run(jref, JReq)
    got = run(_port(weights, defer_sync=True), GenerationRequest)
    assert got == want and want[1][1] == "stop"


def test_defer_sync_requires_fully_backed_pool(weights):
    js, ts, jp, tp = weights
    with pytest.raises(ValueError, match="fully backed"):
        JEngine(js, params=jp, config=JCfg(attention_impl="xla", **dict(
            KW, defer_sync=True, num_pages=8)))
    with pytest.raises(ValueError, match="fully backed"):
        ContinuousEngine(ts, params=tp, config=EngineConfig(**dict(
            KW, defer_sync=True, num_pages=8)), device="cpu")


def test_page_boundary_pause_revives_under_defer_sync(weights, jref):
    """Prompt 8, chunk 4, two chunks ahead: the grant lands on a page
    boundary mid-flight, the slot pauses while the next chunk is already
    queued with it inactive; that chunk must not finish it. 16 tokens,
    the JAX engine's."""
    te = _port(weights, defer_sync=True)
    req = dict(prompt=_prompt(3, 8), max_new_tokens=16, request_id="edge")
    want = jref.generate([JReq(**req)])
    got = te.generate([GenerationRequest(**req)])
    _same(got, want)
    assert len(got[0].tokens) == 16


def test_token_ring_roundtrip_bit_exact(weights, jref):
    """Under ``defer_sync`` each chunk rides the stream ring and
    ``poll_stream`` harvests it; the streamed tokens equal the result and
    the JAX engine's."""
    te = _port(weights, defer_sync=True)
    want = jref.generate([JReq(prompt=[1, 2, 3], max_new_tokens=12)])[0]
    chunks = []
    te.submit(GenerationRequest(prompt=[1, 2, 3], max_new_tokens=12,
                                request_id="ring"), on_tokens=chunks.append)
    results = []
    for _ in range(1000):
        live = te.step()
        te.poll_stream()
        results.extend(te.drain_finished())
        if live == 0 and not te.n_waiting:
            break
    assert results[0].tokens == want.tokens
    assert [t for c in chunks for t in c] == results[0].tokens
    m = te.get_metrics()
    assert m["stream_ring_pushes"] >= 1 and m["stream_ring_polls"] >= 1
    assert m["stream_ring_ready_polls"] >= 1 and m["stream_ring_depth"] >= 1


# ------------------------------------------------- deferred admission


def _busy_then(eng, req_cls, reqs):
    """One request until it is live (a quarter of 4 slots: decode
    pressure), then ``reqs`` in one admission round."""
    eng.submit(req_cls(prompt=_prompt(11, 10), max_new_tokens=12,
                       request_id="busy"))
    while not eng._slots:
        eng.step()
    for r in reqs:
        eng.submit(req_cls(**r))
    return {r.request_id: r for r in eng.run_until_idle()}


def test_deferred_admission_parity_and_ttft(weights, jref):
    """Under decode pressure the first tokens stay on the device and are
    harvested from the next chunk's read: the sync path's tokens (and the
    JAX engine's, which defers too), TTFT stamped at the harvest."""
    reqs = [dict(prompt=_prompt(20 + i, 10), max_new_tokens=10,
                 request_id=f"r{i}") for i in range(3)]
    deferred0 = jref.get_metrics()["deferred_admissions"]
    want = _busy_then(jref, JReq, reqs)
    assert jref.get_metrics()["deferred_admissions"] - deferred0 == 3
    te = _port(weights)
    got = _busy_then(te, GenerationRequest, reqs)
    sync = _port(weights, defer_admission=False)
    ref = _busy_then(sync, GenerationRequest, reqs)
    assert te.get_metrics()["deferred_admissions"] == 3
    assert sync.get_metrics()["deferred_admissions"] == 0
    assert not any(s.first_pending for s in te._slots.values())
    for rid in want:
        assert got[rid].tokens == want[rid].tokens == ref[rid].tokens, rid
        np.testing.assert_allclose(got[rid].logprobs, want[rid].logprobs,
                                   rtol=0, atol=1e-4)
        assert len(got[rid].tokens) >= 1 and got[rid].ttft_s > 0


def test_deferred_admission_single_token_request_falls_back(weights, jref):
    """``max_new_tokens=1`` under decode pressure takes the sync read (a
    deferred slot cannot stop before decoding): exactly one token, the
    JAX engine's."""
    reqs = [dict(prompt=[5, 6, 7], max_new_tokens=1, request_id="one")]
    te = _port(weights)
    want = _busy_then(jref, JReq, reqs)
    got = _busy_then(te, GenerationRequest, reqs)
    assert got["one"].tokens == want["one"].tokens
    assert len(got["one"].tokens) == 1
    assert te.get_metrics()["deferred_admissions"] == 0


def test_deferred_admission_eos_first_token_stops_clean(weights, jref):
    """A deferred admission whose first token is its eos installs
    inactive and retires at the next read: "stop" with that one token,
    as the JAX engine's."""
    first = jref.generate([JReq(prompt=[9, 8, 7], max_new_tokens=6)])[0] \
        .tokens[0]
    reqs = [dict(prompt=[9, 8, 7], max_new_tokens=6, eos_id=first,
                 request_id="p")]
    te = _port(weights)
    want = _busy_then(jref, JReq, reqs)["p"]
    got = _busy_then(te, GenerationRequest, reqs)["p"]
    assert got.finish_reason == want.finish_reason == "stop"
    assert got.tokens == want.tokens == [first]
    assert te.get_metrics()["deferred_admissions"] == 1


def test_firsts_snapshot_one_fetch_per_rescue_wave(weights):
    """The retire-path rescue reads the whole firsts buffer once per
    invalidation, never once per slot; a cached copy costs no read."""
    te = _port(weights, defer_sync=True)
    res = te.generate([GenerationRequest(prompt=[1 + i, 2, 3],
                                         max_new_tokens=6)
                       for i in range(3)])
    assert all(len(r.tokens) == 6 for r in res)
    te._firsts_host = None
    base = te._firsts_fetches
    a = te._firsts_snapshot()
    b = te._firsts_snapshot()
    assert a is b and a.shape == (2, KW["max_slots"])
    assert te._firsts_fetches == base + 1
    assert te.get_metrics()["firsts_fetches"] == te._firsts_fetches


def test_deferred_first_token_rescued_at_capacity_retire(weights):
    """A deferred slot retired before any read (its pages ran out at the
    next capacity check) gets its first token from the firsts snapshot:
    the result of the sync read (held to the JAX engine under page
    pressure in ``test_torch_engine.py``)."""
    reqs = [dict(prompt=_prompt(30 + i, 15), max_new_tokens=8,
                 request_id=f"c{i}") for i in range(3)]
    te = _port(weights, num_pages=5)
    got = _busy_then(te, GenerationRequest, reqs)
    want = _busy_then(_port(weights, num_pages=5, defer_admission=False),
                      GenerationRequest, reqs)
    assert te.get_metrics()["deferred_admissions"] >= 1
    assert te.get_metrics()["capacity_finishes"] >= 1
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason, rid


# ------------------------------------------------------------ streaming


def test_engine_stream_callback_matches_result(weights, jref):
    te = _port(weights)
    want = jref.generate([JReq(prompt=[1, 2, 3], max_new_tokens=10)])[0]
    chunks = []
    te.submit(GenerationRequest(prompt=[1, 2, 3], max_new_tokens=10,
                                request_id="s"), on_tokens=chunks.append)
    res = te.run_until_idle()[0]
    assert res.tokens == want.tokens
    assert [t for c in chunks for t in c] == res.tokens
    assert len(chunks) >= 2                        # actually incremental


def test_engine_stream_respects_eos_trim(weights, jref):
    te = _port(weights)
    probe = jref.generate([JReq(prompt=[1, 2, 3],
                              max_new_tokens=10)])[0].tokens
    chunks = []
    te.submit(GenerationRequest(prompt=[1, 2, 3], max_new_tokens=10,
                                eos_id=probe[3]), on_tokens=chunks.append)
    res = te.run_until_idle()[0]
    assert [t for c in chunks for t in c] == res.tokens == probe[:4]
    assert res.finish_reason == "stop"


def test_subchunk_greedy_parity_with_packed_harvest(weights, jref):
    """One-step sub-chunks emit the full-chunk tokens (the JAX engine's),
    and the frames splice to exactly them."""
    want = jref.generate([JReq(prompt=[1, 2, 3], max_new_tokens=14)])[0]
    te = _port(weights, stream_chunk_steps=1)
    chunks = []
    te.submit(GenerationRequest(prompt=[1, 2, 3], max_new_tokens=14),
              on_tokens=chunks.append)
    res = te.run_until_idle()[0]
    assert res.tokens == want.tokens
    assert [t for c in chunks for t in c] == res.tokens
    assert len(chunks) >= 14 - 1


def test_subchunk_stream_trims_stops_identically(weights, jref):
    """A stop inside a sub-chunk trims the stream as the result: greedy,
    and sampled with min_p=1.0 (pinned to the argmax)."""
    probe = jref.generate([JReq(prompt=[1, 2, 3],
                              max_new_tokens=12)])[0].tokens
    stop = probe[5]
    cut = probe.index(stop) + 1
    for temp, min_p in ((0.0, 0.0), (0.8, 1.0)):
        te = _port(weights, stream_chunk_steps=1)
        chunks = []
        te.submit(GenerationRequest(prompt=[1, 2, 3], max_new_tokens=12,
                                    temperature=temp, min_p=min_p,
                                    stop_ids=[stop]), on_tokens=chunks.append)
        res = te.run_until_idle()[0]
        assert res.tokens == probe[:cut] and res.finish_reason == "stop"
        assert [t for c in chunks for t in c] == res.tokens


def test_adaptive_chunk_adds_one_decode_key(weights):
    """The streaming clamp is a power of two: a streaming + batch run adds
    one decode key (one more graph on the card) beyond the full chunk's,
    and a batch-only run keeps the full chunk."""
    te = _port(weights, stream_chunk_steps=1)
    te.generate([GenerationRequest(prompt=[1, 2], max_new_tokens=8)])
    assert {k[1] for k in te._decode_keys} == {4}
    assert te.get_metrics()["stream_clamped_chunks"] == 0
    chunks = []
    te.submit(GenerationRequest(prompt=[1, 2, 3], max_new_tokens=8),
              on_tokens=chunks.append)
    te.submit(GenerationRequest(prompt=[4, 5], max_new_tokens=8))
    te.run_until_idle()
    assert {k[1] for k in te._decode_keys} == {4, 1}
    assert te.get_metrics()["decode_programs"] == 2
    assert te.get_metrics()["stream_clamped_chunks"] >= 1
    assert [t for c in chunks for t in c]


# ------------------------------------------------------------- overload


def test_submit_raises_typed_error_at_queue_cap(weights, jref):
    te = _port(weights, max_waiting=3)
    for eng, req, err in ((jref, JReq, jtypes.EngineOverloadedError),
                          (te, GenerationRequest, EngineOverloadedError)):
        rejected0 = eng.get_metrics()["rejected_queue_full"]
        restore = _knobs(eng, max_waiting=3)
        try:
            for i in range(3):
                eng.submit(req(prompt=[1 + i, 2, 3], max_new_tokens=8,
                               request_id=f"o{i}"))
            with pytest.raises(err) as ei:
                eng.submit(req(prompt=[9], request_id="o99"))
        finally:
            restore()
        assert ei.value.reason == "queue_full"
        assert ei.value.rpc_error_kind == "overloaded"
        assert eng.get_metrics()["rejected_queue_full"] - rejected0 == 1
    want = sorted(jref.run_until_idle(), key=lambda r: r.request_id)
    got = sorted(te.run_until_idle(), key=lambda r: r.request_id)
    _same(got, want)
    assert [r.finish_reason for r in got] == ["length"] * 3


def test_no_shedding_by_default(weights):
    te = _port(weights, max_slots=2, num_pages=16)
    res = te.generate([GenerationRequest(prompt=[1 + i, 2, 3],
                                         max_new_tokens=8)
                       for i in range(8)])
    assert [r.finish_reason for r in res] == ["length"] * 8
    m = te.get_metrics()
    assert m["rejected_queue_full"] == 0 and m["shed_deadline"] == 0


def test_pump_batch_keeps_siblings_on_shed(weights, jref):
    """A shed inside a pump batch is a per-request result: the siblings
    complete with the JAX engine's tokens, the ids survive."""
    reqs = [dict(prompt=[1 + i, 2, 3], max_new_tokens=6, request_id=f"o{i}")
            for i in range(6)]
    want = {r.request_id: r for r in jref.generate([JReq(**r)
                                                   for r in reqs])}
    pump = EnginePump(_port(weights, max_waiting=2))

    async def run():
        try:
            return await pump.generate([GenerationRequest(**r)
                                        for r in reqs])
        finally:
            await pump.stop()

    results = asyncio.run(run())
    assert [r.request_id for r in results] == [r["request_id"] for r in reqs]
    shed = [r for r in results if r.finish_reason == "overloaded"]
    served = [r for r in results if r.finish_reason == "length"]
    assert shed and served and len(shed) + len(served) == 6
    assert all(r.tokens == [] and r.metadata["overload_reason"] ==
               "queue_full" for r in shed)
    for r in served:
        assert r.tokens == want[r.request_id].tokens


def test_pump_streaming_raises_typed_error(weights):
    """``generate_streaming``, a single-request surface, raises the typed
    error for a shed request; the served ones stream their results."""
    pump = EnginePump(_port(weights, max_slots=1, num_pages=8,
                            max_waiting=1))

    async def run():
        outcomes = {}

        async def client(i):
            frames = []
            try:
                res = await pump.generate_streaming(GenerationRequest(
                    prompt=[1 + i, 2, 3], max_new_tokens=12), frames.extend)
                assert frames == res.tokens
                outcomes[i] = res.finish_reason
            except EngineOverloadedError as e:
                outcomes[i] = f"overloaded:{e.reason}"

        try:
            await asyncio.gather(*(client(i) for i in range(5)))
        finally:
            await pump.stop()
        return outcomes

    outcomes = asyncio.run(run())
    served = [k for k, v in outcomes.items() if v == "length"]
    rejected = [k for k, v in outcomes.items()
                if v == "overloaded:queue_full"]
    assert len(served) + len(rejected) == 5 and served and rejected


def test_pump_streaming_raises_deadline_error(weights):
    from distributed_inference_engine_tpu_torch.engine.types import (
        DeadlineExceededError)

    pump = EnginePump(_port(weights))

    async def run():
        try:
            await pump.generate_streaming(GenerationRequest(
                prompt=[1, 2], deadline_s=0.0, request_id="late"),
                lambda toks: None)
        finally:
            await pump.stop()

    with pytest.raises(DeadlineExceededError):
        asyncio.run(run())


# ---------------------------------------------------------------- warmup


def test_continuous_warmup_returns_all_pages(weights, jref):
    """(admission buckets {1, 2}) x (prefill buckets {16, 64, 128}) = 6
    rounds (the JAX engine's count in its own test), one batched
    admission each, no prefix hit, every page and slot back; then the
    JAX engine's tokens."""
    te = _port(weights, max_slots=2, num_pages=24)
    assert te.warmup() == 6
    m = te.get_metrics()
    assert m["prefill_calls"] == 6 and m["prefix_hit_admissions"] == 0
    assert te.kv.get_stats()["live_slots"] == 0
    assert te.kv.available_pages == 24
    assert te.n_live == 0 and te.n_waiting == 0
    assert te.prefix_cache and te.config.max_waiting == 0
    want = jref.generate([JReq(prompt=[5, 6, 7], max_new_tokens=4)])
    got = te.generate([GenerationRequest(prompt=[5, 6, 7],
                                         max_new_tokens=4)])
    assert got[0].tokens == want[0].tokens and len(got[0].tokens) == 4


def test_warmup_runs_every_served_key_first(weights):
    """On a ragged engine the warmup also runs each (rows, width) bucket
    of the mixed step: a served run afterwards (chunked prompts, decode)
    adds no decode key and no mixed bucket, so on the card it captures no
    graph. Its tokens are those of an engine without the warmup, and
    warmup lifts ``max_waiting`` for its duration."""
    kw = dict(attention_impl="pallas-ragged", prefill_chunk=16,
              max_waiting=1)
    te = _port(weights, **kw)
    rounds = te.warmup()
    assert rounds == 3 * 3 + 3 * 1          # {1,2,4} x ({16,64,128}, {16})
    assert te.config.max_waiting == 1 and te.n_live == 0
    decode_keys, mixed = set(te._decode_keys), set(te._mixed_programs)
    assert {(r, q) for r in (1, 2, 4) for q in (16,)} <= mixed
    prompts = [_prompt(40 + i, n) for i, n in enumerate((5, 23, 40, 70))]
    want = _port(weights, attention_impl="pallas-ragged", prefill_chunk=16
                 ).generate([GenerationRequest(prompt=p, max_new_tokens=6)
                             for p in prompts])
    te.config.max_waiting = 0
    got = te.generate([GenerationRequest(prompt=p, max_new_tokens=6)
                       for p in prompts])
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert te.get_metrics()["mixed_steps"] > 0
    assert te._decode_keys == decode_keys and te._mixed_programs == mixed


async def test_worker_metadata_warmup():
    """``warmup=1`` in a model's metadata runs the engine's warmup at load,
    before any request, on the port's worker as on the JAX one."""
    w = WorkerServer(ServerConfig(worker_id="w", port=0), device="cpu")
    w.load_model(ModelConfig(
        name="m", architecture="llama", dtype="float32", max_batch_size=2,
        max_seq_len=128, metadata={"size": "llama-tiny", "continuous": 1,
                                   "page_size": 16, "prefill_buckets": "[16]",
                                   "warmup": "1"}))
    eng = w.engines["m"]
    assert eng.get_metrics()["total_requests"] >= 2
    assert w._last_warmup["m"][0] == 2 * 2       # {1,2} x {16,128}
    assert eng.n_live == 0 and eng.kv.get_stats()["live_slots"] == 0


# -------------------------------------------------- generate_stream wire


def _stream_factory(weights):
    _, ts, _, tp = weights
    return lambda cfg: ContinuousEngine(ts, params=tp, config=EngineConfig(
        **KW), device="cpu")


async def test_jax_client_streams_from_port_worker(weights, jref):
    """A JAX ``WorkerClient.generate_stream`` against the port's worker:
    the frames, joined, equal the final result's tokens and the JAX
    engine's greedy tokens; a plain ``generate`` agrees."""
    prompt = _prompt(50, 7)
    want = jref.generate([JReq(prompt=prompt, max_new_tokens=9)])[0]
    server = WorkerServer(ServerConfig(worker_id="ts", port=0),
                          engine_factory=_stream_factory(weights))
    server.load_model(ModelConfig(name="tiny", architecture="llama"))
    host, port = await server.start()
    jc = JClient(host, port, timeout=60.0)
    try:
        chunks = []
        res = await jc.generate_stream("tiny", JReq(
            prompt=prompt, max_new_tokens=9, request_id="r"), chunks.append)
        assert [t for c in chunks for t in c] == res.tokens == want.tokens
        assert len(chunks) >= 2 and res.request_id == "r"
        plain = await jc.generate("tiny", [JReq(prompt=prompt,
                                                max_new_tokens=9)])
        assert plain[0].tokens == want.tokens
    finally:
        await jc.close()
        await server.stop()


async def _raw_stream(host, port, model, prompt):
    """One ``generate_stream`` request in raw frames (the JAX package's
    framing): the stream frames and the final envelope."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        await jframing.write_frame(writer, {
            "method": "generate_stream", "id": "x", "model": model,
            "request": {"prompt": prompt, "max_new_tokens": 9}})
        frames = []
        while True:
            frame = await jframing.read_frame(reader, timeout=60.0)
            if not frame.get("stream"):
                return frames, frame
            frames.append(frame)
    finally:
        writer.close()


async def test_port_client_streams_from_jax_worker(weights, jref):
    """The reverse: the port's ``WorkerClient.generate_stream`` against a
    JAX worker (serving the reference engine) gets the JAX engine's
    tokens, frame by frame, and the port's plain ``call`` refuses a
    stream frame. In raw frames, the port's worker answers a
    ``generate_stream`` with the JAX worker's frame keys and final
    envelope keys."""
    prompt = _prompt(51, 12)
    want = jref.generate([JReq(prompt=prompt, max_new_tokens=8)])[0]
    jserver = JServer(JSrvCfg(worker_id="js", port=0),
                      engine_factory=lambda cfg: jref)
    await jserver.start()
    try:
        await jserver.load_model_async(JModel(
            name="tiny", architecture="llama", max_seq_len=128,
            metadata={"continuous": 1}))
        tc = TClient(*jserver.address, timeout=60.0)
        try:
            chunks = []
            res = await tc.generate_stream("tiny", GenerationRequest(
                prompt=prompt, max_new_tokens=8), chunks.append)
            assert [t for c in chunks for t in c] == res.tokens == \
                want.tokens
            with pytest.raises(Exception, match="call_stream"):
                await tc.call("generate_stream", model="tiny",
                              request={"prompt": prompt,
                                       "max_new_tokens": 3})
        finally:
            await tc.close()
        jframes, jfinal = await _raw_stream(*jserver.address, "tiny", prompt)
    finally:
        # the reference engine goes back idle, without the pump's hook
        await jserver._pumps["tiny"].stop()
        await jserver.stop()
        jref.overlap_hook = None

    server = WorkerServer(ServerConfig(worker_id="ts", port=0),
                          engine_factory=_stream_factory(weights))
    server.load_model(ModelConfig(name="tiny", architecture="llama"))
    try:
        frames, final = await _raw_stream(*(await server.start()), "tiny",
                                          prompt)
    finally:
        await server.stop()
    assert [f["tokens"] for f in frames] == [f["tokens"] for f in jframes]
    assert all(set(f) == {"stream", "id", "tokens"}
               for f in frames + jframes)
    assert set(final) - {"worker_id"} == set(jfinal) - {"worker_id"}
    assert set(final["result"]) == set(jfinal["result"])
    assert set(final["result"]["result"]) == \
        set(jfinal["result"]["result"])
    assert final["result"]["result"]["tokens"] == \
        jfinal["result"]["result"]["tokens"]


async def test_worker_counts_sheds_apart_from_errors(weights):
    """A streamed request shed at the queue cap comes back as the typed
    ``overloaded`` error (kind and detail on the envelope), counted in
    ``overloaded_count``, not ``error_count``; ``generate``'s shed results
    count there too."""
    _, ts, _, tp = weights
    server = WorkerServer(ServerConfig(worker_id="tw", port=0),
                          engine_factory=lambda cfg: ContinuousEngine(
                              ts, params=tp, config=EngineConfig(**dict(
                                  KW, max_waiting=1)), device="cpu"))
    server.load_model(ModelConfig(name="tiny", architecture="llama"))
    host, port = await server.start()
    jc = JClient(host, port, timeout=60.0)
    try:
        outs = await jc.generate("tiny", [JReq(prompt=[1 + i, 2],
                                               max_new_tokens=3)
                                          for i in range(4)])
        reasons = [o.finish_reason for o in outs]
        assert "overloaded" in reasons and "length" in reasons
        n_shed = reasons.count("overloaded")
        results = await asyncio.gather(*[jc.generate_stream(
            "tiny", JReq(prompt=[3 + i, 4], max_new_tokens=3),
            lambda t: None) for i in range(4)], return_exceptions=True)
        errs = [r for r in results if isinstance(r, Exception)]
        assert errs and all(getattr(e, "kind", "") == "overloaded"
                            and getattr(e, "detail", "") == "queue_full"
                            for e in errs)
        m = await jc.metrics()
        assert m["overloaded_count"] == n_shed + len(errs)
        assert m["error_count"] == 0
    finally:
        await jc.close()
        await server.stop()


async def test_client_disconnect_mid_stream_keeps_server_alive(weights):
    """A client hanging up mid-stream is routine: the worker keeps
    serving and counts no error."""
    server = WorkerServer(ServerConfig(worker_id="tw", port=0),
                          engine_factory=_stream_factory(weights))
    server.load_model(ModelConfig(name="tiny", architecture="llama"))
    host, port = await server.start()
    try:
        reader, writer = await asyncio.open_connection(host, port)
        await jframing.write_frame(writer, {
            "method": "generate_stream", "id": "x", "model": "tiny",
            "request": {"prompt": [1, 2, 3], "max_new_tokens": 40}})
        frame = await jframing.read_frame(reader, timeout=60.0)
        assert frame.get("stream") is True
        writer.close()
        await asyncio.sleep(0.5)
        c = JClient(host, port, timeout=60.0)
        out = await c.generate("tiny", [JReq(prompt=[1, 2],
                                             max_new_tokens=3)])
        assert len(out[0].tokens) == 3
        assert (await c.metrics())["error_count"] == 0
        await c.close()
    finally:
        await server.stop()


# ------------------------------------------------------ host transfers


def test_host_read_and_uploads_on_the_cpu():
    """On the CPU a packed read is ready at once and returns a copy of
    its own; uploads keep the values and dtype."""
    import torch

    t = torch.arange(6, dtype=torch.int32)
    read = _cuda.HostRead(t)
    assert read.ready()
    host = read.numpy()
    t[0] = 99
    assert host.tolist() == [0, 1, 2, 3, 4, 5]
    up = _cuda.upload(np.arange(4, dtype=np.int64), "cpu", torch.int32)
    assert up.dtype == torch.int32 and up.tolist() == [0, 1, 2, 3]
    dst = torch.zeros(3, dtype=torch.int32)
    _cuda.upload_into(dst, np.asarray([4, 5, 6], np.int64))
    assert dst.tolist() == [4, 5, 6]
