"""The port's worker in the JAX fleet: the event ring (C2), a mixed fleet
behind the JAX coordinator (deploy over ``load_model``, routed and
streamed requests with the JAX worker's greedy tokens, ``worker_trace``,
drain), deploy semantics, residency (stage, swap, LRU eviction, the probe
gate), OpenMetrics over RPC and plain HTTP, ``profile``, the step
timeline, the CLI (no ``--model``, ``--config``) and the fake engines;
each held against the JAX worker or engine on the same inputs."""

import asyncio
import json
import pathlib
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu.api.coordinator import (
    Coordinator,
    CoordinatorConfig,
)
from distributed_inference_engine_tpu.cluster.worker import (
    WorkerClient as JClient,
)
from distributed_inference_engine_tpu.cluster.worker import (
    WorkerServer as JServer,
)
from distributed_inference_engine_tpu.cluster import model_manager as jmm
from distributed_inference_engine_tpu.config import EngineConfig as JEngCfg
from distributed_inference_engine_tpu.config import ModelConfig as JModel
from distributed_inference_engine_tpu.config import ServerConfig as JServerCfg
from distributed_inference_engine_tpu.config import load_config as j_load
from distributed_inference_engine_tpu.engine.continuous import (
    ContinuousEngine as JEngine,
)
from distributed_inference_engine_tpu.engine.types import (
    GenerationRequest as JReq,
)
from distributed_inference_engine_tpu.models import fake as jfake
from distributed_inference_engine_tpu.models.base import init_params
from distributed_inference_engine_tpu.models.llama import llama_spec as jspec
from distributed_inference_engine_tpu.obs import collectors as jcollectors
from distributed_inference_engine_tpu_torch.bridge import params_from_numpy
from distributed_inference_engine_tpu_torch.cluster import model_manager as tmm
from distributed_inference_engine_tpu_torch.cluster.model_manager import (
    GOLDEN_PROMPT,
)
from distributed_inference_engine_tpu_torch.cluster.worker import (
    WorkerClient as TClient,
)
from distributed_inference_engine_tpu_torch.cluster.worker import (
    WorkerServer as TServer,
)
from distributed_inference_engine_tpu_torch.config import (
    EngineConfig,
    ServerConfig,
    load_config,
)
from distributed_inference_engine_tpu_torch.engine.continuous import (
    ContinuousEngine,
)
from distributed_inference_engine_tpu_torch.engine.types import (
    GenerationRequest,
)
from distributed_inference_engine_tpu_torch.models import fake as tfake
from distributed_inference_engine_tpu_torch.models.llama import (
    llama_spec as tspec,
)
from distributed_inference_engine_tpu_torch.obs import collectors
from distributed_inference_engine_tpu_torch.obs.events import (
    canonical_from_snapshot,
)

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
KW = dict(max_slots=4, max_seq_len=128, prefill_buckets=[16, 64],
          page_size=16, num_pages=48, decode_steps_per_call=4,
          kv_dtype="float32")
# llama-tiny fp32 as a fleet deploys it: the JAX worker builds it from
# this config (XLA attention), the port worker from the same weights
TINY_META = {"size": "llama-tiny", "continuous": 1, "page_size": 16,
             "num_pages": 48, "decode_steps_per_call": 4,
             "prefill_buckets": [16, 64], "kv_dtype": "float32",
             "attention_impl": "xla"}
VOCAB_A, VOCAB_B = 997, 1009


def tiny_cfg(name="tiny"):
    return JModel(name=name, architecture="llama", dtype="float32",
                  max_seq_len=128, max_batch_size=4, metadata=dict(TINY_META))


@pytest.fixture(scope="module")
def tiny():
    """The JAX engine's default weights for ``tiny_cfg`` (seed 0), and
    the port's tree of the same values."""
    js = jspec("llama-tiny", dtype="float32", max_seq_len=128)
    ts = tspec("llama-tiny", dtype="float32", max_seq_len=128)
    jp = init_params(js, jax.random.key(0))
    tp = params_from_numpy(jax.device_get(jp), ts, "cpu")
    return js, jp, ts, tp


def port_factory(ts, tp, **over):
    def factory(cfg):
        return ContinuousEngine(ts, params=tp,
                                config=EngineConfig(**{**KW, **over}),
                                device="cpu")
    return factory


def fake_cfg(name="m", **meta):
    md = {"continuous": 1, "max_slots": 4}
    md.update(meta)
    return JModel(name=name, architecture="fake", metadata=md)


def chain_tokens(prompt, n, vocab=VOCAB_A):
    st = 0
    for t in prompt:
        st = jfake._chain(st, t)
    out = []
    for _ in range(n):
        nxt = st % vocab
        st = jfake._chain(st, nxt)
        out.append(nxt)
    return out


def golden(vocab):
    return chain_tokens(list(GOLDEN_PROMPT), 8, vocab)


def prompts(seed=0, lens=(7, 19, 33, 50)):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 1024, size=n).tolist() for n in lens]


async def start_pair(port_kw=None, jax_kw=None, **cfg):
    """A JAX worker and a port worker (CPU) with the same ServerConfig
    fields, started."""
    j = JServer(JServerCfg(worker_id="jw", port=0, **cfg), **(jax_kw or {}))
    t = TServer(ServerConfig(worker_id="tw", port=0, **cfg), device="cpu",
                **(port_kw or {}))
    addrs = [await j.start(), await t.start()]
    return j, t, addrs


async def stop_all(*things):
    for x in things:
        try:
            if isinstance(x, (JClient, TClient)):
                await x.close()
            else:
                await x.stop()
        except Exception:
            pass


# ------------------------------------------------------------ C2: events


async def _event_sequence(server, host, port):
    """One verb sequence: load, a generate of two requests, stage, swap,
    drain; returns the ``events`` payload."""
    c = JClient(host, port, timeout=30.0)
    try:
        await c.load_model(fake_cfg("ma"))
        await c.generate("ma", [JReq(prompt=[3, 1, 4], max_new_tokens=4,
                                     request_id="e0"),
                                JReq(prompt=[2, 7], max_new_tokens=3,
                                     request_id="e1")])
        await c.stage_model(fake_cfg("mb", vocab_size=VOCAB_B))
        await c.swap_model("mb", probe=golden(VOCAB_B))
        await c.drain(timeout_s=5.0)
        return await c.events()
    finally:
        await c.close()


@pytest.mark.parametrize("capacity", [2048, 3])
async def test_event_ring_capacity_keeps_the_last_n(capacity):
    """C2: ``event_ring_capacity`` sizes the port worker's event ring; the
    ``events`` payload has the JAX worker's keys and, after the same verb
    sequence, the JAX worker's event types and arguments in the same
    order, the last ``capacity`` of them, with the same drop count."""
    j, t, ((jh, jp), (th, tp)) = await start_pair(
        event_ring_capacity=capacity)
    try:
        want = await _event_sequence(j, jh, jp)
        got = await _event_sequence(t, th, tp)
    finally:
        await stop_all(j, t)
    assert set(got) == set(want) == {"worker_id", "mono", "wall", "ring",
                                     "timelines"}
    assert set(got["ring"]) == set(want["ring"])
    assert got["ring"]["proc"] == "tw" and got["worker_id"] == "tw"
    types = [e["type"] for e in want["ring"]["events"]]
    full = ["admission.accept", "admission.accept", "model.stage",
            "model.swap", "drain.begin", "drain.done"]
    assert types == full[-capacity:]
    assert [e["type"] for e in got["ring"]["events"]] == types
    assert canonical_from_snapshot(got["ring"]) == \
        canonical_from_snapshot(want["ring"])
    for k in ("seq", "dropped", "schema"):
        assert got["ring"][k] == want["ring"][k], k
    assert len(got["ring"]["events"]) == min(capacity, len(full))
    assert set(got["ring"]["events"][0]) == set(want["ring"]["events"][0])


# ------------------------------------------- a mixed fleet, JAX coordinator


async def test_port_worker_serves_behind_the_jax_coordinator(tiny):
    """The JAX coordinator deploys llama-tiny fp32 to a JAX worker and a
    port worker over ``load_model``; routed and streamed requests come
    back with the JAX engine's greedy tokens; the coordinator's trace of
    a request the port worker served holds that worker's
    ``worker_trace`` marks; ``drain_worker`` on the port worker lets its
    in-flight requests finish, later requests for it move to the JAX
    worker through the shed retry, and its summary has the JAX worker's
    keys (the speculation counters included, since A12)."""
    js, jp, ts, tp = tiny
    want_engine = JEngine(js, params=jp, config=JEngCfg(
        attention_impl="xla", **KW))
    ps = prompts(1, (7, 19, 33, 50, 12, 26))
    want = {i: r.tokens for i, r in enumerate(want_engine.generate(
        [JReq(prompt=p, max_new_tokens=6) for p in ps]))}
    coord = Coordinator(CoordinatorConfig(retry_seed=7,
                                          retry_backoff_base_s=0.01))
    await coord.start()
    j, t, ((jh, jpt), (th, tpt)) = await start_pair(
        port_kw={"engine_factory": port_factory(ts, tp)})
    coord.add_worker("jw", jh, jpt)
    coord.add_worker("tw", th, tpt)
    try:
        assert await coord.deploy_model(tiny_cfg()) == 2
        assert set(t.engines) == set(j.engines) == {"tiny"}
        # routed: every request's tokens are the JAX engine's
        outs = await asyncio.gather(*[
            coord.submit("tiny", prompt=p, max_new_tokens=6,
                         key=f"k{i}", request_id=f"r{i}", no_cache=True)
            for i, p in enumerate(ps)])
        served = {}
        for i, o in enumerate(outs):
            assert o["tokens"] == want[i], i
            served[i] = o["metadata"]["worker_trace"]["worker_id"]
        assert set(served.values()) == {"jw", "tw"}, served
        mine = [i for i, w in served.items() if w == "tw"]
        tr = coord.get_trace(f"r{mine[0]}")
        for phase in ("dispatched", "worker.received", "worker.first_token",
                      "worker.done"):
            assert phase in tr, phase
        assert tr["worker.done"] >= tr["worker.received"] >= \
            tr["dispatched"] - 1e-6
        # streamed, through whichever worker the key routes to
        for i in (mine[0], next(i for i, w in served.items() if w == "jw")):
            chunks = []
            out = await coord.submit_stream(
                "tiny", prompt=ps[i], on_tokens=chunks.append,
                max_new_tokens=6, key=f"k{i}", request_id=f"s{i}")
            assert [x for c in chunks for x in c] == out["tokens"] == \
                want[i]
            assert out["trace"]["worker.done"] >= \
                out["trace"]["worker.received"]
        # drain the port worker with its requests in flight
        busy = [asyncio.ensure_future(coord.submit(
            "tiny", prompt=ps[i], max_new_tokens=6, key=f"k{i}",
            request_id=f"d{i}", no_cache=True)) for i in mine]
        while not t._busy:
            await asyncio.sleep(0.005)
        summary = await coord.drain_worker("tw", timeout_s=30.0,
                                           remove=False)
        for i, f in zip(mine, busy):
            assert (await f)["tokens"] == want[i]
        assert summary["drained"] and summary["in_flight"] == 0
        assert (await TClient(th, tpt).ping())["draining"] is True
        served_before = j.get_metrics()["request_count"]
        later = await asyncio.gather(*[coord.submit(
            "tiny", prompt=ps[i], max_new_tokens=6, key=f"k{i}",
            request_id=f"l{i}", no_cache=True) for i in mine])
        for i, o in zip(mine, later):
            assert o["tokens"] == want[i]
            assert o["metadata"]["worker_trace"]["worker_id"] == "jw"
        assert j.get_metrics()["request_count"] > served_before
        assert t.get_metrics()["overloaded_count"] >= 1
        jsum = await JClient(jh, jpt).drain(timeout_s=30.0)
        assert set(summary) == set(jsum)
        assert set(summary["models"]["tiny"]) == \
            set(jsum["models"]["tiny"])
    finally:
        await coord.stop()
        await stop_all(j, t)


# ------------------------------------------------------- deploy semantics


async def test_deploy_semantics_match_the_jax_worker():
    """An idempotent re-load is a no-op; a different model identity and a
    missing feature raise the JAX worker's errors; ``unload_model``
    answers True once, then False; an unported verb gets the
    unknown-method error."""
    j, t, addrs = await start_pair()
    clients = [JClient(h, p) for h, p in addrs]
    try:
        errs = []
        for srv, c in zip((j, t), clients):
            first = await c.load_model(fake_cfg("m"))
            engine = srv.engines["m"]
            again = await c.load_model(fake_cfg("m"))
            assert again == first and srv.engines["m"] is engine
            assert set(first) == {"loaded", "load_s"}
            row = []
            for bad in (JModel(name="m", architecture="fake",
                               version="2.0", metadata={"continuous": 1}),
                        fake_cfg("m", role="prefill")):
                with pytest.raises(Exception) as e:
                    await c.load_model(bad)
                row.append(str(e.value))
            await c.load_model(JModel(name="s", architecture="fake"))
            with pytest.raises(Exception) as e:
                await c.load_model(fake_cfg("s"))     # needs continuous
            row.append(str(e.value))
            errs.append(row)
            assert await c.unload_model("m") is True
            assert await c.unload_model("m") is False
            assert sorted(srv.engines) == ["s"]
        assert errs[0] == errs[1]
        assert "different config" in errs[1][0]
        # the KV-fabric and disaggregation verbs are not claimed (A10)
        for verb in ("prefill", "prefix_probe", "kv_export", "kv_import",
                     "generate_prefilled", "prefill_generate", "fault_plan"):
            with pytest.raises(Exception, match=f"unknown method '{verb}'"):
                await clients[1].call(verb, model="s")
    finally:
        await stop_all(*clients, j, t)


# --------------------------------------------------------------- residency


async def _residency_sequence(c, budget_kind):
    """load/stage/swap/generate under a budget; returns the receipts, the
    resident sets along the way and the probe-reject error."""
    out = []
    size = {"size_bytes": 100}
    await c.load_model(fake_cfg("ma", **size))
    if budget_kind == "bytes":
        await c.load_model(fake_cfg("mb", vocab_size=VOCAB_B, **size))
        # ma used last: mb is the least recently used idle model
        await c.generate("ma", [JReq(prompt=[5, 5], max_new_tokens=2)])
    out.append((await c.stage_model(fake_cfg("mc", vocab_size=VOCAB_B,
                                             **size))))
    staged = await c.resident_models()
    receipt = await c.swap_model("mc", probe=golden(VOCAB_B))
    out.append({k: v for k, v in receipt.items()
                if k not in ("stage_s", "swap_s")})
    res = await c.resident_models()
    out.append({k: v for k, v in staged.items() if k != "worker_id"})
    out.append({k: v for k, v in res.items() if k != "worker_id"})
    r = await c.generate("mc", [JReq(prompt=[9, 8, 7], max_new_tokens=5)])
    out.append(r[0].tokens)
    await c.stage_model(fake_cfg("md", vocab_size=991, **size))
    with pytest.raises(Exception) as e:
        await c.swap_model("md", probe=golden(VOCAB_B))
    out.append(str(e.value))
    m = await c.metrics()
    out.append({k: m[k] for k in ("resident_models", "resident_bytes",
                                  "staged_models", "stage_started",
                                  "stage_completed", "model_swaps",
                                  "model_evictions", "swap_probe_rejects")})
    return out


@pytest.mark.parametrize("budget", ["count", "bytes"])
async def test_residency_receipts_and_eviction_match_jax(budget):
    """``stage_model``, ``swap_model`` and ``resident_models`` under
    ``max_resident_models=1`` and under ``resident_bytes``: the port
    worker's receipts, eviction order, resident sets, served tokens, probe
    rejection and counters equal the JAX worker's for the same sequence
    of fake engines with declared ``size_bytes``."""
    cfg = ({"max_resident_models": 1} if budget == "count"
           else {"resident_bytes": 250})
    j, t, addrs = await start_pair(**cfg)
    clients = [JClient(h, p) for h, p in addrs]
    try:
        want = await _residency_sequence(clients[0], budget)
        got = await _residency_sequence(clients[1], budget)
    finally:
        await stop_all(*clients, j, t)
    assert got == want
    evicted = want[1]["evicted"]
    assert evicted == (["ma"] if budget == "count" else ["mb"])
    assert want[4] == chain_tokens([9, 8, 7], 5, VOCAB_B)
    assert "swap probe FAILED" in got[5]


@pytest.mark.parametrize("side", ["jax", "port"])
def test_stage_finishes_when_the_overlap_sample_fails(side):
    """A staging thread whose closing ``serving_steps`` sample raises still
    finishes its stage: the swap admits the engine at once, with an
    overlap of 0, in the port's manager as in the JAX one."""
    mod = jmm if side == "jax" else tmm
    samples = iter([5])

    def serving_steps():
        return next(samples)        # the second sample raises

    mgr = mod.ModelManager(lambda cfg: object())
    mgr.stage(fake_cfg("ms"), serving_steps=serving_steps)
    t0 = time.perf_counter()
    receipt = mgr.swap("ms", timeout=30.0)
    assert time.perf_counter() - t0 < 5.0
    assert receipt["overlap_steps"] == 0 and "ms" in mgr.engines


def test_resident_set_survives_touches_during_evictions():
    """Admissions that evict (the engine thread) beside touches, unloads
    and reads (the event loop) leave one consistent resident set."""
    evicted = []
    mgr = tmm.ModelManager(lambda cfg: object(), max_resident_models=2,
                           on_evict=lambda n, e: evicted.append(n))
    errors = []

    def admit():
        try:
            for i in range(3000):
                mgr.admit(fake_cfg(f"m{i % 6}", size_bytes=10), object())
        except Exception as e:       # surfaced below
            errors.append(e)

    th = threading.Thread(target=admit)
    th.start()
    while th.is_alive():
        for i in range(6):
            mgr.touch(f"m{i}")
        mgr.remove("m5")
        mgr.get_stats()
        mgr.resident_bytes_used()
    th.join()
    assert errors == []
    assert len(mgr.engines) <= 2 and evicted
    assert set(mgr.engines) == set(mgr.configs) == set(mgr._lru)
    assert mgr.resident_bytes_used() == 10 * len(mgr.engines)


async def test_unload_detaches_at_once_and_is_not_capped():
    """``unload_model`` takes the model out of the resident set before its
    release runs, and a release longer than ``request_timeout`` (queued
    behind a load on the engine thread) still answers True."""
    t = TServer(ServerConfig(worker_id="tw", port=0, request_timeout=0.3),
                device="cpu")
    host, port = await t.start()
    c = TClient(host, port)
    try:
        await c.load_model(fake_cfg("m"))
        engine = t.engines["m"]
        engine.close = lambda: time.sleep(0.6)
        task = asyncio.ensure_future(c.unload_model("m"))
        await asyncio.sleep(0.1)
        assert (await c.resident_models())["resident"] == []
        assert await task is True
    finally:
        await stop_all(c, t)


# ------------------------------------------------------------- telemetry


def _families(text):
    """Family names with at least one sample in an exposition."""
    names = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        sample = line.split("{", 1)[0].split(" ", 1)[0]
        for sfx in ("_total", "_bucket", "_count", "_sum"):
            if sample.endswith(sfx):
                base = sample[: -len(sfx)]
                if base in jcollectors.CATALOG:
                    sample = base
                    break
        names.add(sample)
    return names


# families the JAX worker fills for the same engine config that the port
# lacks: the KV fabric and disaggregated handoff (A10), fault injection,
# and the process's resident set, which the JAX worker reads through
# psutil where it is installed (the port does not use it). The speculation
# counters the JAX engine reports even when off are the port's too (A12)
NOT_PORTED = {"worker_rss_bytes",
    "kv_fabric_exports", "kv_fabric_imports", "kv_fabric_export_bytes",
    "kv_fabric_import_bytes", "kv_fabric_import_fallbacks",
    "worker_handoff_bytes_shipped", "worker_injected_faults",
}


async def _http_get(host, port, path):
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(1 << 22), timeout=10.0)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return head, body.decode()


async def test_metrics_text_families_match_the_jax_worker(tiny):
    """For the same llama-tiny engine config and the same request, the
    families with samples in the port worker's ``metrics_text`` are the
    JAX worker's less ``NOT_PORTED``; ``GET /metrics`` on the RPC port
    gives the same families, with the OpenMetrics content type; the
    framed RPC still works on that port afterwards."""
    js, jp, ts, tp = tiny
    j, t, addrs = await start_pair(
        port_kw={"engine_factory": port_factory(ts, tp)})
    clients = [JClient(h, p) for h, p in addrs]
    try:
        texts = []
        for c in clients:
            await c.load_model(tiny_cfg())
            await c.generate("tiny", [JReq(prompt=[1, 2, 3, 4],
                                           max_new_tokens=3)])
            await c.metrics_text()                  # scrape-seconds sample
            texts.append(await c.metrics_text())
        jfam, tfam = (_families(x) for x in texts)
        assert tfam == jfam - NOT_PORTED
        assert NOT_PORTED - {"worker_rss_bytes"} <= jfam
        assert tfam <= set(collectors.CATALOG)
        assert {"engine_host_gap_seconds", "worker_resident_bytes",
                "obs_events_emitted", "kv_hbm_bytes"} <= tfam
        head, body = await _http_get(*addrs[1], "/metrics")
        assert head.startswith(b"HTTP/1.1 200")
        assert b"application/openmetrics-text" in head
        assert body.rstrip().endswith("# EOF")
        assert _families(body) == tfam
        head, _ = await _http_get(*addrs[1], "/nope")
        assert head.startswith(b"HTTP/1.1 404")
        assert (await clients[1].ping())["worker_id"] == "tw"
        m = await clients[1].metrics()
        assert m["process"] == {} and m["resident_models"] == 1
    finally:
        await stop_all(*clients, j, t)


async def test_profile_writes_a_trace_and_refuses_a_second_start(
        tiny, tmp_path):
    """``profile start`` then ``stop`` on the CPU writes a Chrome trace
    and each engine's step timeline of the window; a second ``start``
    without a ``stop`` and a ``stop`` without a ``start`` raise the JAX
    worker's errors."""
    js, jp, ts, tp = tiny
    t = TServer(ServerConfig(worker_id="pw", port=0), device="cpu",
                engine_factory=port_factory(ts, tp))
    t.load_model(tiny_cfg())
    host, port = await t.start()
    c = TClient(host, port, timeout=60.0)
    try:
        started = await c.profile("start", trace_dir=str(tmp_path))
        assert started == {"profiling": True, "trace_dir": str(tmp_path)}
        with pytest.raises(Exception, match="profiling already active"):
            await c.profile("start")
        await c.generate("tiny", [GenerationRequest(prompt=[4, 3, 2, 1],
                                                    max_new_tokens=5)])
        done = await c.profile("stop")
        assert done["profiling"] is False
        assert done["trace_dir"] == str(tmp_path)
        trace = json.loads(pathlib.Path(done["trace_file"]).read_text())
        assert "traceEvents" in trace
        kinds = [e["name"] for e in done["timelines"]["tiny"]]
        assert kinds[0] == "prefill" and "decode" in kinds
        (tl,) = done["step_timelines"]
        assert json.loads(pathlib.Path(tl).read_text())["traceEvents"]
        with pytest.raises(Exception, match="profiling is not active"):
            await c.profile("stop")
    finally:
        await stop_all(c, t)


# ----------------------------------------------------------- step timeline


def test_step_timeline_kinds_and_compile_marks_match_jax(tiny, tmp_path):
    """For the same requests (chunked prefill on the split path, a prefix
    hit), the port engine's timeline records have the JAX engine's kinds
    in the same order; ``compile`` marks each program key's first
    dispatch, the port's keys being its graph keys (one mark per decode
    key; an eager admission prefill has none); the Chrome trace loads as
    JSON; the host-gap split is reported; ``timeline_capacity=0``
    disables the timeline in both engines."""
    js, jp, ts, tp = tiny
    kw = dict(KW, prefill_chunk=16)
    ps = prompts(3, (9, 40, 21))
    ps.append(ps[1][:32] + [5, 6, 7])          # a prefix hit, later
    je = JEngine(js, params=jp, config=JEngCfg(attention_impl="xla", **kw))
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(**kw),
                          device="cpu")
    for wave in (ps[:3], ps[3:]):
        jr = je.generate([JReq(prompt=p, max_new_tokens=6) for p in wave])
        tr = te.generate([GenerationRequest(prompt=p, max_new_tokens=6)
                          for p in wave])
        assert [r.tokens for r in tr] == [r.tokens for r in jr]
    jev, tev = je.timeline.events(), te.timeline.events()
    assert [e["name"] for e in tev] == [e["name"] for e in jev]
    assert {"prefill", "prefill_chunk", "decode"} <= {e["name"] for e in tev}
    assert not any(e["args"].get("compile") for e in tev
                   if e["name"] in ("prefill", "prefill_chunk"))
    assert [e["args"]["prefill_tokens"] for e in tev
            if e["name"] != "decode"] == \
        [e["args"]["prefill_tokens"] for e in jev if e["name"] != "decode"]
    decodes = [e for e in tev if e["name"] == "decode"]
    assert decodes[0]["args"]["compile"] is True
    assert sum(bool(e["args"].get("compile")) for e in decodes) == \
        te.get_metrics()["decode_programs"]
    assert all(e["args"]["kv_pages_total"] == 48 for e in decodes)
    doc = json.loads(json.dumps(te.timeline.to_chrome_trace()))
    assert sum(e["ph"] == "X" for e in doc["traceEvents"]) == len(tev)
    path = te.timeline.dump(str(tmp_path / "tl.json"))
    assert json.loads(pathlib.Path(path).read_text())["traceEvents"]
    m = te.get_metrics()
    assert m["dispatch_s_total"] > 0 and m["host_gap_s_total"] >= 0
    assert 0.0 <= m["host_bubble_frac"] < 1.0
    off = dict(kw, timeline_capacity=0)
    je0 = JEngine(js, params=jp, config=JEngCfg(attention_impl="xla", **off))
    te0 = ContinuousEngine(ts, params=tp, config=EngineConfig(**off),
                           device="cpu")
    je0.generate([JReq(prompt=ps[0], max_new_tokens=3)])
    te0.generate([GenerationRequest(prompt=ps[0], max_new_tokens=3)])
    assert je0.timeline is None and te0.timeline is None
    assert te0.get_metrics()["dispatch_s_total"] > 0


# --------------------------------------------------------------------- CLI


TOML = """
[server]
worker_id = "cw"
host = "127.0.0.1"
port = 0
request_timeout = 12.5
max_resident_models = 2
event_ring_capacity = 64

[engine]
max_slots = 4
page_size = 16
prefill_buckets = [16, 64]
timeline_capacity = 128

[[models]]
name = "echo"
architecture = "fake"
max_batch_size = 4

[models.metadata]
continuous = 1
vocab_size = 1009

[[models]]
name = "tiny"
architecture = "llama"
dtype = "float32"

[models.metadata]
size = "llama-tiny"
continuous = 1
"""


def _config_files(tmp_path):
    toml = tmp_path / "w.toml"
    toml.write_text(TOML)
    data = {"server": {"worker_id": "cw", "port": 0, "resident_bytes": 1000,
                       "max_frame_bytes": 1 << 20},
            "engine": {"num_pages": 64, "defer_sync": True},
            "multihost": {"enabled": False, "num_processes": 2},
            "models": [{"name": "echo", "architecture": "fake",
                        "metadata": {"continuous": 1}}],
            "batcher": {"max_batch_size": 3}}
    js = tmp_path / "w.json"
    js.write_text(json.dumps(data))
    return toml, js


def test_config_files_load_as_in_jax(tmp_path):
    """``--config``'s reader: a ``.json`` and a ``.toml`` file give the
    JAX ``load_config``'s models, server and multihost sections, and its
    engine section on every field the port's ``EngineConfig`` has; the
    minimal TOML reader agrees with ``tomllib``; another extension
    raises."""
    from distributed_inference_engine_tpu_torch import config as tconfig

    for path in _config_files(tmp_path):
        got, want = load_config(str(path)), j_load(str(path))
        assert [m.to_dict() for m in got.models] == \
            [m.to_dict() for m in want.models]
        for section in ("server", "multihost"):
            assert (getattr(got, section).__dict__
                    == getattr(want, section).__dict__), section
        for k, v in got.engine.__dict__.items():
            assert getattr(want.engine, k) == v, k
    assert tconfig._parse_toml_minimal(TOML) == tconfig._loads_toml(TOML)
    (tmp_path / "w.ini").write_text("[server]\n")
    with pytest.raises(ValueError, match="unsupported"):
        load_config(str(tmp_path / "w.ini"))


def _start_cli(args):
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_inference_engine_tpu_torch.cli."
         "worker", "--device", "cpu", "--log-level", "WARNING", *args],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []
    deadline = time.time() + 120
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if "listening on" in line:
            host, port = line.rsplit(" ", 1)[1].strip().split(":")
            return proc, host, int(port), lines
    proc.kill()
    raise AssertionError("worker did not come up:\n" + "".join(lines))


@pytest.mark.parametrize("mode", ["empty", "config"])
async def test_cli_starts_empty_or_from_a_config_file(tmp_path, mode):
    """The worker CLI starts with no ``--model`` (a fleet then deploys
    over ``load_model``), or preloads the models of a ``--config`` file
    with its server settings."""
    if mode == "empty":
        args = ["--worker-id", "ew", "--port", "0"]
    else:
        args = ["--config", str(_config_files(tmp_path)[0])]
    proc, host, port, lines = _start_cli(args)
    c = TClient(host, port, timeout=60.0)
    try:
        pong = await c.ping()
        if mode == "empty":
            assert pong["worker_id"] == "ew" and pong["models"] == []
            await c.load_model(fake_cfg("late"))
            assert (await c.ping())["models"] == ["late"]
        else:
            assert pong["worker_id"] == "cw"
            assert pong["models"] == ["echo", "tiny"]
            r = await c.generate("echo", [GenerationRequest(
                prompt=[4, 2], max_new_tokens=3)])
            assert r[0].tokens == chain_tokens([4, 2], 3, VOCAB_B)
            assert (await c.resident_models())["max_resident_models"] == 2
        await c.shutdown()
        assert proc.wait(timeout=60) == 0
    finally:
        await c.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ------------------------------------------------------------ fake engines


def test_fake_engines_give_the_jax_fakes_tokens():
    """``FakeEngine`` and ``FakeContinuousEngine`` emit the JAX fakes'
    tokens, finish reasons and shed outcomes for the same requests and
    knobs (stops, sub-chunk streaming frames, a full queue)."""
    reqs = [dict(prompt=[5, 9, 2], max_new_tokens=7),
            dict(prompt=[1], max_new_tokens=4, stop_ids=[0]),
            dict(prompt=list(range(1, 70)), max_new_tokens=9, eos_id=3)]
    a = jfake.FakeEngine(seed=3).generate([JReq(**r) for r in reqs])
    b = tfake.FakeEngine(seed=3).generate([GenerationRequest(**r)
                                           for r in reqs])
    assert [x.tokens for x in a] == [x.tokens for x in b]
    for kw in (dict(), dict(tokens_per_step=4, stream_chunk_tokens=3),
               dict(vocab_size=7, max_slots=2, prefix_cache=True,
                    prefix_page_size=4, admit_latency_per_token_s=1e-5)):
        outs = []
        for mod, Req in ((jfake, JReq), (tfake, GenerationRequest)):
            eng = mod.FakeContinuousEngine(**kw)
            frames = []
            for i, r in enumerate(reqs):
                eng.submit(Req(request_id=f"f{i}", **r),
                           on_tokens=frames.append if i == 0 else None)
            while eng.n_live or eng.n_waiting:
                eng.step()
            res = sorted(eng.drain_finished(), key=lambda x: x.request_id)
            outs.append(([(x.tokens, x.finish_reason) for x in res], frames))
        assert outs[0] == outs[1], kw
    for mod, Req in ((jfake, JReq), (tfake, GenerationRequest)):
        eng = mod.FakeContinuousEngine(max_waiting=1)
        eng.submit(Req(prompt=[1]))
        with pytest.raises(Exception) as e:
            eng.submit(Req(prompt=[2]))
        assert getattr(e.value, "reason", "") == "queue_full"


async def test_port_workers_with_fakes_serve_behind_the_jax_coordinator():
    """A fleet of two port workers deployed with ``architecture="fake"``
    (the ``ModelConfig`` default) by the JAX coordinator, as the JAX
    fleet tests deploy: routed and streamed requests return the crc32
    chain's tokens."""
    coord = Coordinator(CoordinatorConfig(retry_seed=7,
                                          retry_backoff_base_s=0.01))
    await coord.start()
    workers = [TServer(ServerConfig(worker_id=f"w{i}", port=0),
                       device="cpu") for i in range(2)]
    try:
        for i, w in enumerate(workers):
            coord.add_worker(f"w{i}", *(await w.start()))
        assert await coord.deploy_model(fake_cfg(
            "m", step_latency_s=0.001), register_shards=False) == 2
        ps = [[p, p, 3, 100 + p] for p in range(1, 9)]
        # one at a time: the load balancer alternates between the two
        outs = [await coord.submit("m", prompt=p, max_new_tokens=6,
                                   no_cache=True) for p in ps]
        for p, o in zip(ps, outs):
            assert o["tokens"] == chain_tokens(p, 6)
        assert {o["metadata"]["worker_trace"]["worker_id"]
                for o in outs} == {"w0", "w1"}
        chunks = []
        out = await coord.submit_stream("m", prompt=[4, 4, 4],
                                        on_tokens=chunks.append,
                                        max_new_tokens=5)
        assert [x for c in chunks for x in c] == out["tokens"] == \
            chain_tokens([4, 4, 4], 5)
    finally:
        await coord.stop()
        await stop_all(*workers)
