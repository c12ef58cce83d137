"""Collector tables of the worker, its engines, pumps and event ring (the
worker and engine parts of the JAX package's ``obs/collectors.py``): each
component's metrics dict mapped onto metric families of the JAX catalog,
with the JAX names, kinds, labels and help.

The tables hold the families the port fills. The JAX catalog's others
belong to modules the port does not carry, and the port's exposition
leaves them out rather than printing empty families for them: the
coordinator, batcher, cache, router, load balancer, registry, autoscaler,
upgrade and SLO families (the host plane), the host KV tier and fabric
families (A10), fault injection and the disaggregated handoff. The
artifact families (``worker_artifact_hits``, ``worker_artifact_misses``)
are filled since the serving artifacts were ported (A11); the speculative
engine's and the async drafter's (``engine_spec_*``), and the static
engine's ``engine_decode_seconds``, since speculation and the static
engine were (A12, A8).

Per-engine families (``engine_*``, ``kv_*``, ``pump_*``) carry ``model``
and ``worker_id``; ``worker_*`` families carry ``worker_id``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

from .registry import MetricsRegistry

MODEL_LABELS = ("model", "worker_id")
WORKER_LABELS = ("worker_id",)

# (source_key, metric_name, kind, help); kind: c=counter g=gauge h=histogram

ENGINE_TABLE = [
    ("total_requests", "engine_requests", "c",
     "Requests accepted by the engine"),
    ("total_prompt_tokens", "engine_prompt_tokens", "c",
     "Prompt tokens prefetched/prefilled"),
    ("total_generated_tokens", "engine_generated_tokens", "c",
     "Tokens generated (post stop-trim)"),
    ("total_errors", "engine_errors", "c", "Engine-level request errors"),
    ("admission_denied", "engine_admission_denied", "c",
     "Admissions denied (no slot/pages at the time)"),
    ("rejected_queue_full", "engine_rejected_queue_full", "c",
     "Requests shed at submit: waiting queue full"),
    ("shed_deadline", "engine_shed_deadline", "c",
     "Requests shed after exceeding the queue deadline"),
    ("deadline_expired", "engine_deadline_expired", "c",
     "Requests expired in-queue by their own deadline_s budget"),
    ("capacity_finishes", "engine_capacity_finishes", "c",
     "Sequences force-finished (reason=length) by KV-pool exhaustion"),
    ("engine_steps", "engine_steps", "c",
     "Engine iterations (decode or mixed dispatches)"),
    ("prefill_calls", "engine_prefill_calls", "c",
     "Prefill dispatches (whole-prompt or chunk)"),
    ("mixed_steps", "engine_mixed_steps", "c",
     "Ragged mixed-batch dispatches (decode + prefill chunks)"),
    ("mixed_prefill_tokens", "engine_mixed_prefill_tokens", "c",
     "Prefill tokens carried by mixed dispatches"),
    ("prefix_hit_admissions", "engine_prefix_hit_admissions", "c",
     "Admissions that reused cached prefix KV pages"),
    ("chunked_admissions", "engine_chunked_admissions", "c",
     "Admissions that prefill in chunks"),
    ("deferred_admissions", "engine_deferred_admissions", "c",
     "Admissions whose first-token read was deferred"),
    ("rounds", "engine_spec_rounds", "c",
     "Speculative target+draft verification rounds"),
    ("waiting", "engine_waiting", "g", "Requests in the waiting queue"),
    ("live_slots", "engine_live_slots", "g", "Decoding slots right now"),
    ("prefilling_slots", "engine_prefilling_slots", "g",
     "Slots mid chunked prefill"),
    ("mixed_programs", "engine_mixed_programs", "g",
     "Distinct compiled mixed-step programs"),
    ("batch_occupancy", "engine_batch_occupancy", "g",
     "Mean live slots / max_slots per engine step"),
    ("dispatch_s_total", "engine_dispatch_seconds", "c",
     "Seconds inside device dispatch brackets (host-gap split)"),
    ("host_gap_s_total", "engine_host_gap_seconds", "c",
     "Host seconds between consecutive dispatch brackets"),
    ("host_bubble_frac", "engine_host_bubble_fraction", "g",
     "Host gap share of dispatch+gap wall (roofline split)"),
    ("speculate_k", "engine_spec_k", "g", "Draft tokens proposed per round"),
    ("draft_acceptance_rate", "engine_spec_draft_acceptance_rate", "g",
     "Accepted / proposed draft tokens"),
    ("tokens_per_round", "engine_spec_tokens_per_round", "g",
     "Mean tokens emitted per speculative round"),
    ("spec_async_drafted_tokens", "engine_spec_async_drafted_tokens", "c",
     "Draft tokens proposed by the async bubble drafter"),
    ("spec_async_accepted_tokens", "engine_spec_async_accepted_tokens", "c",
     "Async draft tokens accepted and emitted by verify"),
    ("spec_async_wasted_tokens", "engine_spec_async_wasted_tokens", "c",
     "Async draft tokens discarded (rejected, stale, or clipped)"),
    ("spec_async_catchup_tokens", "engine_spec_async_catchup_tokens", "c",
     "Tokens re-forwarded to catch the draft KV cache up"),
    ("spec_async_accept_rate", "engine_spec_async_accept_rate", "g",
     "Accepted / drafted async speculation tokens"),
    ("spec_async_draft_rounds", "engine_spec_async_draft_rounds", "c",
     "Async draft dispatches (catch-up or propose)"),
    ("spec_async_propose_rounds", "engine_spec_async_propose_rounds", "c",
     "Async draft dispatches that proposed draft tokens"),
    ("spec_async_auto_idles", "engine_spec_async_auto_idles", "c",
     "Scheduler passes skipped: bubble below spec_bubble_floor_s"),
    ("spec_async_bubble_consumed_s", "engine_spec_async_bubble_"
     "consumed_seconds", "c",
     "Host seconds the drafter spent inside the megastep bubble"),
    ("spec_async_draft_cost_ema_s", "engine_spec_async_draft_cost_"
     "ema_seconds", "g",
     "EMA host cost of one draft round (budget gate input)"),
    ("spec_async_pending", "engine_spec_async_pending", "g",
     "Draft proposals awaiting piggybacked verification"),
    ("spec_async_verify_steps", "engine_spec_async_verify_steps", "c",
     "Megasteps that carried extra draft verify columns"),
    ("stream_ring_pushes", "engine_stream_ring_pushes", "c",
     "Decode chunks pushed onto the device->host token ring"),
    ("stream_ring_polls", "engine_stream_ring_polls", "c",
     "poll_stream calls that found ring entries in flight"),
    ("stream_ring_ready_polls", "engine_stream_ring_ready_polls", "c",
     "Ring entries harvested early by a host-bubble poll"),
    ("stream_ring_depth", "engine_stream_ring_depth", "g",
     "High-water depth of the device->host token ring"),
    ("stream_clamped_chunks", "engine_stream_clamped_chunks", "c",
     "Decode chunks shortened by the adaptive streaming clamp"),
    ("firsts_fetches", "engine_firsts_fetches", "c",
     "Whole-buffer deferred-firsts readbacks (one per invalidation)"),
    ("ttft", "engine_ttft_seconds", "h",
     "Time to first token (continuous: from submit, incl. queue wait)"),
    ("prefill", "engine_prefill_seconds", "h", "Prefill dispatch wall time"),
    ("decode_chunk", "engine_decode_chunk_seconds", "h",
     "Decode-chunk wall time (defer_sync: residual blocking wait)"),
    ("decode", "engine_decode_seconds", "h",
     "Decode wall time per generate call (static/speculative engines)"),
]

KV_TABLE = [                       # PagedKVCache.get_stats()
    ("num_pages", "kv_pages", "g", "HBM page-pool size"),
    ("page_size", "kv_page_size", "g", "Tokens per KV page"),
    ("pages_used", "kv_pages_used", "g", "Pages allocated to live slots"),
    ("pages_free", "kv_pages_free", "g", "Pages on the free list"),
    ("pages_cached", "kv_pages_cached", "g",
     "Reclaimable pages held by the prefix cache"),
    ("peak_pages_used", "kv_peak_pages_used", "g",
     "High-water pages_used since start"),
    ("utilization", "kv_utilization", "g", "pages_used / num_pages"),
    ("live_slots", "kv_live_slots", "g", "Slots with page tables"),
    ("free_slots", "kv_free_slots", "g", "Unassigned slot ids"),
    ("prefix_queries", "kv_prefix_queries", "c",
     "Prefix-cache lookups at admission"),
    ("prefix_hit_pages", "kv_prefix_hit_pages", "c",
     "Pages served from the prefix cache"),
    ("prefix_hit_tokens", "kv_prefix_hit_tokens", "c",
     "Prompt tokens whose prefill was skipped via prefix hits"),
    ("prefix_reclaimed", "kv_prefix_reclaimed", "c",
     "Cached pages reclaimed for new allocations"),
    ("prefix_indexed", "kv_prefix_indexed", "g",
     "Page hashes currently in the prefix index"),
    ("hbm_bytes", "kv_hbm_bytes", "g", "Device bytes held by the page pools"),
]

PUMP_TABLE = [                     # EnginePump.get_stats() (sans "engine")
    ("in_flight", "pump_in_flight", "g",
     "Requests inside the pump (inbox + engine)"),
    ("thread_alive", "pump_thread_alive", "g",
     "1 while the engine thread is running"),
    ("steps", "pump_steps", "c", "engine.step() calls by the pump thread"),
    ("step_errors", "pump_step_errors", "c",
     "Engine steps that raised (backed off and continued)"),
    ("inbox_depth", "pump_inbox_depth", "g",
     "Requests enqueued but not yet admitted"),
]

WORKER_TABLE = [                   # WorkerServer.get_metrics() top level
    ("uptime_s", "worker_uptime_seconds", "g", "Seconds since start"),
    ("request_count", "worker_requests", "c",
     "generate/generate_stream RPCs served"),
    ("error_count", "worker_errors", "c", "RPC handler errors"),
    ("overloaded_count", "worker_overloaded", "c",
     "Requests shed by engine overload handling"),
    ("deadline_expired_count", "worker_deadline_expired", "c",
     "Requests whose deadline_s budget expired on this worker"),
    ("draining", "worker_draining", "g",
     "1 while the worker refuses admission (drain in progress)"),
    ("drain_count", "worker_drains", "c", "Drain RPCs honored"),
    ("ping_count", "worker_pings", "c", "Health probes answered"),
    ("active_connections", "worker_active_connections", "g",
     "Open RPC connections"),
    ("artifact_hits", "worker_artifact_hits", "c",
     "Model loads cold-started from a pre-fused serving artifact"),
    ("artifact_misses", "worker_artifact_misses", "c",
     "Artifact-configured loads that fell back to the slow path"),
    ("latency", "worker_request_seconds", "h",
     "generate/generate_stream RPC wall time"),
    ("model_load", "worker_model_load_seconds", "h",
     "load_model wall time (artifact cold-start vs slow path)"),
    ("resident_models", "worker_resident_models", "g",
     "Models resident (engine built, serving-ready) on this worker"),
    ("resident_bytes", "worker_resident_bytes", "g",
     "Parameter bytes held by resident models"),
    ("staged_models", "worker_staged_models", "g",
     "Models staging in the background (built, not yet swapped in)"),
    ("stage_started", "worker_stage_started", "c",
     "Background model stages started"),
    ("stage_completed", "worker_stage_completed", "c",
     "Background model stages that finished building"),
    ("stage_failed", "worker_stage_failed", "c",
     "Background model stages that raised during build"),
    ("model_swaps", "worker_model_swaps", "c",
     "Hot swaps that activated a staged model"),
    ("model_evictions", "worker_model_evictions", "c",
     "Idle models evicted by the resident count/byte budget (LRU)"),
    ("swap_probe_rejects", "worker_swap_probe_rejects", "c",
     "Swaps refused by the golden-token probe (staged engine discarded)"),
    ("stage_overlap_steps", "worker_stage_overlap_steps", "c",
     "Engine steps served by resident models while a stage ran"),
    ("model_stage", "worker_stage_seconds", "h",
     "Background stage wall time (artifact restore off the dispatch path)"),
    ("model_swap", "worker_model_swap_seconds", "h",
     "swap_model wall time the caller observed (stage overlap excluded)"),
]

# families whose label values are dynamic
EXTRA_FAMILIES = [
    ("obs_scrape_seconds", "h", ("server",),
     "Wall time to collect and render one /metrics exposition"),
    ("obs_scrape_ok", "g", ("server",),
     "1 if the last /metrics scrape rendered without error"),
    ("obs_events_emitted", "c", ("proc",),
     "Typed fleet events emitted into this process's ring"),
    ("obs_events_dropped", "c", ("proc",),
     "Fleet events overwritten by ring wrap (oldest evicted)"),
]

_GROUPS: List[Tuple[List, Tuple[str, ...]]] = [
    (ENGINE_TABLE, MODEL_LABELS),
    (KV_TABLE, MODEL_LABELS),
    (PUMP_TABLE, MODEL_LABELS),
    (WORKER_TABLE, WORKER_LABELS),
]

_KINDS = {"c": "counter", "g": "gauge", "h": "histogram"}


def _build_catalog() -> Dict[str, Tuple[str, Tuple[str, ...], str]]:
    cat: Dict[str, Tuple[str, Tuple[str, ...], str]] = {}
    for table, labels in _GROUPS:
        for _src, name, kind, help in table:
            cat[name] = (_KINDS[kind], labels, help)
    for name, kind, labels, help in EXTRA_FAMILIES:
        cat[name] = (_KINDS[kind], tuple(labels), help)
    return cat


#: metric family name -> (kind, labelnames, help)
CATALOG: Dict[str, Tuple[str, Tuple[str, ...], str]] = _build_catalog()


def ensure_families(reg: MetricsRegistry) -> None:
    """Register every catalog family (idempotent), so an exposition
    carries every TYPE/HELP line even before a component reports."""
    for name, (kind, labels, help) in CATALOG.items():
        getattr(reg, kind)(name, help, labels)


def clear_worker_labelled(reg: MetricsRegistry) -> None:
    """Drop the children of every family labelled by worker_id, so a
    scrape leaves no series of an unloaded model behind."""
    for name in reg.names:
        fam = reg.get(name)
        if fam is not None and "worker_id" in fam.labelnames:
            fam.clear()


def _apply_table(reg: MetricsRegistry, table, src: Mapping[str, Any],
                 labelnames: Tuple[str, ...],
                 labels: Dict[str, str]) -> None:
    for src_key, name, kind, help in table:
        if src_key not in src:
            continue                       # engines differ in what they report
        v = src[src_key]
        if kind == "c":
            reg.counter(name, help, labelnames).labels(**labels).set(
                float(v))
        elif kind == "g":
            reg.gauge(name, help, labelnames).labels(**labels).set(float(v))
        elif kind == "h" and isinstance(v, Mapping):
            buckets = v.get("buckets")
            if buckets:
                reg.histogram(name, help, labelnames).labels(
                    **labels).set_snapshot(
                        buckets, v.get("sum_s", 0.0), v.get("count", 0))


def apply_engine(reg: MetricsRegistry, m: Optional[Mapping[str, Any]],
                 model: str = "", worker_id: str = "") -> None:
    """One engine's ``get_metrics()`` dict, with its ``kv`` sub-dict."""
    if not m:
        return
    labels = {"model": model, "worker_id": worker_id}
    _apply_table(reg, ENGINE_TABLE, m, MODEL_LABELS, labels)
    kv = m.get("kv")
    if isinstance(kv, Mapping):
        _apply_table(reg, KV_TABLE, kv, MODEL_LABELS, labels)


def apply_pump(reg: MetricsRegistry, ps: Optional[Mapping[str, Any]],
               model: str = "", worker_id: str = "") -> None:
    if ps:
        _apply_table(reg, PUMP_TABLE, ps, MODEL_LABELS,
                     {"model": model, "worker_id": worker_id})


def apply_event_log(reg: MetricsRegistry, s: Optional[Mapping[str, Any]],
                    proc: str) -> None:
    """An ``EventLog.get_stats()`` dict for one process's ring."""
    if not s:
        return
    labels = {"proc": str(proc)}
    reg.counter("obs_events_emitted", CATALOG["obs_events_emitted"][2],
                ("proc",)).labels(**labels).set(
                    float(s.get("events_emitted", 0)))
    reg.counter("obs_events_dropped", CATALOG["obs_events_dropped"][2],
                ("proc",)).labels(**labels).set(
                    float(s.get("events_dropped", 0)))


def record_scrape(reg: MetricsRegistry, server: str, seconds: float,
                  ok: bool) -> None:
    """One scrape's collect-and-render wall time and outcome, recorded
    after the render, so it shows on the next exposition."""
    labels = {"server": str(server)}
    reg.histogram("obs_scrape_seconds", CATALOG["obs_scrape_seconds"][2],
                  ("server",)).labels(**labels).observe(float(seconds))
    reg.gauge("obs_scrape_ok", CATALOG["obs_scrape_ok"][2],
              ("server",)).labels(**labels).set(1.0 if ok else 0.0)


def apply_worker(reg: MetricsRegistry, wm: Optional[Mapping[str, Any]],
                 worker_id: Optional[str] = None) -> None:
    """A ``WorkerServer.get_metrics()`` dict: the worker families plus
    every loaded model's engine metrics and pump stats."""
    if not wm:
        return
    wid = str(worker_id if worker_id is not None
              else wm.get("worker_id", ""))
    _apply_table(reg, WORKER_TABLE, wm, WORKER_LABELS, {"worker_id": wid})
    models = wm.get("models")
    if isinstance(models, Mapping):
        for model, em in models.items():
            apply_engine(reg, em, model=str(model), worker_id=wid)
    pumps = wm.get("pumps")
    if isinstance(pumps, Mapping):
        for model, ps in pumps.items():
            apply_pump(reg, ps, model=str(model), worker_id=wid)
