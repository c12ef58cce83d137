"""Worker: the framed-RPC server hosting PyTorch engines (port of the
JAX package's ``cluster/worker.py``, wire-compatible with its coordinator
and ``WorkerClient``).

Verbs, with the JAX worker's keys and semantics:

- serving: ``ping`` (with ``staged`` and ``draining``), ``generate`` and
  ``generate_stream`` (each result carries ``metadata["worker_trace"]``,
  phase offsets from this worker's receive time);
- deploy: ``load_model`` (idempotent for the same model identity; a
  different identity or a missing feature raises) and ``unload_model``;
- residency (``cluster/model_manager.py``): ``stage_model`` builds an
  engine on a side thread while the resident ones serve, ``swap_model``
  gates it on a golden probe and admits it under the
  ``max_resident_models``/``resident_bytes`` budget (idle models are
  evicted least recently used first), ``resident_models``;
- ``drain``: refuse new work with the typed ``overloaded``/``draining``
  shed, wait for the work in flight, report a per-model summary;
- telemetry: ``metrics``, ``metrics_text`` (OpenMetrics, also plain
  ``GET /metrics`` on the RPC port), ``events`` (the event ring of
  ``event_ring_capacity`` and every engine's step timeline), ``profile``
  (``torch.profiler``: a Chrome trace, bracketing the step timelines);
- ``list_models``, ``shutdown``, and the port's own ``kernel_counts``.

The KV-fabric and disaggregation verbs (``prefill``, ``prefix_probe``,
``kv_export``, ``kv_import``, ``generate_prefilled``,
``prefill_generate``; ROADMAP.md A10) and fault injection are not ported:
a request for one gets the unknown-method error. Each continuous engine
gets an ``EnginePump``: concurrent connections join one rolling decode
batch. A model's metadata ``warmup=1`` runs the engine's ``warmup()`` at
load (or stage). A model with ``artifact=<dir>`` cold-starts from its
serving artifact where one matches (``engine/artifact.py``), warming the
batch buckets its manifest records; ``metrics`` counts such loads in
``artifact_hits`` and the ones that fell back to the slow path in
``artifact_misses``. ``unload_model`` joins the model's pump thread, drops its
engine's graphs, pools and weights and empties torch's caches, so the
card's memory comes back. The ``process`` dict of ``metrics`` stays empty
(the JAX worker fills it only where psutil is installed).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import gc
import logging
import os
import resource
import signal
import tempfile
import threading
import time
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

import torch

from ..config import ModelConfig, ServerConfig
from ..engine.types import GenerationRequest, GenerationResult
from ..models import _coerce
from ..obs import collectors as obs_collectors
from ..obs.events import EventLog
from ..obs.registry import OPENMETRICS_CONTENT_TYPE, MetricsRegistry
from ..ops import _cuda
from ..serving.pump import EnginePump
from ..utils.rpc import FramedRPCClient, FramedServerMixin, relay_stream
from ..utils.tracing import LatencyStats
from .model_manager import ModelManager, ModelProbeError, ModelStageError

logger = logging.getLogger(__name__)


class WorkerDrainingError(RuntimeError):
    """Admission refused: this worker is draining. Wire kind
    ``overloaded`` with detail ``draining``, so a coordinator's shed
    retry moves the request to another replica (and, a shed not being a
    fault, the drain leaves this worker's health alone)."""

    rpc_error_kind = "overloaded"
    rpc_error_detail = "draining"


# -------------------------------------------------- request/result marshalling


def request_to_dict(r: GenerationRequest) -> Dict[str, Any]:
    return {
        "prompt": list(r.prompt),
        "max_new_tokens": r.max_new_tokens,
        "temperature": r.temperature,
        "top_k": r.top_k,
        "top_p": r.top_p,
        "min_p": r.min_p,
        "request_id": r.request_id,
        "eos_id": r.eos_id,
        "stop_ids": list(r.stop_ids),
        "stop_sequences": [list(s) for s in r.stop_sequences],
        "deadline_s": r.deadline_s,
    }


def request_from_dict(d: Dict[str, Any]) -> GenerationRequest:
    return GenerationRequest(
        prompt=list(d["prompt"]),
        max_new_tokens=int(d.get("max_new_tokens", 16)),
        temperature=float(d.get("temperature", 0.0)),
        top_k=int(d.get("top_k", 0)),
        top_p=float(d.get("top_p", 1.0)),
        min_p=float(d.get("min_p", 0.0)),
        request_id=str(d.get("request_id", "")),
        eos_id=int(d.get("eos_id", -1)),
        stop_ids=[int(t) for t in d.get("stop_ids", [])],
        stop_sequences=[[int(t) for t in s]
                        for s in d.get("stop_sequences", [])],
        deadline_s=(float(d["deadline_s"])
                    if d.get("deadline_s") is not None else None),
    )


def result_to_dict(r: GenerationResult) -> Dict[str, Any]:
    return {
        "request_id": r.request_id,
        "tokens": list(r.tokens),
        "finish_reason": r.finish_reason,
        "prompt_tokens": r.prompt_tokens,
        "logprobs": [float(x) for x in r.logprobs],
        "ttft_s": r.ttft_s,
        "decode_s": r.decode_s,
        "metadata": dict(r.metadata),
    }


def result_from_dict(d: Dict[str, Any]) -> GenerationResult:
    return GenerationResult(
        request_id=str(d.get("request_id", "")),
        tokens=list(d.get("tokens", [])),
        finish_reason=str(d.get("finish_reason", "")),
        prompt_tokens=int(d.get("prompt_tokens", 0)),
        logprobs=[float(x) for x in d.get("logprobs", [])],
        ttft_s=float(d.get("ttft_s", 0.0)),
        decode_s=float(d.get("decode_s", 0.0)),
        metadata=dict(d.get("metadata", {})),
    )


EngineFactory = Callable[[ModelConfig], Any]


def build_engine(cfg: ModelConfig, device="cuda"):
    """Default engine factory: the config-driven ``engine_from_config``."""
    from ..models import engine_from_config

    return engine_from_config(cfg, device=device)


def _model_identity(cfg: ModelConfig):
    """The fields that decide which model an engine serves; engine knobs
    (continuous mode, page sizes, batch limits) are the worker's own."""
    return (cfg.name, cfg.version, cfg.architecture, cfg.path, cfg.dtype,
            cfg.quantized, str(cfg.metadata.get("size", "")))


def _engine_features(cfg: ModelConfig) -> frozenset:
    """The RPC surface an engine config provides. A re-load is a no-op
    only when the hosted engine provides a superset of what the new
    deploy needs."""
    if cfg.metadata.get("role") == "prefill":
        return frozenset({"prefill"})
    if cfg.metadata.get("continuous"):
        return frozenset({"generate", "generate_prefilled"})
    return frozenset({"generate"})


def _free_device_memory(idle: bool = False) -> None:
    """Release the freed blocks: torch's caching allocator (and the
    pinned host blocks of the caching host allocator) keep them until
    asked. ``idle`` (no engine resident or staging): the kernels' split
    scratch and cuBLAS's workspaces go too (``_cuda.release_scratch``),
    so that no segment stays pinned by them."""
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        if idle:
            _cuda.release_scratch()
        torch.cuda.empty_cache()
        empty_host = getattr(torch._C, "_host_emptyCache", None)
        if empty_host is not None:
            empty_host()


def _device_memory() -> Dict[str, int]:
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    return {"allocated_bytes": torch.cuda.memory_allocated(),
            "reserved_bytes": torch.cuda.memory_reserved()}


# -------------------------------------------------------------------- server


class WorkerServer(FramedServerMixin):
    """Framed-RPC worker host for the port's engines."""

    def __init__(self, config: Optional[ServerConfig] = None,
                 engine_factory: Optional[EngineFactory] = None,
                 device="cuda") -> None:
        self.config = config or ServerConfig()
        self.worker_id = self.config.worker_id
        self.engine_factory = engine_factory or (
            lambda cfg: build_engine(cfg, device=device))
        # the manager owns the resident set and the staging, swap and
        # eviction policy; the worker aliases its dicts
        self.model_manager = ModelManager(
            self._build_engine,
            max_resident_models=self.config.max_resident_models,
            resident_bytes=self.config.resident_bytes,
            busy_fn=self._model_busy, on_evict=self._on_model_evicted)
        self.engines: Dict[str, Any] = self.model_manager.engines
        self.model_configs: Dict[str, ModelConfig] = (
            self.model_manager.configs)
        self._pumps: Dict[str, EnginePump] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._conn_writers: set = set()
        # engine construction and release run here, off the event loop
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"{self.worker_id}-engine")
        self._started_at = 0.0
        self._shutdown_event = asyncio.Event()
        self._request_count = 0
        self._error_count = 0
        self._overloaded_count = 0     # load sheds, apart from real errors
        self._deadline_expired_count = 0
        self._ping_count = 0
        self._active_connections = 0
        # drain: admission verbs refuse new work while the work in flight
        # (``_busy`` admission RPCs, the pumps' futures) runs out
        self._draining = False
        self._busy = 0
        self._drain_count = 0
        self.latency = LatencyStats()
        # load_model wall time per load, and whether each artifact-configured
        # load cold-started from its artifact (hit) or fell back to the
        # slow path (miss)
        self.model_load_stats = LatencyStats()
        self._last_load_s: Dict[str, float] = {}
        self._artifact_hits = 0
        self._artifact_misses = 0
        # builds run on the engine thread and on staging threads
        self._artifact_lock = threading.Lock()
        # model -> (warmup rounds, seconds) of its load-time warmup
        self._last_warmup: Dict[str, Tuple[int, float]] = {}
        self._methods: Dict[str, Callable[[Dict[str, Any]],
                                          Awaitable[Any]]] = {
            "ping": self._rpc_ping,
            "generate": self._rpc_generate,
            "load_model": self._rpc_load_model,
            "stage_model": self._rpc_stage_model,
            "swap_model": self._rpc_swap_model,
            "resident_models": self._rpc_resident_models,
            "unload_model": self._rpc_unload_model,
            "list_models": self._rpc_list_models,
            "metrics": self._rpc_metrics,
            "metrics_text": self._rpc_metrics_text,
            "profile": self._rpc_profile,
            "drain": self._rpc_drain,
            "shutdown": self._rpc_shutdown,
            "events": self._rpc_events,
            "kernel_counts": self._rpc_kernel_counts,
        }
        self._stream_methods = {
            "generate_stream": self._rpc_generate_stream,
        }
        # the flight recorder, collected over ``events``
        self.events = EventLog(self.worker_id,
                               capacity=self.config.event_ring_capacity)
        # this worker's dict metrics mirrored into metric families at
        # scrape time (metrics_text, GET /metrics)
        self.obs_registry = MetricsRegistry()
        obs_collectors.ensure_families(self.obs_registry)
        self.obs_registry.add_collector(self._obs_collect)
        self._profiling_dir: Optional[str] = None
        self._profiler: Any = None

    @property
    def max_frame_bytes(self) -> int:
        return self.config.max_frame_bytes

    # -- lifecycle ---------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        if self._server is None:
            raise RuntimeError("worker not started")
        host, port = self._server.sockets[0].getsockname()[:2]
        return host, port

    async def start(self, install_signal_handlers: bool = False
                    ) -> Tuple[str, int]:
        self._server = await asyncio.start_server(
            self._handle_connection, self.config.host, self.config.port)
        self._started_at = time.time()
        if install_signal_handlers:
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(sig, self._shutdown_event.set)
        host, port = self.address
        logger.info("worker %s listening on %s:%d", self.worker_id, host, port)
        return host, port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            self._close_all_connections()
            await self._server.wait_closed()
            self._server = None
        for pump in list(self._pumps.values()):
            await pump.stop()
        if self._profiler is not None:
            self._profiler.stop()
            self._profiler = self._profiling_dir = None
        self._executor.shutdown(wait=False, cancel_futures=True)
        self._shutdown_event.set()
        logger.info("worker %s stopped", self.worker_id)

    async def serve_forever(self) -> None:
        await self._shutdown_event.wait()
        await self.stop()

    # -- models ------------------------------------------------------------

    def _build_engine(self, cfg: ModelConfig):
        """The factory, the artifact accounting, then (metadata
        ``warmup=1``) the engine's warm-up: the serving programs run once
        at load, so the first requests pay no first-run costs (on the
        card, no graph captures). An artifact cold start warms the batch
        buckets its manifest records (``warmup_from_manifest``; the
        factory's artifacts record every bucket the engine serves).
        Shared by ``load_model`` and the staging thread."""
        engine = self.engine_factory(cfg)
        artifact_hit = getattr(engine, "artifact_manifest", None) is not None
        if cfg.metadata.get("artifact"):
            with self._artifact_lock:
                if artifact_hit:
                    self._artifact_hits += 1
                else:
                    self._artifact_misses += 1
        if _coerce(False, cfg.metadata.get("warmup", False)) and hasattr(
                engine, "warmup"):
            t0 = time.perf_counter()
            if artifact_hit and hasattr(engine, "warmup_from_manifest"):
                n = engine.warmup_from_manifest()
            else:
                n = engine.warmup()
            self._last_warmup[cfg.name] = (n, time.perf_counter() - t0)
            logger.info("worker %s warmed %s (%d rounds, %.2f s)",
                        self.worker_id, cfg.name, n,
                        self._last_warmup[cfg.name][1])
        return engine

    def _model_busy(self, name: str) -> bool:
        """Eviction guard: a model with queued or decoding work stays."""
        pump = self._pumps.get(name)
        if pump is not None and pump.get_stats().get("in_flight", 0) > 0:
            return True
        engine = self.engines.get(name)
        return bool(engine is not None and (getattr(engine, "n_live", 0)
                                            or getattr(engine, "n_waiting",
                                                       0)))

    def _release(self, engine: Any, pump: Any) -> None:
        """Stop ``pump`` (its thread joined, so no step or replay is in
        flight), drop ``engine``'s graphs, pools and weights, and give the
        memory back."""
        if pump is not None:
            pump.join()
        close = getattr(engine, "close", None)
        if close is not None:
            close()
        del engine, pump
        _free_device_memory(idle=not self.engines
                            and not self.model_manager.staged_names())

    def _on_model_evicted(self, name: str, engine) -> None:
        self._release(engine, self._pumps.pop(name, None))
        logger.info("worker %s evicted model %s (resident budget)",
                    self.worker_id, name)

    def _start_pump(self, cfg: ModelConfig, engine) -> None:
        """A continuous engine's rolling-batch pump."""
        if hasattr(engine, "submit") and hasattr(engine, "step"):
            self._pumps[cfg.name] = EnginePump(engine, event_log=self.events,
                                               model=cfg.name)

    def _check_idempotent(self, cfg: ModelConfig) -> bool:
        """True when ``cfg`` is already loaded with a compatible config;
        raises on a model identity or feature mismatch."""
        if cfg.name not in self.engines:
            return False
        have = self.model_configs[cfg.name]
        if _model_identity(have) != _model_identity(cfg):
            raise ValueError(
                f"model {cfg.name!r} already loaded with a different config")
        need, got = _engine_features(cfg), _engine_features(have)
        if not need <= got:
            raise ValueError(
                f"model {cfg.name!r} already loaded with features "
                f"{sorted(got)} but this deploy needs {sorted(need)} "
                "— unload it first")
        return True

    def load_model(self, cfg: ModelConfig) -> None:
        if self._check_idempotent(cfg):
            logger.info("worker %s: model %s already loaded (idempotent)",
                        self.worker_id, cfg.name)
            self.model_manager.touch(cfg.name)
            return
        t0 = time.perf_counter()
        engine = self._build_engine(cfg)
        self.model_manager.admit(cfg, engine)
        self._start_pump(cfg, engine)
        load_s = time.perf_counter() - t0
        self.model_load_stats.add(load_s)
        self._last_load_s[cfg.name] = load_s
        logger.info("worker %s loaded model %s (%s) in %.2fs%s",
                    self.worker_id, cfg.name, cfg.architecture, load_s,
                    " [artifact cold-start]"
                    if getattr(engine, "artifact_manifest", None) is not None
                    else "")

    async def load_model_async(self, cfg: ModelConfig) -> None:
        """Load on the engine thread, off the event loop; loads and
        unloads run one at a time."""
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(self._executor, self.load_model, cfg)

    async def unload_model(self, name: str) -> bool:
        """Take ``name`` out of the resident set and the pump table here,
        on the event loop, so the verbs stop seeing it at once; release it
        (pump joined, engine closed, memory freed) on the engine thread,
        after any load or swap queued there. False when not resident."""
        engine = self.model_manager.remove(name)
        pump = self._pumps.pop(name, None)
        if engine is None:
            if pump is not None:
                pump.shutdown_nowait()
            return False
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(self._executor, self._release, engine,
                                   pump)
        logger.info("worker %s unloaded model %s", self.worker_id, name)
        return True

    # -- background staging and hot swap -----------------------------------

    def _serving_steps(self) -> int:
        """Pump steps over every resident continuous engine: the clock the
        staging overlap is counted on."""
        return sum(int(p._steps) for p in list(self._pumps.values()))

    def stage_model(self, cfg: ModelConfig):
        """Begin staging ``cfg`` on a side thread (the pumps keep
        stepping). Idempotent while in flight; None when the model is
        already resident."""
        if cfg.name in self.engines and self._check_idempotent(cfg):
            return None
        return self.model_manager.stage(cfg,
                                        serving_steps=self._serving_steps)

    def swap_model(self, name: str,
                   probe_expected: Optional[List[int]] = None,
                   timeout: Optional[float] = None) -> Dict[str, Any]:
        """Activate a staged model: wait for its build, gate it on the
        probe, admit it (evicting idle models over the budget), give it a
        pump. Blocking: call off the event loop."""
        receipt = self.model_manager.swap(name, probe_expected=probe_expected,
                                          timeout=timeout)
        if not receipt.get("already_resident"):
            self._start_pump(self.model_configs[name], self.engines[name])
        return receipt

    # -- RPC hooks -----------------------------------------------------------

    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        self._active_connections += 1
        try:
            await super()._handle_connection(reader, writer)
        finally:
            self._active_connections -= 1

    async def _run_handler(self, method: str, handler, msg) -> Any:
        # generate, load, swap and unload (queued behind a load or swap on
        # the engine thread) run as long as their work; drain carries its
        # own timeout_s; the other verbs are bounded here
        if method in ("generate", "load_model", "swap_model",
                      "unload_model", "drain"):
            return await handler(msg)
        return await asyncio.wait_for(handler(msg),
                                      timeout=self.config.request_timeout)

    def _envelope_extra(self) -> Dict[str, Any]:
        return {"worker_id": self.worker_id}

    def _timeout_error(self, method: str) -> str:
        return f"request timed out after {self.config.request_timeout}s"

    def _on_handler_error(self, method: str, exc: Exception) -> None:
        if method in ("generate", "generate_stream"):
            # load sheds and expired budgets are the engine working as
            # configured, not faults: each has its own counter
            kind = getattr(exc, "rpc_error_kind", "")
            if kind == "overloaded":
                self._overloaded_count += 1
                return
            if kind == "deadline":
                self._deadline_expired_count += 1
                return
            self._error_count += 1

    def _after_dispatch(self, method: str, req_id: str, duration_s: float,
                        response: Dict[str, Any]) -> None:
        if method in ("generate", "generate_stream"):
            self.latency.add(duration_s)

    # -- RPC methods ---------------------------------------------------------

    async def _rpc_ping(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        self._ping_count += 1
        return {"worker_id": self.worker_id, "time": time.time(),
                "mono": time.perf_counter(), "models": sorted(self.engines),
                "staged": self.model_manager.staged_names(),
                "draining": self._draining}

    def _admit(self) -> None:
        """Admission gate of the work-carrying verbs."""
        if self._draining:
            raise WorkerDrainingError(
                f"worker {self.worker_id} is draining — retry on another "
                "replica")

    def _attach_worker_trace(self, result: GenerationResult,
                             t_recv: float) -> None:
        """This worker's phase marks on the result's metadata, as offsets
        from its receive time (the coordinator anchors them at its own
        ``dispatched`` mark). ``first_token`` is the engine's TTFT, from
        submit."""
        result.metadata.setdefault("worker_trace", {
            "worker_id": self.worker_id,
            "offsets": {"received": 0.0,
                        "first_token": float(result.ttft_s),
                        "done": time.perf_counter() - t_recv},
        })

    def _engine_for(self, msg: Dict[str, Any], capability: str):
        name = msg.get("model")
        if not name:
            raise ValueError("missing 'model'")
        engine = self.engines.get(name)
        if engine is None:
            raise ValueError(f"model {name!r} not loaded "
                             f"(have: {sorted(self.engines)})")
        if not hasattr(engine, capability):
            raise ValueError(
                f"model {name!r} engine ({type(engine).__name__}) does not "
                f"support {capability!r} — wrong pool role?")
        # every routed request refreshes the model's LRU position
        self.model_manager.touch(name)
        return name, engine

    async def _rpc_generate(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        t_recv = time.perf_counter()
        self._admit()
        name, engine = self._engine_for(msg, "generate")
        reqs = [request_from_dict(d) for d in msg.get("requests", [])]
        if not reqs:
            raise ValueError("empty 'requests'")
        self._request_count += 1
        self._busy += 1
        try:
            pump = self._pumps.get(name)
            if pump is not None:
                results = await pump.generate(reqs)
            else:
                loop = asyncio.get_running_loop()
                results = await loop.run_in_executor(
                    self._executor, engine.generate, reqs)
        finally:
            self._busy -= 1
        # sheds are per-request results, not errors: counted apart
        self._overloaded_count += sum(
            1 for r in results if r.finish_reason == "overloaded")
        self._deadline_expired_count += sum(
            1 for r in results if r.finish_reason == "deadline")
        for r in results:
            self._attach_worker_trace(r, t_recv)
        return {"model": name,
                "results": [result_to_dict(r) for r in results]}

    async def _rpc_generate_stream(self, msg: Dict[str, Any], send
                                   ) -> Dict[str, Any]:
        """Stream one request's tokens as they decode: frames
        ``{"tokens": [...]}`` ride the connection ahead of the final
        result's envelope (continuous engines only)."""
        self._admit()
        name, _engine = self._engine_for(msg, "generate")
        pump = self._pumps.get(name)
        if pump is None:
            raise ValueError(
                f"model {name!r} is not a continuous engine — streaming "
                "needs metadata.continuous=1")
        req = request_from_dict(msg.get("request") or {})
        t_recv = time.perf_counter()
        self._request_count += 1
        self._busy += 1
        try:
            queue: asyncio.Queue = asyncio.Queue()
            fut = asyncio.ensure_future(
                pump.generate_streaming(req, queue.put_nowait))
            result = await relay_stream(fut, queue, send)
        finally:
            self._busy -= 1
        self._attach_worker_trace(result, t_recv)
        return {"model": name, "result": result_to_dict(result)}

    async def _rpc_load_model(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        cfg = ModelConfig.from_dict(msg["config"])
        await self.load_model_async(cfg)
        # an idempotent re-load reports the original load's seconds
        return {"loaded": cfg.name,
                "load_s": self._last_load_s.get(cfg.name, 0.0)}

    async def _rpc_stage_model(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Begin background staging and return at once; ``swap_model``
        waits for it, probes it and installs it."""
        cfg = ModelConfig.from_dict(msg["config"])
        rec = self.stage_model(cfg)
        if rec is not None:
            self.events.emit("model.stage", model=cfg.name)
        return {"staging": cfg.name, "already_resident": rec is None}

    async def _rpc_swap_model(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Activate a staged model (probe-gated), on the engine thread."""
        name = msg.get("model")
        if not name:
            raise ValueError("missing 'model'")
        probe = msg.get("probe")
        timeout = msg.get("timeout_s")
        loop = asyncio.get_running_loop()
        try:
            receipt = await loop.run_in_executor(
                self._executor,
                lambda: self.swap_model(
                    name,
                    probe_expected=([int(t) for t in probe]
                                    if probe else None),
                    timeout=float(timeout) if timeout else None))
        except (ModelProbeError, ModelStageError) as e:
            raise ValueError(str(e)) from e
        if not receipt.get("already_resident"):
            self.events.emit("model.swap", model=name)
        return receipt

    async def _rpc_resident_models(self, msg: Dict[str, Any]
                                   ) -> Dict[str, Any]:
        return {"worker_id": self.worker_id,
                "resident": sorted(self.engines),
                "staged": self.model_manager.staged_names(),
                "resident_bytes": self.model_manager.resident_bytes_used(),
                "max_resident_models": self.config.max_resident_models,
                "resident_bytes_budget": self.config.resident_bytes}

    async def _rpc_unload_model(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        return {"unloaded": await self.unload_model(msg["model"])}

    async def _rpc_list_models(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        return {"models": {n: c.to_dict()
                           for n, c in list(self.model_configs.items())}}

    async def _rpc_metrics(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        return self.get_metrics()

    def _obs_collect(self) -> None:
        obs_collectors.clear_worker_labelled(self.obs_registry)
        obs_collectors.apply_worker(self.obs_registry, self.get_metrics())
        obs_collectors.apply_event_log(self.obs_registry,
                                       self.events.get_stats(),
                                       proc=self.worker_id)

    def metrics_text(self) -> str:
        """This worker's metrics as OpenMetrics text. The render times
        itself (``obs_scrape_seconds``, ``obs_scrape_ok``); the sample
        lands on the next exposition."""
        t0 = time.perf_counter()
        try:
            text = self.obs_registry.render()
        except Exception:
            obs_collectors.record_scrape(self.obs_registry, self.worker_id,
                                         time.perf_counter() - t0, ok=False)
            raise
        obs_collectors.record_scrape(self.obs_registry, self.worker_id,
                                     time.perf_counter() - t0, ok=True)
        return text

    async def _rpc_metrics_text(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        return {"content_type": OPENMETRICS_CONTENT_TYPE,
                "text": self.metrics_text()}

    async def _http_get(self, path: str) -> Optional[Tuple[str, bytes]]:
        if path == "/metrics":
            return (OPENMETRICS_CONTENT_TYPE,
                    self.metrics_text().encode("utf-8"))
        return None

    async def _rpc_profile(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Start or stop a ``torch.profiler`` trace of this process (CPU
        ops, and the card's kernels where there is one), bracketing every
        engine's step-timeline capture to the same window. ``stop`` writes
        the Chrome trace and each engine's step timeline into the trace
        directory and returns their paths and the window's records."""
        action = msg.get("action")
        if action == "start":
            if self._profiling_dir is not None:
                raise ValueError(
                    f"profiling already active -> {self._profiling_dir}")
            trace_dir = msg.get("trace_dir") or os.path.join(
                tempfile.gettempdir(), f"{self.worker_id}-trace")
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            self._profiler, self._profiling_dir = prof, trace_dir
            for engine in list(self.engines.values()):
                tl = getattr(engine, "timeline", None)
                if tl is not None:
                    tl.start_capture()
            return {"profiling": True, "trace_dir": trace_dir}
        if action == "stop":
            if self._profiling_dir is None:
                raise ValueError("profiling is not active")
            prof, self._profiler = self._profiler, None
            out, self._profiling_dir = self._profiling_dir, None
            windows = {}
            for name, engine in list(self.engines.items()):
                tl = getattr(engine, "timeline", None)
                if tl is not None:
                    windows[name] = (tl, tl.stop_capture())

            prof.stop()         # on the thread that started it

            def finish() -> Tuple[str, List[str]]:
                os.makedirs(out, exist_ok=True)
                path = os.path.join(out, f"{self.worker_id}.trace.json")
                prof.export_chrome_trace(path)
                return path, [tl.dump(os.path.join(
                    out, f"step_timeline_{name}.json"), evs)
                    for name, (tl, evs) in windows.items()]

            loop = asyncio.get_running_loop()
            path, written = await loop.run_in_executor(None, finish)
            return {"profiling": False, "trace_dir": out,
                    "trace_file": path, "step_timelines": written,
                    "timelines": {n: evs for n, (_, evs) in windows.items()}}
        raise ValueError(f"unknown profile action {action!r} "
                         "(use 'start' or 'stop')")

    async def _rpc_drain(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Graceful drain: stop admitting (new work gets the typed
        ``draining`` shed; ``ping`` shows ``draining``), wait for the work
        in flight (the pumps' inboxes and futures, the ``_busy`` admission
        count), then report a per-model summary of the engines' counters.
        Idempotent; ``timeout_s`` rides in the message."""
        timeout_s = float(msg.get("timeout_s", 30.0))
        if not self._draining:
            self._draining = True
            self._drain_count += 1
            self.events.emit("drain.begin")
            logger.info("worker %s draining (timeout %.1fs)",
                        self.worker_id, timeout_s)
        deadline = time.monotonic() + timeout_s
        drained = True
        for pump in list(self._pumps.values()):
            if not await pump.drain(max(0.0, deadline - time.monotonic())):
                drained = False
        while self._busy > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        if self._busy > 0:
            drained = False
        summary: Dict[str, Any] = {}
        for name, engine in list(self.engines.items()):
            m = engine.get_metrics()
            summary[name] = {
                k: v for k, v in m.items()
                if isinstance(v, (int, float)) and any(
                    t in k for t in ("prefix", "kv", "page", "token",
                                     "request", "waiting", "live"))}
        self.events.emit("drain.done", drained=drained, in_flight=self._busy)
        return {"worker_id": self.worker_id, "drained": drained,
                "in_flight": self._busy, "models": summary}

    async def _rpc_events(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """The event ring and every resident engine's step timeline
        (``perf_counter`` axis), with a fresh ``mono`` stamp."""
        timelines: Dict[str, List[Dict[str, Any]]] = {}
        for name, engine in list(self.engines.items()):
            tl = getattr(engine, "timeline", None)
            if tl is not None:
                timelines[name] = tl.events()
        return {"worker_id": self.worker_id, "mono": time.perf_counter(),
                "wall": time.time(), "ring": self.events.snapshot(),
                "timelines": timelines}

    async def _rpc_kernel_counts(self, msg: Dict[str, Any]
                                 ) -> Dict[str, Any]:
        """This process's CUDA kernel launch counts; ``reset=True`` zeroes
        them after reading (a caller brackets a run with reset/read)."""
        counts = _cuda.launch_counts()
        if msg.get("reset"):
            _cuda.reset_launch_counts()
        return {"worker_id": self.worker_id, "launches": counts}

    async def _rpc_shutdown(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        self._shutdown_event.set()
        return {"shutting_down": True}

    def get_metrics(self) -> Dict[str, Any]:
        return {
            "worker_id": self.worker_id,
            "uptime_s": (time.time() - self._started_at
                         if self._started_at else 0.0),
            "request_count": self._request_count,
            "error_count": self._error_count,
            "overloaded_count": self._overloaded_count,
            "deadline_expired_count": self._deadline_expired_count,
            "draining": 1 if self._draining else 0,
            "drain_count": self._drain_count,
            "ping_count": self._ping_count,
            "active_connections": self._active_connections,
            "latency": self.latency.snapshot(),
            "model_load": self.model_load_stats.snapshot(),
            "artifact_hits": self._artifact_hits,
            "artifact_misses": self._artifact_misses,
            # model -> [rounds, seconds] of its load-time warm-up
            "model_warmup": {n: list(w) for n, w in self._last_warmup.items()},
            # residency: resident and staged gauges, stage and swap
            # histograms, evictions, probe rejects, the staging overlap
            **self.model_manager.get_stats(),
            "models": {name: eng.get_metrics()
                       for name, eng in list(self.engines.items())},
            "pumps": {name: {k: v for k, v in pump.get_stats().items()
                             if k != "engine"}
                      for name, pump in list(self._pumps.items())},
            "process": {},
            # this process's caching allocator on the card (bytes in live
            # tensors, bytes reserved from the device), and its peak
            # resident set on the host (a checkpoint load's footprint)
            "device_memory": _device_memory(),
            "peak_rss_bytes": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024,
            "kernel_launches": _cuda.launch_counts(),
        }


# -------------------------------------------------------------------- client


class WorkerClient(FramedRPCClient):
    """Framed-RPC client for one worker (JAX or PyTorch)."""

    async def ping(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        return await self.call("ping", timeout=timeout)

    async def events(self, timeout: Optional[float] = None
                     ) -> Dict[str, Any]:
        """The event ring and the step timelines."""
        return await self.call("events", timeout=timeout)

    async def generate(self, model: str, requests: List[GenerationRequest],
                       timeout: Optional[float] = None
                       ) -> List[GenerationResult]:
        result = await self.call(
            "generate", model=model,
            requests=[request_to_dict(r) for r in requests], timeout=timeout)
        return [result_from_dict(d) for d in result["results"]]

    async def generate_stream(self, model: str, request: GenerationRequest,
                              on_tokens, timeout: Optional[float] = None
                              ) -> GenerationResult:
        """Stream one request: ``on_tokens(tokens)`` fires per frame;
        returns the final result. ``timeout`` bounds the gap between
        frames, not the whole generation."""
        result = await self.call_stream(
            "generate_stream",
            lambda frame: on_tokens(list(frame.get("tokens", []))),
            model=model, request=request_to_dict(request), timeout=timeout)
        return result_from_dict(result["result"])

    async def load_model(self, cfg: ModelConfig,
                         timeout: Optional[float] = None) -> Dict[str, Any]:
        """Load ``cfg``; returns the receipt ``{loaded, load_s}``."""
        return await self.call("load_model", config=cfg.to_dict(),
                               timeout=timeout if timeout is not None
                               else 300.0)

    async def unload_model(self, name: str) -> bool:
        result = await self.call("unload_model", model=name)
        return bool(result["unloaded"])

    async def stage_model(self, cfg: ModelConfig,
                          timeout: Optional[float] = None) -> Dict[str, Any]:
        """Begin background staging; returns at once."""
        return await self.call("stage_model", config=cfg.to_dict(),
                               timeout=timeout)

    async def swap_model(self, name: str, probe: Optional[List[int]] = None,
                         timeout: Optional[float] = None) -> Dict[str, Any]:
        """Activate a staged model, gated on the ``probe`` tokens; returns
        the receipt ``{swapped, stage_s, swap_s, overlap_steps,
        evicted}``."""
        budget = timeout if timeout is not None else 300.0
        return await self.call(
            "swap_model", model=name,
            probe=[int(t) for t in probe] if probe else None,
            timeout_s=budget, timeout=budget + 10.0)

    async def resident_models(self) -> Dict[str, Any]:
        """The resident and staged models and the byte budget."""
        return await self.call("resident_models")

    async def drain(self, timeout_s: float = 30.0) -> Dict[str, Any]:
        """Drain: stop admission, wait for the work in flight, return the
        per-model summary."""
        return await self.call("drain", timeout_s=timeout_s,
                               timeout=timeout_s + 10.0)

    async def profile(self, action: str, trace_dir: Optional[str] = None,
                      timeout: Optional[float] = None) -> Dict[str, Any]:
        """``profile`` ``start`` (optionally into ``trace_dir``) or
        ``stop``."""
        params: Dict[str, Any] = {"action": action}
        if trace_dir:
            params["trace_dir"] = trace_dir
        return await self.call("profile", timeout=timeout, **params)

    async def list_models(self) -> Dict[str, Any]:
        return await self.call("list_models")

    async def metrics(self) -> Dict[str, Any]:
        return await self.call("metrics")

    async def metrics_text(self) -> str:
        """The worker's OpenMetrics text (the ``/metrics`` body)."""
        return str((await self.call("metrics_text"))["text"])

    async def kernel_counts(self, reset: bool = False) -> Dict[str, int]:
        result = await self.call("kernel_counts", reset=reset)
        return dict(result["launches"])

    async def shutdown(self) -> None:
        await self.call("shutdown")
