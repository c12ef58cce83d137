"""Worker: the framed-RPC server hosting PyTorch engines (port of the
``cluster/worker.py`` subset the serving path needs).

Verbs: ``ping``, ``generate``, ``generate_stream``, ``list_models``,
``metrics``, ``kernel_counts`` and ``shutdown`` — the wire envelope, the
stream frames and the request/result dicts are the JAX worker's, so the
JAX package's ``WorkerClient`` (and coordinator) can drive this worker
unchanged. Each engine gets an ``EnginePump``: concurrent connections
join one rolling decode batch. A model's metadata ``warmup=1`` runs the
engine's ``warmup()`` at load. Not ported yet (ROADMAP.md A6): multi-model
residency budgets, staging/swap, drain, prefill/decode pools, KV fabric,
profiling, events and OpenMetrics text.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import signal
import time
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from ..config import ModelConfig, ServerConfig
from ..engine.types import GenerationRequest, GenerationResult
from ..ops import _cuda
from ..models import _coerce
from ..serving.pump import EnginePump
from ..utils.rpc import FramedRPCClient, FramedServerMixin, relay_stream
from ..utils.tracing import LatencyStats

logger = logging.getLogger(__name__)


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


# -------------------------------------------------------------------- server


class WorkerServer(FramedServerMixin):
    """Framed-RPC worker host for the port's engines."""

    def __init__(self, config: Optional[ServerConfig] = None,
                 engine_factory: Optional[EngineFactory] = None,
                 device="cuda") -> None:
        self.config = config or ServerConfig()
        if self.config.max_resident_models or self.config.resident_bytes:
            raise NotImplementedError(
                "multi-model residency budgets are not ported to the "
                "PyTorch worker yet (ROADMAP.md A6)")
        self.worker_id = self.config.worker_id
        self.engine_factory = engine_factory or (
            lambda cfg: build_engine(cfg, device=device))
        self.engines: Dict[str, Any] = {}
        self.model_configs: Dict[str, ModelConfig] = {}
        self._pumps: Dict[str, Any] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._conn_writers: set = set()
        # engine construction runs here, off the event loop
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"{self.worker_id}-engine")
        self._started_at = 0.0
        self._shutdown_event = asyncio.Event()
        self._request_count = 0
        self._error_count = 0
        self._overloaded_count = 0     # load sheds, apart from real errors
        self._deadline_expired_count = 0
        self._ping_count = 0
        self.latency = LatencyStats()
        self.model_load_stats = LatencyStats()
        self._last_load_s: Dict[str, float] = {}
        # model -> (warmup rounds, seconds) of its load-time warmup
        self._last_warmup: Dict[str, Tuple[int, float]] = {}
        self._methods: Dict[str, Callable[[Dict[str, Any]],
                                          Awaitable[Any]]] = {
            "ping": self._rpc_ping,
            "generate": self._rpc_generate,
            "list_models": self._rpc_list_models,
            "metrics": self._rpc_metrics,
            "kernel_counts": self._rpc_kernel_counts,
            "shutdown": self._rpc_shutdown,
        }
        self._stream_methods = {
            "generate_stream": self._rpc_generate_stream,
        }

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
        for pump in self._pumps.values():
            await pump.stop()
        self._executor.shutdown(wait=False, cancel_futures=True)
        self._shutdown_event.set()
        logger.info("worker %s stopped", self.worker_id)

    async def serve_forever(self) -> None:
        await self._shutdown_event.wait()
        await self.stop()

    # -- models ------------------------------------------------------------

    def _build_engine(self, cfg: ModelConfig):
        """The factory, then (metadata ``warmup=1``) the engine's
        ``warmup()``: the serving programs run once at load, so the first
        requests pay no first-run costs (on the card, no graph
        captures)."""
        engine = self.engine_factory(cfg)
        if _coerce(False, cfg.metadata.get("warmup", False)) and hasattr(
                engine, "warmup"):
            t0 = time.perf_counter()
            n = engine.warmup()
            self._last_warmup[cfg.name] = (n, time.perf_counter() - t0)
            logger.info("worker %s warmed %s (%d rounds, %.2f s)",
                        self.worker_id, cfg.name, n,
                        self._last_warmup[cfg.name][1])
        return engine

    def load_model(self, cfg: ModelConfig) -> None:
        if cfg.name in self.engines:
            raise ValueError(f"model {cfg.name!r} already loaded")
        t0 = time.perf_counter()
        engine = self._build_engine(cfg)
        self.engines[cfg.name] = engine
        self.model_configs[cfg.name] = cfg
        self._pumps[cfg.name] = EnginePump(engine)
        load_s = time.perf_counter() - t0
        self.model_load_stats.add(load_s)
        self._last_load_s[cfg.name] = load_s
        logger.info("worker %s loaded model %s in %.2fs", self.worker_id,
                    cfg.name, load_s)

    async def load_model_async(self, cfg: ModelConfig) -> None:
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(self._executor, self.load_model, cfg)

    # -- RPC hooks -----------------------------------------------------------

    async def _run_handler(self, method: str, handler, msg) -> Any:
        # generate runs as long as its requests; control verbs are bounded
        if method == "generate":
            return await handler(msg)
        return await asyncio.wait_for(handler(msg),
                                      timeout=self.config.request_timeout)

    def _envelope_extra(self) -> Dict[str, Any]:
        return {"worker_id": self.worker_id}

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
                "staged": [], "draining": False}

    def _engine_for(self, msg: Dict[str, Any]):
        name = msg.get("model")
        if not name:
            raise ValueError("missing 'model'")
        engine = self.engines.get(name)
        if engine is None:
            raise ValueError(f"model {name!r} not loaded "
                             f"(have: {sorted(self.engines)})")
        return name, engine

    async def _rpc_generate(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        name, _engine = self._engine_for(msg)
        reqs = [request_from_dict(d) for d in msg.get("requests", [])]
        if not reqs:
            raise ValueError("empty 'requests'")
        self._request_count += 1
        results = await self._pumps[name].generate(reqs)
        # sheds are per-request results, not errors: counted apart
        self._overloaded_count += sum(
            1 for r in results if r.finish_reason == "overloaded")
        self._deadline_expired_count += sum(
            1 for r in results if r.finish_reason == "deadline")
        return {"model": name,
                "results": [result_to_dict(r) for r in results]}

    async def _rpc_generate_stream(self, msg: Dict[str, Any], send
                                   ) -> Dict[str, Any]:
        """Stream one request's tokens as they decode: frames
        ``{"tokens": [...]}`` ride the connection ahead of the final
        result's envelope."""
        name, _engine = self._engine_for(msg)
        req = request_from_dict(msg.get("request") or {})
        self._request_count += 1
        queue: asyncio.Queue = asyncio.Queue()
        fut = asyncio.ensure_future(
            self._pumps[name].generate_streaming(req, queue.put_nowait))
        result = await relay_stream(fut, queue, send)
        return {"model": name, "result": result_to_dict(result)}

    async def _rpc_list_models(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        return {"models": {n: c.to_dict()
                           for n, c in self.model_configs.items()}}

    async def _rpc_metrics(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        return self.get_metrics()

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
            "ping_count": self._ping_count,
            "latency": self.latency.snapshot(),
            "model_load": self.model_load_stats.snapshot(),
            "models": {name: eng.get_metrics()
                       for name, eng in self.engines.items()},
            "pumps": {name: {k: v for k, v in pump.get_stats().items()
                             if k != "engine"}
                      for name, pump in self._pumps.items()},
            "kernel_launches": _cuda.launch_counts(),
        }


# -------------------------------------------------------------------- client


class WorkerClient(FramedRPCClient):
    """Framed-RPC client for one worker (JAX or PyTorch)."""

    async def ping(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        return await self.call("ping", timeout=timeout)

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

    async def list_models(self) -> Dict[str, Any]:
        return await self.call("list_models")

    async def metrics(self) -> Dict[str, Any]:
        return await self.call("metrics")

    async def kernel_counts(self, reset: bool = False) -> Dict[str, int]:
        result = await self.call("kernel_counts", reset=reset)
        return dict(result["launches"])

    async def shutdown(self) -> None:
        await self.call("shutdown")

