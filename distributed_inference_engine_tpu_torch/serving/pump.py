"""EnginePump: async facade over the continuous engine's synchronous pump
(port of ``serving/pump.py``, thread discipline unchanged).

``ContinuousEngine`` is single-threaded and synchronous (it queues device
work and blocks once per chunk on its host read), while the worker serves
many concurrent RPC connections. The pump owns a dedicated engine thread;
RPC handlers ``await generate(...)`` and their requests join the SAME
rolling decode batch, so a request arriving mid-flight starts its prefill
at the next chunk boundary.

Thread discipline: every engine method runs on the pump thread only. The
asyncio side talks through a lock-guarded inbox and resolves futures with
``call_soon_threadsafe``. ``drain`` waits until nothing is queued or in
flight (the worker's ``drain`` verb); with an ``event_log`` the pump
records each admission's acceptance or shed in the worker's event ring.
Any engine with ``submit``/``step``/``drain_finished`` runs under it
(the fakes of ``models/fake.py`` too): the overlap hook and the stream
ring's poll are used where the engine has them.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..engine.types import (
    DeadlineExceededError,
    EngineOverloadedError,
    GenerationRequest,
    GenerationResult,
)

logger = logging.getLogger(__name__)

_IDLE_WAIT_S = 0.25       # safety-net poll when idle
_ERROR_BACKOFF_S = 0.05   # pause after a failed step


class EnginePump:
    """Drives a ``ContinuousEngine`` on a dedicated thread; asyncio-facing
    ``generate`` joins requests into the rolling batch."""

    def __init__(self, engine: Any, event_log: Any = None,
                 model: str = "") -> None:
        self.engine = engine
        # the owning worker's event ring (lock-guarded: safe to emit from
        # the pump thread) and the model name its events carry
        self._events = event_log
        self._model = model
        self._overlap_admitted = 0
        self._stream_frames_polled = 0
        self._spec_rounds = 0
        self._poll_stream = getattr(engine, "poll_stream", None)

        # batch-formation overlap: the engine calls this right after
        # queueing a decode chunk, while the device is busy — the inbox
        # drain runs in the step's shadow, then the stream ring's poll
        # (the previous chunk's copy has had a chunk of device time to
        # land), then the async drafter's catch-up round, strictly after
        # the poll: computed tokens go out before predicted ones, and the
        # poll commits the state the catch-up reads. Safe: the hook fires
        # inside engine.step(), which only runs on the pump thread, and it
        # touches the engine only through submit(), poll_stream() and the
        # speculator's schedule() (one queued dispatch, no host read).
        def _overlap() -> None:
            self._overlap_admitted += self._drain_inbox()
            if self._poll_stream is not None:
                self._stream_frames_polled += self._poll_stream()
            spec = getattr(self.engine, "speculator", None)
            if spec is not None:
                self._spec_rounds += spec.schedule()

        if hasattr(engine, "overlap_hook"):
            engine.overlap_hook = _overlap
        # (request, stream callback or None, future, loop)
        self._inbox: List[Tuple[GenerationRequest, Any, asyncio.Future,
                                asyncio.AbstractEventLoop]] = []
        self._inbox_lock = threading.Lock()
        # pump id -> (future, loop, caller's original request id)
        self._futures: Dict[str, Tuple[asyncio.Future,
                                       asyncio.AbstractEventLoop, str]] = {}
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._step_errors = 0
        self._steps = 0
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ asyncio

    async def generate(self, requests: List[GenerationRequest]
                       ) -> List[GenerationResult]:
        """Submit into the rolling batch; resolves when all finish.

        Overload is a per-request outcome: a request refused at the queue
        cap comes back as a result with ``finish_reason="overloaded"`` (no
        tokens) while its siblings complete; single-request callers
        (``generate_streaming``) get the typed error instead."""
        return await self._submit_all(requests)

    async def generate_streaming(self, request: GenerationRequest,
                                 on_tokens) -> GenerationResult:
        """``generate`` for one request, with ``on_tokens(tokens)`` called
        on this loop with each batch of new tokens (trimmed as the final
        result is). A shed request raises ``EngineOverloadedError``, one
        past its own deadline ``DeadlineExceededError``."""
        res = (await self._submit_all([request], on_tokens=on_tokens))[0]
        if res.finish_reason == "overloaded":
            reason = res.metadata.get("overload_reason", "queue_full")
            raise EngineOverloadedError(
                f"request {res.request_id} shed ({reason}); retry on "
                "another replica or later", reason=reason)
        if res.finish_reason == "deadline":
            raise DeadlineExceededError(
                f"request {res.request_id} deadline expired while queued",
                request_id=res.request_id)
        return res

    async def _submit_all(self, requests: List[GenerationRequest],
                          on_tokens=None) -> List[GenerationResult]:
        self._ensure_thread()
        loop = asyncio.get_running_loop()
        cb = None
        if on_tokens is not None:
            # engine thread -> the caller's loop
            def cb(tokens, _loop=loop, _cb=on_tokens):
                _loop.call_soon_threadsafe(_cb, tokens)
        futs: List[asyncio.Future] = []
        with self._inbox_lock:
            for r in requests:
                fut: asyncio.Future = loop.create_future()
                self._inbox.append((r, cb, fut, loop))
                futs.append(fut)
        self._wake.set()
        return list(await asyncio.gather(*futs))

    async def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait until nothing is queued or in flight (the caller stops
        admission first: the worker's ``drain`` verb). True when drained
        within ``timeout_s``, False when work is still pending then."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        while True:
            with self._inbox_lock:
                busy = bool(self._inbox)
            if not (busy or self._futures):
                return True
            if time.monotonic() >= deadline:
                return False
            await asyncio.sleep(0.02)

    async def stop(self) -> None:
        """Stop the thread and wait (up to 5 s) for its step in flight to
        end."""
        self.shutdown_nowait()
        t = self._thread
        if t is not None:
            await asyncio.get_running_loop().run_in_executor(None, t.join,
                                                             5.0)

    def join(self) -> None:
        """Synchronous stop: signal the thread and wait until it has
        exited, so no step or graph replay is in flight (the worker's
        release of an engine, off the event loop)."""
        self.shutdown_nowait()
        t = self._thread
        if t is not None:
            t.join()

    def shutdown_nowait(self) -> None:
        """Synchronous shutdown signal (``WorkerServer.stop``): stops the
        thread and fails every in-flight and queued future so no RPC
        client awaits forever."""
        self._stop.set()
        self._wake.set()
        exc = RuntimeError("engine pump shut down")
        with self._inbox_lock:
            pending, self._inbox = self._inbox, []
        for _req, _cb, fut, loop in pending:
            loop.call_soon_threadsafe(self._set_exc, fut, exc)
        self._fail_all(exc)

    # ------------------------------------------------------------- thread

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="engine-pump", daemon=True)
            self._thread.start()

    def _run(self) -> None:
        logger.info("engine pump started")
        while not self._stop.is_set():
            admitted = self._drain_inbox()
            live = 0
            try:
                if admitted or self.engine.n_live or self.engine.n_waiting:
                    self._steps += 1
                    live = self.engine.step()
                    for res in self.engine.drain_finished():
                        self._resolve(res)
                    # between steps: the chunk step() queued may already
                    # be host-side
                    if self._poll_stream is not None:
                        self._stream_frames_polled += self._poll_stream()
            except Exception as e:  # engine failure fans to all in-flight
                self._step_errors += 1
                logger.exception("engine pump step failed")
                self._fail_all(e)
                # drop the broken batch so n_live can't spin the loop hot,
                # then back off before serving fresh submissions
                try:
                    self.engine.abort_all()
                except Exception:
                    logger.exception("engine abort_all failed")
                time.sleep(_ERROR_BACKOFF_S)
                continue
            if not live and not self.engine.n_waiting:
                # idle: block until new work arrives
                self._wake.wait(timeout=_IDLE_WAIT_S)
                self._wake.clear()
        # fail anything still in flight so no caller hangs on shutdown
        self._fail_all(RuntimeError("engine pump shut down"))
        logger.info("engine pump stopped")

    def _drain_inbox(self) -> int:
        with self._inbox_lock:
            batch, self._inbox = self._inbox, []
        for req, cb, fut, loop in batch:
            pump_id = (f"pump-{id(self):x}-{len(self._futures)}-"
                       f"{time.monotonic_ns()}")
            original_id = req.request_id
            req.request_id = pump_id
            self._futures[pump_id] = (fut, loop, original_id)
            try:
                self.engine.submit(req, on_tokens=cb)
                if self._events is not None:
                    self._events.emit("admission.accept", model=self._model,
                                      request_id=original_id or pump_id)
            except EngineOverloadedError as e:
                # a per-request outcome: siblings already submitted keep
                # their futures (see generate())
                del self._futures[pump_id]
                shed = GenerationResult(
                    request_id=original_id or pump_id, tokens=[],
                    finish_reason="overloaded",
                    prompt_tokens=len(req.prompt),
                    metadata={"overload_reason": e.reason})
                if self._events is not None:
                    self._events.emit("admission.reject", model=self._model,
                                      request_id=original_id or pump_id,
                                      reason=e.reason)
                loop.call_soon_threadsafe(self._set_result, fut, shed)
            except Exception as e:      # e.g. an empty prompt
                del self._futures[pump_id]
                loop.call_soon_threadsafe(self._set_exc, fut, e)
        return len(batch)

    def _resolve(self, res: GenerationResult) -> None:
        entry = self._futures.pop(res.request_id, None)
        if entry is None:
            logger.warning("pump: no future for %s", res.request_id)
            return
        fut, loop, original_id = entry
        res.request_id = original_id or res.request_id
        loop.call_soon_threadsafe(self._set_result, fut, res)

    def _fail_all(self, exc: Exception) -> None:
        futures, self._futures = self._futures, {}
        for fut, loop, _orig in futures.values():
            loop.call_soon_threadsafe(self._set_exc, fut, exc)

    @staticmethod
    def _set_result(fut: asyncio.Future, value: Any) -> None:
        if not fut.done():
            fut.set_result(value)

    @staticmethod
    def _set_exc(fut: asyncio.Future, exc: Exception) -> None:
        if not fut.done():
            fut.set_exception(exc)

    # ------------------------------------------------------------- stats

    def get_stats(self) -> Dict[str, Any]:
        with self._inbox_lock:
            inbox_depth = len(self._inbox)
        return {
            "in_flight": len(self._futures),
            "thread_alive": bool(self._thread and self._thread.is_alive()),
            "steps": self._steps,
            "step_errors": self._step_errors,
            "inbox_depth": inbox_depth,
            # requests admitted INSIDE a device step's shadow via the
            # engine's overlap hook (vs the top-of-loop drain)
            "overlap_admitted": self._overlap_admitted,
            # streamed frames delivered by the ring polls rather than the
            # deferred flush
            "stream_frames_polled": self._stream_frames_polled,
            # draft rounds dispatched from the overlap hook (the step-top
            # propose rounds are the engine's)
            "spec_overlap_rounds": self._spec_rounds,
            "engine": self.engine.get_metrics(),
        }
