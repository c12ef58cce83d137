"""Framed-RPC client and server loop (port of the parts of the JAX
package's ``utils/rpc.py`` that the port's worker verbs need).

Request: ``{"method": m, "id": ..., **params}``; response envelope:
``{"id", "success", "result" | "error"[, "error_kind", "error_detail"],
**extra}``; a streaming method sends ``{"stream": true, "id": ...,
**chunk}`` frames ahead of its envelope — the same frames as the JAX
plane, so either side's client talks to either side's server. A
connection whose first bytes spell an HTTP verb gets one plain-HTTP
answer instead (``GET /metrics`` on the RPC port, ``_http_get``). Not
ported: fault injection.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from .framing import (
    HEADER_SIZE,
    FrameError,
    read_frame,
    read_frame_after_header,
    write_frame,
)

logger = logging.getLogger(__name__)

# a frame starts with magic 0xD17E, never printable ASCII: a connection
# whose first four bytes spell an HTTP verb is a plain HTTP client
_HTTP_VERB_PREFIXES = (b"GET ", b"HEAD", b"POST", b"PUT ", b"DELE",
                       b"OPTI", b"PATC")


class RPCError(RuntimeError):
    """Peer-reported request failure (distinct from transport failure);
    ``kind``/``detail`` carry the envelope's machine-readable class."""

    def __init__(self, message: str, kind: str = "",
                 detail: str = "") -> None:
        super().__init__(message)
        self.kind = kind
        self.detail = detail


class FramedRPCClient:
    """Pooled framed-RPC client: concurrent calls ride their own
    connections (at most ``max_connections``); one frame in flight per
    connection; a connection that fails mid-call is discarded."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 max_frame: int = 64 * 1024 * 1024,
                 max_connections: int = 8) -> None:
        self.host = host
        self.port = port
        self.timeout = timeout
        self.max_frame = max_frame
        self.max_connections = max(1, max_connections)
        self._free: List[Tuple[asyncio.StreamReader,
                               asyncio.StreamWriter]] = []
        self._slots: Optional[asyncio.Semaphore] = None
        self._seq = 0

    async def _acquire(self, timeout: float):
        while self._free:
            reader, writer = self._free.pop()
            if not writer.is_closing():
                return reader, writer
        return await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port), timeout=timeout)

    async def close(self) -> None:
        free, self._free = self._free, []
        for _reader, writer in free:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def call(self, method: str, *, timeout: Optional[float] = None,
                   **params: Any) -> Any:
        """One request frame, one response frame. Raises ``RPCError`` when
        the peer reports failure (or sends a stream frame: use
        ``call_stream``); transport errors propagate."""
        return await self._roundtrip(method, None, timeout, params)

    async def call_stream(self, method: str, on_chunk: Callable[[Dict], None],
                          *, timeout: Optional[float] = None,
                          **params: Any) -> Any:
        """One request, then the stream frames (each passed to
        ``on_chunk``) ahead of the usual envelope; returns the final
        result. ``timeout`` bounds each frame's read, not the call."""
        return await self._roundtrip(method, on_chunk, timeout, params)

    async def _roundtrip(self, method: str,
                         on_chunk: Optional[Callable[[Dict], None]],
                         timeout: Optional[float],
                         params: Dict[str, Any]) -> Any:
        """The one request/response cycle of ``call`` and
        ``call_stream``."""
        if self._slots is None:
            self._slots = asyncio.Semaphore(self.max_connections)
        self._seq += 1
        msg = {"method": method, "id": f"{id(self):x}-{self._seq}", **params}
        effective = timeout if timeout is not None else self.timeout
        async with self._slots:
            conn = await self._acquire(effective)
            try:
                await write_frame(conn[1], msg)
                while True:
                    frame = await read_frame(conn[0],
                                             max_frame=self.max_frame,
                                             timeout=effective)
                    if isinstance(frame, dict) and frame.get("stream"):
                        if on_chunk is None:
                            raise RPCError(
                                f"unexpected stream frame from {method!r} "
                                "— use call_stream for streaming methods")
                        on_chunk(frame)
                        continue
                    response = frame
                    break
            except BaseException:
                # a cancelled or failed caller leaves frames on the socket
                conn[1].close()
                raise
            self._free.append(conn)
        if not isinstance(response, dict):
            raise RPCError(f"malformed response: {response!r}")
        if not response.get("success"):
            raise RPCError(response.get("error", "unknown peer error"),
                           kind=str(response.get("error_kind", "")),
                           detail=str(response.get("error_detail", "")))
        return response.get("result")


class ClientGone(Exception):
    """The streaming client hung up mid-stream — not a handler failure."""


async def relay_stream(fut: "asyncio.Future", queue: "asyncio.Queue",
                       send) -> Any:
    """Forward token chunks from ``queue`` to ``send`` until ``fut``
    resolves, send the stragglers, return the result. Sound because the
    chunk callbacks and the future's resolution ride the same
    ``call_soon_threadsafe`` FIFO: when ``fut`` is done, every chunk is
    queued."""
    try:
        while True:
            getter = asyncio.ensure_future(queue.get())
            done, _ = await asyncio.wait(
                {getter, fut}, return_when=asyncio.FIRST_COMPLETED)
            if getter in done:
                await send({"tokens": getter.result()})
                continue
            getter.cancel()
            break
        while not queue.empty():
            await send({"tokens": queue.get_nowait()})
        return await fut
    except BaseException:
        fut.cancel()
        raise


def _error_envelope(req_id: str, extra: Dict[str, Any],
                    e: Exception) -> Dict[str, Any]:
    response = {"id": req_id, "success": False, **extra, "error": str(e)}
    kind = getattr(e, "rpc_error_kind", "") or getattr(e, "kind", "")
    if kind:
        response["error_kind"] = kind
    detail = (getattr(e, "rpc_error_detail", "")
              or getattr(e, "detail", ""))
    if detail:
        response["error_detail"] = detail
    return response


class FramedServerMixin:
    """Framed-RPC server connection loop. Subclasses set ``_methods``
    (name -> async handler) and ``_conn_writers`` (a set), and may set
    ``_stream_methods`` (name -> ``handler(msg, send)``, where ``await
    send(obj)`` writes a ``{"stream": true, "id": ...}`` frame ahead of
    the envelope) and override the hooks ``_run_handler``,
    ``_envelope_extra``, ``_on_handler_error`` and ``_after_dispatch``.
    Responses come back in frame order."""

    _methods: Dict[str, Callable[[Dict[str, Any]], Awaitable[Any]]]
    _stream_methods: Dict[str, Callable[..., Awaitable[Any]]] = {}
    _conn_writers: set
    max_frame_bytes: int = 64 * 1024 * 1024

    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        self._conn_writers.add(writer)
        try:
            first = True
            while True:
                try:
                    if first:
                        # an HTTP verb in the first bytes: one plain-HTTP
                        # answer (GET /metrics); else a frame header
                        first = False
                        head = await reader.readexactly(HEADER_SIZE)
                        if head[:4] in _HTTP_VERB_PREFIXES:
                            await self._serve_http(head, reader, writer)
                            break
                        msg = await read_frame_after_header(
                            reader, head, max_frame=self.max_frame_bytes)
                    else:
                        msg = await read_frame(
                            reader, max_frame=self.max_frame_bytes)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break                                  # client closed
                except FrameError as e:
                    await write_frame(writer, {"success": False,
                                               "error": f"bad frame: {e}"})
                    break
                if (isinstance(msg, dict)
                        and msg.get("method") in self._stream_methods):
                    response = await self._dispatch_stream(msg, writer)
                    if response is None:      # client hung up mid-stream
                        break
                else:
                    response = await self._dispatch(msg)
                try:
                    await write_frame(writer, response)
                except (ConnectionResetError, BrokenPipeError):
                    break
        finally:
            self._conn_writers.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _dispatch(self, msg: Any) -> Dict[str, Any]:
        t0 = time.perf_counter()
        if not isinstance(msg, dict) or "method" not in msg:
            return {"success": False,
                    "error": "message must be a dict with 'method'"}
        method = msg["method"]
        handler = self._methods.get(method)
        req_id = msg.get("id", "")
        extra = self._envelope_extra()
        if handler is None:
            return {"id": req_id, "success": False, **extra,
                    "error": f"unknown method {method!r}"}
        try:
            result = await self._run_handler(method, handler, msg)
            response = {"id": req_id, "success": True, **extra,
                        "result": result}
        except asyncio.TimeoutError:
            response = {"id": req_id, "success": False, **extra,
                        "error": self._timeout_error(method)}
        except Exception as e:       # fan the error back, keep serving
            self._on_handler_error(method, e)
            logger.warning("%s: %s failed: %s", type(self).__name__,
                           method, e)
            response = _error_envelope(req_id, extra, e)
        self._after_dispatch(method, req_id, time.perf_counter() - t0,
                             response)
        return response

    async def _dispatch_stream(self, msg: Dict[str, Any],
                               writer: asyncio.StreamWriter
                               ) -> Optional[Dict[str, Any]]:
        """Run a streaming handler: its chunk frames go out as it sends
        them, then the envelope. Returns None when the client hung up
        mid-stream (routine for an aborted generation, not a handler
        failure, and nobody is left to answer)."""
        t0 = time.perf_counter()
        method = msg["method"]
        handler = self._stream_methods[method]
        req_id = msg.get("id", "")
        extra = self._envelope_extra()

        async def send(obj: Dict[str, Any]) -> None:
            try:
                await write_frame(writer,
                                  {"stream": True, "id": req_id, **obj})
            except (ConnectionResetError, BrokenPipeError, OSError) as e:
                raise ClientGone() from e

        try:
            result = await handler(msg, send)
            response = {"id": req_id, "success": True, **extra,
                        "result": result}
        except ClientGone:
            logger.info("%s: client disconnected mid-stream (%s)",
                        type(self).__name__, method)
            return None
        except Exception as e:
            self._on_handler_error(method, e)
            logger.warning("%s: %s failed: %s", type(self).__name__,
                           method, e)
            response = _error_envelope(req_id, extra, e)
        self._after_dispatch(method, req_id, time.perf_counter() - t0,
                             response)
        return response

    async def _serve_http(self, head: bytes, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        """Answer one plain-HTTP request on the framed port; the caller
        closes the connection. GET and HEAD reach ``_http_get``; anything
        else, and an unknown path, gets a 404."""
        try:
            raw = head
            if b"\r\n\r\n" not in raw:
                raw += await asyncio.wait_for(
                    reader.readuntil(b"\r\n\r\n"), timeout=5.0)
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError, ConnectionResetError):
            return                  # a scraper that hung up loses its scrape
        parts = raw.split(b"\r\n", 1)[0].decode("latin-1").split()
        method = parts[0].upper() if parts else ""
        path = (parts[1] if len(parts) > 1 else "/").split("?", 1)[0]
        status, ctype, body = ("404 Not Found", "text/plain; charset=utf-8",
                               b"not found\n")
        if method in ("GET", "HEAD"):
            try:
                got = await self._http_get(path)
            except Exception as e:
                logger.warning("%s: HTTP %s %s failed: %s",
                               type(self).__name__, method, path, e)
                got = None
                status, body = ("500 Internal Server Error",
                                f"{e}\n".encode("utf-8", "replace"))
            if got is not None:
                ctype, body = got
                status = "200 OK"
        payload = b"" if method == "HEAD" else body
        try:
            writer.write(
                f"HTTP/1.1 {status}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n"
                "Connection: close\r\n\r\n".encode("latin-1") + payload)
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass

    async def _http_get(self, path: str) -> Optional[Tuple[str, bytes]]:
        """Override hook: ``(content_type, body)``, or None for a 404."""
        return None

    async def _run_handler(self, method: str, handler, msg) -> Any:
        return await handler(msg)

    def _envelope_extra(self) -> Dict[str, Any]:
        return {}

    def _timeout_error(self, method: str) -> str:
        return f"{method} timed out"

    def _on_handler_error(self, method: str, exc: Exception) -> None:
        pass

    def _after_dispatch(self, method: str, req_id: str, duration_s: float,
                        response: Dict[str, Any]) -> None:
        pass

    def _close_all_connections(self) -> None:
        for w in list(self._conn_writers):
            w.close()
