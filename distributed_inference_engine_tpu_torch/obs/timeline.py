"""StepTimeline: a ring-buffer recorder of an engine's dispatches,
exported as Chrome trace-event JSON (Perfetto, ``chrome://tracing``); a
copy of the JAX package's ``obs/timeline.py``.

``torch.profiler`` shows the card's kernels; the timeline shows the
engine's view of the same window: which step was a mixed step or a
decode chunk, how many prefill tokens rode along, the page pool's
occupancy, and which dispatch was the first of its program key (on the
card, the one that captured its CUDA graph: ``compile``). One small dict
a dispatch, appended to a bounded deque; the worker's ``profile`` verb
brackets it around the profiler's start and stop.

Each step is a complete event (``"ph": "X"``) with microsecond
``ts``/``dur`` from the timeline's epoch; ``args`` carry the per-step
payload. ``busy_gap_split`` splits a window of records into time inside
dispatch brackets and host time between them (the async drafter's
bubble estimate reads it).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import deque
from typing import Any, Dict, List, Optional


class StepTimeline:
    """Bounded per-engine step recorder with Chrome trace export."""

    def __init__(self, capacity: int = 4096, name: str = "engine") -> None:
        self.name = name
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=max(1, self.capacity))
        self._epoch = time.perf_counter()
        self._capture_from: Optional[float] = None
        self._dropped = 0

    def record(self, kind: str, t_start: float, dur_s: float,
               **args: Any) -> None:
        """One complete dispatch: ``t_start`` a ``time.perf_counter()``
        stamp, ``dur_s`` its wall duration."""
        if len(self._events) == self._events.maxlen:
            self._dropped += 1
        self._events.append({"name": kind, "t": float(t_start),
                             "dur": float(dur_s), "args": args})

    # -- capture window (brackets the profiler's start and stop) ----------

    def start_capture(self) -> None:
        self._capture_from = time.perf_counter()

    def stop_capture(self) -> List[Dict[str, Any]]:
        """Events recorded since ``start_capture()`` (all events if the
        window was never opened); the ring stays intact."""
        since, self._capture_from = self._capture_from, None
        return self.events(since=since)

    def events(self, since: Optional[float] = None) -> List[Dict[str, Any]]:
        evs = list(self._events)
        if since is not None:
            evs = [e for e in evs if e["t"] >= since]
        return evs

    # -- export ------------------------------------------------------------

    def to_chrome_trace(self, events: Optional[List[Dict[str, Any]]] = None
                        ) -> Dict[str, Any]:
        """Chrome trace-event JSON object (the ``traceEvents`` container
        Perfetto reads)."""
        if events is None:
            events = self.events()
        out: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": self.name},
        }]
        for e in events:
            out.append({"name": e["name"], "ph": "X",
                        "ts": (e["t"] - self._epoch) * 1e6,
                        "dur": e["dur"] * 1e6, "pid": 0, "tid": 0,
                        "args": dict(e["args"])})
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "metadata": {"timeline": self.name,
                             "dropped_events": self._dropped}}

    def dump(self, path: str,
             events: Optional[List[Dict[str, Any]]] = None) -> str:
        """Write the Chrome trace to ``path`` through a temporary file and
        a rename, so a reader never sees half a document."""
        trace = self.to_chrome_trace(events)
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix="." + os.path.basename(path)
                                   + "-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(trace, f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path


def busy_gap_split(events: List[Dict[str, Any]]) -> Dict[str, float]:
    """A window of dispatch records split into busy seconds (inside a
    dispatch bracket) and gap seconds (host time between consecutive
    brackets; overlapping brackets clamp it at zero). Records without a
    ``dur`` are skipped. Returns busy_s, gap_s, bubble_frac = gap / (busy +
    gap), and the count of records split."""
    spans = sorted((e["t"], e["t"] + e["dur"]) for e in events
                   if e.get("dur") is not None)
    busy = 0.0
    gap = 0.0
    prev_end: Optional[float] = None
    for t0, t1 in spans:
        busy += t1 - t0
        if prev_end is not None and t0 > prev_end:
            gap += t0 - prev_end
        prev_end = max(prev_end, t1) if prev_end is not None else t1
    total = busy + gap
    return {
        "busy_s": busy,
        "gap_s": gap,
        "bubble_frac": (gap / total) if total > 0 else 0.0,
        "n_events": len(spans),
    }
