"""The worker's flight recorder (copy of the JAX package's
``obs/events.py``): a bounded, thread-safe ring of typed events.

Each record is ``{"seq", "type", "t_wall", "t_mono", "args"}``: ``seq``
a per-process sequence number that is never reset (a ring wrap shows as
a gap at the front), ``t_wall`` = ``time.time()``, ``t_mono`` =
``time.perf_counter()`` (the clock a JAX coordinator aligns across
processes), ``args`` a small JSON-safe payload. ``snapshot()`` is what
the worker's ``events`` verb returns.

``EVENTS`` holds the types a worker and its pumps emit, with the JAX
catalog's help text; the coordinator's, breaker, KV-fabric, fault and SLO
types belong to modules the port does not carry (ROADMAP.md A, the host
plane). ``EventLog.emit`` rejects a type outside the catalog.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Tuple

SCHEMA_VERSION = 1

#: event type -> help (the JAX catalog's entries for a worker)
EVENTS: Dict[str, str] = {
    "admission.accept": "Request admitted into an engine pump inbox",
    "admission.reject": "Request refused by a pump (inbox full / "
                        "overload shed)",
    "drain.begin": "Graceful drain started (worker stops admitting)",
    "drain.done": "Drain completed (in-flight work quiesced)",
    "model.stage": "Background model stage started on a worker",
    "model.swap": "Hot swap activated a staged model",
}


class EventLog:
    """Bounded, thread-safe ring of typed events for one process
    (``proc`` names its track in a merged fleet trace). Emission is one
    dict append under a lock and never raises for ring pressure: the
    oldest event is dropped and counted."""

    def __init__(self, proc: str, capacity: int = 2048) -> None:
        self.proc = str(proc)
        self.capacity = max(1, int(capacity))
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._dropped = 0

    def emit(self, etype: str, **args: Any) -> None:
        """Append one typed event; an unknown type raises ``ValueError``."""
        if etype not in EVENTS:
            raise ValueError(f"unknown event type {etype!r} (add it to "
                             "obs.events.EVENTS)")
        rec = {"seq": 0, "type": etype, "t_wall": time.time(),
               "t_mono": time.perf_counter(), "args": args}
        with self._lock:
            rec["seq"] = self._seq
            self._seq += 1
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(rec)

    def snapshot(self) -> Dict[str, Any]:
        """The ring with its schema and drop accounting (the ``events``
        verb's ``ring``)."""
        with self._lock:
            return {"schema": SCHEMA_VERSION, "proc": self.proc,
                    "seq": self._seq, "dropped": self._dropped,
                    "events": [dict(e) for e in self._events]}

    def get_stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"events_emitted": self._seq,
                    "events_dropped": self._dropped,
                    "events_buffered": len(self._events)}


def _canon(v: Any) -> Any:
    """Hashable canonical form of an event argument."""
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _canon(x)) for k, x in v.items()))
    return v


def canonical_from_snapshot(snap: Dict[str, Any]) -> List[Tuple[str, Tuple]]:
    """A ``snapshot()``'s events without their timestamps and sequence
    numbers, ``[(type, sorted(args.items())), ...]`` in emission order:
    what two rings that saw the same verbs hold alike."""
    return [(e["type"], tuple(sorted(
        (k, _canon(v)) for k, v in (e.get("args") or {}).items())))
        for e in snap.get("events", ())]
