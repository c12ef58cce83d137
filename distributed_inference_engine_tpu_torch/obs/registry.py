"""Metrics registry with OpenMetrics text exposition (copy of the JAX
package's ``obs/registry.py``).

Components keep their metric dicts; scrape-time collector callbacks
(``obs/collectors.py``) mirror each dict into counter, gauge and histogram
families with stable names, so the hot paths carry no metrics
bookkeeping. Counter children take ``set()`` as well as ``inc()`` (most
sources are existing monotonic counters, mirrored at scrape time);
histogram children take ``observe()`` or ``set_snapshot()`` (the
cumulative buckets of a ``LatencyStats`` snapshot). ``render()`` emits
OpenMetrics text: ``# TYPE``/``# HELP`` for every family (with or without
samples), counter samples suffixed ``_total``, histogram
``_bucket``/``_count``/``_sum``, and ``# EOF``.
"""

from __future__ import annotations

import bisect
import logging
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
# the exposition appends these — a family name carrying one would collide
# with its own samples (e.g. family "x_total" renders sample "x_total_total")
_RESERVED_SUFFIXES = ("_total", "_bucket", "_sum", "_count", "_created")
_RESERVED_LABELS = ("le", "quantile")

# default latency buckets (seconds) — THE LatencyStats bounds, so a
# snapshot's cumulative counts line up with a registry histogram's ``le``
# labels without translation
from ..utils.tracing import LATENCY_BUCKETS as DEFAULT_BUCKETS  # noqa: E402


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    for sfx in _RESERVED_SUFFIXES:
        if name.endswith(sfx):
            raise ValueError(
                f"metric name {name!r} ends with reserved suffix {sfx!r} "
                "(the exposition appends sample suffixes itself)")
    return name


def _check_labels(labelnames: Sequence[str]) -> Tuple[str, ...]:
    out = tuple(labelnames)
    for ln in out:
        if not _LABEL_RE.match(ln) or ln.startswith("__"):
            raise ValueError(f"invalid label name {ln!r}")
        if ln in _RESERVED_LABELS:
            raise ValueError(f"label name {ln!r} is reserved")
    if len(set(out)) != len(out):
        raise ValueError(f"duplicate label names in {out!r}")
    return out


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def format_value(v: Any) -> str:
    """OpenMetrics sample value: ints bare, floats shortest-round-trip."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def format_le(bound: float) -> str:
    if bound == float("inf"):
        return "+Inf"
    return format_value(bound)


class _Child:
    """One labelled time series inside a family."""

    __slots__ = ("_value",)

    def __init__(self) -> None:
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value


class _CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self._value += amount

    def set(self, total: float) -> None:
        """Mirror a monotonic SOURCE counter (scrape-time collectors)."""
        self._value = float(total)


class _GaugeChild(_Child):
    def set(self, value: float) -> None:
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self._value -= amount


class _HistogramChild:
    __slots__ = ("_buckets", "_counts", "_sum", "_count", "_snap")

    def __init__(self, buckets: Tuple[float, ...]) -> None:
        self._buckets = buckets
        self._counts = [0] * (len(buckets) + 1)   # +Inf tail
        self._sum = 0.0
        self._count = 0
        self._snap: Optional[Tuple[Dict[str, float], float, float]] = None

    def observe(self, value: float) -> None:
        self._counts[bisect.bisect_left(self._buckets, value)] += 1
        self._sum += value
        self._count += 1
        self._snap = None

    def set_snapshot(self, buckets: Dict[str, float], sum_v: float,
                     count: float) -> None:
        """Adopt pre-cumulated bucket counts (``le`` label → cumulative
        count), e.g. a ``LatencyStats.snapshot()['buckets']`` dict."""
        self._snap = (dict(buckets), float(sum_v), float(count))

    def samples(self) -> Tuple[List[Tuple[str, float]], float, float]:
        """[(le_label, cumulative_count), ...], sum, count."""
        if self._snap is not None:
            b, s, c = self._snap
            items = list(b.items())
            # order finite bounds ascending, +Inf last
            items.sort(key=lambda kv: (kv[0] == "+Inf", float(
                "inf") if kv[0] == "+Inf" else float(kv[0])))
            if not items or items[-1][0] != "+Inf":
                items.append(("+Inf", c))
            return items, s, c
        out, cum = [], 0
        for bound, n in zip(self._buckets, self._counts):
            cum += n
            out.append((format_le(bound), float(cum)))
        out.append(("+Inf", float(self._count)))
        return out, self._sum, float(self._count)


class _Family:
    kind = ""
    _child_cls: Any = _Child

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()) -> None:
        self.name = _check_name(name)
        self.help = help
        self.labelnames = _check_labels(labelnames)
        self._children: Dict[Tuple[str, ...], Any] = {}
        self._lock = threading.Lock()

    def labels(self, **labels: str) -> Any:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        key = tuple(str(labels[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
        return child

    def _make_child(self) -> Any:
        return self._child_cls()

    def clear(self) -> None:
        """Drop all children — collectors that rebuild label sets from
        scratch each scrape (e.g. per-worker series) call this first so
        departed label values don't linger forever."""
        with self._lock:
            self._children.clear()

    def items(self) -> List[Tuple[Dict[str, str], Any]]:
        """Snapshot of ``(labels dict, child)`` pairs. Scrape-side
        consumers — the autoscaler's SLO reader — iterate series through
        this instead of reaching into the render path."""
        with self._lock:
            return [(dict(zip(self.labelnames, key)), child)
                    for key, child in self._children.items()]

    # -- rendering ---------------------------------------------------------

    def _label_str(self, key: Tuple[str, ...],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        pairs = [(ln, lv) for ln, lv in zip(self.labelnames, key)]
        pairs.extend(extra)
        if not pairs:
            return ""
        inner = ",".join(f'{ln}="{_escape_label(lv)}"' for ln, lv in pairs)
        return "{" + inner + "}"

    def render(self) -> List[str]:
        lines = [f"# TYPE {self.name} {self.kind}"]
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            lines.extend(self._render_child(key, child))
        return lines

    def _render_child(self, key: Tuple[str, ...], child: Any) -> List[str]:
        raise NotImplementedError


class Counter(_Family):
    kind = "counter"
    _child_cls = _CounterChild

    def _render_child(self, key, child):
        return [f"{self.name}_total{self._label_str(key)} "
                f"{format_value(child.value)}"]


class Gauge(_Family):
    kind = "gauge"
    _child_cls = _GaugeChild

    def _render_child(self, key, child):
        return [f"{self.name}{self._label_str(key)} "
                f"{format_value(child.value)}"]


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def _render_child(self, key, child):
        items, sum_v, count = child.samples()
        lines = [
            f"{self.name}_bucket{self._label_str(key, (('le', le),))} "
            f"{format_value(n)}"
            for le, n in items
        ]
        lines.append(f"{self.name}_count{self._label_str(key)} "
                     f"{format_value(count)}")
        lines.append(f"{self.name}_sum{self._label_str(key)} "
                     f"{format_value(sum_v)}")
        return lines


class MetricsRegistry:
    """Family registry + collector callbacks + OpenMetrics renderer."""

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    # -- registration ------------------------------------------------------

    def _register(self, cls, name: str, help: str,
                  labelnames: Sequence[str], **kw) -> Any:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or fam.labelnames != tuple(
                        labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {fam.labelnames}")
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    @property
    def names(self) -> List[str]:
        return sorted(self._families)

    # -- collectors --------------------------------------------------------

    def add_collector(self, fn: Callable[[], None]) -> None:
        """Register a scrape-time callback that mirrors component state
        into families. Exceptions are logged, not raised — one broken
        component must not take down the whole exposition."""
        self._collectors.append(fn)

    def collect(self) -> None:
        for fn in self._collectors:
            try:
                fn()
            except Exception:
                logger.warning("metrics collector %r failed", fn,
                               exc_info=True)

    # -- exposition --------------------------------------------------------

    def render(self, run_collectors: bool = True) -> str:
        if run_collectors:
            self.collect()
        lines: List[str] = []
        for name in sorted(self._families):
            lines.extend(self._families[name].render())
        lines.append("# EOF")
        return "\n".join(lines) + "\n"
