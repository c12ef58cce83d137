"""Per-worker multi-model residency: background staging and the
probe-gated swap (port of the JAX package's ``cluster/model_manager.py``,
same receipts, errors and counters).

``ModelManager`` owns one worker's resident set:

- ``engines``/``configs``: the resident models (the worker aliases these
  dicts, so every verb reads the same state).
- ``stage(cfg)``: build the next model's engine on a daemon side thread
  while the resident models' pumps keep stepping. The serving pumps' step
  counts are sampled around the stage, so the overlap is measured
  (``stage_overlap_steps``). On the card a staged engine's load-time
  warm-up captures its graphs under ``ops/_cuda.py:GRAPH_LOCK``, which
  every replay also takes: the serving pump waits for each capture.
- ``swap(name)``: wait for the stage, golden-gate the engine, then admit
  it under the residency budget. An engine cold-started from a serving
  artifact replays its manifest's recorded probe; any other is held to a
  caller-supplied expected token list over ``GOLDEN_PROMPT``
  (``engine/artifact.py``). A mismatch discards the staged engine and
  raises ``ModelProbeError``; the resident models keep serving.
- LRU eviction: admission over ``max_resident_models`` or
  ``resident_bytes`` evicts the least recently used idle model. A model
  with work in flight is never evicted (``busy_fn``), nor is the model
  just admitted.

The resident set changes on more than one thread (the worker's event
loop unloads and touches, its engine thread loads, swaps and evicts), so
every read and write of it holds ``_lock``; ``on_evict`` (the release of
an engine) runs after the lock is let go.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

from ..config import ModelConfig
from ..engine.artifact import (
    GOLDEN_PROMPT,
    ArtifactCorruptError,
    run_probe,
    verify_golden,
)
from ..utils.tracing import LatencyStats

logger = logging.getLogger(__name__)


class ModelProbeError(RuntimeError):
    """A staged engine failed its golden-token gate: it was discarded and
    must not serve. The resident models are untouched."""


class ModelStageError(RuntimeError):
    """Staging failed (the factory raised) or the model was never staged."""


class _Staged:
    """One in-flight background stage."""

    __slots__ = ("cfg", "thread", "done", "engine", "error", "stage_s",
                 "steps_at_start", "overlap_steps")

    def __init__(self, cfg: ModelConfig) -> None:
        self.cfg = cfg
        self.thread: Optional[threading.Thread] = None
        self.done = threading.Event()
        self.engine: Any = None
        self.error: Optional[BaseException] = None
        self.stage_s = 0.0
        self.steps_at_start = 0
        self.overlap_steps = 0


def engine_size_bytes(cfg: ModelConfig, engine: Any) -> int:
    """Bytes of one resident engine: ``metadata.size_bytes`` where the
    deploy declares it (the fakes), else the bytes of its parameter
    tensors (the engine's ``param_bytes``, not its KV pools), else 0 (only
    the count budget sees it)."""
    declared = cfg.metadata.get("size_bytes")
    if declared:
        return int(declared)
    return int(getattr(engine, "param_bytes", 0))


class ModelManager:
    """Resident-model policy for one worker (see the module docstring)."""

    def __init__(
        self,
        build: Callable[[ModelConfig], Any],
        *,
        max_resident_models: int = 0,
        resident_bytes: int = 0,
        busy_fn: Optional[Callable[[str], bool]] = None,
        on_evict: Optional[Callable[[str, Any], None]] = None,
    ) -> None:
        self.build = build
        self.max_resident_models = int(max_resident_models)
        self.resident_bytes = int(resident_bytes)
        self.busy_fn = busy_fn
        self.on_evict = on_evict
        self.engines: Dict[str, Any] = {}
        self.configs: Dict[str, ModelConfig] = {}
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self._bytes: Dict[str, int] = {}
        self._staged: Dict[str, _Staged] = {}
        self._lock = threading.Lock()
        self._stages_started = 0
        self._stages_completed = 0
        self._stages_failed = 0
        self._swaps = 0
        self._evictions = 0
        self._probe_rejects = 0
        self._stage_overlap_steps = 0
        self.stage_stats = LatencyStats()
        self.swap_stats = LatencyStats()

    # -- residency ---------------------------------------------------------

    def touch(self, name: str) -> None:
        """Mark one resident model as just used (the LRU order)."""
        with self._lock:
            if name in self._lru:
                self._lru.move_to_end(name)

    def admit(self, cfg: ModelConfig, engine: Any) -> List[str]:
        """Install an engine into the resident set and evict idle models
        over the budget, least recently used first; returns the evicted
        names. The admitted model is never a candidate."""
        name = cfg.name
        size = engine_size_bytes(cfg, engine)
        with self._lock:
            self.engines[name] = engine
            self.configs[name] = cfg
            self._bytes[name] = size
            self._lru[name] = None
            self._lru.move_to_end(name)
        return self._evict_over_budget(protect=name)

    def remove(self, name: str) -> Optional[Any]:
        """Drop one model from the resident set (an unload, not an
        eviction); returns the engine, or None if absent."""
        with self._lock:
            return self._remove(name)

    def _remove(self, name: str) -> Optional[Any]:
        self.configs.pop(name, None)
        self._lru.pop(name, None)
        self._bytes.pop(name, None)
        return self.engines.pop(name, None)

    def resident_bytes_used(self) -> int:
        with self._lock:
            return sum(self._bytes.values())

    def _over_budget(self) -> bool:
        if (self.max_resident_models
                and len(self.engines) > self.max_resident_models):
            return True
        return bool(self.resident_bytes
                    and sum(self._bytes.values()) > self.resident_bytes)

    def _evict_over_budget(self, protect: str) -> List[str]:
        evicted: List[str] = []
        while True:
            with self._lock:
                if not self._over_budget():
                    break
                victim = None
                for name in self._lru:        # least recently used first
                    if name == protect:
                        continue
                    if self.busy_fn is not None and self.busy_fn(name):
                        continue              # work in flight pins it
                    victim = name
                    break
                if victim is None:
                    # every other model is busy or protected: serving
                    # beats the budget; the next admission tries again
                    logger.warning(
                        "resident budget exceeded but every candidate is "
                        "busy (%d models, %d bytes)", len(self.engines),
                        sum(self._bytes.values()))
                    break
                engine = self._remove(victim)
            self._evictions += 1
            evicted.append(victim)
            logger.info("evicted idle model %s (LRU, resident budget)",
                        victim)
            if self.on_evict is not None and engine is not None:
                self.on_evict(victim, engine)
        return evicted

    # -- background staging ------------------------------------------------

    def staged_names(self) -> List[str]:
        with self._lock:
            return sorted(self._staged)

    def stage(self, cfg: ModelConfig,
              serving_steps: Optional[Callable[[], int]] = None) -> _Staged:
        """Begin building ``cfg``'s engine on a side thread; returns the
        stage record at once (idempotent per name while in flight).
        ``serving_steps`` is sampled at the start and the end."""
        name = cfg.name
        with self._lock:
            rec = self._staged.get(name)
            if rec is not None:
                return rec
            rec = _Staged(cfg)
            self._staged[name] = rec
            self._stages_started += 1
        if serving_steps is not None:
            rec.steps_at_start = int(serving_steps())

        def _run() -> None:
            t0 = time.perf_counter()
            try:
                rec.engine = self.build(cfg)
            except BaseException as e:      # surfaced at swap time
                rec.error = e
            rec.stage_s = time.perf_counter() - t0
            try:
                if serving_steps is not None:
                    rec.overlap_steps = (int(serving_steps())
                                         - rec.steps_at_start)
            except Exception:   # best-effort overlap accounting
                logger.exception("stage of %s: overlap sample failed", name)
                rec.overlap_steps = 0
            finally:
                rec.done.set()

        rec.thread = threading.Thread(target=_run, daemon=True,
                                      name=f"stage-{name}")
        rec.thread.start()
        return rec

    def stage_wait(self, name: str,
                   timeout: Optional[float] = None) -> _Staged:
        """Block until ``name``'s stage finishes; pops and returns its
        record. Raises ``ModelStageError`` when never staged, timed out or
        failed."""
        rec = self._staged.get(name)
        if rec is None:
            raise ModelStageError(
                f"model {name!r} is not staged (staged: {self.staged_names()})")
        if not rec.done.wait(timeout):
            raise ModelStageError(
                f"stage of {name!r} still running after {timeout}s")
        with self._lock:
            self._staged.pop(name, None)
        self._stage_overlap_steps += rec.overlap_steps
        if rec.error is not None:
            self._stages_failed += 1
            raise ModelStageError(
                f"stage of {name!r} failed: {type(rec.error).__name__}: "
                f"{rec.error}") from rec.error
        self._stages_completed += 1
        self.stage_stats.add(rec.stage_s)
        return rec

    # -- probe-gated swap --------------------------------------------------

    def _golden_gate(self, engine: Any,
                     probe_expected: Optional[List[int]]) -> None:
        """The same trust boundary as an artifact cold start: an engine
        with a manifest replays its recorded golden generation; any other
        replays ``probe_expected`` greedily over ``GOLDEN_PROMPT``. With
        neither there is no gate (as ``load_model``)."""
        manifest = getattr(engine, "artifact_manifest", None)
        if manifest is not None:
            try:
                verify_golden(engine, manifest)
                return
            except ArtifactCorruptError as e:
                raise ModelProbeError(str(e)) from e
        if probe_expected:
            want = [int(t) for t in probe_expected]
            got = run_probe(engine, list(GOLDEN_PROMPT), len(want))
            if got != want:
                raise ModelProbeError(
                    f"swap probe FAILED: expected {want}, got {got} — "
                    "staged engine numerics are wrong, refusing to swap")

    def swap(self, name: str,
             probe_expected: Optional[List[int]] = None,
             timeout: Optional[float] = None) -> Dict[str, Any]:
        """Activate a staged model: wait for its build, gate it, admit it
        under the budget. The receipt holds ``stage_s`` (in the
        background) and ``swap_s`` (what the caller waited). On a probe
        failure the staged engine is dropped and ``ModelProbeError``
        raised."""
        t0 = time.perf_counter()
        if name in self.engines and name not in self._staged:
            self.touch(name)
            return {"swapped": name, "already_resident": True,
                    "stage_s": 0.0, "swap_s": 0.0, "evicted": []}
        rec = self.stage_wait(name, timeout=timeout)
        try:
            self._golden_gate(rec.engine, probe_expected)
        except ModelProbeError:
            self._probe_rejects += 1
            raise
        evicted = self.admit(rec.cfg, rec.engine)
        swap_s = time.perf_counter() - t0
        self._swaps += 1
        self.swap_stats.add(swap_s)
        logger.info(
            "swapped in model %s: stage %.3fs (background, %d steps "
            "overlapped), swap wait %.3fs, evicted %s", name, rec.stage_s,
            rec.overlap_steps, swap_s, evicted or "none")
        return {"swapped": name, "already_resident": False,
                "stage_s": rec.stage_s, "swap_s": swap_s,
                "overlap_steps": rec.overlap_steps, "evicted": evicted}

    # -- introspection -----------------------------------------------------

    def get_stats(self) -> Dict[str, Any]:
        with self._lock:
            resident = len(self.engines)
            used = sum(self._bytes.values())
            staged = len(self._staged)
        return {
            "resident_models": resident,
            "resident_bytes": used,
            "staged_models": staged,
            "stage_started": self._stages_started,
            "stage_completed": self._stages_completed,
            "stage_failed": self._stages_failed,
            "model_swaps": self._swaps,
            "model_evictions": self._evictions,
            "swap_probe_rejects": self._probe_rejects,
            "stage_overlap_steps": self._stage_overlap_steps,
            "model_stage": self.stage_stats.snapshot(),
            "model_swap": self.swap_stats.snapshot(),
        }
