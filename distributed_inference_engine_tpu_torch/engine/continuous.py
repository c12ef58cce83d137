"""Continuous-batching engine over the paged KV cache, in PyTorch (port of
the ``engine/continuous.py:ContinuousEngine`` subset the serving path
runs).

A fixed pool of ``max_slots`` decode slots stays busy: requests are
admitted into free slots between decode chunks, finished slots return
their pages at once.

- Admission prefills whole prompts straight into the pages
  (``forward_prefill_into_pages``), batched; a prefix-cache hit prefills
  only the uncached suffix against its cached pages.
- Chunked prefill (``prefill_chunk``): a prompt whose uncached part
  exceeds the chunk is prefilled a chunk per engine step, its first chunk
  riding the batched admission prefill. By default each step advances
  every prefilling prompt in suffix-prefill dispatches grouped by context
  size, then runs the decode chunk (the split path). With
  ``attention_impl="pallas-ragged"`` a step with prompts mid-prefill is
  one ragged mixed step instead: every decode slot advances one token
  and the prefill chunks ride the same forward (``forward_mixed_step``,
  the ragged-attention kernel writing each row's K/V into its pages).
- Decode runs in chunks of ``decode_steps_per_call`` steps in the window
  scheme: the pools are frozen for the chunk, fresh K/V accumulates in a
  side window, attention is the flash-decode kernel over prefix ⊕ window
  (or its writeback variant, ``"pallas-decode-fw"``, or the paged-attention
  kernel over the prefix merged with the window, ``"pallas"``), and the
  window is written into the pages once at the chunk's end. With
  ``decode_mode="inline"``, and always for a sliding-window spec
  (Mistral v0.1), each step writes its K/V into the pages and attends
  through the paged-attention kernel (``forward_decode_paged``): no side
  window and no flush.
- Stops: EOS, ``max_new_tokens``, capacity (``"length"``) and the first
  ``_DEVICE_STOP_K`` single-token stop ids retire a slot on the device,
  inside the chunk; longer stop lists and stop sequences retire on the
  host, which trims every result with ``trim_at_stops``.
- One host read per chunk or mixed step: tokens, logprobs, active flags,
  the lengths, the deferred admissions' first tokens (``firsts``) and a
  mixed step's prefill samples ride one packed int32 buffer, copied to
  pinned host memory right behind the work that wrote it
  (``ops/_cuda.py:HostRead``).
- Deferred admission (``defer_admission``, on by default as in JAX): under
  decode pressure an admission round's first tokens stay on the device
  and reach the host in the next chunk's packed read. ``defer_sync``
  reads chunk k after queueing chunk k+1; ``poll_stream`` harvests a
  chunk's tokens as soon as its copy has landed, and ``submit(on_tokens=)``
  streams them (``stream_chunk_steps`` shortens the chunks while a slot
  streams). ``max_waiting`` and ``queue_deadline_s`` shed load.
- One dispatch per chunk (the JAX engine's one jitted program per chunk,
  ``_decode_chunk``'s ``lax.scan``, and per mixed-step bucket): on a CUDA
  device each decode chunk and each mixed step is a replay of a CUDA
  graph, captured the first time its key is seen. A decode key is
  (``n_steps``, stop ids in use, top-k/top-p/min-p mask, sampling noise),
  the values a chunk's body branches on on the host; a mixed key is the
  bucket (prefill rows, chunk width) plus the same three flags. The body
  (embedding to packed output, the chunk-end page flush included) reads
  and writes only tensors at fixed addresses: the per-slot state below,
  the page pools and table, ``_cap`` and a mixed bucket's input buffer,
  each filled by one host-to-device copy before the replay. On the CPU
  the same body runs eagerly.

What the port leaves out, and how it fails when asked for it, is in
``config.EngineConfig.check_supported``. The JAX default decode path
(``attention_impl="auto"`` -> a dense gather of the live prefix) is a TPU
layout choice; here "auto", "pallas-decode" and "pallas-ragged" (on its
pure-decode steps) run the flash-decode kernel on the window scheme, and
every ``attention_impl`` runs the paged-attention kernel on the inline
path (JAX sends "auto" there to its XLA gather).
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import EngineConfig
from ..obs.timeline import StepTimeline
from ..models.base import (
    ModelSpec,
    Params,
    forward_decode_paged,
    forward_decode_window,
    forward_mixed_step,
    forward_prefill_into_pages,
    forward_prefill_suffix,
    init_params,
    unembed,
    write_pages_device,
    write_prefill_pages,
)
from ..ops import _cuda
from ..ops.attention import raw_view
from ..ops.quant import param_bytes, prepare_params
from ..ops.sampling import (
    SamplingParams,
    gumbel_noise,
    masked_sampling_probs,
    sample_tokens_with_logprobs,
)
from ..utils.tracing import LatencyStats
from .engine import _next_bucket, _pow2_buckets, knob_flags, request_knobs
from .paged_kv import PagedKVCache
from .spec_accept import rejection_accept
from .types import (
    EngineOverloadedError,
    GenerationRequest,
    GenerationResult,
    find_stop_cut,
    trim_at_stops,
)

logger = logging.getLogger(__name__)

# device-side stop-id capacity per slot: extras stay on the host scan
_DEVICE_STOP_K = 8


def _key_name(key: Tuple) -> str:
    """A decode, mixed, verify or draft graph key as text
    (``get_metrics``)."""
    kind, *shape, flag, mask, noise = key
    if kind == "mixed":
        dims = f"rows={shape[0]} width={shape[1]}"
    else:
        dims = f"{_KEY_DIM[kind]}={shape[0]}"
    flag_name = "propose" if kind == "draft" else "stops"
    return (f"{kind} {dims} {flag_name}={int(flag)} mask={int(mask)} "
            f"noise={int(noise)}")


_KEY_DIM = {"decode": "n_steps", "verify": "k", "draft": "width"}


class _Slot:
    """Host-side bookkeeping for one live sequence."""

    __slots__ = ("request", "slot_id", "prompt_len", "produced", "tokens",
                 "logprobs", "admitted_at", "first_token_at", "on_tokens",
                 "streamed", "stop_cut", "first_pending")

    def __init__(self, request: GenerationRequest, slot_id: int,
                 prompt_len: int, on_tokens=None) -> None:
        self.request = request
        self.slot_id = slot_id
        self.prompt_len = prompt_len
        self.produced = 0
        self.tokens: List[int] = []
        self.logprobs: List[float] = []
        self.admitted_at = time.perf_counter()
        self.first_token_at = 0.0
        self.on_tokens = on_tokens      # streaming: cb(new_tokens: List[int])
        self.streamed = 0               # tokens already emitted to the cb
        self.stop_cut = -1              # earliest stop cut, once found
        # deferred admission: the prefill-sampled first token lives in the
        # device firsts buffer until the next chunk's packed read
        self.first_pending = False


class _PrefillProgress:
    """A long prompt mid-way through chunked prefill: its slot and pages
    are allocated, but it is not decoding yet (not in ``_slots``)."""

    __slots__ = ("request", "prompt", "done", "on_tokens", "t_submit")

    def __init__(self, request: GenerationRequest, prompt: List[int],
                 on_tokens, t_submit: float, done: int) -> None:
        self.request = request
        self.prompt = prompt
        self.done = done                # tokens prefilled (page-aligned)
        self.on_tokens = on_tokens
        self.t_submit = t_submit


class _ChunkEntry:
    """A dispatched decode chunk or mixed step: its packed device output
    (flat int32: ``2 * n_steps + 4`` rows of ``max_slots`` — tokens,
    logprob bits, active flags, lengths, the two ``firsts`` rows — then a
    mixed step's prefill samples), the host read queued right behind it,
    and the slots it was dispatched for.

    Processing has two halves: ``_harvest_chunk`` (the token half: the
    read, token appends, stop scan, stream emit; idempotent through
    ``harvested``) and ``_process_packed`` (the control half: finish,
    host-side stop retires, revives). Under ``defer_sync`` the entry also
    sits on the stream ring, where ``poll_stream`` harvests it once its
    copy has landed."""

    __slots__ = ("packed", "read", "n_steps", "snapshot", "t0", "caps",
                 "fresh_firsts", "host", "harvested", "progressed", "key")

    def __init__(self, packed: torch.Tensor, n_steps: int,
                 snapshot: Dict[int, _Slot], t0: float, caps: List[int],
                 fresh_firsts: bool, key: Tuple) -> None:
        self.packed = packed
        self.key = key              # the graph key it was dispatched under
        # queued right behind the body that wrote ``packed`` (a graph's
        # static output, which its next replay rewrites)
        self.read = _cuda.HostRead(packed)
        self.n_steps = n_steps
        self.snapshot = snapshot
        self.t0 = t0
        self.caps = caps
        # sync call sites: no install ran between dispatch and read, so
        # the packed firsts rows are current
        self.fresh_firsts = fresh_firsts
        self.host: Optional[np.ndarray] = None    # set by _harvest_chunk
        self.harvested = False
        # slot -> progressed, stashed at harvest for the control half
        self.progressed: Dict[int, bool] = {}

    def ready(self) -> bool:
        """True when the packed buffer can be read without waiting."""
        return self.host is not None or self.read.ready()


class ContinuousEngine:
    """Slot-based continuous batching over a paged KV cache.

    Synchronous: callers ``submit`` and drive ``step()`` (or
    ``run_until_idle``); ``serving/pump.py`` runs it on its own thread.
    ``device`` defaults to the card; tests pass ``device="cpu"``, where the
    kernels' plain versions run.

    ``artifact_path`` restores ``(spec, params, manifest)`` from a serving
    artifact (``engine/artifact.py``; ``spec`` may be None, the sidecar's
    is used) and skips ``prepare_params``: the artifact IS the prepared
    tree. With ``artifact_selfcheck`` the manifest's golden probe is
    replayed before the engine admits traffic; a divergence raises
    ``ArtifactCorruptError``. ``load_info`` holds the load's phases in
    seconds and bytes (the factory's and the artifact's), reported under
    ``get_metrics()["load"]``."""

    def __init__(self, spec: Optional[ModelSpec],
                 params: Optional[Params] = None,
                 config: Optional[EngineConfig] = None, seed: int = 0,
                 device="cuda", artifact_path: Optional[str] = None,
                 artifact_selfcheck: bool = True, draft_spec=None,
                 draft_params=None) -> None:
        self.config = config or EngineConfig()
        cfg = self.config
        cfg.check_supported()        # before any weight is made
        self.device = torch.device(device)
        self.load_info: Dict[str, Any] = {}
        self.artifact_manifest: Optional[Dict[str, Any]] = None
        if artifact_path is not None:
            from .artifact import load_artifact

            a_spec, params, self.artifact_manifest = load_artifact(
                artifact_path, device=self.device, stats=self.load_info)
            if spec is None:
                spec = a_spec
        self.spec = spec.validate()
        # defer_sync needs a fully backed pool: the host's lengths go one
        # chunk stale, and only a pool that can always grow every slot to
        # max_seq_len guarantees a chunk never writes past reserved pages
        if cfg.defer_sync and cfg.num_pages < cfg.max_slots * (
                -(-min(cfg.max_seq_len, spec.max_seq_len)
                  // cfg.page_size)):
            raise ValueError(
                "defer_sync needs a fully backed page pool: num_pages >= "
                "max_slots * ceil(max_seq_len / page_size)")
        if params is None:
            params = init_params(spec, torch.Generator(
                device=self.device).manual_seed(seed))
        # the int4 q|k|v and gate|up payload fusion (ops/quant.py); an
        # artifact's tree is already prepared
        self.params = (params if self.artifact_manifest is not None
                       else prepare_params(params))
        # the weights' stored bytes (the residency budget's measure)
        self.param_bytes = param_bytes(self.params)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)

        self.max_slots = cfg.max_slots
        max_seq = min(cfg.max_seq_len, spec.max_seq_len)
        self.kv = PagedKVCache(
            spec, max_slots=cfg.max_slots, page_size=cfg.page_size,
            num_pages=cfg.num_pages, max_seq_len=max_seq,
            dtype=cfg.kv_dtype, device=self.device)
        # defer_sync: chunk k's packed output is read after chunk k+1 is
        # queued (the pool's own bound must agree with the check above)
        self._defer = bool(cfg.defer_sync)
        assert not self._defer or cfg.num_pages >= (
            cfg.max_slots * self.kv.max_pages_per_seq)
        # the deferred chunk in flight; under defer_sync the same entry
        # also sits on the stream ring until its token half is harvested
        self._pending: Optional[_ChunkEntry] = None
        # dispatched but unharvested chunks, oldest first (poll_stream)
        self._ring: Deque[_ChunkEntry] = collections.deque()
        self.prefill_buckets = sorted(
            {b for b in cfg.prefill_buckets if b < max_seq} | {max_seq})
        self.max_seq_len = max_seq
        self.attn_impl = cfg.attention_impl
        if self.attn_impl == "pallas-ragged" and spec.sliding_window:
            raise ValueError(
                "attention_impl='pallas-ragged' does not support "
                "sliding-window models: the ragged kernel carries no window "
                "mask (every context page is live)")
        # sliding-window specs always decode inline: their prefix mask
        # depends on the growing total length
        self.use_window = (cfg.decode_mode == "window"
                           and not spec.sliding_window)
        # pure-decode steps of a ragged engine take the flash-decode kernel
        self.decode_impl = ("pallas-decode"
                            if self.attn_impl == "pallas-ragged"
                            else self.attn_impl)
        self.decode_fused = bool(cfg.decode_fused)
        self.prefix_cache = bool(cfg.prefix_cache)
        self._ctx_page_buckets = _pow2_buckets(self.kv.max_pages_per_seq)
        self._prefix_hit_admissions = 0
        # chunked prefill: the chunk is page-aligned, so every suffix chunk
        # starts on a page boundary (the context gather reads whole pages)
        ps = self.kv.page_size
        self._chunk = (max(ps, cfg.prefill_chunk // ps * ps)
                       if cfg.prefill_chunk else 0)
        self._prefilling: Dict[int, _PrefillProgress] = {}
        self._mixed = self.attn_impl == "pallas-ragged" and self._chunk > 0
        # a mixed step's prefill rows pad to one of these widths: short
        # tails reuse the smaller prefill buckets (one CUDA graph a bucket)
        self._mixed_q_buckets = (sorted(
            {b for b in self.prefill_buckets if b < self._chunk}
            | {self._chunk}) if self._chunk else [1])

        # (request, stream callback or None, t_submit)
        self._waiting: Deque[Tuple[GenerationRequest, Any, float]] = (
            collections.deque())
        self._slots: Dict[int, _Slot] = {}
        self._finished: List[GenerationResult] = []

        # device-side per-slot state [max_slots], at fixed addresses for
        # the engine's lifetime (a CUDA graph reads and writes them): each
        # chunk and mixed step writes them in place at its end, admission
        # installs and retires patch them in place
        n = cfg.max_slots
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        self._lengths = torch.zeros((n,), **i32)
        self._last = torch.zeros((n,), **i32)
        self._active = torch.zeros((n,), dtype=torch.bool, device=dev)
        self._produced = torch.zeros((n,), **i32)
        self._max_new = torch.zeros((n,), **i32)
        self._eos = torch.full((n,), -1, **i32)
        self._temps = torch.zeros((n,), dtype=torch.float32, device=dev)
        self._top_k = torch.zeros((n,), **i32)
        self._top_p = torch.ones((n,), dtype=torch.float32, device=dev)
        self._min_p = torch.zeros((n,), dtype=torch.float32, device=dev)
        self._stops_dev = torch.full((n, _DEVICE_STOP_K), -1, **i32)
        # deferred admission: each slot's [token; logprob bits] of its
        # prefill-sampled first token, copied into every chunk's packed
        # output, so the host harvests it from the next chunk's read
        self._firsts_dev = torch.zeros((2, n), **i32)
        # host copy of it for the retire-path rescues: a sync read caches
        # the rows that rode the packed output; None = stale (an install
        # rewrote columns), then _firsts_snapshot reads the whole buffer
        self._firsts_host: Optional[np.ndarray] = None
        self._defer_admit = bool(cfg.defer_admission)
        # each slot's token capacity for the chunk, copied in before it
        self._cap = torch.zeros((n,), **i32)
        # a mixed bucket's inputs, one int32 buffer a bucket (_step_mixed)
        self._mixed_inputs: Dict[Tuple[int, int], torch.Tensor] = {}
        # CUDA graphs by key (module docstring), sharing one memory pool:
        # replays never overlap, and a replay's packed output is copied to
        # the host (_ChunkEntry.read) before any later work is queued
        self._graphs: Dict[Tuple, _cuda.CapturedGraph] = {}
        self._graph_pool: Any = None
        self._decode_keys: set = set()
        # launches of the eager warm-up passes before each capture (their
        # results are discarded; the replays count the chunks' launches)
        self._graph_warmup_launches: "collections.Counter[str]" = (
            collections.Counter())
        # the comparison hook: True runs every body eagerly on the card
        # (chip_smoke.py and the card tests hold the replays to it); no
        # config field or flag sets it
        self._eager = False
        # host mirrors: lengths for the capacity loop, and the sampling
        # knobs so a step knows without a device sync whether any row
        # needs the top-k/top-p/min-p mask or the Gumbel draw
        self._lengths_host = np.zeros((n,), np.int32)
        self._knobs_host = np.zeros((n, 4), np.float32)   # temp,k,p,min_p
        self._knobs_host[:, 2] = 1.0
        self._stop_slots: set = set()

        # ---- metrics
        self.prefill_stats = LatencyStats()
        self.chunk_stats = LatencyStats()
        self.ttft_stats = LatencyStats()
        self._total_requests = 0
        self._total_generated = 0
        self._total_prompt_tokens = 0
        self._admission_denied = 0
        self._rejected_full = 0        # submits refused: queue at cap
        self._shed_deadline = 0        # queued requests shed past deadline
        self._deadline_expired = 0     # per-request deadline_s expiries
        self._capacity_finishes = 0
        self._steps = 0
        self._decode_steps = 0
        self._prefill_calls = 0
        self._chunked_admissions = 0
        self._deferred_admissions = 0
        self._mixed_steps = 0
        self._mixed_prefill_tokens = 0
        # (prefill-rows bucket, chunk bucket) shapes the mixed step ran
        self._mixed_programs: set = set()
        self._occupancy_sum = 0
        # sub-chunk streaming: ring traffic, clamp engagements, and the
        # firsts buffer's whole reads (one per invalidation, never per slot)
        self._ring_pushes = 0
        self._ring_polls = 0
        self._ring_ready_polls = 0
        self._ring_high_water = 0
        self._stream_clamped_chunks = 0
        self._firsts_fetches = 0
        # step timeline (obs/timeline.py): one record a dispatch; a record
        # carries compile=True on its program key's first dispatch. The
        # port's program keys are the graph keys of the decode chunks and
        # mixed steps (_run): on the card that dispatch is the capture.
        # An admission prefill runs eagerly, so it has none
        cap = int(cfg.timeline_capacity or 0)
        self.timeline: Optional[StepTimeline] = (
            StepTimeline(capacity=cap, name="continuous") if cap else None)
        self._tl_programs: set = set()
        # the host-gap split, kept with the timeline off too: seconds
        # inside dispatch brackets against host seconds between them. A
        # sync decode bracket holds the blocking read (~device-busy wall);
        # a defer_sync one the dispatch alone, so its gap reads higher
        self._dispatch_s = 0.0
        self._host_gap_s = 0.0
        self._last_dispatch_end: Optional[float] = None
        # called right after a chunk's launches are queued and before its
        # read (the pump drains its inbox and polls the stream ring here,
        # in the device's shadow); it must only enqueue work (submit) or
        # poll the ring
        self.overlap_hook: Optional[Any] = None

        # async speculation (engine/spec_async.py): dispatched but
        # unprocessed chunks; while one is in flight the host lags the
        # device, so the speculator only catches its caches up
        self._inflight_chunks = 0
        self._spec_verify_steps = 0
        # the verify step's draft-column counts, at a fixed address
        self._n_drafts = torch.zeros((n,), **i32)
        self.speculator = None
        if cfg.spec_async:
            if self._defer:
                raise ValueError(
                    "spec_async requires defer_sync=False: proposals "
                    "need the live host frontier, which deferral keeps "
                    "one chunk stale")
            if self.spec.sliding_window:
                raise ValueError(
                    "spec_async does not support sliding-window "
                    "attention (the ragged verify path rejects it)")
            from .spec_async import AsyncSpeculator, resolve_draft

            if draft_spec is None or draft_params is None:
                draft_spec, draft_params = resolve_draft(
                    self.spec, self.params, cfg.spec_draft_model,
                    device=self.device)
            self.speculator = AsyncSpeculator(
                self, draft_spec, draft_params,
                k=int(cfg.spec_max_draft or 4),
                bubble_floor_s=float(cfg.spec_bubble_floor_s), seed=seed)

        if self.artifact_manifest is not None and artifact_selfcheck:
            # the golden-token self-check BEFORE any traffic: the save-time
            # probe replayed on the restored tree through the serving
            # path (on the card its graphs are captured here, at load)
            from .artifact import verify_golden

            t0 = time.perf_counter()
            if verify_golden(self, self.artifact_manifest):
                self.load_info["golden_probe_s"] = time.perf_counter() - t0

    # ------------------------------------------------------------- submit

    def submit(self, request: GenerationRequest, on_tokens=None) -> str:
        """Enqueue; returns the request id (assigned if empty).

        ``on_tokens`` (optional) streams the output: called on the
        engine's thread with each batch of new tokens, trimmed as the
        final result is (``max_new_tokens``, stops); the final
        ``GenerationResult`` holds the whole sequence. Past ``max_waiting``
        queued requests, raises ``EngineOverloadedError``."""
        if not request.prompt:
            raise ValueError("empty prompt")
        self._check_admission_cap()
        self._total_requests += 1
        if not request.request_id:
            request.request_id = f"creq-{self._total_requests}"
        self._waiting.append((request, on_tokens, time.perf_counter()))
        return request.request_id

    # ----------------------------------------------------------- overload

    def _check_admission_cap(self) -> None:
        """Hard backpressure at submit: a bounded waiting queue degrades
        service under overload instead of growing without bound."""
        cap = self.config.max_waiting
        if cap and self.n_waiting >= cap:
            self._rejected_full += 1
            raise EngineOverloadedError(
                f"waiting queue full ({self.n_waiting}/{cap}); "
                "retry on another replica or later", reason="queue_full")

    def _shed_expired(self) -> None:
        """Deadline shedding, two budgets checked at step start, before
        any prefill or decode work is spent on the victim:

        - the engine-wide ``queue_deadline_s`` (overload control): a
          request still queued past it resolves with
          ``finish_reason="overloaded"`` (``overload_reason`` "deadline",
          no tokens, ``ttft_s`` its queue wait); the pump turns it into
          the typed ``EngineOverloadedError`` for single-request callers;
        - the request's own ``deadline_s``: expiry resolves with
          ``finish_reason="deadline"`` and is never retried upstream.
        """
        q = self._waiting
        if not q:
            return
        queue_deadline = self.config.queue_deadline_s
        now = time.perf_counter()
        cut = (now - queue_deadline) if queue_deadline else None
        # FIFO: the head is the oldest, so the engine-wide budget is a head
        # check; per-request deadlines scan only when some request has one
        if not (cut is not None and q[0][2] <= cut) and not any(
                item[0].deadline_s is not None for item in q):
            return
        keep: Deque[Tuple[GenerationRequest, Any, float]] = (
            collections.deque())
        for item in q:
            req, t = item[0], item[2]
            if cut is not None and t <= cut:
                self._shed_deadline += 1
                self._finished.append(GenerationResult(
                    request_id=req.request_id,
                    tokens=[],
                    finish_reason="overloaded",
                    prompt_tokens=len(req.prompt),
                    ttft_s=now - t,
                    decode_s=0.0,
                    metadata={"overload_reason": "deadline"},
                ))
            elif req.deadline_s is not None and now - t >= req.deadline_s:
                self._deadline_expired += 1
                self._finished.append(GenerationResult(
                    request_id=req.request_id,
                    tokens=[],
                    finish_reason="deadline",
                    prompt_tokens=len(req.prompt),
                    ttft_s=now - t,
                    decode_s=0.0,
                    metadata={"deadline_s": req.deadline_s},
                ))
            else:
                keep.append(item)
        self._waiting = keep

    # ---------------------------------------------------------- admission

    # the host knob rows and the sampler's flags (engine/engine.py, shared
    # with the static and speculative engines)
    _knob_flags = staticmethod(knob_flags)
    _request_knobs = staticmethod(request_knobs)

    def _sample_knobs(self, logits: torch.Tensor, knobs: np.ndarray):
        """Sample rows of ``logits`` under host knob rows -> (tokens [n]
        int32, logprobs [n] fp32) on the device."""
        t = _cuda.upload(knobs, self.device)
        sampling = SamplingParams(t[:, 0], t[:, 1].to(torch.int32), t[:, 2],
                                  t[:, 3])
        needs_mask, needs_noise = self._knob_flags(knobs)
        return sample_tokens_with_logprobs(
            logits, sampling, generator=self._gen, needs_mask=needs_mask,
            needs_noise=needs_noise)

    def _sample_firsts(self, hidden: torch.Tensor, last_idx: np.ndarray,
                       reqs: List[GenerationRequest]) -> torch.Tensor:
        """Prefill tail: last-token logits -> first tokens and logprobs, on
        the device as one [2, bb] int32 buffer (tokens; logprob bits), so
        the caller reads both in one transfer, or not at all."""
        bb = hidden.shape[0]
        idx = _cuda.upload(last_idx, self.device, torch.int64)
        last = hidden[torch.arange(bb, device=self.device), idx]
        logits = unembed(self.spec, self.params, last)
        toks, lps = self._sample_knobs(logits,
                                       self._request_knobs(reqs, bb))
        return torch.stack([toks, lps.view(torch.int32)])

    @staticmethod
    def _read_firsts(firsts: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """The host read of a ``_sample_firsts`` buffer -> (tokens,
        logprobs)."""
        host = firsts.cpu().numpy()
        return host[0], host[1].view(np.float32)

    def _register_slot_host(self, req: GenerationRequest, slot: int,
                            prompt_len: int, first: int, t_submit: float,
                            on_tokens=None, first_lp: float = 0.0) -> bool:
        """Host bookkeeping of one admission; True when the slot stays
        live (its device state needs installing)."""
        state = _Slot(req, slot, prompt_len, on_tokens)
        state.tokens.append(first)
        state.logprobs.append(first_lp)
        state.produced = 1
        state.admitted_at = t_submit         # TTFT clock starts at submit
        state.first_token_at = time.perf_counter()
        self.ttft_stats.add(state.first_token_at - t_submit)
        self._slots[slot] = state
        self._emit_stream(state)
        state.stop_cut = find_stop_cut([first], req)
        if state.stop_cut >= 0 or req.max_new_tokens <= 1:
            self._finish(slot, "stop" if state.stop_cut >= 0 else "length")
            return False
        return True

    @staticmethod
    def _slot_row(req: GenerationRequest, slot: int, prompt_len: int,
                  first: int) -> Dict[str, Any]:
        return {"slot": slot, "prompt_len": prompt_len, "first": first,
                "max_new": req.max_new_tokens, "eos": req.eos_id,
                "temp": req.temperature, "top_k": req.top_k,
                "top_p": req.top_p, "min_p": req.min_p,
                "stops": list(req.stop_ids or ())[:_DEVICE_STOP_K]}

    def _install_device(self, rows: List[Dict[str, Any]],
                        firsts: Optional[torch.Tensor] = None,
                        cols: Sequence[int] = ()) -> None:
        """Write a round's per-slot device state: three host->device
        copies (slots, ints, floats) and one indexed write per state
        tensor. With ``firsts`` (deferred admission, the counterpart of
        JAX's ``_install_device_first``) the first tokens come from the
        prefill's device output instead: row i's from column ``cols[i]``
        of ``firsts`` ([2, bb]: tokens; logprob bits), parked in
        ``_firsts_dev`` for the next chunk's packed read; a first token
        equal to the slot's eos installs it inactive. No host read."""
        if not rows:
            return
        m = len(rows)
        ints = np.full((m, 5 + _DEVICE_STOP_K), -1, np.int32)
        floats = np.zeros((m, 3), np.float32)
        slots = np.zeros((m,), np.int64)
        for i, r in enumerate(rows):
            s = r["slot"]
            slots[i] = s
            ints[i, :5] = (r["prompt_len"], r["first"], r["max_new"],
                           r["eos"], r["top_k"])
            ints[i, 5: 5 + len(r["stops"])] = r["stops"]
            floats[i] = (r["temp"], r["top_p"], r["min_p"])
            self._lengths_host[s] = r["prompt_len"]
            self._knobs_host[s] = (r["temp"], r["top_k"], r["top_p"],
                                   r["min_p"])
            (self._stop_slots.add if r["stops"]
             else self._stop_slots.discard)(s)
        dev = self.device
        idx = _cuda.upload(slots, dev)
        it = _cuda.upload(ints, dev)
        ft = _cuda.upload(floats, dev)
        self._lengths[idx] = it[:, 0]
        if firsts is None:
            self._last[idx] = it[:, 1]
            self._active[idx] = True
        else:
            sel = firsts[:, _cuda.upload(np.asarray(cols, np.int64), dev)]
            self._last[idx] = sel[0]
            self._active[idx] = (sel[0] != it[:, 3]) | (it[:, 3] < 0)
            self._firsts_dev[:, idx] = sel
            self._firsts_host = None   # columns rewritten: the cache is stale
        self._produced[idx] = 1
        self._max_new[idx] = it[:, 2]
        self._eos[idx] = it[:, 3]
        self._top_k[idx] = it[:, 4]
        self._stops_dev[idx] = it[:, 5:]
        self._temps[idx] = ft[:, 0]
        self._top_p[idx] = ft[:, 1]
        self._min_p[idx] = ft[:, 2]

    def _install_slot(self, req: GenerationRequest, slot: int,
                      prompt_len: int, first: int, t_dispatch: float,
                      on_tokens, t_submit: float,
                      first_lp: float = 0.0) -> None:
        self.prefill_stats.add(time.perf_counter() - t_dispatch)
        self._tl_record("prefill", t_dispatch, rows=1,
                        prefill_tokens=prompt_len)
        if self._register_slot_host(req, slot, prompt_len, first, t_submit,
                                    on_tokens, first_lp=first_lp):
            self._install_device(
                [self._slot_row(req, slot, prompt_len, first)])

    def _admit_row_cap(self) -> int:
        cap = self.config.admission_max_rows
        return min(self.max_slots, cap) if cap else self.max_slots

    def _should_hold_admissions(self) -> bool:
        """Admission coalescing (``admission_min_batch``), as in the JAX
        engine: hold a small admission round for batch-mates unless the
        engine is under half full or the oldest request waited too long.
        A prompt mid-prefill holds a slot, so it counts as live."""
        mb = self.config.admission_min_batch
        if not mb or not self._waiting:
            return False
        live = len(self._slots) + len(self._prefilling)
        if len(self._waiting) >= min(mb, self.max_slots - live):
            return False
        if live * 2 < self.max_slots:
            return False
        return (time.perf_counter() - self._waiting[0][2]
                < self.config.admission_max_hold_s)

    def _try_admit(self) -> int:
        """Prefill waiting requests into free slots; returns #admitted.
        Cache misses share one batched prefill; prefix-cache hits run
        their suffix prefill one by one. A request whose first page a
        same-round admission will register waits for that flush, so it
        finds the pages and takes the suffix path. With ``prefill_chunk``
        a prompt whose uncached part exceeds the chunk starts chunked: a
        miss sends its first chunk through the batched prefill, a hit
        resumes after its cached pages."""
        if self._should_hold_admissions():
            return 0
        admitted = 0
        batch: List[Tuple] = []
        pending_hashes: set = set()
        while self._waiting:
            req, on_tok, t_submit = self._waiting[0]
            prompt = req.prompt[-(self.max_seq_len - 1):]
            if self.prefix_cache:
                h1 = self.kv.first_page_hash(prompt)
                if batch and h1 is not None and h1 in pending_hashes:
                    self._admit_batch(batch)
                    batch = []
                    pending_hashes.clear()
                got = self.kv.alloc_slot_prefix(prompt)
                if got is None:
                    self._admission_denied += 1
                    break
                slot, n_cached = got
            else:
                slot = self.kv.alloc_slot(len(prompt))
                n_cached = 0
                if slot is None:
                    self._admission_denied += 1
                    break
            # chunk whenever the uncached part exceeds the chunk: a prefix
            # hit with a long unique tail stalls decode as hard as a miss
            will_chunk = (bool(self._chunk)
                          and len(prompt) - n_cached > self._chunk)
            if self.prefix_cache and n_cached == 0 and not will_chunk:
                # a chunked admission registers its prefix only after its
                # last chunk: advertising its hash would force flushes
                # that register nothing
                hr = self.kv.first_page_hash(prompt, registerable=True)
                if hr is not None:
                    pending_hashes.add(hr)
            self._waiting.popleft()
            admitted += 1
            if will_chunk and n_cached > 0:
                self._prefix_hit_admissions += 1
                self._start_chunked(req, on_tok, slot, prompt, t_submit,
                                    done=n_cached)
            elif will_chunk or n_cached == 0:
                # a chunked miss sends its first chunk (and the full prompt
                # for the chunk advance) through the batched prefill
                batch.append((req, on_tok, slot,
                              prompt[: self._chunk] if will_chunk
                              else prompt, t_submit,
                              prompt if will_chunk else None))
                if len(batch) >= self._admit_row_cap():
                    self._admit_batch(batch)
                    batch = []
                    pending_hashes.clear()
            else:
                t0 = time.perf_counter()
                self._prefix_hit_admissions += 1
                toks, lps = self._read_firsts(self._run_suffix_prefill(
                    [prompt[n_cached:]], [slot], [n_cached], [req]))
                self.kv.register_prefix(slot, prompt)
                self._total_prompt_tokens += len(prompt)
                self._install_slot(req, slot, len(prompt), int(toks[0]), t0,
                                   on_tok, t_submit=t_submit,
                                   first_lp=float(lps[0]))
        if batch:
            self._admit_batch(batch)
        return admitted

    def _admit_batch(self, batch) -> None:
        """One prefill (pools written in place) + one first-token read +
        one state install for N cache-miss admissions. Rows pad to a
        power-of-two batch and the prompts to a prefill bucket; pad rows
        have seq_len 0 and write nothing. A row with a full prompt
        (``full`` not None) is the first chunk of a chunked admission.

        Deferred admission: under decode pressure (at least a quarter of
        the slots live) and when every row wants more than one token, the
        first-token read is skipped: the first tokens are installed on the
        device and harvested from the next chunk's packed read."""
        t0 = time.perf_counter()
        self._prefill_calls += 1
        n = len(batch)
        bb = 1 << (n - 1).bit_length()
        tb = _next_bucket(max(len(p) for _, _, _, p, _, _ in batch),
                          self.prefill_buckets)
        tokens = np.zeros((bb, tb), np.int32)
        seq_lens = np.zeros((bb,), np.int32)
        table_rows = np.zeros((bb, self.kv.max_pages_per_seq), np.int32)
        for i, (_req, _cb, slot, prompt, _ts, _full) in enumerate(batch):
            tokens[i, : len(prompt)] = prompt
            seq_lens[i] = len(prompt)
            table_rows[i] = self.kv._table[slot]
        hidden, _, _ = forward_prefill_into_pages(
            self.spec, self.params, _cuda.upload(tokens, self.device),
            seq_lens, self.kv.k_pages, self.kv.v_pages, table_rows)
        first_dev = self._sample_firsts(
            hidden, np.maximum(seq_lens - 1, 0), [r for r, *_ in batch])
        # a max_new_tokens <= 1 request must stop before decoding, which
        # needs its token on the host: such rounds read
        defer = (self._defer_admit
                 and len(self._slots) * 4 >= self.max_slots
                 and all(r.max_new_tokens > 1 for r, *_ in batch))
        host = None if defer else self._read_firsts(first_dev)
        self.prefill_stats.add(time.perf_counter() - t0)
        tl_args = {"deferred": True} if defer else {}
        self._tl_record("prefill", t0, rows=n,
                        prefill_tokens=int(seq_lens.sum()), **tl_args)
        rows: List[Dict[str, Any]] = []
        cols: List[int] = []
        for i, (req, cb, slot, prompt, t_submit, full) in enumerate(batch):
            if full is not None:
                # first chunk of a chunked admission: its pages are written
                # and its sample is discarded (the logits saw a truncated
                # prompt); the chunk advance takes over. Its prompt tokens
                # and prefix pages are counted at the last chunk
                self._start_chunked(req, cb, slot, full, t_submit,
                                    done=len(prompt))
                continue
            if self.prefix_cache:
                self.kv.register_prefix(slot, prompt)
            self._total_prompt_tokens += len(prompt)
            if defer:
                state = _Slot(req, slot, len(prompt), cb)
                state.first_pending = True
                state.admitted_at = t_submit
                self._slots[slot] = state
                rows.append(self._slot_row(req, slot, len(prompt), 0))
                cols.append(i)
                continue
            first = int(host[0][i])
            if self._register_slot_host(req, slot, len(prompt), first,
                                        t_submit, cb,
                                        first_lp=float(host[1][i])):
                rows.append(self._slot_row(req, slot, len(prompt), first))
        if defer:
            self._deferred_admissions += len(rows)
            self._install_device(rows, first_dev, cols)
        else:
            self._install_device(rows)

    def _run_suffix_prefill(self, suffixes, slots, n_ctxs, reqs
                            ) -> torch.Tensor:
        """Prefill each row's ``suffixes[i]`` on top of ``n_ctxs[i]``
        (page-aligned) tokens already in ``slots[i]``'s pages; the fresh
        K/V lands at that offset. Shared by prefix-cache hits and the
        chunk advance. Returns the ``_sample_firsts`` device buffer."""
        n = len(suffixes)
        bb = 1 << (n - 1).bit_length()
        tb = _next_bucket(max(len(s) for s in suffixes), self.prefill_buckets)
        ps = self.kv.page_size
        mpb = _next_bucket(max(c // ps for c in n_ctxs),
                           self._ctx_page_buckets)
        tokens = np.zeros((bb, tb), np.int32)
        suffix_lens = np.zeros((bb,), np.int32)
        n_ctx = np.zeros((bb,), np.int32)
        phys = np.zeros((bb, mpb), np.int64)
        table_rows = np.zeros((bb, self.kv.max_pages_per_seq), np.int32)
        for i, (suffix, slot, ctx) in enumerate(zip(suffixes, slots, n_ctxs)):
            tokens[i, : len(suffix)] = suffix
            suffix_lens[i] = len(suffix)
            n_ctx[i] = ctx
            phys[i] = self.kv._table[slot, :mpb]
            table_rows[i] = self.kv._table[slot]
        spec = self.spec
        L, Hkv, Dh = spec.n_layers, spec.n_kv_heads, spec.head_dim
        pages = _cuda.upload(phys, self.device)
        # the context in the compute dtype (fp8 pages gathered as bytes,
        # then widened), beside the suffix's fresh keys unrounded
        kv_dt = self.kv.dtype
        ck = raw_view(self.kv.k_pages)[:, pages].view(kv_dt).reshape(
            L, bb, mpb * ps, Hkv, Dh)
        cv = raw_view(self.kv.v_pages)[:, pages].view(kv_dt).reshape(
            L, bb, mpb * ps, Hkv, Dh)
        hidden, ks, vs = forward_prefill_suffix(
            spec, self.params, _cuda.upload(tokens, self.device),
            suffix_lens, n_ctx, ck.to(spec.torch_dtype),
            cv.to(spec.torch_dtype))
        write_prefill_pages(self.kv.k_pages, self.kv.v_pages, ks, vs,
                            table_rows, suffix_lens, start=n_ctx)
        return self._sample_firsts(hidden, np.maximum(suffix_lens - 1, 0),
                                   list(reqs))

    # ----------------------------------------------------- chunked prefill

    def _start_chunked(self, req: GenerationRequest, on_tokens, slot: int,
                       prompt: List[int], t_submit: float, done: int
                       ) -> None:
        """Begin the incremental prefill of a long prompt: its slot and
        pages are reserved; ``done`` (page-aligned, > 0) tokens are in its
        pages, from the batched first chunk or a prefix-cache hit."""
        self._chunked_admissions += 1
        self._prefilling[slot] = _PrefillProgress(req, prompt, on_tokens,
                                                  t_submit, done)

    def _finish_prefill(self, slot: int, prog: _PrefillProgress, first: int,
                        first_lp: float, rows: List[Dict[str, Any]]) -> None:
        """A prompt's last chunk ran: it registers its prefix and becomes
        a live slot with the last chunk's sample as its first token."""
        del self._prefilling[slot]
        if self.prefix_cache:
            self.kv.register_prefix(slot, prog.prompt)
        self._total_prompt_tokens += len(prog.prompt)
        if self._register_slot_host(prog.request, slot, len(prog.prompt),
                                    first, prog.t_submit, prog.on_tokens,
                                    first_lp=first_lp):
            rows.append(self._slot_row(prog.request, slot, len(prog.prompt),
                                       first))

    def _advance_chunked(self) -> None:
        """The split path: advance every prompt mid-prefill by one chunk,
        in one suffix-prefill dispatch per context-page bucket (batching
        pads every row's context gather to the batch's largest, so rows
        are grouped to keep that padding under 2x)."""
        if not self._prefilling:
            return
        groups: Dict[int, List[Tuple[int, _PrefillProgress]]] = {}
        for slot, prog in self._prefilling.items():
            b = _next_bucket(prog.done // self.kv.page_size,
                             self._ctx_page_buckets)
            groups.setdefault(b, []).append((slot, prog))
        for _, items in sorted(groups.items()):
            self._advance_group(items)

    def _advance_group(self, items) -> None:
        """One suffix-prefill dispatch advancing ``items`` by a chunk each;
        only a prompt's last chunk yields its first token, read to the host
        only when some row finished."""
        t0 = time.perf_counter()
        suffixes = [prog.prompt[prog.done: prog.done + self._chunk]
                    for _, prog in items]
        firsts = self._run_suffix_prefill(
            suffixes, [slot for slot, _ in items],
            [prog.done for _, prog in items],
            [prog.request for _, prog in items])
        self._prefill_calls += 1
        self.prefill_stats.add(time.perf_counter() - t0)
        self._tl_record("prefill_chunk", t0, rows=len(items),
                        prefill_tokens=sum(len(s) for s in suffixes))
        host = None
        rows: List[Dict[str, Any]] = []
        for i, (slot, prog) in enumerate(items):
            prog.done += len(suffixes[i])
            if prog.done < len(prog.prompt):
                continue
            if host is None:
                host = self._read_firsts(firsts)
            self._finish_prefill(slot, prog, int(host[0][i]),
                                 float(host[1][i]), rows)
        self._install_device(rows)

    # ---------------------------------------------------------- streaming

    def _emit_stream(self, state: _Slot) -> int:
        """Push a slot's new tokens to its streaming callback, trimmed as
        ``_finish`` trims the final result (``max_new_tokens``, the stop
        cut), so a consumer never sees a token the result won't hold.
        Returns 1 when a frame was delivered, else 0."""
        cb = state.on_tokens
        if cb is None:
            return 0
        req = state.request
        toks = state.tokens[: req.max_new_tokens]
        if 0 <= state.stop_cut <= len(toks):
            toks = toks[: state.stop_cut]
        if len(toks) > state.streamed:
            fresh = toks[state.streamed:]
            state.streamed = len(toks)
            try:
                cb(fresh)
            except Exception:
                logger.exception("stream callback failed for %s",
                                 req.request_id)
                state.on_tokens = None     # don't retry a broken consumer
            return 1
        return 0

    # ------------------------------------------------------------- finish

    def _firsts_snapshot(self) -> np.ndarray:
        """Host [2, max_slots] copy of the deferred firsts buffer for the
        retire-path rescues: the copy that rode a sync packed read, or,
        when that is stale, one read of the whole buffer (never one per
        slot; ``firsts_fetches`` counts them)."""
        if self._firsts_host is None:
            self._firsts_host = self._firsts_dev.cpu().numpy()
            self._firsts_fetches += 1
        return self._firsts_host

    def _rescue_first(self, state: _Slot, slot: int) -> None:
        """Deliver the deferred first token of a slot that retires before
        any packed read harvested it, from the batched snapshot."""
        state.first_pending = False
        fp = self._firsts_snapshot()
        state.tokens.insert(0, int(fp[0, slot]))
        state.logprobs.insert(
            0, float(fp[1:2, slot].copy().view(np.float32)[0]))
        state.first_token_at = time.perf_counter()
        self.ttft_stats.add(state.first_token_at - state.admitted_at)

    def _finish(self, slot: int, reason: str) -> None:
        state = self._slots.pop(slot)
        self._stop_slots.discard(slot)
        self.kv.free_slot(slot)
        req = state.request
        if state.first_pending:
            # retired before a packed read delivered its first token
            self._rescue_first(state, slot)
        toks, stopped = trim_at_stops(state.tokens, req)
        if stopped:
            reason = "stop"
        self._total_generated += len(toks)
        self._finished.append(GenerationResult(
            request_id=req.request_id,
            tokens=toks,
            finish_reason=reason,
            prompt_tokens=state.prompt_len,
            logprobs=state.logprobs[: len(toks)],
            ttft_s=state.first_token_at - state.admitted_at,
            decode_s=time.perf_counter() - state.first_token_at,
        ))

    def _set_active(self, slots: List[int], value: bool) -> None:
        """Retire (False) or revive (True) slots on the device, queued
        behind any chunk in flight."""
        if slots:
            self._active[_cuda.upload(np.asarray(slots, np.int64),
                                      self.device)] = value

    # --------------------------------------------------------------- step

    def _advance(self, next_tok, lp, lengths, last, active, produced, cap,
                 use_stops: bool):
        """The per-step bookkeeping of a decode step (the JAX chunk's
        ``advance``): eos, ``max_new_tokens``, the capacity grant and the
        device stop matrix retire a slot in place. Returns the new
        (lengths, last, active, produced) and the step's emitted tokens
        (-1 for idle slots) and logprobs."""
        was = active
        produced = produced + was.to(torch.int32)
        hit_eos = (next_tok == self._eos) & (self._eos >= 0)
        lengths = lengths + was.to(torch.int32)
        done = hit_eos | (produced >= self._max_new) | (lengths >= cap)
        if use_stops:
            done = done | ((next_tok[:, None] == self._stops_dev)
                           & (self._stops_dev >= 0)).any(dim=-1)
        active = was & ~done
        last = torch.where(was, next_tok, last)
        emitted = torch.where(was, next_tok, torch.full_like(next_tok, -1))
        lp = torch.where(was, lp, torch.zeros_like(lp))
        return lengths, last, active, produced, emitted, lp

    # ------------------------------------------------------ dispatch

    def _state(self) -> Tuple[torch.Tensor, ...]:
        return self._lengths, self._last, self._active, self._produced

    def _run(self, key: Tuple, body, generators=None) -> torch.Tensor:
        """``body()`` on the CPU (or with the ``_eager`` hook); on a CUDA
        device a replay of ``key``'s graph, captured first if new.
        ``generators`` are the ones ``body`` draws from (the engine's by
        default; a draft round's, the speculator's)."""
        if self.device.type != "cuda" or self._eager:
            return body()
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = self._capture(
                body, generators or (self._gen,))
        return graph.replay()

    def _capture(self, body, generators) -> _cuda.CapturedGraph:
        """One eager warm-up pass of ``body`` on the capture stream, its
        effects undone (the per-slot state and the generators restored;
        the pages and draft caches it wrote, the replay writes again), then
        the capture. A failure raises: there is no eager fallback."""
        with _cuda.GRAPH_LOCK:
            stream = _cuda.capture_stream(self.device)
            saved = [t.clone() for t in self._state()]
            gen_states = [g.get_state() for g in generators]
            t0 = time.perf_counter()
            with _cuda.recording_launches() as warm:
                _cuda.warm_up(body, stream)
            warmup_s = time.perf_counter() - t0
            self._graph_warmup_launches.update(warm)
            for t, v in zip(self._state(), saved):
                t.copy_(v)
            for g, st in zip(generators, gen_states):
                g.set_state(st)
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph = _cuda.capture_graph(body, pool=self._graph_pool,
                                        stream=stream,
                                        generators=tuple(generators))
            graph.warmup_s = warmup_s
            return graph

    def _decode_chunk(self, n_steps: int, caps: List[int], t0: float
                      ) -> _ChunkEntry:
        """Queue one chunk of ``n_steps`` decode steps over all slots
        (``caps``: each slot's token capacity): fill the inputs, run the
        body (a graph replay on the card), queue the packed output's host
        copy. The entry's snapshot holds the slots it was dispatched for."""
        needs_mask, needs_noise = self._knob_flags(self._knobs_host)
        key = ("decode", n_steps, bool(self._stop_slots), needs_mask,
               needs_noise)
        self._decode_keys.add(key)
        _cuda.upload_into(self._cap, np.asarray(caps, np.int32))
        table = self.kv.page_table
        self._decode_steps += n_steps
        packed = self._run(key, lambda: self._decode_body(
            n_steps, key[2], needs_mask, needs_noise, table))
        self._inflight_chunks += 1
        return _ChunkEntry(packed, n_steps, dict(self._slots), t0, caps,
                           fresh_firsts=not self._defer, key=key)

    def _decode_body(self, n_steps: int, use_stops: bool, needs_mask: bool,
                     needs_noise: bool, table: torch.Tensor) -> torch.Tensor:
        """The decode chunk on the device, from the embedding to the packed
        output: ``n_steps`` steps, then (window scheme) the side window's
        flush into the pages, then the per-slot state written in place.
        Reads only tensors at fixed addresses."""
        spec = self.spec
        n = self.max_slots
        start_lengths = self._lengths
        lengths, last = self._lengths, self._last
        active, produced = self._active, self._produced
        sampling = SamplingParams(self._temps, self._top_k, self._top_p,
                                  self._min_p)
        side_k = side_v = None
        if self.use_window:
            side_k = torch.zeros((spec.n_layers, n, n_steps,
                                  spec.n_kv_heads, spec.head_dim),
                                 dtype=spec.torch_dtype, device=self.device)
            side_v = torch.zeros_like(side_k)
        toks, lps = [], []
        for _ in range(n_steps):
            if self.use_window:
                hidden, side_k, side_v = forward_decode_window(
                    spec, self.params, last, lengths, start_lengths,
                    self.kv.k_pages, self.kv.v_pages, table, side_k, side_v,
                    active, attn_impl=self.decode_impl,
                    fused=self.decode_fused)
            else:
                # inactive slots (free, or retired earlier in the chunk)
                # must not write
                hidden, _, _ = forward_decode_paged(
                    spec, self.params, last, lengths, self.kv.k_pages,
                    self.kv.v_pages, table, active,
                    attn_impl=self.decode_impl, fused=self.decode_fused)
            logits = unembed(spec, self.params, hidden)
            next_tok, lp = sample_tokens_with_logprobs(
                logits, sampling, generator=self._gen,
                needs_mask=needs_mask, needs_noise=needs_noise)
            lengths, last, active, produced, emitted, lp = self._advance(
                next_tok, lp, lengths, last, active, produced, self._cap,
                use_stops)
            toks.append(emitted)
            lps.append(lp)
        if self.use_window:
            # chunk-end flush: slot b's fresh K/V sits in side entries [0,
            # written) and lands at [start, start + written) of its pages
            write_pages_device(self.kv.k_rows, self.kv.v_rows, side_k,
                               side_v, table, lengths - start_lengths,
                               start_lengths, self.kv.page_size)
        packed = torch.cat([
            torch.stack(toks), torch.stack(lps).view(torch.int32),
            active[None].to(torch.int32), lengths[None],
            self._firsts_dev], dim=0).reshape(-1)
        for dst, src in zip(self._state(), (lengths, last, active,
                                             produced)):
            dst.copy_(src)
        return packed

    def _step_verify(self, drafts, q_probs, n_drafts: np.ndarray,
                     verified) -> None:
        """A decode step carrying the pending proposals as extra verify
        columns (the JAX ``_step_verify``): one dispatch advances a drafted
        slot by its accepted run plus one target token and every other
        slot by one plain token. Its packed output is a decode chunk's at
        ``n_steps = k + 1`` plus one row of accept counts, which the
        speculator reads off the same host read."""
        kd = self.speculator.k
        t0 = time.perf_counter()
        caps = self._cap_list()
        needs_mask, needs_noise = self._knob_flags(self._knobs_host)
        use_stops = bool(self._stop_slots)
        key = ("verify", kd, use_stops, needs_mask, needs_noise)
        _cuda.upload_into(self._cap, np.asarray(caps, np.int32))
        _cuda.upload_into(self._n_drafts, n_drafts)
        table = self.kv.page_table
        packed = self._run(key, lambda: self._verify_body(
            drafts, q_probs, use_stops, needs_mask, needs_noise, table))
        self._inflight_chunks += 1
        entry = _ChunkEntry(packed, kd + 1, dict(self._slots), t0, caps,
                            fresh_firsts=True, key=key)
        self._run_overlap_hook()
        self._process_packed(entry)
        self._spec_verify_steps += 1
        self.speculator.note_verified(entry, verified)
        self._tl_record("verify", t0, program=key, rows=len(entry.snapshot),
                        n_steps=kd + 1)

    def _verify_body(self, drafts: torch.Tensor, q_probs: torch.Tensor,
                     use_stops: bool, needs_mask: bool, needs_noise: bool,
                     table: torch.Tensor) -> torch.Tensor:
        """The verify step on the device (the JAX ``_verify_chunk``): one
        ragged ``forward_mixed_step`` over ``[last, d_0 .. d_{m-1}]`` a row
        (a plain row is a q=1 decode row, an idle one inert), the target's
        knob-masked distributions at every position, ``rejection_accept``
        with the column mask, then the emission replaying the decode
        step's eos/budget/cap/stop order position by position. Reads only
        tensors at fixed addresses."""
        spec = self.spec
        b = self.max_slots
        kd = drafts.shape[1]
        dev = self.device
        lengths, last = self._lengths, self._last
        active, produced = self._active, self._produced
        n_drafts = self._n_drafts
        tokens = torch.cat([last[:, None], drafts], dim=1)       # [B, kd+1]
        zero = torch.zeros_like(lengths)
        ctx = torch.where(active, lengths, zero)
        qlens = torch.where(active, 1 + n_drafts, zero)
        x, _, _ = forward_mixed_step(
            spec, self.params, tokens, ctx, qlens, self.kv.k_pages,
            self.kv.v_pages, table, return_hidden_all=True)
        logits = unembed(spec, self.params, x)                   # [B, kd+1, V]
        sampling = SamplingParams(self._temps, self._top_k, self._top_p,
                                  self._min_p)
        p_probs = masked_sampling_probs(logits, sampling, needs_mask)
        if needs_noise:
            u = torch.rand((b, kd), generator=self._gen, device=dev)
            noise = gumbel_noise((b, spec.vocab_size), self._gen, dev)
        else:
            u, noise = torch.zeros((b, kd), device=dev), None
        valid = torch.arange(kd, device=dev)[None, :] < n_drafts[:, None]
        qz = torch.where(valid[:, :, None], q_probs,
                         torch.zeros_like(q_probs))
        n_acc, final, _ = rejection_accept(
            p_probs, qz, drafts, self._temps <= 0.0, u, noise, valid=valid)
        cand = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
        cand = cand.scatter(1, n_acc.long()[:, None], final[:, None])
        # the untempered logprob at each position, as the sampler reports
        lp_all = torch.log_softmax(logits.float(), dim=-1)
        lp_cand = torch.gather(lp_all, 2, cand.long()[:, :, None])[..., 0]
        toks, lps = [], []
        for j in range(kd + 1):
            tok_j = cand[:, j]
            # a row past its accepted run stays active but emits nothing:
            # its stale done conditions must not retire it
            em = active & (j <= n_acc)
            produced = produced + em.to(torch.int32)
            hit_eos = (tok_j == self._eos) & (self._eos >= 0)
            new_len = lengths + em.to(torch.int32)
            done = hit_eos | (produced >= self._max_new) | (new_len >= self._cap)
            if use_stops:
                done = done | ((tok_j[:, None] == self._stops_dev)
                               & (self._stops_dev >= 0)).any(dim=-1)
            active = active & ~(em & done)
            last = torch.where(em, tok_j, last)
            lengths = new_len
            toks.append(torch.where(em, tok_j, torch.full_like(tok_j, -1)))
            lps.append(torch.where(em, lp_cand[:, j],
                                   torch.zeros_like(lp_cand[:, j])))
        packed = torch.cat([
            torch.stack(toks), torch.stack(lps).view(torch.int32),
            active[None].to(torch.int32), lengths[None], self._firsts_dev,
            n_acc[None]], dim=0).reshape(-1)
        for dst, src in zip(self._state(), (lengths, last, active,
                                             produced)):
            dst.copy_(src)
        return packed

    def step(self) -> int:
        """One engine iteration: admit, advance the chunked prefills, then
        one decode chunk — or, on a ragged engine with prompts
        mid-prefill, one mixed step. Returns the number of live and
        mid-prefill slots after it. Queued requests past a deadline are
        resolved first (``_shed_expired``). With ``defer_sync`` chunk k's
        packed output is read after chunk k+1 is queued: finishes,
        host-side stops and streaming run one chunk behind the device."""
        self._shed_expired()
        self._try_admit()
        if self._mixed and self._prefilling:
            self._step_mixed()
            return self.n_live
        self._advance_chunked()
        if not self._slots:
            # a deferred chunk whose processing freed the last live slots
            # leaves the next one pending with no current snapshot entry:
            # processing it would be a no-op, so drop it
            if self._pending is not None:
                self._inflight_chunks = max(0, self._inflight_chunks - 1)
            self._pending = None
            self._ring.clear()
            return len(self._prefilling)
        self._steps += 1
        self._occupancy_sum += len(self._slots)
        if self.speculator is not None:
            # the step top is the one gap where the host state IS the
            # device frontier: draft proposals happen here (the overlap
            # hook's calls, a chunk in flight, only catch caches up)
            self.speculator.schedule()
        # capacity: grow every slot toward a full chunk (two under
        # defer_sync: the device may be a chunk past the host's lengths);
        # one that can't fit another token finishes with "length"
        n_steps = self.config.decode_steps_per_call
        ahead = 2 * n_steps if self._defer else n_steps
        if self.speculator is not None:
            # a verify window writes K/V at [L, L + k + 1): a smaller grant
            # would write through stale table entries into other slots
            ahead = max(ahead, self.speculator.k + 1)
        retired: List[int] = []
        for slot in list(self._slots):
            cur = int(self._lengths_host[slot])
            cap_tok = self.kv.ensure_capacity(slot, cur + ahead)
            if cap_tok <= cur:
                self._capacity_finishes += 1
                retired.append(slot)
                self._finish(slot, "length")
            else:
                n_steps = min(n_steps, cap_tok - cur)
        self._set_active(retired, False)
        # while a live slot streams, decode in shorter chunks so its
        # tokens reach the host every stream_chunk_steps steps; a power of
        # two, so a run adds at most one decode key
        scs = self.config.stream_chunk_steps
        if scs > 0 and n_steps > 1 and any(
                s.on_tokens is not None for s in self._slots.values()):
            sub = 1 << (scs - 1).bit_length()
            if sub < n_steps:
                n_steps = sub
                self._stream_clamped_chunks += 1
        if not self._slots or n_steps <= 0:
            return self.n_live
        if self.speculator is not None:
            ver = self.speculator.take_verifiable()
            if ver is not None:
                # fresh proposals: this step verifies them instead of a
                # plain decode chunk
                self._step_verify(*ver)
                return self.n_live

        t0 = time.perf_counter()
        entry = self._decode_chunk(n_steps, self._cap_list(), t0)
        self._run_overlap_hook()
        if self._defer:
            self._ring.append(entry)
            self._ring_pushes += 1
            self._ring_high_water = max(self._ring_high_water,
                                        len(self._ring))
            prev, self._pending = self._pending, entry
            if prev is not None:
                self._process_packed(prev)
        else:
            self._process_packed(entry)
        self._tl_record("decode", t0, program=entry.key,
                        rows=len(entry.snapshot), n_steps=n_steps)
        return self.n_live

    def _cap_list(self) -> List[int]:
        """Each slot's token capacity (0 for a free slot)."""
        return [min(self.kv.slot_capacity(s), self.max_seq_len)
                if s in self._slots else 0 for s in range(self.max_slots)]

    def _tl_record(self, kind: str, t0: float, program: Any = None,
                   **args: Any) -> None:
        """One dispatch's host-gap accounting and step-timeline record
        (the JAX engine's ``_tl_record``): ``program`` is its program key
        (a decode or mixed graph key), whose first dispatch the record
        marks ``compile=True``. It reads host mirrors only: no device
        synchronisation."""
        now = time.perf_counter()
        self._dispatch_s += now - t0
        last = self._last_dispatch_end
        if last is not None and t0 > last:
            self._host_gap_s += t0 - last
        self._last_dispatch_end = now
        tl = self.timeline
        if tl is None:
            return
        if program is not None and program not in self._tl_programs:
            self._tl_programs.add(program)
            args["compile"] = True
        args["live_slots"] = len(self._slots)
        args["waiting"] = len(self._waiting)
        if self._prefilling:
            args["prefilling"] = len(self._prefilling)
        kv = self.kv
        args["kv_pages_used"] = (kv.num_pages - len(kv._free)
                                 - len(kv._reclaimable))
        args["kv_pages_total"] = kv.num_pages
        tl.record(kind, t0, now - t0, **args)

    def _run_overlap_hook(self) -> None:
        if self.overlap_hook is not None:
            try:
                self.overlap_hook()
            except Exception:
                logger.exception("overlap hook failed")

    # -------------------------------------------------------- mixed step

    def _step_mixed(self) -> None:
        """One mixed step (``attention_impl="pallas-ragged"`` with prompts
        mid-prefill): every decode slot advances one token and prefill
        chunks ride the same ``forward_mixed_step``, instead of the split
        path's suffix dispatch plus decode chunk.

        ``mixed_step_tokens`` caps the prefill tokens per step at row
        granularity, oldest prompt first and always at least one row. The
        ragged kernel writes every row's K/V into its pages: a mixed step
        has no side window and no chunk-end flush. It reads its packed
        output at once (one token a slot leaves nothing for
        ``defer_sync`` to overlap), after processing a deferred chunk
        still pending: selection and capacity need the current host
        state."""
        t0 = time.perf_counter()
        if self._pending is not None:
            prev, self._pending = self._pending, None
            self._process_packed(prev)
        budget = self.config.mixed_step_tokens
        sel: List[Tuple[int, _PrefillProgress, List[int]]] = []
        spent = 0
        for slot, prog in self._prefilling.items():
            sfx = prog.prompt[prog.done: prog.done + self._chunk]
            if budget and sel and spent + len(sfx) > budget:
                break
            sel.append((slot, prog, sfx))
            spent += len(sfx)

        # decode capacity: one more token of pages per live slot
        retired: List[int] = []
        for slot in list(self._slots):
            cur = int(self._lengths_host[slot])
            if self.kv.ensure_capacity(slot, cur + 1) <= cur:
                self._capacity_finishes += 1
                retired.append(slot)
                self._finish(slot, "length")
        self._set_active(retired, False)
        # the kernel writes each prefill row's K/V blindly: its pages must
        # cover the chunk before the launch
        for slot, prog, sfx in sel:
            self.kv.ensure_capacity(slot, prog.done + len(sfx))
            self.kv.ensure_backed(slot, prog.done + len(sfx))

        n = len(sel)
        rpb = 1 << (n - 1).bit_length()
        qb = _next_bucket(max(len(s) for _, _, s in sel),
                          self._mixed_q_buckets)
        self._mixed_programs.add((rpb, qb))
        # the bucket's inputs, one int32 row a prefill row (pad rows inert:
        # q_len 0, greedy knobs): tokens [qb], ctx, q_len, top_k, the page
        # table [mp], then the bits of temperature, top_p and min_p
        mp = self.kv.max_pages_per_seq
        inputs = np.zeros((rpb, qb + 3 + mp + 3), np.int32)
        for i, (slot, prog, sfx) in enumerate(sel):
            inputs[i, : len(sfx)] = sfx
            inputs[i, qb: qb + 2] = (prog.done, len(sfx))
            inputs[i, qb + 3: qb + 3 + mp] = self.kv._table[slot]
        pf_knobs = self._request_knobs([prog.request for _, prog, _ in sel],
                                       rpb)
        inputs[:, qb + 2] = pf_knobs[:, 1]
        inputs[:, qb + 3 + mp:] = np.ascontiguousarray(
            pf_knobs[:, [0, 2, 3]]).view(np.int32)

        self._steps += 1
        self._mixed_steps += 1
        self._mixed_prefill_tokens += spent
        self._occupancy_sum += len(self._slots)
        entry = self._mixed_chunk(inputs, qb, pf_knobs, self._cap_list(),
                                  t0)
        self._run_overlap_hook()
        self._process_packed(entry)

        # only a prompt's last chunk yields its first token (the samples
        # ride the packed output past its decode rows)
        pf_host = entry.host[(2 * entry.n_steps + 4) * self.max_slots:]
        pf_lps = pf_host[rpb:].view(np.float32)
        rows: List[Dict[str, Any]] = []
        for i, (slot, prog, sfx) in enumerate(sel):
            prog.done += len(sfx)
            if prog.done >= len(prog.prompt):
                self._finish_prefill(slot, prog, int(pf_host[i]),
                                     float(pf_lps[i]), rows)
        self._install_device(rows)
        self._tl_record("mixed", t0, program=entry.key, prefill_rows=n,
                        prefill_tokens=spent)

    def _mixed_chunk(self, inputs: np.ndarray, qb: int, pf_knobs: np.ndarray,
                     caps: List[int], t0: float) -> _ChunkEntry:
        """Queue one mixed step: copy the bucket's inputs (``inputs``, see
        ``_step_mixed``) and the capacities in, then run the body (a graph
        replay on the card) and queue the packed output's host copy."""
        rpb = inputs.shape[0]
        needs_mask, needs_noise = self._knob_flags(
            np.concatenate([self._knobs_host, pf_knobs]))
        key = ("mixed", rpb, qb, bool(self._stop_slots), needs_mask,
               needs_noise)
        buf = self._mixed_inputs.get((rpb, qb))
        if buf is None:
            buf = self._mixed_inputs[(rpb, qb)] = torch.zeros(
                inputs.shape, dtype=torch.int32, device=self.device)
        _cuda.upload_into(buf, inputs)
        _cuda.upload_into(self._cap, np.asarray(caps, np.int32))
        table = self.kv.page_table
        packed = self._run(key, lambda: self._mixed_body(
            buf, qb, key[3], needs_mask, needs_noise, table))
        self._inflight_chunks += 1
        return _ChunkEntry(packed, 1, dict(self._slots), t0, caps,
                           fresh_firsts=True, key=key)

    def _mixed_body(self, buf: torch.Tensor, qb: int, use_stops: bool,
                    needs_mask: bool, needs_noise: bool, table: torch.Tensor
                    ) -> torch.Tensor:
        """The mixed step on the device: the decode rows (one per slot;
        active rows q=1 at ctx=length, the rest inert with q=0, ctx=0) and
        the prefill rows of ``buf`` in one ragged forward, one ``unembed``
        and one sampling over all rows, the decode rows' ``advance``, the
        packed output, the per-slot state written in place."""
        spec = self.spec
        b = self.max_slots
        dev = self.device
        mp = table.shape[1]
        lengths, last = self._lengths, self._last
        active, produced = self._active, self._produced
        pf_knobs = buf[:, qb + 3 + mp:].view(torch.float32)
        tokens = torch.zeros((b, qb), dtype=torch.int32, device=dev)
        tokens[:, 0] = last
        tokens = torch.cat([tokens, buf[:, :qb]])
        ctx = torch.cat([torch.where(active, lengths,
                                     torch.zeros_like(lengths)), buf[:, qb]])
        qlens = torch.cat([active.to(torch.int32), buf[:, qb + 1]])
        hidden, _, _ = forward_mixed_step(
            spec, self.params, tokens, ctx, qlens, self.kv.k_pages,
            self.kv.v_pages, torch.cat([table, buf[:, qb + 3: qb + 3 + mp]]))
        logits = unembed(spec, self.params, hidden)
        sampling = SamplingParams(
            torch.cat([self._temps, pf_knobs[:, 0]]),
            torch.cat([self._top_k, buf[:, qb + 2]]),
            torch.cat([self._top_p, pf_knobs[:, 1]]),
            torch.cat([self._min_p, pf_knobs[:, 2]]))
        tok, lp = sample_tokens_with_logprobs(
            logits, sampling, generator=self._gen, needs_mask=needs_mask,
            needs_noise=needs_noise)
        new_len, new_last, new_active, new_produced, emitted, dlp = \
            self._advance(tok[:b], lp[:b], lengths, last, active, produced,
                          self._cap, use_stops)
        packed = torch.cat([
            emitted, dlp.view(torch.int32), new_active.to(torch.int32),
            new_len, self._firsts_dev.reshape(-1), tok[b:],
            lp[b:].view(torch.int32)])
        for dst, src in zip(self._state(), (new_len, new_last, new_active,
                                             new_produced)):
            dst.copy_(src)
        return packed

    # ---------------------------------------------------- chunk processing

    def poll_stream(self) -> int:
        """Harvest the token half of every stream-ring entry whose copy has
        landed, oldest first, without waiting. The pump calls it in the
        host's gaps (the overlap hook, between steps), so streamed tokens
        reach consumers as soon as they are host-side; the control half
        stays with the deferred flush (``_process_packed``). Returns the
        frames delivered."""
        if not self._ring:
            return 0
        self._ring_polls += 1
        frames = 0
        while self._ring:
            entry = self._ring[0]
            if entry.harvested:
                self._ring.popleft()
                continue
            if not entry.ready():
                break
            self._ring_ready_polls += 1
            frames += self._harvest_chunk(entry)
        return frames

    def _harvest_chunk(self, entry: _ChunkEntry) -> int:
        """The token half of processing a chunk: the host read (a wait on
        the entry's copy only), token and logprob appends, the deferred
        first tokens, the length mirror, the incremental stop scan and the
        stream emit. Idempotent. Columns apply only to the ``_Slot``
        objects live at dispatch. Returns the frames delivered."""
        if entry.harvested:
            return 0
        entry.harvested = True
        try:
            self._ring.remove(entry)
        except ValueError:
            pass
        n_steps = entry.n_steps
        b = self.max_slots
        t_read = time.perf_counter()
        flat = entry.read.numpy()
        entry.host = flat
        rows = flat[: (2 * n_steps + 4) * b].reshape(2 * n_steps + 4, b)
        toks_np = rows[:n_steps]
        lps_np = rows[n_steps:2 * n_steps].view(np.float32)
        lengths_row = rows[2 * n_steps + 1]
        firsts_tok = rows[2 * n_steps + 2]
        firsts_lp = rows[2 * n_steps + 3].view(np.float32)
        if entry.fresh_firsts:
            # the whole firsts buffer rode the read: the rescues use it
            self._firsts_host = rows[2 * n_steps + 2:]
        # sync: dispatch to read; defer: the wait alone (a dispatch time
        # would span an unrelated host step)
        self.chunk_stats.add(time.perf_counter()
                             - (t_read if self._defer else entry.t0))

        frames = 0
        for slot, state in entry.snapshot.items():
            if self._slots.get(slot) is not state:
                continue                 # finished earlier (or slot reused)
            self._lengths_host[slot] = lengths_row[slot]
            col, lcol = toks_np[:, slot], lps_np[:, slot]
            # no progress: the slot was inactive on the device for the
            # whole chunk (under defer_sync, a paused slot whose revive
            # landed after this chunk was queued); the control half must
            # not judge it from this chunk's caps
            entry.progressed[slot] = bool(state.first_pending
                                          or (col >= 0).any())
            prev = len(state.tokens)     # first index not stop-scanned
            if state.first_pending:
                # TTFT is stamped at delivery under deferral
                state.first_pending = False
                state.tokens.append(int(firsts_tok[slot]))
                state.logprobs.append(float(firsts_lp[slot]))
                state.first_token_at = time.perf_counter()
                self.ttft_stats.add(state.first_token_at - state.admitted_at)
            for si in range(n_steps):
                if col[si] >= 0:
                    state.tokens.append(int(col[si]))
                    state.logprobs.append(float(lcol[si]))
            state.produced = len(state.tokens)
            req = state.request
            if (req.eos_id >= 0 or req.stop_ids or req.stop_sequences) \
                    and state.stop_cut < 0:
                state.stop_cut = find_stop_cut(state.tokens, req, start=prev)
            frames += self._emit_stream(state)
        return frames

    def _process_packed(self, entry: _ChunkEntry) -> None:
        """The control half of processing a chunk (after its token half,
        if the ring poll has not harvested it yet): finish the slots the
        device retired, retire host-side stops, revive slots paused at the
        chunk's capacity grant (``entry.caps``)."""
        self._harvest_chunk(entry)
        # counted at dispatch; processed once an entry
        self._inflight_chunks = max(0, self._inflight_chunks - 1)
        n_steps = entry.n_steps
        b = self.max_slots
        rows = entry.host[: (2 * n_steps + 4) * b].reshape(
            2 * n_steps + 4, b)
        active_np = rows[2 * n_steps].astype(bool)
        lengths_row = rows[2 * n_steps + 1]

        retired: List[int] = []
        revived: List[int] = []
        for slot, state in entry.snapshot.items():
            if self._slots.get(slot) is not state:
                continue
            req = state.request
            if not active_np[slot]:
                if not entry.progressed.get(slot, False):
                    # inactive for the whole chunk: the chunk that stopped
                    # it decided pause or finish
                    continue
                if (state.produced < req.max_new_tokens
                        and state.stop_cut < 0
                        and int(lengths_row[slot]) >= entry.caps[slot]
                        and entry.caps[slot] < self.max_seq_len):
                    # stopped at the chunk's capacity grant, not at a
                    # budget or stop: paused, the next step grows it
                    revived.append(slot)
                else:
                    self._finish(slot, "length")
            elif ((req.stop_ids or req.stop_sequences)
                  and 0 <= state.stop_cut <= req.max_new_tokens):
                retired.append(slot)
                self._finish(slot, "stop")
        self._set_active(retired, False)
        self._set_active(revived, True)

    # ---------------------------------------------------------------- run

    def run_until_idle(self, max_iters: int = 100000
                       ) -> List[GenerationResult]:
        """Pump until every queued request finishes; returns (and clears)
        the finished results."""
        for _ in range(max_iters):
            if self.step() == 0 and not self.n_waiting:
                break
        return self.drain_finished()

    def generate(self, requests: List[GenerationRequest]
                 ) -> List[GenerationResult]:
        """Submit all, pump to completion, return in request order. With
        ``max_waiting`` set, a request past the cap comes back as its own
        ``finish_reason="overloaded"`` result (raising mid-batch would
        strand the submitted head of the batch in the queue)."""
        order: List[str] = []
        shed: Dict[str, GenerationResult] = {}
        for r in requests:
            try:
                order.append(self.submit(r))
            except EngineOverloadedError as e:
                rid = r.request_id or f"creq-shed-{self._rejected_full}"
                r.request_id = rid
                order.append(rid)
                shed[rid] = GenerationResult(
                    request_id=rid, tokens=[], finish_reason="overloaded",
                    prompt_tokens=len(r.prompt),
                    metadata={"overload_reason": e.reason})
        results = {r.request_id: r for r in self.run_until_idle()}
        results.update(shed)
        return [results[i] for i in order]

    def drain_finished(self) -> List[GenerationResult]:
        out, self._finished = self._finished, []
        return out

    def abort_all(self) -> int:
        """Drop every waiting, mid-prefill and live request and free their
        pages."""
        n = len(self._waiting) + len(self._slots) + len(self._prefilling)
        self._pending = None            # an unprocessed deferred chunk
        self._ring.clear()              # and its stream-ring entry
        self._inflight_chunks = 0
        self._waiting.clear()
        for slot in list(self._slots) + list(self._prefilling):
            self._slots.pop(slot, None)
            self._prefilling.pop(slot, None)
            self.kv.free_slot(slot)
        self._stop_slots.clear()
        self._active.zero_()
        return n

    def close(self) -> None:
        """Drop what holds the engine's device memory: every request, the
        CUDA graphs (whose private pool is freed with the last of them),
        the mixed buckets' inputs, the KV pools and the weights, and the
        overlap hook that ties the engine to its pump. Whoever steps the
        engine (its pump's thread) must have stopped first; the engine is
        unusable after. The caller releases the freed blocks
        (``torch.cuda.empty_cache``) once the last reference is gone."""
        self.abort_all()
        self.overlap_hook = None
        self.speculator = None
        self._graphs.clear()
        self._graph_pool = None
        self._mixed_inputs.clear()
        self.kv = None
        self.params = None

    @property
    def n_waiting(self) -> int:
        return len(self._waiting)

    @property
    def n_live(self) -> int:
        # a prompt mid-prefill holds a slot and needs further steps: the
        # pump gates its loop on this
        return len(self._slots) + len(self._prefilling)

    # ------------------------------------------------------------- warmup

    def warmup(self, batch: Optional[int] = None,
               max_new_tokens: int = 2) -> int:
        """Run the serving programs once before traffic: one rolling batch
        per (admission batch bucket x prefill bucket), as the JAX engine's
        warmup does (``batch`` restricts to one bucket); on a ragged
        engine with chunked prefill, also one round per (admission batch
        bucket x mixed-step chunk bucket), whose prompts prefill one chunk
        and then a tail of that bucket beside one-token tails, so each
        (rows, width) bucket a served run can reach runs once. On the card
        this captures the graphs of those keys, so a served run captures
        none. The prefix cache is off for the duration (warmup prompts
        would otherwise hit each other's pages and skip the batched
        prefill) and ``max_waiting`` is lifted; every page and slot is
        returned at the end. Stat counters tick. Returns the rounds."""
        if batch:
            sizes = [batch]
        else:
            sizes = _pow2_buckets(self.max_slots)
        rounds: List[List[int]] = []
        for n in sizes:
            for tb in self.prefill_buckets:
                prompt_len = min(tb, self.max_seq_len - 1 - max_new_tokens)
                if prompt_len >= 1:
                    rounds.append([prompt_len] * n)
        if self._mixed:
            for n in sizes:
                for qb in self._mixed_q_buckets:
                    lens = [self._chunk + qb] + [self._chunk + 1] * (n - 1)
                    if max(lens) <= self.max_seq_len - 1 - max_new_tokens:
                        rounds.append(lens)
        saved_prefix = self.prefix_cache
        saved_cap = self.config.max_waiting
        self.prefix_cache = False
        self.config.max_waiting = 0
        try:
            for lens in rounds:
                for n_tok in lens:
                    self.submit(GenerationRequest(
                        prompt=[1] * n_tok, max_new_tokens=max_new_tokens))
                self.run_until_idle()
        finally:
            self.prefix_cache = saved_prefix
            self.config.max_waiting = saved_cap
        return len(rounds)

    def warmup_from_manifest(self, max_new_tokens: int = 2) -> int:
        """The artifact-aware warmup: only the admission batch buckets the
        artifact's writer recorded (a respawned worker warms what its
        predecessor served); the full ``warmup`` when the manifest records
        none that fit this engine."""
        valid = set(_pow2_buckets(self.max_slots))
        b = (self.artifact_manifest or {}).get("buckets", {})
        batches = [n for n in b.get("batch", []) if n in valid]
        if not batches:
            return self.warmup(max_new_tokens=max_new_tokens)
        return sum(self.warmup(batch=n, max_new_tokens=max_new_tokens)
                   for n in batches)

    # ------------------------------------------------------------ metrics

    def get_metrics(self) -> Dict[str, Any]:
        # read from other threads while the pump captures graphs or a
        # release closes the engine: snapshot the dicts, and a closed
        # engine reports no pool
        kv = self.kv
        return {
            "total_requests": self._total_requests,
            "total_prompt_tokens": self._total_prompt_tokens,
            "total_generated_tokens": self._total_generated,
            "waiting": self.n_waiting,
            "live_slots": len(self._slots),
            "admission_denied": self._admission_denied,
            "rejected_queue_full": self._rejected_full,
            "shed_deadline": self._shed_deadline,
            "deadline_expired": self._deadline_expired,
            "capacity_finishes": self._capacity_finishes,
            "engine_steps": self._steps,
            "decode_steps": self._decode_steps,
            "prefill_calls": self._prefill_calls,
            "mixed_steps": self._mixed_steps,
            "mixed_prefill_tokens": self._mixed_prefill_tokens,
            "mixed_programs": len(self._mixed_programs),
            # distinct decode keys seen (the graphs a card engine needs),
            # counted on the CPU too, where nothing is captured
            "decode_programs": len(self._decode_keys),
            "cuda_graphs": len(self._graphs),
            # each graph's (eager warm-up, capture) seconds
            "graph_capture_s": {_key_name(k): [g.warmup_s, g.capture_s]
                                for k, g in list(self._graphs.items())},
            "graph_warmup_launches": sum(
                list(self._graph_warmup_launches.values())),
            "prefix_hit_admissions": self._prefix_hit_admissions,
            "prefilling_slots": len(self._prefilling),
            "chunked_admissions": self._chunked_admissions,
            "deferred_admissions": self._deferred_admissions,
            # sub-chunk streaming: ring traffic, the clamp's engagements,
            # and the firsts buffer's whole reads
            "stream_ring_pushes": self._ring_pushes,
            "stream_ring_polls": self._ring_polls,
            "stream_ring_ready_polls": self._ring_ready_polls,
            "stream_ring_depth": self._ring_high_water,
            "stream_clamped_chunks": self._stream_clamped_chunks,
            "firsts_fetches": self._firsts_fetches,
            # async speculation: zeros when the drafter is off, as in JAX
            **{f"spec_async_{k}": v for k, v in (
                self.speculator.get_metrics()
                if self.speculator is not None else {
                    "drafted_tokens": 0, "accepted_tokens": 0,
                    "wasted_tokens": 0, "catchup_tokens": 0,
                    "accept_rate": 0.0, "draft_rounds": 0,
                    "propose_rounds": 0, "auto_idles": 0,
                    "bubble_consumed_s": 0.0, "draft_cost_ema_s": 0.0,
                    "pending": 0}).items()},
            "spec_async_verify_steps": self._spec_verify_steps,
            # the host-gap split (JAX's keys)
            "dispatch_s_total": self._dispatch_s,
            "host_gap_s_total": self._host_gap_s,
            "host_bubble_frac": (
                self._host_gap_s / (self._dispatch_s + self._host_gap_s)
                if (self._dispatch_s + self._host_gap_s) > 0 else 0.0),
            "ttft": self.ttft_stats.snapshot(),
            "batch_occupancy": (self._occupancy_sum
                                / (self._steps * self.max_slots)
                                if self._steps else 0.0),
            "prefill": self.prefill_stats.snapshot(),
            "decode_chunk": self.chunk_stats.snapshot(),
            "kv": kv.get_stats() if kv is not None else {},
            "attn_impl": self.attn_impl,
            "decode_mode": "window" if self.use_window else "inline",
            "decode_fused": self.decode_fused,
            "device": str(self.device),
            "param_bytes": self.param_bytes,
            # the load's phases (factory, artifact), seconds and bytes
            "load": dict(self.load_info),
            # per-process launch counts of the CUDA kernels
            "kernel_launches": _cuda.launch_counts(),
        }
