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
  the lengths before and after, and a mixed step's prefill samples ride
  one packed int32 buffer.
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
from ..ops.quant import prepare_params
from ..ops.sampling import SamplingParams, sample_tokens_with_logprobs
from ..utils.tracing import LatencyStats
from .paged_kv import PagedKVCache
from .types import (
    GenerationRequest,
    GenerationResult,
    find_stop_cut,
    trim_at_stops,
)

logger = logging.getLogger(__name__)

# device-side stop-id capacity per slot: extras stay on the host scan
_DEVICE_STOP_K = 8


def _next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds largest bucket {max(buckets)}")


def _pow2_buckets(cap: int, start: int = 1) -> List[int]:
    out, b = [], start
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return out


def _key_name(key: Tuple) -> str:
    """A decode or mixed graph key as text (``get_metrics``)."""
    kind, *shape, stops, mask, noise = key
    dims = (f"n_steps={shape[0]}" if kind == "decode"
            else f"rows={shape[0]} width={shape[1]}")
    return (f"{kind} {dims} stops={int(stops)} mask={int(mask)} "
            f"noise={int(noise)}")


class _Slot:
    """Host-side bookkeeping for one live sequence."""

    __slots__ = ("request", "slot_id", "prompt_len", "produced", "tokens",
                 "logprobs", "admitted_at", "first_token_at", "stop_cut")

    def __init__(self, request: GenerationRequest, slot_id: int,
                 prompt_len: int) -> None:
        self.request = request
        self.slot_id = slot_id
        self.prompt_len = prompt_len
        self.produced = 0
        self.tokens: List[int] = []
        self.logprobs: List[float] = []
        self.admitted_at = time.perf_counter()
        self.first_token_at = 0.0
        self.stop_cut = -1


class _PrefillProgress:
    """A long prompt mid-way through chunked prefill: its slot and pages
    are allocated, but it is not decoding yet (not in ``_slots``)."""

    __slots__ = ("request", "prompt", "done", "t_submit")

    def __init__(self, request: GenerationRequest, prompt: List[int],
                 t_submit: float, done: int) -> None:
        self.request = request
        self.prompt = prompt
        self.done = done                # tokens prefilled (page-aligned)
        self.t_submit = t_submit


class _Chunk:
    """A dispatched decode chunk or mixed step: its packed device output
    (flat int32: ``2 * n_steps + 3`` rows of ``max_slots``, then a mixed
    step's prefill samples) and the slots it was dispatched for."""

    __slots__ = ("packed", "n_steps", "snapshot", "t0", "caps")

    def __init__(self, packed, n_steps, snapshot, t0, caps) -> None:
        self.packed = packed
        self.n_steps = n_steps
        self.snapshot = snapshot
        self.t0 = t0
        self.caps = caps


class ContinuousEngine:
    """Slot-based continuous batching over a paged KV cache.

    Synchronous: callers ``submit`` and drive ``step()`` (or
    ``run_until_idle``); ``serving/pump.py`` runs it on its own thread.
    ``device`` defaults to the card; tests pass ``device="cpu"``, where the
    kernels' plain versions run."""

    def __init__(self, spec: ModelSpec, params: Optional[Params] = None,
                 config: Optional[EngineConfig] = None, seed: int = 0,
                 device="cuda") -> None:
        self.config = config or EngineConfig()
        cfg = self.config
        cfg.check_supported()        # before any weight is made
        self.device = torch.device(device)
        self.spec = spec.validate()
        if params is None:
            params = init_params(spec, torch.Generator(
                device=self.device).manual_seed(seed))
        # the int4 q|k|v and gate|up payload fusion (ops/quant.py)
        self.params = prepare_params(params)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)

        self.max_slots = cfg.max_slots
        max_seq = min(cfg.max_seq_len, spec.max_seq_len)
        self.kv = PagedKVCache(
            spec, max_slots=cfg.max_slots, page_size=cfg.page_size,
            num_pages=cfg.num_pages, max_seq_len=max_seq,
            dtype=cfg.kv_dtype, device=self.device)
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

        self._waiting: Deque[Tuple[GenerationRequest, float]] = (
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
        # each slot's token capacity for the chunk, copied in before it
        self._cap = torch.zeros((n,), **i32)
        # a mixed bucket's inputs, one int32 buffer a bucket (_step_mixed)
        self._mixed_inputs: Dict[Tuple[int, int], torch.Tensor] = {}
        # CUDA graphs by key (module docstring), sharing one memory pool:
        # replays never overlap, and a replay's packed output is read
        # before the next one
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
        self._deadline_expired = 0
        self._capacity_finishes = 0
        self._steps = 0
        self._decode_steps = 0
        self._prefill_calls = 0
        self._chunked_admissions = 0
        self._mixed_steps = 0
        self._mixed_prefill_tokens = 0
        # (prefill-rows bucket, chunk bucket) shapes the mixed step ran
        self._mixed_programs: set = set()
        self._occupancy_sum = 0
        # called right after a chunk's launches are queued and before its
        # blocking read (the pump drains its inbox here, in the device's
        # shadow); it must only enqueue work (submit)
        self.overlap_hook: Optional[Any] = None

    # ------------------------------------------------------------- submit

    def submit(self, request: GenerationRequest) -> str:
        """Enqueue; returns the request id (assigned if empty)."""
        if not request.prompt:
            raise ValueError("empty prompt")
        self._total_requests += 1
        if not request.request_id:
            request.request_id = f"creq-{self._total_requests}"
        self._waiting.append((request, time.perf_counter()))
        return request.request_id

    def _shed_expired(self) -> None:
        """A request's own ``deadline_s`` budget, checked at step start
        before any prefill or decode work is spent on it (the per-request
        branch of the JAX engine's ``_shed_expired``): a request still
        queued ``deadline_s`` after its submit resolves with
        ``finish_reason="deadline"`` and no tokens; the client already
        stopped caring. The engine-wide ``queue_deadline_s`` is not ported
        (ROADMAP A5d)."""
        if not any(req.deadline_s is not None for req, _ in self._waiting):
            return
        now = time.perf_counter()
        keep: Deque[Tuple[GenerationRequest, float]] = collections.deque()
        for req, t_submit in self._waiting:
            if req.deadline_s is not None and now - t_submit >= req.deadline_s:
                self._deadline_expired += 1
                self._finished.append(GenerationResult(
                    request_id=req.request_id,
                    tokens=[],
                    finish_reason="deadline",
                    prompt_tokens=len(req.prompt),
                    ttft_s=now - t_submit,
                    decode_s=0.0,
                    metadata={"deadline_s": req.deadline_s},
                ))
            else:
                keep.append((req, t_submit))
        self._waiting = keep

    # ---------------------------------------------------------- admission

    @staticmethod
    def _knob_flags(knobs: np.ndarray) -> Tuple[bool, bool]:
        """(needs_mask, needs_noise) of host knob rows [temp, k, p, min_p]:
        whether any row uses top-k/top-p/min-p, or samples at all."""
        needs_mask = bool((knobs[:, 1] > 0).any() | (knobs[:, 2] < 1.0).any()
                          | (knobs[:, 3] > 0).any())
        return needs_mask, bool((knobs[:, 0] > 0).any())

    @staticmethod
    def _request_knobs(reqs: Sequence[GenerationRequest], n: int
                       ) -> np.ndarray:
        """Host knob rows [temp, k, p, min_p] of ``reqs``, padded to ``n``
        rows with greedy defaults."""
        knobs = np.zeros((n, 4), np.float32)
        knobs[:, 2] = 1.0
        for i, r in enumerate(reqs):
            knobs[i] = (r.temperature, r.top_k, r.top_p, r.min_p)
        return knobs

    def _sample_knobs(self, logits: torch.Tensor, knobs: np.ndarray):
        """Sample rows of ``logits`` under host knob rows -> (tokens [n]
        int32, logprobs [n] fp32) on the device."""
        t = torch.from_numpy(knobs).to(self.device)
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
        idx = torch.as_tensor(last_idx, device=self.device).long()
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
                            first_lp: float = 0.0) -> bool:
        """Host bookkeeping of one admission; True when the slot stays
        live (its device state needs installing)."""
        state = _Slot(req, slot, prompt_len)
        state.tokens.append(first)
        state.logprobs.append(first_lp)
        state.produced = 1
        state.admitted_at = t_submit         # TTFT clock starts at submit
        state.first_token_at = time.perf_counter()
        self.ttft_stats.add(state.first_token_at - t_submit)
        self._slots[slot] = state
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

    def _install_device(self, rows: List[Dict[str, Any]]) -> None:
        """Write a round's per-slot device state: two host->device copies
        (ints, floats) and one indexed write per state tensor."""
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
        idx = torch.from_numpy(slots).to(dev)
        it = torch.from_numpy(ints).to(dev)
        ft = torch.from_numpy(floats).to(dev)
        self._lengths[idx] = it[:, 0]
        self._last[idx] = it[:, 1]
        self._active[idx] = True
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
                      t_submit: float, first_lp: float = 0.0) -> None:
        self.prefill_stats.add(time.perf_counter() - t_dispatch)
        if self._register_slot_host(req, slot, prompt_len, first, t_submit,
                                    first_lp=first_lp):
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
        return (time.perf_counter() - self._waiting[0][1]
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
            req, t_submit = self._waiting[0]
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
                self._start_chunked(req, slot, prompt, t_submit,
                                    done=n_cached)
            elif will_chunk or n_cached == 0:
                # a chunked miss sends its first chunk (and the full prompt
                # for the chunk advance) through the batched prefill
                batch.append((req, slot, prompt[: self._chunk] if will_chunk
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
                                   t_submit=t_submit, first_lp=float(lps[0]))
        if batch:
            self._admit_batch(batch)
        return admitted

    def _admit_batch(self, batch) -> None:
        """One prefill (pools written in place) + one first-token read +
        one state install for N cache-miss admissions. Rows pad to a
        power-of-two batch and the prompts to a prefill bucket; pad rows
        have seq_len 0 and write nothing. A row with a full prompt
        (``full`` not None) is the first chunk of a chunked admission."""
        t0 = time.perf_counter()
        self._prefill_calls += 1
        n = len(batch)
        bb = 1 << (n - 1).bit_length()
        tb = _next_bucket(max(len(p) for _, _, p, _, _ in batch),
                          self.prefill_buckets)
        tokens = np.zeros((bb, tb), np.int32)
        seq_lens = np.zeros((bb,), np.int32)
        table_rows = np.zeros((bb, self.kv.max_pages_per_seq), np.int32)
        for i, (_req, slot, prompt, _ts, _full) in enumerate(batch):
            tokens[i, : len(prompt)] = prompt
            seq_lens[i] = len(prompt)
            table_rows[i] = self.kv._table[slot]
        hidden, _, _ = forward_prefill_into_pages(
            self.spec, self.params, torch.from_numpy(tokens).to(self.device),
            seq_lens, self.kv.k_pages, self.kv.v_pages, table_rows)
        firsts, first_lps = self._read_firsts(self._sample_firsts(
            hidden, np.maximum(seq_lens - 1, 0), [r for r, *_ in batch]))
        self.prefill_stats.add(time.perf_counter() - t0)
        rows = []
        for i, (req, slot, prompt, t_submit, full) in enumerate(batch):
            if full is not None:
                # first chunk of a chunked admission: its pages are written
                # and its sample is discarded (the logits saw a truncated
                # prompt); the chunk advance takes over. Its prompt tokens
                # and prefix pages are counted at the last chunk
                self._start_chunked(req, slot, full, t_submit,
                                    done=len(prompt))
                continue
            if self.prefix_cache:
                self.kv.register_prefix(slot, prompt)
            self._total_prompt_tokens += len(prompt)
            first = int(firsts[i])
            if self._register_slot_host(req, slot, len(prompt), first,
                                        t_submit,
                                        first_lp=float(first_lps[i])):
                rows.append(self._slot_row(req, slot, len(prompt), first))
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
        pages = torch.from_numpy(phys).to(self.device)
        ck = self.kv.k_pages[:, pages].reshape(L, bb, mpb * ps, Hkv, Dh)
        cv = self.kv.v_pages[:, pages].reshape(L, bb, mpb * ps, Hkv, Dh)
        hidden, ks, vs = forward_prefill_suffix(
            spec, self.params, torch.from_numpy(tokens).to(self.device),
            suffix_lens, n_ctx, ck.to(spec.torch_dtype),
            cv.to(spec.torch_dtype))
        write_prefill_pages(self.kv.k_pages, self.kv.v_pages, ks, vs,
                            table_rows, suffix_lens, start=n_ctx)
        return self._sample_firsts(hidden, np.maximum(suffix_lens - 1, 0),
                                   list(reqs))

    # ----------------------------------------------------- chunked prefill

    def _start_chunked(self, req: GenerationRequest, slot: int,
                       prompt: List[int], t_submit: float, done: int
                       ) -> None:
        """Begin the incremental prefill of a long prompt: its slot and
        pages are reserved; ``done`` (page-aligned, > 0) tokens are in its
        pages, from the batched first chunk or a prefix-cache hit."""
        self._chunked_admissions += 1
        self._prefilling[slot] = _PrefillProgress(req, prompt, t_submit,
                                                  done)

    def _finish_prefill(self, slot: int, prog: _PrefillProgress, first: int,
                        first_lp: float, rows: List[Dict[str, Any]]) -> None:
        """A prompt's last chunk ran: it registers its prefix and becomes
        a live slot with the last chunk's sample as its first token."""
        del self._prefilling[slot]
        if self.prefix_cache:
            self.kv.register_prefix(slot, prog.prompt)
        self._total_prompt_tokens += len(prog.prompt)
        if self._register_slot_host(prog.request, slot, len(prog.prompt),
                                    first, prog.t_submit, first_lp=first_lp):
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

    # ------------------------------------------------------------- finish

    def _finish(self, slot: int, reason: str) -> None:
        state = self._slots.pop(slot)
        self._stop_slots.discard(slot)
        self.kv.free_slot(slot)
        req = state.request
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
        if slots:
            self._active[torch.as_tensor(slots, device=self.device)] = value

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

    def _run(self, key: Tuple, body) -> torch.Tensor:
        """``body()`` on the CPU (or with the ``_eager`` hook); on a CUDA
        device a replay of ``key``'s graph, captured first if new."""
        if self.device.type != "cuda" or self._eager:
            return body()
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = self._capture(body)
        return graph.replay()

    def _capture(self, body) -> _cuda.CapturedGraph:
        """One eager warm-up pass of ``body`` on the capture stream, its
        effects undone (the per-slot state and the generator restored; the
        pages it wrote, the replay writes again), then the capture. A
        failure raises: there is no eager fallback."""
        with _cuda.GRAPH_LOCK:
            stream = _cuda.capture_stream(self.device)
            saved = [t.clone() for t in self._state()]
            gen_state = self._gen.get_state()
            t0 = time.perf_counter()
            with _cuda.recording_launches() as warm:
                _cuda.warm_up(body, stream)
            warmup_s = time.perf_counter() - t0
            self._graph_warmup_launches.update(warm)
            for t, v in zip(self._state(), saved):
                t.copy_(v)
            self._gen.set_state(gen_state)
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph = _cuda.capture_graph(body, pool=self._graph_pool,
                                        stream=stream,
                                        generators=(self._gen,))
            graph.warmup_s = warmup_s
            return graph

    def _decode_chunk(self, n_steps: int, caps: List[int], t0: float
                      ) -> _Chunk:
        """Queue one chunk of ``n_steps`` decode steps over all slots
        (``caps``: each slot's token capacity): fill the inputs, then run
        the body (a graph replay on the card)."""
        needs_mask, needs_noise = self._knob_flags(self._knobs_host)
        key = ("decode", n_steps, bool(self._stop_slots), needs_mask,
               needs_noise)
        self._decode_keys.add(key)
        self._cap.copy_(torch.as_tensor(caps, dtype=torch.int32))
        table = self.kv.page_table
        self._decode_steps += n_steps
        packed = self._run(key, lambda: self._decode_body(
            n_steps, key[2], needs_mask, needs_noise, table))
        return _Chunk(packed, n_steps, dict(self._slots), t0, caps)

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
            start_lengths[None]], dim=0).reshape(-1)
        for dst, src in zip(self._state(), (lengths, last, active,
                                             produced)):
            dst.copy_(src)
        return packed

    def step(self) -> int:
        """One engine iteration: admit, advance the chunked prefills, then
        one decode chunk — or, on a ragged engine with prompts
        mid-prefill, one mixed step. Returns the number of live and
        mid-prefill slots after it. A queued request past its own
        ``deadline_s`` is resolved first (``_shed_expired``)."""
        self._shed_expired()
        self._try_admit()
        if self._mixed and self._prefilling:
            self._step_mixed()
            return len(self._slots) + len(self._prefilling)
        self._advance_chunked()
        if not self._slots:
            return len(self._prefilling)
        self._steps += 1
        self._occupancy_sum += len(self._slots)
        # capacity: grow every slot toward a full chunk; one that can't
        # fit another token finishes with "length"
        n_steps = self.config.decode_steps_per_call
        retired: List[int] = []
        for slot in list(self._slots):
            cur = int(self._lengths_host[slot])
            cap_tok = self.kv.ensure_capacity(slot, cur + n_steps)
            if cap_tok <= cur:
                self._capacity_finishes += 1
                retired.append(slot)
                self._finish(slot, "length")
            else:
                n_steps = min(n_steps, cap_tok - cur)
        self._set_active(retired, False)
        if not self._slots or n_steps <= 0:
            return len(self._slots) + len(self._prefilling)

        t0 = time.perf_counter()
        chunk = self._decode_chunk(n_steps, self._cap_list(), t0)
        self._run_overlap_hook()
        self._process_chunk(chunk)
        return len(self._slots) + len(self._prefilling)

    def _cap_list(self) -> List[int]:
        """Each slot's token capacity (0 for a free slot)."""
        return [min(self.kv.slot_capacity(s), self.max_seq_len)
                if s in self._slots else 0 for s in range(self.max_slots)]

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
        has no side window and no chunk-end flush."""
        t0 = time.perf_counter()
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
        chunk = self._mixed_chunk(inputs, qb, pf_knobs, self._cap_list(),
                                  t0)
        self._run_overlap_hook()
        pf_host = self._process_chunk(chunk)

        # only a prompt's last chunk yields its first token
        rows: List[Dict[str, Any]] = []
        pf_lps = pf_host[rpb:].view(np.float32)
        for i, (slot, prog, sfx) in enumerate(sel):
            prog.done += len(sfx)
            if prog.done >= len(prog.prompt):
                self._finish_prefill(slot, prog, int(pf_host[i]),
                                     float(pf_lps[i]), rows)
        self._install_device(rows)

    def _mixed_chunk(self, inputs: np.ndarray, qb: int, pf_knobs: np.ndarray,
                     caps: List[int], t0: float) -> _Chunk:
        """Queue one mixed step: copy the bucket's inputs (``inputs``, see
        ``_step_mixed``) and the capacities in, then run the body (a graph
        replay on the card)."""
        rpb = inputs.shape[0]
        needs_mask, needs_noise = self._knob_flags(
            np.concatenate([self._knobs_host, pf_knobs]))
        key = ("mixed", rpb, qb, bool(self._stop_slots), needs_mask,
               needs_noise)
        buf = self._mixed_inputs.get((rpb, qb))
        if buf is None:
            buf = self._mixed_inputs[(rpb, qb)] = torch.zeros(
                inputs.shape, dtype=torch.int32, device=self.device)
        buf.copy_(torch.from_numpy(inputs))
        self._cap.copy_(torch.as_tensor(caps, dtype=torch.int32))
        table = self.kv.page_table
        packed = self._run(key, lambda: self._mixed_body(
            buf, qb, key[3], needs_mask, needs_noise, table))
        return _Chunk(packed, 1, dict(self._slots), t0, caps)

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
            new_len, lengths, tok[b:], lp[b:].view(torch.int32)])
        for dst, src in zip(self._state(), (new_len, new_last, new_active,
                                             new_produced)):
            dst.copy_(src)
        return packed

    def _process_chunk(self, chunk: _Chunk) -> np.ndarray:
        """The one blocking read of a chunk or mixed step, then token
        appends, stop scans and finish/revive. Returns what the packed
        buffer carries past the decode rows (a mixed step's prefill
        samples)."""
        n_steps = chunk.n_steps
        b = self.max_slots
        flat = chunk.packed.cpu().numpy()
        host = flat[: (2 * n_steps + 3) * b].reshape(2 * n_steps + 3, b)
        toks_np = host[:n_steps]
        lps_np = host[n_steps:2 * n_steps].view(np.float32)
        active_np = host[2 * n_steps].astype(bool)
        lengths_row = host[2 * n_steps + 1]
        self.chunk_stats.add(time.perf_counter() - chunk.t0)

        retired: List[int] = []
        revived: List[int] = []
        for slot, state in chunk.snapshot.items():
            if self._slots.get(slot) is not state:
                continue
            self._lengths_host[slot] = lengths_row[slot]
            col, lcol = toks_np[:, slot], lps_np[:, slot]
            progressed = bool((col >= 0).any())
            prev = len(state.tokens)
            for si in range(n_steps):
                if col[si] >= 0:
                    state.tokens.append(int(col[si]))
                    state.logprobs.append(float(lcol[si]))
            state.produced = len(state.tokens)
            req = state.request
            if (req.eos_id >= 0 or req.stop_ids or req.stop_sequences) \
                    and state.stop_cut < 0:
                state.stop_cut = find_stop_cut(state.tokens, req, start=prev)
            if not active_np[slot]:
                if not progressed:
                    # inactive for the whole chunk: the chunk that stopped
                    # it decided pause or finish
                    continue
                if (state.produced < req.max_new_tokens
                        and state.stop_cut < 0
                        and int(lengths_row[slot]) >= chunk.caps[slot]
                        and chunk.caps[slot] < self.max_seq_len):
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
        return flat[(2 * n_steps + 3) * b:]

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
        """Submit all, pump to completion, return in request order."""
        order = [self.submit(r) for r in requests]
        results = {r.request_id: r for r in self.run_until_idle()}
        return [results[i] for i in order]

    def drain_finished(self) -> List[GenerationResult]:
        out, self._finished = self._finished, []
        return out

    def abort_all(self) -> int:
        """Drop every waiting, mid-prefill and live request and free their
        pages."""
        n = len(self._waiting) + len(self._slots) + len(self._prefilling)
        self._waiting.clear()
        for slot in list(self._slots) + list(self._prefilling):
            self._slots.pop(slot, None)
            self._prefilling.pop(slot, None)
            self.kv.free_slot(slot)
        self._stop_slots.clear()
        self._active.zero_()
        return n

    @property
    def n_waiting(self) -> int:
        return len(self._waiting)

    @property
    def n_live(self) -> int:
        # a prompt mid-prefill holds a slot and needs further steps: the
        # pump gates its loop on this
        return len(self._slots) + len(self._prefilling)

    # ------------------------------------------------------------ metrics

    def get_metrics(self) -> Dict[str, Any]:
        return {
            "total_requests": self._total_requests,
            "total_prompt_tokens": self._total_prompt_tokens,
            "total_generated_tokens": self._total_generated,
            "waiting": self.n_waiting,
            "live_slots": len(self._slots),
            "admission_denied": self._admission_denied,
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
                                for k, g in self._graphs.items()},
            "graph_warmup_launches": sum(
                self._graph_warmup_launches.values()),
            "prefix_hit_admissions": self._prefix_hit_admissions,
            "prefilling_slots": len(self._prefilling),
            "chunked_admissions": self._chunked_admissions,
            "ttft": self.ttft_stats.snapshot(),
            "batch_occupancy": (self._occupancy_sum
                                / (self._steps * self.max_slots)
                                if self._steps else 0.0),
            "prefill": self.prefill_stats.snapshot(),
            "decode_chunk": self.chunk_stats.snapshot(),
            "kv": self.kv.get_stats(),
            "attn_impl": self.attn_impl,
            "decode_mode": "window" if self.use_window else "inline",
            "decode_fused": self.decode_fused,
            "device": str(self.device),
            # per-process launch counts of the CUDA kernels
            "kernel_launches": _cuda.launch_counts(),
        }
