"""Fake engines (port of the JAX package's ``models/fake.py``; no torch):
the engine interfaces with injectable latency and failures, so the
worker, its pump and a fleet behind a coordinator are testable without a
model.

- ``FakeEngine``: the batch ``generate`` interface. A generation echoes
  the prompt reversed, up to ``max_new_tokens``.
- ``FakeContinuousEngine``: the ``submit``/``step``/``drain_finished``
  interface the pump drives. The next token is a crc32 chain over the
  whole context (prompt and tokens so far) mod ``vocab_size``, so the
  output does not depend on which worker serves a request, and a replay
  of prompt plus generated prefix continues with the same tokens.

``FakeContinuousEngine`` also carries the JAX fake's async-speculation
model (``spec_async``). The JAX fakes' KV-fabric hooks and disaggregated
prefill belong to features the port does not carry (ROADMAP.md A10);
``models/__init__.py`` raises for their metadata.
"""

from __future__ import annotations

import random
import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List

from ..engine.types import (
    EngineOverloadedError,
    GenerationRequest,
    GenerationResult,
)
from ..utils.tracing import LatencyStats


class FakeEngine:
    """The batch engine interface with simulated latency and failures."""

    def __init__(self, latency_s: float = 0.0,
                 per_token_latency_s: float = 0.0, error_rate: float = 0.0,
                 seed: int = 0) -> None:
        self.latency_s = latency_s
        self.per_token_latency_s = per_token_latency_s
        self.error_rate = error_rate
        self._rand = random.Random(seed)
        self.prefill_stats = LatencyStats()
        self.decode_stats = LatencyStats()
        self._total_requests = 0
        self._total_generated_tokens = 0
        self._total_errors = 0

    def generate(self, requests: List[GenerationRequest]
                 ) -> List[GenerationResult]:
        self._total_requests += len(requests)
        t0 = time.perf_counter()
        if self.error_rate and self._rand.random() < self.error_rate:
            self._total_errors += 1
            raise RuntimeError("injected fake-engine failure")
        n_tokens = sum(min(len(r.prompt), r.max_new_tokens)
                       for r in requests)
        delay = self.latency_s + self.per_token_latency_s * n_tokens
        if delay:
            time.sleep(delay)
        results = []
        for i, r in enumerate(requests):
            toks = list(reversed(r.prompt))[: r.max_new_tokens]
            self._total_generated_tokens += len(toks)
            results.append(GenerationResult(
                request_id=(r.request_id
                            or f"fake-{self._total_requests}-{i}"),
                tokens=toks, finish_reason="length",
                prompt_tokens=len(r.prompt), ttft_s=delay, decode_s=0.0,
                metadata={"fake": True}))
        self.prefill_stats.add(time.perf_counter() - t0)
        return results

    def get_metrics(self) -> Dict[str, Any]:
        return {
            "total_requests": self._total_requests,
            "total_prompt_tokens": 0,
            "total_generated_tokens": self._total_generated_tokens,
            "total_errors": self._total_errors,
            "prefill": self.prefill_stats.snapshot(),
            "decode": self.decode_stats.snapshot(),
            "spec": {"fake": True},
        }


def _chain(state: int, token: int) -> int:
    """Fold one token id into the crc32 context state."""
    return zlib.crc32(b"%d," % token, state)


@dataclass
class FakeEngineConfig:
    """The part of ``EngineConfig`` the pump and worker touch."""

    max_waiting: int = 0
    queue_deadline_s: float = 0.0
    mixed_step_tokens: int = 0      # set by the pump; unused by the fake


class FakeContinuousEngine:
    """Continuous-batching fake (see the module docstring).

    Overload and deadline semantics are ``ContinuousEngine``'s: a bounded
    waiting queue sheds at submit (``EngineOverloadedError``),
    ``queue_deadline_s`` sheds queued requests as ``overloaded``, and a
    request's own ``deadline_s`` expires it with ``finish_reason=
    "deadline"`` before any step is spent on it. Stops: ``eos_id`` and
    ``stop_ids``. ``admit_latency_per_token_s`` charges admission per
    uncached prompt token, with ``prefix_cache`` crediting page-aligned
    prompt heads already admitted. ``stream_chunk_tokens`` splits a step
    into sub-chunks while a live slot streams, each extra one costing
    ``stream_dispatch_overhead_s``.

    ``spec_async`` models the async drafter (the JAX fake's model): the
    step's host bubble is its idle-slot share, ``(1 - live / max_slots) *
    step_latency_s``; when a streaming slot exists and the bubble clears
    ``spec_bubble_floor_s``, each streaming slot gains an accept credit of
    ``spec_max_draft * spec_accept_rate`` a step and emits its whole
    credits (at most ``spec_max_draft``) as extra chain tokens at no added
    wall time; else the step counts an auto-idle."""

    def __init__(self, step_latency_s: float = 0.0, tokens_per_step: int = 1,
                 max_slots: int = 8, max_waiting: int = 0,
                 queue_deadline_s: float = 0.0, vocab_size: int = 997,
                 admit_latency_per_token_s: float = 0.0,
                 prefix_cache: bool = False, prefix_page_size: int = 64,
                 stream_chunk_tokens: int = 0,
                 stream_dispatch_overhead_s: float = 0.0,
                 spec_async: bool = False, spec_max_draft: int = 4,
                 spec_accept_rate: float = 0.7,
                 spec_bubble_floor_s: float = 0.0) -> None:
        self.config = FakeEngineConfig(
            max_waiting=int(max_waiting),
            queue_deadline_s=float(queue_deadline_s))
        self.step_latency_s = float(step_latency_s)
        self.tokens_per_step = max(1, int(tokens_per_step))
        self.stream_chunk_tokens = max(0, int(stream_chunk_tokens))
        self.stream_dispatch_overhead_s = float(stream_dispatch_overhead_s)
        self._stream_sub_chunks = 0
        self.spec_async = bool(spec_async)
        self.spec_max_draft = max(1, int(spec_max_draft))
        self.spec_accept_rate = min(1.0, max(0.0, float(spec_accept_rate)))
        self.spec_bubble_floor_s = float(spec_bubble_floor_s)
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_wasted = 0
        self._spec_rounds = 0
        self._spec_auto_idles = 0
        self._spec_bubble_s = 0.0
        self.max_slots = max(1, int(max_slots))
        self.vocab_size = max(2, int(vocab_size))
        self.admit_latency_per_token_s = float(admit_latency_per_token_s)
        self.prefix_cache = bool(prefix_cache)
        self.prefix_page_size = max(1, int(prefix_page_size))
        self._prefix_seen: set = set()
        self._prefix_cached_tokens = 0
        self._admit_sleep_s = 0.0
        # waiting: (request, on_tokens, t_submit); live: [req, cb,
        # t_submit, chain state, tokens]
        self._waiting: List[tuple] = []
        self._live: List[list] = []
        self._finished: List[GenerationResult] = []
        self._total_requests = 0
        self._total_generated = 0
        self._steps = 0
        self._rejected_full = 0
        self._shed_deadline = 0
        self._deadline_expired = 0
        # ttft from submit (queue wait and admission included); step wall,
        # the fake's inter-token latency
        self.ttft_stats = LatencyStats()
        self.step_stats = LatencyStats()

    # ------------------------------------------------------------- submit

    def submit(self, request: GenerationRequest, on_tokens=None) -> str:
        if not request.prompt:
            raise ValueError("empty prompt")
        cap = self.config.max_waiting
        if cap and len(self._waiting) >= cap:
            self._rejected_full += 1
            raise EngineOverloadedError(
                f"waiting queue full ({len(self._waiting)}/{cap}); retry "
                "on another replica or later", reason="queue_full")
        self._total_requests += 1
        if not request.request_id:
            request.request_id = f"fcreq-{self._total_requests}"
        self._waiting.append((request, on_tokens, time.perf_counter()))
        return request.request_id

    # --------------------------------------------------------------- step

    def _shed_expired(self) -> None:
        queue_deadline = self.config.queue_deadline_s
        now = time.perf_counter()
        cut = (now - queue_deadline) if queue_deadline else None
        keep = []
        for req, cb, t in self._waiting:
            if cut is not None and t <= cut:
                self._shed_deadline += 1
                self._finished.append(GenerationResult(
                    request_id=req.request_id, tokens=[],
                    finish_reason="overloaded", prompt_tokens=len(req.prompt),
                    ttft_s=now - t, metadata={"overload_reason": "deadline"}))
            elif req.deadline_s is not None and now - t >= req.deadline_s:
                self._deadline_expired += 1
                self._finished.append(GenerationResult(
                    request_id=req.request_id, tokens=[],
                    finish_reason="deadline", prompt_tokens=len(req.prompt),
                    ttft_s=now - t, metadata={"deadline_s": req.deadline_s}))
            else:
                keep.append((req, cb, t))
        self._waiting = keep

    def _admit_prefix(self, prompt: List[int]) -> int:
        """The prompt tokens this admission pays for, after crediting the
        page-aligned prefixes already admitted (``prefix_cache``); records
        the new prefixes."""
        if not self.prefix_cache:
            return len(prompt)
        page = self.prefix_page_size
        full_pages = len(prompt) // page
        warm_pages = 0
        for j in range(full_pages, 0, -1):
            if tuple(prompt[:j * page]) in self._prefix_seen:
                warm_pages = j
                break
        for j in range(1, full_pages + 1):
            self._prefix_seen.add(tuple(prompt[:j * page]))
        cached = warm_pages * page
        self._prefix_cached_tokens += cached
        return len(prompt) - cached

    def step(self) -> int:
        """One decode step of every live slot (admitting from the waiting
        queue first); returns the live count."""
        self._shed_expired()
        while self._waiting and len(self._live) < self.max_slots:
            req, cb, t = self._waiting.pop(0)
            if self.admit_latency_per_token_s:
                uncached = self._admit_prefix(list(req.prompt))
                if uncached:
                    pause = self.admit_latency_per_token_s * uncached
                    self._admit_sleep_s += pause
                    time.sleep(pause)
            state = 0
            for tok in req.prompt:
                state = _chain(state, tok)
            # the trailing 0.0: the slot's speculation accept credit
            self._live.append([req, cb, t, state, [], 0.0])
        if not self._live:
            return 0
        # sub-chunks only while a live slot streams
        sizes = [self.tokens_per_step]
        if (self.stream_chunk_tokens
                and self.stream_chunk_tokens < self.tokens_per_step
                and any(s[1] is not None for s in self._live)):
            k = self.stream_chunk_tokens
            sizes = [k] * (self.tokens_per_step // k)
            if self.tokens_per_step % k:
                sizes.append(self.tokens_per_step % k)
        sub_sleep = self.step_latency_s / len(sizes)
        t_step = time.perf_counter()
        self._steps += 1
        had = {id(s): bool(s[4]) for s in self._live}
        # the draft rounds, decided once a step; a slot's extra tokens ride
        # its first sub-chunk
        spec_extra: Dict[int, int] = {}
        if self.spec_async:
            bubble = ((1.0 - len(self._live) / self.max_slots)
                      * self.step_latency_s)
            streaming = [s for s in self._live if s[1] is not None]
            if streaming and bubble >= self.spec_bubble_floor_s:
                k = self.spec_max_draft
                self._spec_bubble_s += bubble
                for slot in streaming:
                    slot[5] += k * self.spec_accept_rate
                    extra = min(int(slot[5]), k)
                    slot[5] -= extra
                    self._spec_rounds += 1
                    self._spec_drafted += k
                    self._spec_accepted += extra
                    self._spec_wasted += k - extra
                    if extra:
                        spec_extra[id(slot)] = extra
            else:
                self._spec_auto_idles += 1
        done_slots: set = set()
        now = t_step
        for si, budget in enumerate(sizes):
            if si and self.stream_dispatch_overhead_s:
                time.sleep(self.stream_dispatch_overhead_s)
            if sub_sleep:
                time.sleep(sub_sleep)
            now = time.perf_counter()
            if len(sizes) > 1:
                self._stream_sub_chunks += 1
            for slot in self._live:
                key = id(slot)
                if key in done_slots:
                    continue
                req, cb, t, state, toks = slot[:5]
                fresh: List[int] = []
                done = False
                for _ in range(budget + spec_extra.pop(key, 0)):
                    nxt = state % self.vocab_size
                    state = _chain(state, nxt)
                    toks.append(nxt)
                    fresh.append(nxt)
                    self._total_generated += 1
                    if nxt == req.eos_id or nxt in (req.stop_ids or ()):
                        done = True
                        break
                    if len(toks) >= req.max_new_tokens:
                        done = True
                        break
                slot[3] = state
                if fresh and cb is not None:
                    cb(list(fresh))
                if fresh and not had[key]:
                    had[key] = True
                    self.ttft_stats.add(now - t)
                if done:
                    done_slots.add(key)
                    stopped = bool(toks) and (
                        toks[-1] == req.eos_id
                        or toks[-1] in (req.stop_ids or ()))
                    self._finished.append(GenerationResult(
                        request_id=req.request_id, tokens=list(toks),
                        finish_reason="stop" if stopped else "length",
                        prompt_tokens=len(req.prompt), ttft_s=now - t,
                        decode_s=now - t, metadata={"fake": True}))
        self.step_stats.add(now - t_step)
        if done_slots:
            self._live = [s for s in self._live if id(s) not in done_slots]
        return len(self._live)

    def generate(self, requests: List[GenerationRequest]
                 ) -> List[GenerationResult]:
        """Submit all, step to completion, return in request order."""
        ids = [self.submit(r) for r in requests]
        want = set(ids)
        done: Dict[str, GenerationResult] = {}
        while want - set(done):
            self.step()
            for res in self.drain_finished():
                done[res.request_id] = res
            if not self._live and not self._waiting and want - set(done):
                break
        return [done[i] for i in ids]

    def drain_finished(self) -> List[GenerationResult]:
        out, self._finished = self._finished, []
        return out

    def abort_all(self) -> int:
        n = len(self._live) + len(self._waiting)
        self._live.clear()
        self._waiting.clear()
        return n

    @property
    def n_waiting(self) -> int:
        return len(self._waiting)

    @property
    def n_live(self) -> int:
        return len(self._live)

    def get_metrics(self) -> Dict[str, Any]:
        return {
            "total_requests": self._total_requests,
            "total_prompt_tokens": 0,
            "total_generated_tokens": self._total_generated,
            "waiting": len(self._waiting),
            "live_slots": len(self._live),
            "engine_steps": self._steps,
            "rejected_queue_full": self._rejected_full,
            "shed_deadline": self._shed_deadline,
            "deadline_expired": self._deadline_expired,
            "prefix_cached_tokens": self._prefix_cached_tokens,
            "admit_sleep_s": self._admit_sleep_s,
            "stream_sub_chunks": self._stream_sub_chunks,
            # the real engine's spec_async_* family; a fake draft round is
            # its own verify step
            "spec_async_drafted_tokens": self._spec_drafted,
            "spec_async_accepted_tokens": self._spec_accepted,
            "spec_async_wasted_tokens": self._spec_wasted,
            "spec_async_catchup_tokens": 0,
            "spec_async_accept_rate": (
                self._spec_accepted / self._spec_drafted
                if self._spec_drafted else 0.0),
            "spec_async_draft_rounds": self._spec_rounds,
            "spec_async_propose_rounds": self._spec_rounds,
            "spec_async_auto_idles": self._spec_auto_idles,
            "spec_async_bubble_consumed_s": self._spec_bubble_s,
            "spec_async_draft_cost_ema_s": 0.0,
            "spec_async_pending": 0,
            "spec_async_verify_steps": self._spec_rounds,
            "ttft": self.ttft_stats.snapshot(),
            "decode_chunk": self.step_stats.snapshot(),
            "spec": {"fake": True, "continuous": True},
        }
