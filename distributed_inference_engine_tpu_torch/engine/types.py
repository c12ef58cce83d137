"""Generation request/result types and the shared stop trimmer: a copy
of the JAX package's ``engine/types.py``, so the port and the JAX fleet
marshal the same fields."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


# machine-readable error class for load shedding: the engine's waiting
# queue is full (hard backpressure at submit) or the request sat in queue
# past its deadline (shed at admission). The coordinator reacts by trying
# ONE alternate replica, then surfaces the typed error to the client —
# an overloaded worker is NOT an unhealthy worker.
OVERLOADED = "overloaded"


class EngineOverloadedError(RuntimeError):
    """The engine shed this request instead of queueing it unboundedly."""

    rpc_error_kind = OVERLOADED

    def __init__(self, msg: str, reason: str = "queue_full",
                 retry_after_s: Optional[float] = None) -> None:
        super().__init__(msg)
        # "queue_full" | "deadline" | "draining" | "fleet_overloaded"
        self.reason = reason
        # backoff hint for the caller: set by fleet-level admission
        # shedding (the coordinator at max fleet and still SLO-violating);
        # None for engine-local sheds, where "one alternate then error"
        # already encodes the policy
        self.retry_after_s = retry_after_s
        # rides the RPC error envelope as ``error_detail`` so remote
        # callers get the reason structurally, not by sniffing text
        self.rpc_error_detail = reason


# machine-readable error class for a request that aged out of its OWN
# per-request budget (``GenerationRequest.deadline_s``). Distinct from an
# OVERLOADED shed: a shed is the worker's problem (retriable elsewhere),
# a deadline expiry is the request's problem (never retried — the client
# already stopped caring, and replaying it only wastes another worker's
# engine steps).
DEADLINE = "deadline"


class DeadlineExceededError(RuntimeError):
    """The request's per-request deadline expired before completion."""

    rpc_error_kind = DEADLINE

    def __init__(self, msg: str, request_id: str = "") -> None:
        super().__init__(msg)
        self.request_id = request_id
        self.rpc_error_detail = request_id


@dataclass
class GenerationRequest:
    """One generation job (token-id space; tokenization is a host concern)."""

    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0                # keep tokens with p >= min_p * p_max
    request_id: str = ""
    eos_id: int = -1                  # -1: never stops early
    # additional stop conditions, checked host-side (eos_id stays the fast
    # device-side exit): any single id in stop_ids, or any exact token
    # subsequence in stop_sequences, ends generation. The matched stop
    # token/sequence is INCLUDED in the output (same contract as eos_id).
    stop_ids: List[int] = field(default_factory=list)
    stop_sequences: List[List[int]] = field(default_factory=list)
    # remaining per-request time budget in seconds, measured from engine
    # submit. None = no deadline. The coordinator decrements it by queue/
    # transit time before each dispatch hop, so the value a worker sees is
    # the budget it actually has left; engines shed the request unstarted
    # (finish_reason="deadline", zero decode steps) once it ages out.
    deadline_s: Optional[float] = None


def find_stop_cut(tokens: List[int], req: "GenerationRequest",
                  start: int = 0) -> int:
    """Earliest cut index (exclusive, stop INCLUDED) of any stop condition
    — ``eos_id``, ``stop_ids``, or ``stop_sequences`` — or -1 if none.

    ``start`` is a scan hint: the index of the first token not yet checked.
    The scan rewinds by the longest stop sequence minus one so a match
    spanning the boundary is still found — callers tracking a per-slot
    checked offset get O(total) stop detection instead of rescanning from
    zero after every decode chunk."""
    stops = set(req.stop_ids or ())
    if req.eos_id >= 0:
        stops.add(req.eos_id)
    seqs = [list(s) for s in (req.stop_sequences or ()) if s]
    if not stops and not seqs:
        return -1
    max_len = max((len(s) for s in seqs), default=1)
    begin = max(0, start - (max_len - 1))
    cut = -1
    if stops:
        for i in range(begin, len(tokens)):
            if tokens[i] in stops:
                cut = i + 1
                break
    for seq in seqs:
        n = len(seq)
        for i in range(begin, len(tokens) - n + 1):
            if tokens[i: i + n] == seq:
                end = i + n
                if cut < 0 or end < cut:
                    cut = end
                break
    return cut


def scan_host_stops(out_tokens: List[List[int]], requests, act_host,
                    scanned: List[int]) -> List[int]:
    """The static and speculative decode loops' host stop scan, after each
    chunk: for each still-active request with ``stop_ids`` or
    ``stop_sequences``, check its newly appended tokens; matched rows are
    cleared in ``act_host`` (the loop condition) and returned, so the
    caller clears their device flags in one write. ``scanned`` holds each
    request's resume offset, advanced here."""
    stopped: List[int] = []
    for i, r in enumerate(requests):
        if act_host[i] and (r.stop_ids or r.stop_sequences):
            if find_stop_cut(out_tokens[i], r, start=scanned[i]) >= 0:
                stopped.append(i)
                act_host[i] = False
        scanned[i] = len(out_tokens[i])
    return stopped


def trim_at_stops(tokens: List[int], req: "GenerationRequest"
                  ) -> Tuple[List[int], bool]:
    """Cap at ``max_new_tokens`` and cut at the EARLIEST stop condition,
    keeping the matched stop itself. Returns (trimmed tokens, stopped?).

    One shared trimmer so the static, continuous, speculative, and
    streaming paths cannot disagree about what the final output is."""
    toks = list(tokens[: req.max_new_tokens])
    cut = find_stop_cut(toks, req)
    if cut >= 0:
        return toks[:cut], True
    return toks, False


@dataclass
class GenerationResult:
    request_id: str
    tokens: List[int]                 # generated token ids (no prompt)
    finish_reason: str                # "stop" | "length"
    prompt_tokens: int = 0
    # per generated token: log p(token | prefix) under the model's
    # UNTEMPERED distribution (what scoring APIs report), aligned with
    # ``tokens`` and trimmed identically
    logprobs: List[float] = field(default_factory=list)
    # time to first token. Static/speculative engines measure from the
    # generate dispatch (prefill + first sample); the continuous engine
    # measures from SUBMIT, so queue wait under load is included.
    ttft_s: float = 0.0
    decode_s: float = 0.0
    metadata: Dict[str, Any] = field(default_factory=dict)
