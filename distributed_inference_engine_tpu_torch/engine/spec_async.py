"""Bubble-scheduled asynchronous speculation in the continuous engine
(port of ``engine/spec_async.py``).

``AsyncSpeculator`` drafts in the host gaps between the engine's device
dispatches and lets the next decode step verify the proposals as extra
query columns of one ragged mixed step (``ContinuousEngine._step_verify``):

- **Drafting** runs a small draft model (``resolve_draft``: a truncated
  self-draft, ``"layers:N"``, or a serving artifact, ``"artifact:<path>"``)
  over dense per-slot caches of ``min(max_seq_len) + k + 1`` positions, for
  streaming slots only (submitted with ``on_tokens``).
- **Scheduling.** ``schedule()`` runs from the pump's overlap hook (after
  the stream poll, while a chunk is in flight: catch-up only) and from the
  engine's step top (the host state is the frontier: proposing allowed).
  Each call estimates the per-step host bubble (``obs/timeline.py:
  busy_gap_split`` over recent records, else the engine's gap
  accumulators) and idles below ``spec_bubble_floor_s`` (``auto_idles``).
- **Rounds.** A round is one dispatch over every slot row: the catch-up
  window (``forward_window`` over the committed tokens the draft has not
  seen, a window bucket of ``_W_BUCKETS``; rows that sit out start at the
  sentinel ``S``, so every write of theirs drops), then with ``propose``
  ``k`` autoregressive proposals. On the card each (window, propose, mask,
  noise) key is a CUDA graph of the engine's (``_run``), its noise drawn
  from the speculator's generator registered with the graph.
- **Proposals stay on the device**: ``drafts [B, k]`` and ``q_probs [B, k,
  V]`` are written into fixed buffers the verify step reads; the host
  keeps only each slot's basis (committed length, last token).
  ``take_verifiable`` drops a stale or capacity-clipped proposal and
  ``note_verified`` extends the draft caches' valid prefix from the verify
  step's packed read: no extra host read.

The emitted tokens never depend on the draft: the verify step recomputes
the target distribution at every position, so a stale or garbage proposal
only lowers the acceptance rate (counted in ``wasted_tokens``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.base import (
    ModelSpec,
    Params,
    dense_kv_cache,
    forward_window,
    kv_torch_dtype,
)
from ..obs.timeline import busy_gap_split
from ..ops import _cuda
from ..ops.sampling import SamplingParams, gumbel_noise
from .spec_accept import draft_sample

__all__ = ["AsyncSpeculator", "resolve_draft"]


def resolve_draft(spec: ModelSpec, params: Params, name: str,
                  device="cuda") -> Tuple[ModelSpec, Params]:
    """(draft spec, draft params) from ``EngineConfig.spec_draft_model``:
    ``"layers:N"`` (``""`` is ``layers:2``) truncates the target's own
    prepared tree to its first N blocks, N clamped to ``n_layers - 1``;
    ``"artifact:<path>"`` restores a serving artifact. The draft must share
    the target's vocabulary."""
    from .speculative import truncated_draft

    name = name or "layers:2"
    if name.startswith("artifact:"):
        from .artifact import load_artifact

        d_spec, d_params, _ = load_artifact(name.split(":", 1)[1],
                                            device=device)
        if d_spec.vocab_size != spec.vocab_size:
            raise ValueError(
                f"draft vocab {d_spec.vocab_size} != target vocab "
                f"{spec.vocab_size}: rejection sampling compares "
                "distributions index-by-index")
        return d_spec, d_params
    if name.startswith("layers:"):
        n = int(name.split(":", 1)[1])
        if spec.n_layers < 2:
            raise ValueError(
                "spec_async truncated self-draft needs n_layers >= 2 "
                "(pass spec_draft_model='artifact:...' for a 1-layer "
                "target)")
        n = max(1, min(n, spec.n_layers - 1))
        return truncated_draft(spec, params, n)
    raise ValueError(
        f"spec_draft_model {name!r} is not 'layers:N'|'artifact:<path>'")


class AsyncSpeculator:
    """The drafter over one ``ContinuousEngine`` (module docstring)."""

    # catch-up window buckets: the steady state (deficit 1, the bonus
    # token) lives in the small one; the large one drains fresh prompts a
    # window at a time
    _W_BUCKETS = (8, 64)

    def __init__(self, engine: Any, draft_spec: ModelSpec,
                 draft_params: Params, *, k: int, bubble_floor_s: float,
                 seed: int = 0) -> None:
        if k < 1:
            raise ValueError(f"spec_max_draft {k} < 1")
        self.engine = engine
        self.draft_spec = draft_spec
        self.draft_params = draft_params
        self.k = int(k)
        self.bubble_floor_s = float(bubble_floor_s)
        dev = engine.device
        self._gen = torch.Generator(device=dev).manual_seed(seed ^ 0x5bec)

        b = engine.max_slots
        cfg = engine.config
        # +k+1: proposals land past the committed frontier
        s_d = min(cfg.max_seq_len, engine.spec.max_seq_len) + self.k + 1
        shape = (draft_spec.n_layers, b, s_d, draft_spec.n_kv_heads,
                 draft_spec.head_dim)
        dt = kv_torch_dtype(cfg.kv_dtype)
        self._S = s_d
        self._dck = dense_kv_cache(shape, dt, dev)
        self._dcv = dense_kv_cache(shape, dt, dev)
        # the proposals, at fixed addresses (the verify step's graph reads
        # them), and each window bucket's inputs: tokens, n_valid, start
        self._drafts = torch.zeros((b, self.k), dtype=torch.int32,
                                   device=dev)
        self._qprobs = torch.zeros((b, self.k, draft_spec.vocab_size),
                                   dtype=torch.float32, device=dev)
        self._inputs: Dict[int, torch.Tensor] = {}

        # host mirrors: each row's valid draft-KV prefix, the _Slot it
        # belongs to (slot ids are reused), and its admitted prompt
        self._dlen = np.zeros((b,), np.int64)
        self._ident: Dict[int, Any] = {}
        self._prompt: Dict[int, List[int]] = {}
        # pending proposals: slot -> (basis L, basis last token)
        self._pending: Dict[int, Tuple[int, int]] = {}

        self._drafted_tokens = 0
        self._accepted_tokens = 0
        self._wasted_tokens = 0
        self._catchup_tokens = 0
        self._draft_rounds = 0
        self._propose_rounds = 0
        self._auto_idles = 0
        self._bubble_consumed_s = 0.0
        self._cost_ema: Optional[float] = None
        self._gap_mark = (0.0, 0)
        self._last_est = 0.0

    # ------------------------------------------------------------ budget

    def _bubble_estimate(self) -> float:
        """The per-step host bubble, in seconds: ``busy_gap_split`` over the
        timeline's last 32 records, or (timeline off) the engine's gap
        accumulator over the steps since the last estimate. 0.0 until
        measured, so a positive floor idles the drafter at first."""
        eng = self.engine
        tl = eng.timeline
        if tl is not None:
            ev = tl.events()
            if len(ev) < 2:
                return 0.0
            split = busy_gap_split(ev[-32:])
            return split["gap_s"] / max(1, split["n_events"] - 1)
        steps = eng._steps + eng._mixed_steps + eng._spec_verify_steps
        d_gap = eng._host_gap_s - self._gap_mark[0]
        d_n = steps - self._gap_mark[1]
        if d_n <= 0:
            return self._last_est
        self._gap_mark = (eng._host_gap_s, steps)
        self._last_est = d_gap / d_n
        return self._last_est

    # ------------------------------------------------------- host mirror

    def _sync_ident(self) -> None:
        """Reconcile rows with the engine's live ``_Slot`` objects: a
        finished or reused slot resets its row and wastes its proposal; a
        new slot caches its admitted prompt."""
        eng = self.engine
        for slot in list(self._ident):
            st = eng._slots.get(slot)
            if st is None or st is not self._ident[slot]:
                del self._ident[slot]
                self._prompt.pop(slot, None)
                self._dlen[slot] = 0
                if self._pending.pop(slot, None) is not None:
                    self._wasted_tokens += self.k
        for slot, st in eng._slots.items():
            if slot not in self._ident:
                self._ident[slot] = st
                self._dlen[slot] = 0
                p = st.request.prompt
                self._prompt[slot] = (
                    list(p) if len(p) == st.prompt_len
                    else list(p[-st.prompt_len:]))

    def _seq_tok(self, slot: int, st: Any, i: int) -> int:
        p = self._prompt[slot]
        return p[i] if i < len(p) else int(st.tokens[i - len(p)])

    # --------------------------------------------------------- schedule

    def schedule(self) -> int:
        """One bubble-budgeted draft round; returns the rows worked. One
        dispatch and no host read: an overrun queues behind the next
        chunk instead of delaying its dispatch."""
        eng = self.engine
        if not eng._slots:
            return 0
        t_start = time.perf_counter()
        self._sync_ident()
        if self._bubble_estimate() < self.bubble_floor_s:
            self._auto_idles += 1
            return 0
        can_propose = eng._inflight_chunks == 0 and not self._pending
        wmax = self._W_BUCKETS[-1]
        rows: List[Tuple[int, int, int]] = []     # (slot, start, cat)
        propose_rows: List[int] = []
        for slot, st in eng._slots.items():
            if st.on_tokens is None or st.first_pending:
                continue            # streaming slots only
            total = st.prompt_len + len(st.tokens)      # = L + 1
            deficit = total - int(self._dlen[slot])
            if can_propose and deficit <= wmax:
                # deficit 0 (a wasted proposal, the slot unmoved):
                # re-forward the frontier token, an idempotent write
                start = total - 1 if deficit <= 0 else int(self._dlen[slot])
                rows.append((slot, start, total - start))
                propose_rows.append(slot)
            elif deficit > 0:
                start = int(self._dlen[slot])
                rows.append((slot, start, min(deficit, wmax)))
        if not rows:
            return 0

        need = max(c for _, _, c in rows)
        w = next(b_ for b_ in self._W_BUCKETS if b_ >= need)
        b = eng.max_slots
        host = np.zeros((b, w + 2), np.int32)
        host[:, w + 1] = self._S            # the sentinel: every write drops
        for slot, start, cat in rows:
            st = eng._slots[slot]
            host[slot, :cat] = [self._seq_tok(slot, st, i)
                                for i in range(start, start + cat)]
            host[slot, w] = cat
            host[slot, w + 1] = start
        buf = self._inputs.get(w)
        if buf is None:
            buf = self._inputs[w] = torch.zeros(
                host.shape, dtype=torch.int32, device=eng.device)
        _cuda.upload_into(buf, host)
        do_prop = bool(propose_rows)
        needs_mask, needs_noise = eng._knob_flags(eng._knobs_host)
        key = ("draft", w, do_prop, needs_mask, needs_noise)
        eng._run(key, lambda: self._round(buf, w, do_prop, needs_mask,
                                          needs_noise),
                 generators=(self._gen,))

        for slot, start, cat in rows:
            self._dlen[slot] = start + cat
            self._catchup_tokens += cat
        for slot in propose_rows:
            st = eng._slots[slot]
            total = st.prompt_len + len(st.tokens)
            self._pending[slot] = (total - 1,
                                   self._seq_tok(slot, st, total - 1))
            self._drafted_tokens += self.k
        self._draft_rounds += 1
        self._propose_rounds += do_prop
        dt = time.perf_counter() - t_start
        self._bubble_consumed_s += dt
        self._cost_ema = (dt if self._cost_ema is None
                          else 0.8 * self._cost_ema + 0.2 * dt)
        return len(rows)

    def _round(self, buf: torch.Tensor, w: int, propose: bool,
               needs_mask: bool, needs_noise: bool) -> torch.Tensor:
        """One draft round on the device (the JAX ``_round``): the catch-up
        window over every row's ragged tokens, then (``propose``) ``k``
        proposals from the distribution after each row's last window token,
        written into the fixed proposal buffers. Reads only tensors at
        fixed addresses."""
        eng = self.engine
        spec, params = self.draft_spec, self.draft_params
        tokens, n_valid, start = buf[:, :w], buf[:, w], buf[:, w + 1]
        logits, _, _ = forward_window(spec, params, tokens, n_valid, start,
                                      self._dck, self._dcv)
        if not propose:
            return n_valid
        b = tokens.shape[0]
        dev = tokens.device
        q_logits = logits[torch.arange(b, device=dev),
                          torch.clamp(n_valid - 1, min=0).long()]
        sampling = SamplingParams(eng._temps, eng._top_k, eng._top_p,
                                  eng._min_p)
        greedy = eng._temps <= 0.0
        pos = start + n_valid
        one = torch.ones_like(n_valid)
        for j in range(self.k):
            noise = (gumbel_noise((b, spec.vocab_size), self._gen, dev)
                     if needs_noise else None)
            d_tok, q_probs = draft_sample(q_logits, sampling, greedy, noise,
                                          needs_mask)
            nxt, _, _ = forward_window(spec, params, d_tok[:, None], one,
                                       pos, self._dck, self._dcv)
            q_logits, pos = nxt[:, 0], pos + 1
            self._drafts[:, j] = d_tok
            self._qprobs[:, j] = q_probs
        return self._drafts

    # ----------------------------------------------------------- verify

    def take_verifiable(self):
        """Consume the pending proposals for the next decode step: (drafts,
        q_probs, n_drafts [max_slots] columns a slot, verified: slot ->
        (basis L, columns)), or None when none survives. A proposal is
        fresh when its basis is still the slot's frontier; its columns are
        clipped to the slot's page grant (the verify window writes K/V at
        ``[L, L + m + 1)``: a write through a stale table entry would land
        in another slot's pages). Every drop or clip is wasted."""
        if not self._pending:
            return None
        eng = self.engine
        self._sync_ident()
        n_drafts = np.zeros((eng.max_slots,), np.int32)
        verified: Dict[int, Tuple[int, int]] = {}
        for slot, (basis_len, basis_last) in list(self._pending.items()):
            del self._pending[slot]
            st = eng._slots.get(slot)
            if st is None or self._ident.get(slot) is not st:
                self._wasted_tokens += self.k
                continue
            total = st.prompt_len + len(st.tokens)
            fresh = (total - 1 == basis_len
                     and self._seq_tok(slot, st, basis_len) == basis_last)
            cap_tok = min(eng.kv.slot_capacity(slot), eng.max_seq_len)
            m = max(0, min(self.k, cap_tok - basis_len - 1))
            if not fresh or m <= 0:
                self._wasted_tokens += self.k
                continue
            self._wasted_tokens += self.k - m
            n_drafts[slot] = m
            verified[slot] = (basis_len, m)
        if not verified:
            return None
        return self._drafts, self._qprobs, n_drafts, verified

    def note_verified(self, entry: Any,
                      verified: Dict[int, Tuple[int, int]]) -> None:
        """Bookkeeping from the verify step's packed read (``entry.host``):
        the acceptance counters, and each row's valid prefix extended by
        the accepted tokens actually emitted (a budget, cap or eos cut
        discards the rest)."""
        n = entry.n_steps
        b = self.engine.max_slots
        acc_row = entry.host[(2 * n + 4) * b: (2 * n + 5) * b]
        toks = entry.host[: n * b].reshape(n, b)
        eng = self.engine
        for slot, (basis_len, m) in verified.items():
            n_acc = int(acc_row[slot])
            emitted = int((toks[:, slot] >= 0).sum())
            n_eff = max(0, min(n_acc, m, emitted))
            self._accepted_tokens += n_eff
            self._wasted_tokens += m - n_eff
            st = eng._slots.get(slot)
            if st is not None and self._ident.get(slot) is st:
                total = st.prompt_len + len(st.tokens)
                self._dlen[slot] = min(basis_len + 1 + n_eff, total)

    # ---------------------------------------------------------- metrics

    def get_metrics(self) -> Dict[str, Any]:
        drafted = self._drafted_tokens
        return {
            "drafted_tokens": drafted,
            "accepted_tokens": self._accepted_tokens,
            "wasted_tokens": self._wasted_tokens,
            "catchup_tokens": self._catchup_tokens,
            "accept_rate": (self._accepted_tokens / drafted
                            if drafted else 0.0),
            "draft_rounds": self._draft_rounds,
            "propose_rounds": self._propose_rounds,
            "auto_idles": self._auto_idles,
            "bubble_consumed_s": self._bubble_consumed_s,
            "draft_cost_ema_s": self._cost_ema or 0.0,
            "pending": len(self._pending),
        }
