"""Speculative decoding: a small draft model proposes, the target verifies
(port of ``engine/speculative.py``).

Each round, for every row of the batch:

1. **Draft.** The draft forwards ``last`` (one ``forward_window`` over its
   dense cache), then proposes ``k`` tokens one by one, recording each
   step's knob-masked distribution ``q_j``.
2. **Verify.** One target ``forward_window`` over ``[last, d_0 .. d_{k-1}]``
   gives ``p_0 .. p_k`` and writes the window's K/V.
3. **Accept** with the shared rule (``engine/spec_accept.py``): greedy rows
   emit the target's own greedy chain; sampled rows are exact for the
   knob-masked target distribution.
4. Rejected positions leave K/V past the accepted length in both caches;
   the lengths mask it and the next round overwrites it.

``rounds_per_call`` rounds run back to back on the device and end in ONE
packed host read (emitted tokens, their logprob bits, accept counts, live
flags for every round): accept counts and lengths stay on the device
between rounds. Requests without host stops run one call ahead (call i+1
is queued before call i is read, so the read overlaps the next call's
work); a call queued past the end finds every row frozen and emits
nothing. The JAX engine skips such a call on the device (``lax.cond``);
here its rounds run with every row frozen.

The randomness (draft draws, acceptance uniforms, the final draw's Gumbel
noise) comes from the engine's seeded ``torch.Generator``: sampled runs
reproduce from the seed, not JAX's key stream. ``shard_fn`` and
``kv_sharding`` raise ``NotImplementedError`` naming ROADMAP.md A13.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import EngineConfig
from ..models.base import (
    ModelSpec,
    Params,
    forward_prefill,
    forward_window,
    init_params,
    kv_torch_dtype,
    unembed,
)
from ..obs.timeline import StepTimeline
from ..ops import _cuda
from ..ops.quant import (
    QuantizedTensor,
    fuse_block_weights,
    param_bytes,
    prepare_params,
)
from ..ops.sampling import (
    gumbel_noise,
    masked_sampling_probs,
    sample_tokens_with_logprobs,
)
from ..utils.tracing import LatencyStats
from .engine import (
    BatchSampling,
    _next_bucket,
    _pow2_buckets,
    batch_arrays,
    prefill_cache,
)
from .spec_accept import draft_sample, rejection_accept
from .types import (
    GenerationRequest,
    GenerationResult,
    scan_host_stops,
    trim_at_stops,
)


def truncated_draft(spec: ModelSpec, params: Params, n_layers: int
                    ) -> tuple:
    """A draft from the target's own first ``n_layers`` blocks, the
    embeddings, final norm and LM head shared (no copy): a self-draft
    whose agreement with the target is structural even at random init.
    ``QuantizedTensor`` leaves slice payload and scales together (a fused
    q|k|v or gate|up payload too)."""
    L = spec.n_layers
    if not 1 <= n_layers < L:
        raise ValueError(f"draft layers {n_layers} not in [1, {L})")
    d_spec = spec.replace(n_layers=n_layers)

    def cut(x):
        if isinstance(x, QuantizedTensor):
            s = x.s[:n_layers] if x.s.dim() and x.s.shape[0] == L else x.s
            return dataclasses.replace(x, q=x.q[:n_layers], s=s)
        return x[:n_layers]

    d_params = dict(params)                 # non-block leaves shared
    d_params["blocks"] = {k: cut(v) for k, v in params["blocks"].items()}
    return d_spec, d_params


def scale_top_blocks(spec: ModelSpec, params: Params, n_shared: int,
                     eps: float) -> Params:
    """The acceptance sweep's target: blocks ``>= n_shared`` get their
    residual-writing weights (``wo``, ``w_down`` and their biases) scaled
    by ``eps``. At ``eps = 0`` those blocks are identities, so the target's
    logits are ``truncated_draft(spec, params, n_shared)``'s and greedy
    acceptance is 1. A quantized tree scales only its scales (the payload
    is shared)."""
    L = spec.n_layers
    if not 0 < n_shared < L:
        raise ValueError(f"n_shared {n_shared} not in (0, {L})")
    blocks = dict(params["blocks"])

    def scaled(t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        t[n_shared:] *= eps
        return t

    for name in ("wo", "w_down", "bo", "b_down"):
        w = blocks.get(name)
        if w is None:
            continue
        if isinstance(w, QuantizedTensor):
            blocks[name] = dataclasses.replace(w, s=scaled(w.s))
        else:
            blocks[name] = scaled(w)
    return {**params, "blocks": blocks}


class SpeculativeEngine:
    """The static engine's ``generate`` contract, decoding with draft-model
    speculation (the JAX ``SpeculativeEngine``)."""

    def __init__(self, spec: ModelSpec, draft_spec: ModelSpec,
                 params: Optional[Params] = None,
                 draft_params: Optional[Params] = None,
                 config: Optional[EngineConfig] = None, seed: int = 0,
                 speculate_k: int = 4, rounds_per_call: int = 4,
                 shard_fn=None, kv_sharding=None, device="cuda") -> None:
        if shard_fn is not None or kv_sharding is not None:
            raise NotImplementedError(
                "speculative decoding with shard_fn/kv_sharding (tp) is not "
                "ported to PyTorch yet (ROADMAP.md A13)")
        self.spec = spec.validate()
        self.draft_spec = draft_spec.validate()
        if spec.vocab_size != draft_spec.vocab_size:
            raise ValueError(
                f"draft vocab {draft_spec.vocab_size} != target vocab "
                f"{spec.vocab_size} — speculative decoding needs a shared "
                "token space")
        if speculate_k < 1:
            raise ValueError("speculate_k must be >= 1")
        if rounds_per_call < 1:
            raise ValueError("rounds_per_call must be >= 1")
        self.k = int(speculate_k)
        self.rounds_per_call = int(rounds_per_call)
        self.config = config or EngineConfig()
        self.device = torch.device(device)
        if params is None:
            params = init_params(spec, torch.Generator(
                device=self.device).manual_seed(seed))
        if draft_params is None:
            draft_params = init_params(draft_spec, torch.Generator(
                device=self.device).manual_seed(seed + 100))
        self.params = prepare_params(params)
        self.draft_params = fuse_block_weights(draft_params)
        self.param_bytes = param_bytes(self.params)
        self.load_info: Dict[str, Any] = {}
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)

        cfg = self.config
        self.batch_buckets = _pow2_buckets(cfg.max_slots)
        self.prefill_buckets = sorted(
            b for b in cfg.prefill_buckets if b <= spec.max_seq_len
        ) or [min(128, spec.max_seq_len)]
        self.seq_buckets = _pow2_buckets(
            min(cfg.max_seq_len, spec.max_seq_len), start=128)
        self.kv_dtype = kv_torch_dtype(cfg.kv_dtype)

        self.prefill_stats = LatencyStats()
        self.round_stats = LatencyStats()
        cap = int(getattr(config, "timeline_capacity", 4096) or 0)
        self.timeline: Optional[StepTimeline] = (
            StepTimeline(capacity=cap, name="speculative") if cap else None)
        self._tl_programs: set = set()
        self._total_requests = 0
        self._total_prompt_tokens = 0
        self._total_generated = 0
        self._total_rounds = 0
        self._total_accepted = 0
        self._total_proposed = 0

    # ------------------------------------------------------------- device

    def _prefill_both(self, tokens: np.ndarray, seq_lens: np.ndarray,
                      sampling: BatchSampling):
        """Both models over the prompts -> (first tokens and logprob bits
        [2, bb], target K, V, draft K, V); the first token is the target's,
        drawn by the other engines' sampler."""
        bb = tokens.shape[0]
        tok = _cuda.upload(tokens, self.device)
        hid_t, tks, tvs = forward_prefill(self.spec, self.params, tok,
                                          seq_lens)
        _, dks, dvs = forward_prefill(self.draft_spec, self.draft_params,
                                      tok, seq_lens)
        idx = _cuda.upload(seq_lens - 1, self.device, torch.int64)
        last = hid_t[torch.arange(bb, device=self.device), idx]
        logits = unembed(self.spec, self.params, last)
        first, lp = sample_tokens_with_logprobs(
            logits, sampling.params, generator=self._gen,
            needs_mask=sampling.needs_mask, needs_noise=sampling.needs_noise)
        return (torch.stack([first, lp.view(torch.int32)]), tks, tvs, dks,
                dvs)

    def _noise(self, shape, sampling: BatchSampling):
        return (gumbel_noise(shape, self._gen, self.device)
                if sampling.needs_noise else None)

    def _round(self, state, max_new, eos, sampling: BatchSampling):
        """One speculative round for every row (the JAX ``_round_core``).
        ``state`` is (tck, tcv, dck, dcv, lengths, last, active, produced):
        both caches hold K/V for positions ``[0, lengths)``, ``last`` is the
        newest token, not yet cached. Returns the new state and the packed
        [B, 2(k+1) + 2] int32 output: emitted tokens (-1 past the accepted
        run and for frozen rows), their logprob bits, n_acc, live flag."""
        tck, tcv, dck, dcv, lengths, last, active, produced = state
        spec_t, spec_d, k = self.spec, self.draft_spec, self.k
        b = lengths.shape[0]
        v = spec_t.vocab_size
        sp = sampling.params
        ones = torch.ones_like(lengths)
        greedy = sampling.greedy[:, None]

        # 1. the draft forwards `last` -> q_0, then proposes k tokens
        d_logits, dck, dcv = forward_window(
            spec_d, self.draft_params, last[:, None], ones, lengths, dck, dcv)
        q_logits = d_logits[:, 0]
        pos = lengths + 1
        drafts, q_list = [], []
        for _ in range(k):
            d_tok, probs = draft_sample(q_logits, sp, greedy,
                                        self._noise((b, v), sampling),
                                        sampling.needs_mask)
            nxt, dck, dcv = forward_window(
                spec_d, self.draft_params, d_tok[:, None], ones, pos, dck,
                dcv)
            q_logits, pos = nxt[:, 0], pos + 1
            drafts.append(d_tok)
            q_list.append(probs)
        drafts_t = torch.stack(drafts, dim=1)                # [B, k]
        q_probs = torch.stack(q_list, dim=1)                 # [B, k, V]

        # 2. the target verifies [last, d_0 .. d_{k-1}]
        window = torch.cat([last[:, None], drafts_t], dim=1)
        t_logits, tck, tcv = forward_window(
            spec_t, self.params, window, torch.full_like(lengths, k + 1),
            lengths, tck, tcv)                               # [B, k+1, V]
        p_probs = masked_sampling_probs(t_logits, sp, sampling.needs_mask)

        # 3. acceptance
        u = (torch.rand((b, k), generator=self._gen, device=self.device)
             if sampling.needs_noise
             else torch.zeros((b, k), device=self.device))
        n_acc, final, _ = rejection_accept(
            p_probs, q_probs, drafts_t, greedy, u,
            self._noise((b, v), sampling))

        # 4. bookkeeping (frozen rows emit nothing)
        was = active
        slot_pos = torch.arange(k + 1, device=self.device)[None, :]
        emit = (slot_pos <= n_acc[:, None]) & was[:, None]
        cand = torch.cat([drafts_t, torch.zeros_like(last)[:, None]], dim=1)
        cand = cand.scatter(1, n_acc.long()[:, None], final[:, None])
        emitted = torch.where(emit, cand, torch.full_like(cand, -1))
        produced = produced + torch.where(was, n_acc + 1,
                                          torch.zeros_like(n_acc))
        hit_eos = ((emitted == eos[:, None]) & (eos[:, None] >= 0)).any(1)
        active = was & ~(hit_eos | (produced >= max_new))
        lengths = torch.where(was, lengths + n_acc + 1, lengths)
        last = torch.where(was, final, last)
        # the untempered logprob of each emitted token: window position j
        # is the distribution emitted token j was drawn from
        lp_all = torch.log_softmax(t_logits.float(), dim=-1)
        lp = torch.gather(lp_all, 2, torch.clamp(emitted, min=0).long()
                          [:, :, None])[..., 0]
        lp = torch.where(emitted >= 0, lp, torch.zeros_like(lp))
        packed = torch.cat([emitted, lp.view(torch.int32), n_acc[:, None],
                            active.to(torch.int32)[:, None]], dim=1)
        return (tck, tcv, dck, dcv, lengths, last, active, produced), packed

    def _rounds(self, state, max_new, eos, sampling: BatchSampling):
        """``rounds_per_call`` rounds, then the packed outputs' host copy
        queued behind them: (state, HostRead of [R, B, 2(k+1) + 2])."""
        packs = []
        for _ in range(self.rounds_per_call):
            state, packed = self._round(state, max_new, eos, sampling)
            packs.append(packed)
        return state, _cuda.HostRead(torch.stack(packs))

    def _tl(self, kind: str, prog, t0: float, dur: float, **args) -> None:
        if self.timeline is None:
            return
        if prog not in self._tl_programs:
            self._tl_programs.add(prog)
            args["compile"] = True
        self.timeline.record(kind, t0, dur, **args)

    # ------------------------------------------------------------ generate

    def generate(self, requests: List[GenerationRequest]
                 ) -> List[GenerationResult]:
        if not requests:
            return []
        if min(len(r.prompt) for r in requests) < 1:
            raise ValueError("empty prompt")
        self._total_requests += len(requests)
        n = len(requests)
        k = self.k
        bb = _next_bucket(n, self.batch_buckets)
        max_prompt = min(max(len(r.prompt) for r in requests),
                         max(self.prefill_buckets))
        tb = _next_bucket(max_prompt, self.prefill_buckets)
        max_new = max(r.max_new_tokens for r in requests)
        total_cap = max(tb + k + 1, _next_bucket(
            min(max_prompt + max_new + k + 1, self.seq_buckets[-1]),
            self.seq_buckets))
        a = batch_arrays(requests, bb, tb, lambda r, lp: max(
            1, min(r.max_new_tokens, total_cap - lp - k - 1)))
        sampling = BatchSampling(requests, bb, self.device)

        t0 = time.perf_counter()
        first_dev, tks, tvs, dks, dvs = self._prefill_both(
            a["tokens"], a["seq_lens"], sampling)
        caches = [prefill_cache(x, total_cap, self.kv_dtype)
                  for x in (tks, tvs, dks, dvs)]
        del tks, tvs, dks, dvs
        fp = _cuda.HostRead(first_dev).numpy()         # ONE read
        first, first_lp = fp[0], fp[1].view(np.float32)
        is_real = np.zeros((bb,), bool)
        is_real[:n] = True
        produced_np = is_real.astype(np.int32)
        hit = is_real & (first == a["eos"]) & (a["eos"] >= 0)
        active_np = is_real & ~hit & (produced_np < a["max_new"])
        out_tokens = [[int(first[i])] for i in range(n)]
        out_lps = [[float(first_lp[i])] for i in range(n)]
        ttft = time.perf_counter() - t0
        self.prefill_stats.add(ttft)
        self._tl("spec_prefill", ("spec_prefill", bb, tb), t0, ttft,
                 rows=n, prefill_tokens=int(a["seq_lens"][:n].sum()))

        dev = self.device
        active = _cuda.upload(active_np.copy(), dev)
        state = (*caches, _cuda.upload(a["seq_lens"], dev),
                 _cuda.upload(np.where(first >= 0, first, 0)
                              .astype(np.int32), dev),
                 active, _cuda.upload(produced_np, dev))
        max_new_d = _cuda.upload(a["max_new"], dev)
        eos_d = _cuda.upload(a["eos"], dev)

        t1 = time.perf_counter()
        act_host = active_np
        scanned = [0] * n
        stopped = scan_host_stops(out_tokens, requests, act_host, scanned)
        if stopped and act_host.any():
            active[_cuda.upload(np.asarray(stopped, np.int64), dev)] = False
        R, k1 = self.rounds_per_call, k + 1
        # requests with host stops keep the dispatch -> read loop (a stop
        # must land on the device state between calls); the rest run one
        # call ahead
        overlap = not any(r.stop_ids or r.stop_sequences for r in requests)
        pending = None
        while act_host.any():
            if pending is None:
                state, read = self._rounds(state, max_new_d, eos_d,
                                           sampling)
            else:
                state, read = pending
                pending = None
            if overlap:
                pending = self._rounds(state, max_new_d, eos_d, sampling)
            pks = read.numpy()              # ONE read per R rounds
            for r in range(R):
                pk = pks[r]
                em = pk[:, :k1]
                lps = np.ascontiguousarray(pk[:, k1: 2 * k1]).view(
                    np.float32)
                n_acc = pk[:, 2 * k1]
                act_host = pk[:, 2 * k1 + 1].astype(bool)
                live = int((em[:, 0] >= 0).sum())
                if not live:
                    continue          # a call's tail after every row froze
                self._total_rounds += 1
                self._total_accepted += int(n_acc[em[:, 0] >= 0].sum())
                self._total_proposed += k * live
                for i in range(n):
                    for j in range(k1):
                        if em[i, j] >= 0:
                            out_tokens[i].append(int(em[i, j]))
                            out_lps[i].append(float(lps[i, j]))
            stopped = scan_host_stops(out_tokens, requests, act_host,
                                      scanned)
            if stopped and act_host.any():
                # the sync loop only (overlap is off with host stops)
                state[6][_cuda.upload(np.asarray(stopped, np.int64),
                                      dev)] = False
        decode_t = time.perf_counter() - t1
        self.round_stats.add(decode_t)
        self._tl("spec_rounds", ("spec_rounds", bb, R), t1, decode_t,
                 rows=n, rounds_per_call=R, k=k)

        results = []
        for i, r in enumerate(requests):
            toks, stop = trim_at_stops(out_tokens[i], r)
            self._total_prompt_tokens += len(r.prompt)
            self._total_generated += len(toks)
            results.append(GenerationResult(
                request_id=r.request_id or f"spec-{self._total_requests}-{i}",
                tokens=toks,
                logprobs=out_lps[i][: len(toks)],
                finish_reason="stop" if stop else "length",
                prompt_tokens=len(r.prompt),
                ttft_s=ttft,
                decode_s=decode_t,
            ))
        return results

    # ------------------------------------------------------------- warmup

    def warmup(self, batch: Optional[int] = None,
               max_new_tokens: int = 2) -> int:
        """One tiny generate per (batch bucket x prefill bucket), the prompt
        clamped so a speculative round runs. Returns the generates run."""
        sizes = [batch] if batch else self.batch_buckets
        cap = self.seq_buckets[-1] - self.k - 1 - max_new_tokens
        runs = 0
        for n in sizes:
            for tb in self.prefill_buckets:
                plen = max(1, min(tb, cap))
                self.generate([GenerationRequest(
                    prompt=[1] * plen, max_new_tokens=max_new_tokens)
                    for _ in range(n)])
                runs += 1
        return runs

    # ------------------------------------------------------------ metrics

    def get_metrics(self) -> Dict[str, Any]:
        acc_rate = (self._total_accepted / self._total_proposed
                    if self._total_proposed else 0.0)
        return {
            "total_requests": self._total_requests,
            "total_prompt_tokens": self._total_prompt_tokens,
            "total_generated_tokens": self._total_generated,
            "speculate_k": self.k,
            "rounds": self._total_rounds,
            "draft_acceptance_rate": acc_rate,
            "tokens_per_round": ((self._total_accepted + self._total_rounds)
                                 / self._total_rounds
                                 if self._total_rounds else 0.0),
            "prefill": self.prefill_stats.snapshot(),
            "decode": self.round_stats.snapshot(),
        }
