"""The static engine: batched prefill, then decode chunks over a dense KV
cache (port of ``engine/engine.py:Engine``).

``generate`` serves one batch to completion:

- **Buckets.** The batch pads to a power-of-two bucket, the prompts to a
  prefill bucket (an overlong prompt keeps its tail), and the cache to the
  total-length bucket, as in JAX, whose jitted programs are keyed on them.
- **Prefill** runs every prompt through the model, samples each first
  token with its logprob and writes the K/V into a dense cache ``[L, B, S,
  Hkv, Dh]`` in ``config.kv_dtype`` (``astype_kv``: an fp8 cache holds
  JAX's bytes). One host read: the first tokens with their logprob bits.
- **Decode** runs in chunks of ``decode_steps_per_call`` steps
  (``models/base.py:forward_decode``, ``unembed``, the sampler, the
  eos/budget bookkeeping on the device). Each chunk ends in one packed host
  read: tokens, logprob bits and live flags; there is none inside a
  chunk. Host stops (``stop_ids``, ``stop_sequences``) are scanned before
  the loop and after each chunk; ``trim_at_stops`` cuts every result.

The JAX engine compiles one program per bucket; here the chunks run
eagerly (capturing them per bucket is ROADMAP.md B work). The sampler's
randomness comes from the engine's seeded ``torch.Generator``, which cannot
reproduce JAX's key stream: sampled runs reproduce from the seed, greedy
runs give JAX's tokens. ``shard_fn`` and ``sp_mesh`` (parallel serving)
raise ``NotImplementedError`` naming ROADMAP.md A13.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import EngineConfig
from ..models.base import (
    ModelSpec,
    Params,
    dense_kv_cache,
    forward_decode,
    forward_prefill,
    init_params,
    kv_torch_dtype,
    unembed,
)
from ..obs.timeline import StepTimeline
from ..ops import _cuda
from ..ops.attention import astype_kv, raw_view
from ..ops.quant import param_bytes, prepare_params
from ..ops.sampling import SamplingParams, sample_tokens_with_logprobs
from ..utils.tracing import LatencyStats
from .types import (  # noqa: F401  (re-export, as in JAX)
    GenerationRequest,
    GenerationResult,
    scan_host_stops,
    trim_at_stops,
)


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


def request_knobs(reqs: Sequence[GenerationRequest], n: int) -> np.ndarray:
    """Host knob rows [temp, k, p, min_p] of ``reqs``, padded to ``n`` rows
    with greedy defaults."""
    knobs = np.zeros((n, 4), np.float32)
    knobs[:, 2] = 1.0
    for i, r in enumerate(reqs):
        knobs[i] = (r.temperature, r.top_k, r.top_p, r.min_p)
    return knobs


def knob_flags(knobs: np.ndarray) -> Tuple[bool, bool]:
    """(needs_mask, needs_noise) of host knob rows [temp, k, p, min_p]:
    whether any row uses top-k/top-p/min-p, or samples at all, so no step
    syncs with the device to decide the sampler's branches."""
    needs_mask = bool((knobs[:, 1] > 0).any() | (knobs[:, 2] < 1.0).any()
                      | (knobs[:, 3] > 0).any())
    return needs_mask, bool((knobs[:, 0] > 0).any())


class BatchSampling:
    """A batch's sampling knobs on the device (``SamplingParams``, the
    greedy rows) with their host flags (``knob_flags``)."""

    def __init__(self, requests: Sequence[GenerationRequest], bb: int,
                 device) -> None:
        knobs = request_knobs(requests, bb)
        t = _cuda.upload(knobs, device)
        self.params = SamplingParams(t[:, 0], t[:, 1].to(torch.int32),
                                     t[:, 2], t[:, 3])
        self.needs_mask, self.needs_noise = knob_flags(knobs)
        self.greedy = self.params.temperature <= 0.0


def batch_arrays(requests: Sequence[GenerationRequest], bb: int, tb: int,
                 budget) -> Dict[str, np.ndarray]:
    """The host half of a batch's assembly, shared with the speculative
    engine: prompts right-padded into ``[bb, tb]`` (an overlong prompt
    keeps its tail; pad rows hold one token), their lengths, each row's
    token budget (``budget(request, prompt_len)``) and eos."""
    tokens = np.zeros((bb, tb), np.int32)
    seq_lens = np.ones((bb,), np.int32)          # padded rows: len 1
    max_new = np.zeros((bb,), np.int32)
    eos = np.full((bb,), -1, np.int32)
    for i, r in enumerate(requests):
        p = r.prompt[-tb:]
        tokens[i, : len(p)] = p
        seq_lens[i] = len(p)
        max_new[i] = budget(r, len(p))
        eos[i] = r.eos_id
    return {"tokens": tokens, "seq_lens": seq_lens, "max_new": max_new,
            "eos": eos}


def prefill_cache(ks: torch.Tensor, total_cap: int, dtype: torch.dtype
                  ) -> torch.Tensor:
    """A ``dense_kv_cache`` of ``total_cap`` positions holding the prefill's
    K or V ``[L, B, T, Hkv, Dh]`` at ``[0, T)``, rounded by the JAX cast."""
    L, b, t, hkv, dh = ks.shape
    cache = dense_kv_cache((L, b, total_cap, hkv, dh), dtype, ks.device)
    raw_view(cache)[:, :, :t] = raw_view(astype_kv(ks, dtype))
    return cache


class Engine:
    """Single-program engine over one model (the JAX ``Engine``).

    ``generate`` is synchronous device work; the worker runs it on its
    executor thread. ``device`` defaults to the card; tests pass
    ``device="cpu"``, where the kernels' plain versions run.
    ``artifact_path`` restores the prepared tree from a serving artifact
    (``spec`` may be None) and, with ``artifact_selfcheck``, replays its
    golden probe before any traffic."""

    def __init__(self, spec: Optional[ModelSpec],
                 params: Optional[Params] = None,
                 config: Optional[EngineConfig] = None, seed: int = 0,
                 shard_fn=None, sp_mesh=None,
                 artifact_path: Optional[str] = None,
                 artifact_selfcheck: bool = True, device="cuda") -> None:
        if shard_fn is not None or sp_mesh is not None:
            raise NotImplementedError(
                "shard_fn/sp_mesh (parallel serving) is not ported to "
                "PyTorch yet (ROADMAP.md A13)")
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
        self.config = config or EngineConfig()
        if params is None:
            params = init_params(spec, torch.Generator(
                device=self.device).manual_seed(seed))
        # the artifact IS the prepared tree
        self.params = (params if self.artifact_manifest is not None
                       else prepare_params(params))
        self.param_bytes = param_bytes(self.params)
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
        self.decode_stats = LatencyStats()
        cap = int(getattr(config, "timeline_capacity", 4096) or 0)
        self.timeline: Optional[StepTimeline] = (
            StepTimeline(capacity=cap, name="static") if cap else None)
        self._tl_programs: set = set()
        self._total_requests = 0
        self._total_prompt_tokens = 0
        self._total_generated_tokens = 0
        self._total_errors = 0

        if self.artifact_manifest is not None and artifact_selfcheck:
            from .artifact import verify_golden

            t0 = time.perf_counter()
            if verify_golden(self, self.artifact_manifest):
                self.load_info["golden_probe_s"] = time.perf_counter() - t0

    # ------------------------------------------------------------- device

    def _prefill(self, tokens: np.ndarray, seq_lens: np.ndarray,
                 sampling: BatchSampling):
        """Prompts -> (first tokens and their logprob bits [2, bb] int32,
        K [L, bb, tb, Hkv, Dh], V), on the device."""
        bb = tokens.shape[0]
        hidden, ks, vs = forward_prefill(
            self.spec, self.params, _cuda.upload(tokens, self.device),
            seq_lens)
        idx = _cuda.upload(seq_lens - 1, self.device, torch.int64)
        last = hidden[torch.arange(bb, device=self.device), idx]
        logits = unembed(self.spec, self.params, last)
        first, lp = sample_tokens_with_logprobs(
            logits, sampling.params, generator=self._gen,
            needs_mask=sampling.needs_mask, needs_noise=sampling.needs_noise)
        return torch.stack([first, lp.view(torch.int32)]), ks, vs

    def _decode_chunk(self, ck, cv, lengths, last, active, produced,
                      max_new, eos, sampling: BatchSampling, n_steps: int):
        """``n_steps`` decode steps for every row on the device (the JAX
        chunk's scan body): forward, sample, the eos and budget retires,
        lengths advanced for live rows. Returns the new state and the
        packed [2 * n_steps + 1, bb] int32 output: tokens (-1 for idle
        rows), logprob bits, live flags."""
        spec, params = self.spec, self.params
        toks, lps = [], []
        for _ in range(n_steps):
            hidden, ck, cv = forward_decode(spec, params, last, lengths,
                                            ck, cv)
            logits = unembed(spec, params, hidden)
            nxt, lp = sample_tokens_with_logprobs(
                logits, sampling.params, generator=self._gen,
                needs_mask=sampling.needs_mask,
                needs_noise=sampling.needs_noise)
            was = active
            produced = produced + was.to(torch.int32)
            hit_eos = (nxt == eos) & (eos >= 0)
            active = was & ~(hit_eos | (produced >= max_new))
            lengths = lengths + was.to(torch.int32)
            last = torch.where(was, nxt, last)
            toks.append(torch.where(was, nxt, torch.full_like(nxt, -1)))
            lps.append(torch.where(was, lp, torch.zeros_like(lp)))
        packed = torch.cat([torch.stack(toks),
                            torch.stack(lps).view(torch.int32),
                            active[None].to(torch.int32)])
        return (ck, cv, lengths, last, active, produced), packed

    def _set_inactive(self, active: torch.Tensor, rows: List[int]) -> None:
        active[_cuda.upload(np.asarray(rows, np.int64), self.device)] = False

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
        """Run a batch of requests to completion, padded to the batch,
        prefill and sequence buckets."""
        if not requests:
            return []
        self._total_requests += len(requests)
        n = len(requests)
        bb = _next_bucket(n, self.batch_buckets)
        if min(len(r.prompt) for r in requests) < 1:
            raise ValueError("empty prompt")
        # overlong prompts keep their tail
        max_prompt = min(max(len(r.prompt) for r in requests),
                         max(self.prefill_buckets))
        tb = _next_bucket(max_prompt, self.prefill_buckets)
        max_new = max(r.max_new_tokens for r in requests)
        total_cap = max(tb, _next_bucket(
            min(max_prompt + max_new, self.seq_buckets[-1]),
            self.seq_buckets))
        a = batch_arrays(requests, bb, tb, lambda r, lp: max(
            1, min(r.max_new_tokens, total_cap - lp)))
        sampling = BatchSampling(requests, bb, self.device)

        t0 = time.perf_counter()
        first_dev, ks, vs = self._prefill(a["tokens"], a["seq_lens"],
                                          sampling)
        ck = prefill_cache(ks, total_cap, self.kv_dtype)
        cv = prefill_cache(vs, total_cap, self.kv_dtype)
        del ks, vs
        fp = _cuda.HostRead(first_dev).numpy()          # ONE read
        first_np, first_lp = fp[0], fp[1].view(np.float32)
        is_real = np.zeros((bb,), bool)
        is_real[:n] = True
        produced_np = is_real.astype(np.int32)          # the prefill sample
        hit = is_real & (first_np == a["eos"]) & (a["eos"] >= 0)
        active_np = is_real & ~hit & (produced_np < a["max_new"])
        first_np = np.where(is_real, first_np, -1)
        ttft = time.perf_counter() - t0
        self.prefill_stats.add(ttft)
        self._tl("prefill", ("prefill", bb, tb), t0, ttft, rows=n,
                 prefill_tokens=int(a["seq_lens"][:n].sum()))

        out_tokens = [[int(first_np[i])] for i in range(n)]
        out_lps = [[float(first_lp[i])] for i in range(n)]
        dev = self.device
        lengths = _cuda.upload(a["seq_lens"], dev)
        last = _cuda.upload(np.where(first_np >= 0, first_np, 0)
                            .astype(np.int32), dev)
        # a copy: host stops clear rows of the device flags in place
        active = _cuda.upload(active_np.copy(), dev)
        produced = _cuda.upload(produced_np, dev)
        max_new_d = _cuda.upload(a["max_new"], dev)
        eos_d = _cuda.upload(a["eos"], dev)

        t1 = time.perf_counter()
        n_steps = self.config.decode_steps_per_call
        # the loop runs on the host mirror of the live flags, seeded from
        # the prefill sample and updated from each chunk's packed read
        act_host = active_np
        scanned = [0] * n
        # the first token itself may match a host stop
        stopped = scan_host_stops(out_tokens, requests, act_host, scanned)
        if stopped and act_host.any():
            self._set_inactive(active, stopped)
        while act_host.any():
            (ck, cv, lengths, last, active, produced), packed = \
                self._decode_chunk(ck, cv, lengths, last, active, produced,
                                   max_new_d, eos_d, sampling, n_steps)
            host = _cuda.HostRead(packed).numpy()   # ONE read per chunk
            toks_np = host[:n_steps]
            lps_np = host[n_steps: 2 * n_steps].view(np.float32)
            act_host = host[-1].astype(bool)
            for i in range(n):
                for s in range(n_steps):
                    t = int(toks_np[s, i])
                    if t >= 0:
                        out_tokens[i].append(t)
                        out_lps[i].append(float(lps_np[s, i]))
            stopped = scan_host_stops(out_tokens, requests, act_host,
                                      scanned)
            if stopped and act_host.any():
                self._set_inactive(active, stopped)
        decode_t = time.perf_counter() - t1
        self.decode_stats.add(decode_t)
        self._tl("decode", ("decode", bb, n_steps), t1, decode_t, rows=n,
                 n_steps=n_steps)

        results = []
        for i, r in enumerate(requests):
            toks, stop = trim_at_stops(out_tokens[i], r)
            self._total_prompt_tokens += len(r.prompt)
            self._total_generated_tokens += len(toks)
            results.append(GenerationResult(
                request_id=r.request_id or f"gen-{self._total_requests}-{i}",
                tokens=toks,
                finish_reason="stop" if stop else "length",
                prompt_tokens=len(r.prompt),
                logprobs=out_lps[i][: len(toks)],
                ttft_s=ttft,
                decode_s=decode_t,
            ))
        return results

    # ------------------------------------------------------------- warmup

    def warmup(self, batch: Optional[int] = None,
               max_new_tokens: int = 2) -> int:
        """One tiny generate per (batch bucket x prefill bucket), every
        batch bucket by default, the prompt clamped below the top sequence
        bucket so a decode chunk runs. Stat counters tick. Returns the
        generates run."""
        sizes = [batch] if batch else self.batch_buckets
        runs = 0
        for n in sizes:
            for tb in self.prefill_buckets:
                plen = max(1, min(tb, self.seq_buckets[-1] - max_new_tokens))
                self.generate([GenerationRequest(
                    prompt=[1] * plen, max_new_tokens=max_new_tokens)
                    for _ in range(n)])
                runs += 1
        return runs

    def warmup_from_manifest(self, max_new_tokens: int = 2) -> int:
        """The artifact-aware warmup: only the batch buckets the artifact's
        writer recorded, or the full ``warmup`` when it records none that
        fit."""
        b = (self.artifact_manifest or {}).get("buckets", {})
        batches = [n for n in b.get("batch", []) if n in self.batch_buckets]
        if not batches:
            return self.warmup(max_new_tokens=max_new_tokens)
        return sum(self.warmup(batch=n, max_new_tokens=max_new_tokens)
                   for n in batches)

    # ------------------------------------------------------------ metrics

    def get_metrics(self) -> Dict[str, Any]:
        return {
            "total_requests": self._total_requests,
            "total_prompt_tokens": self._total_prompt_tokens,
            "total_generated_tokens": self._total_generated_tokens,
            "total_errors": self._total_errors,
            "prefill": self.prefill_stats.snapshot(),
            "decode": self.decode_stats.snapshot(),
            "spec": {
                "n_layers": self.spec.n_layers,
                "d_model": self.spec.d_model,
                "vocab_size": self.spec.vocab_size,
            },
        }
