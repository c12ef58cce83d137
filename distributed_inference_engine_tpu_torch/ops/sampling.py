"""Token sampling (port of ``ops/sampling.py``): temperature, top-k, top-p
and min-p masks, then a Gumbel-max draw; greedy rows take the argmax of
the masked logits.

The JAX draw comes from a ``jax.random`` key, which torch cannot
reproduce. So the draw is an argument: ``uniform`` ([B, V] fp32 in
[1e-20, 1)) lets a test feed the JAX uniforms and get identical tokens;
without it the draw comes from ``generator`` (the engine's seeded
``torch.Generator`` on the logits' device). Inside a CUDA graph the engine
registers that generator with the graph, so each replay draws fresh
uniforms from the generator's current offset and advances it, as the
eager calls would.

The JAX code hides the three [B, V] sorts of the mask behind a
``lax.cond`` on a device predicate. Here the predicate is a host bool:
``needs_mask`` (and ``needs_noise`` for the draw) may be passed by a
caller that knows it from host state — the engine does, so a decode step
never syncs to decide — and is computed from the params otherwise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class SamplingParams(NamedTuple):
    """Per-row sampling knobs, each a [B] tensor."""

    temperature: torch.Tensor   # 0.0 => greedy
    top_k: torch.Tensor         # 0 or >= vocab => disabled
    top_p: torch.Tensor         # 1.0 => disabled
    min_p: Optional[torch.Tensor] = None  # 0.0 => disabled

    @classmethod
    def make(cls, batch: int, temperature=0.0, top_k=0, top_p=1.0,
             min_p=0.0, device=None) -> "SamplingParams":
        def full(v, dt):
            return torch.full((batch,), v, dtype=dt, device=device)

        return cls(full(temperature, torch.float32), full(top_k, torch.int32),
                   full(top_p, torch.float32), full(min_p, torch.float32))

    def min_p_or_zeros(self) -> torch.Tensor:
        if self.min_p is None:
            return torch.zeros_like(self.temperature)
        return self.min_p


def _mask_topk_topp(scaled: torch.Tensor, params: SamplingParams
                    ) -> torch.Tensor:
    """Top-k, top-p and min-p masks on tempered logits [B, V]."""
    b, v = scaled.shape
    k = torch.where(params.top_k <= 0, torch.full_like(params.top_k, v),
                    params.top_k).long()
    sorted_desc = torch.flip(torch.sort(scaled, dim=-1).values, dims=[-1])
    kth = torch.gather(sorted_desc, 1, torch.clamp(k - 1, 0, v - 1)[:, None])
    keep_topk = scaled >= kth
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    # rank of each logit in the descending order; stable, as jnp.argsort
    ranks = torch.argsort(torch.argsort(-scaled, dim=-1, stable=True),
                          dim=-1, stable=True)
    keep_sorted = (cum - probs_sorted) < params.top_p[:, None]
    keep_topp = torch.gather(keep_sorted, 1, ranks)
    minp = torch.clamp(params.min_p_or_zeros(), 0.0, 1.0)
    probs = torch.gather(probs_sorted, 1, ranks)
    keep_minp = (minp[:, None] <= 0.0) | \
        (probs >= minp[:, None] * probs_sorted[:, :1])
    keep = keep_topk & keep_topp & keep_minp
    return torch.where(keep, scaled, torch.full_like(scaled, float("-inf")))


def _needs_mask(params: SamplingParams) -> bool:
    return bool(torch.any(params.top_k > 0) | torch.any(params.top_p < 1.0)
                | torch.any(params.min_p_or_zeros() > 0.0))


def _masked_scaled_logits(logits: torch.Tensor, params: SamplingParams,
                          needs_mask: Optional[bool] = None) -> torch.Tensor:
    temp = torch.clamp(params.temperature, min=1e-6)[:, None]
    scaled = logits / temp
    if needs_mask is None:
        needs_mask = _needs_mask(params)
    return _mask_topk_topp(scaled, params) if needs_mask else scaled


def masked_sampling_probs(logits: torch.Tensor, params: SamplingParams,
                          needs_mask: Optional[bool] = None) -> torch.Tensor:
    """The sampling distribution ``sample_tokens`` draws from, as
    probabilities: tempered, top-k/top-p/min-p masked, renormalised.
    ``logits`` is [B, V] or [B, P, V] (P positions a row, each masked with
    its row's knobs); params are [B]. Greedy rows come back near one-hot
    at the argmax."""
    lg = logits.float()
    squeeze = lg.dim() == 2
    if squeeze:
        lg = lg[:, None, :]
    b, p, v = lg.shape

    def rep(x: torch.Tensor) -> torch.Tensor:
        return torch.repeat_interleave(x, p, dim=0)

    flat = SamplingParams(rep(params.temperature), rep(params.top_k),
                          rep(params.top_p), rep(params.min_p_or_zeros()))
    masked = _masked_scaled_logits(lg.reshape(b * p, v), flat, needs_mask)
    probs = torch.softmax(masked, dim=-1).reshape(b, p, v)
    return probs[:, 0] if squeeze else probs


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Gumbel noise ``-log(-log(u))`` fp32, u uniform in [1e-20, 1) as
    ``sample_tokens`` draws it: what a categorical draw (the JAX
    ``jax.random.categorical``, ``argmax(gumbel + logits)``) adds."""
    u = torch.rand(shape, generator=generator, device=device) + 1e-20
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, params: SamplingParams,
                  generator: Optional[torch.Generator] = None,
                  uniform: Optional[torch.Tensor] = None,
                  needs_mask: Optional[bool] = None,
                  needs_noise: Optional[bool] = None) -> torch.Tensor:
    """One token per row of logits [B, V] -> [B] int32."""
    b, v = logits.shape
    logits = logits.float()
    masked = _masked_scaled_logits(logits, params, needs_mask)
    greedy = torch.argmax(masked, dim=-1)
    if needs_noise is None:
        needs_noise = uniform is not None or bool(
            torch.any(params.temperature > 0.0))
    if not needs_noise:
        return greedy.to(torch.int32)
    if uniform is None:
        # jax.random.uniform(minval=1e-20, maxval=1) = 1e-20 + U[0, 1)
        uniform = torch.rand((b, v), generator=generator,
                             device=logits.device) + 1e-20
    gumbel = -torch.log(-torch.log(uniform.float()))
    stochastic = torch.argmax(masked + gumbel, dim=-1)
    return torch.where(params.temperature <= 0.0, greedy,
                       stochastic).to(torch.int32)


def sample_tokens_with_logprobs(logits: torch.Tensor, params: SamplingParams,
                                generator: Optional[torch.Generator] = None,
                                uniform: Optional[torch.Tensor] = None,
                                needs_mask: Optional[bool] = None,
                                needs_noise: Optional[bool] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sample_tokens`` plus the chosen token's untempered log-probability
    ([B] fp32)."""
    toks = sample_tokens(logits, params, generator, uniform, needs_mask,
                         needs_noise)
    logp = torch.log_softmax(logits.float(), dim=-1)
    chosen = torch.gather(logp, 1, toks.long()[:, None])[:, 0]
    return toks, chosen
