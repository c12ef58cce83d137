"""Speculative decoding's acceptance rule (port of
``engine/spec_accept.py``), shared by the speculative engine and the
continuous engine's verify step.

Greedy rows accept while ``argmax p_j == d_j``, so the emitted run is the
target's own greedy chain whatever the draft proposed. Sampled rows accept
``d_j`` with probability ``min(1, p_j[d_j] / q_j[d_j])`` and resample the
first rejection from ``norm(max(p - q, 0))`` (Leviathan et al.).

JAX draws the randomness from keys, which torch cannot reproduce, so these
functions take it as tensors: the acceptance uniforms ``u [B, k]`` and the
Gumbel noise of each categorical draw (``jax.random.categorical(key, l)``
is ``argmax(gumbel(key, l.shape) + l)``). Fed JAX's ``uniform`` and
``gumbel`` of the same keys, they return JAX's ``n_acc``, ``final`` and
``accept``. Engines make the noise from their ``torch.Generator``
(``ops/sampling.py:gumbel_noise``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.sampling import SamplingParams, masked_sampling_probs


def _categorical(probs: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over ``log(max(probs, 1e-30))`` with the
    draw's noise given."""
    return torch.argmax(
        gumbel + torch.log(torch.clamp(probs, min=1e-30)), dim=-1)


def draft_sample(q_logits: torch.Tensor, sampling: SamplingParams,
                 greedy: torch.Tensor, gumbel: Optional[torch.Tensor],
                 needs_mask: Optional[bool] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One draft proposal from the knob-masked draft distribution; greedy
    rows take the raw argmax. ``gumbel`` [B, V] is the draw's noise (None
    when every row is greedy). Returns (token [B] int32, q_probs [B, V])."""
    probs = masked_sampling_probs(q_logits, sampling, needs_mask)
    greedy1 = greedy[:, 0] if greedy.dim() == 2 else greedy
    d_tok = torch.argmax(q_logits, dim=-1)
    if gumbel is not None:
        d_tok = torch.where(greedy1, d_tok, _categorical(probs, gumbel))
    return d_tok.to(torch.int32), probs


def rejection_accept(
    p_probs: torch.Tensor,     # [B, k+1, V] knob-masked target probs
    q_probs: torch.Tensor,     # [B, k, V] knob-masked draft probs
    drafts: torch.Tensor,      # [B, k] int32 proposed tokens
    greedy: torch.Tensor,      # [B] (or [B, 1]) bool: temperature <= 0
    u: torch.Tensor,           # [B, k] acceptance uniforms in [0, 1)
    gumbel: Optional[torch.Tensor],  # [B, V] the final draw's noise
    valid: Optional[torch.Tensor] = None,   # [B, k] bool column mask
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rejection-sampling acceptance over one verify window (the JAX
    function's op order). ``valid`` force-rejects masked columns before the
    cumulative run, so a row with none lands on ``n_acc == 0`` with its
    final drawn from position 0: the plain decode sample when its
    ``q_probs`` row is zeros. ``gumbel`` may be None when every row is
    greedy. Returns (n_acc [B] int32, final [B] int32, accept [B, k]
    bool); the emitted run is ``drafts[:, :n_acc]`` then ``final``."""
    b, k = drafts.shape
    bidx = torch.arange(b, device=drafts.device)
    greedy2 = greedy if greedy.dim() == 2 else greedy[:, None]
    d = drafts.long()[:, :, None]
    p_at_d = torch.gather(p_probs[:, :k], 2, d)[..., 0]
    q_at_d = torch.gather(q_probs, 2, d)[..., 0]
    acc_samp = u * q_at_d < p_at_d
    acc_greedy = torch.argmax(p_probs[:, :k], dim=-1) == drafts
    accept = torch.where(greedy2, acc_greedy, acc_samp)
    if valid is not None:
        accept = accept & valid
    n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)

    # final token: a bonus draw from p_k when all accepted, else from the
    # residual at the first rejected position
    all_acc = n_acc == k
    pos_r = torch.clamp(n_acc, max=k - 1)
    p_rej = p_probs[bidx, pos_r]
    q_rej = q_probs[bidx, pos_r]
    resid = torch.clamp(p_rej - q_rej, min=0.0)
    resid_sum = resid.sum(-1, keepdim=True)
    # degenerate residual (q covers p): fall back to p
    resid = torch.where(resid_sum > 1e-9, resid, p_rej)
    resid = resid / resid.sum(-1, keepdim=True)
    final_dist = torch.where(all_acc[:, None], p_probs[:, k], resid)
    final = torch.argmax(final_dist, dim=-1)
    if gumbel is not None:
        final = torch.where(greedy2[:, 0], final,
                            _categorical(final_dist, gumbel))
    return n_acc.to(torch.int32), final.to(torch.int32), accept
