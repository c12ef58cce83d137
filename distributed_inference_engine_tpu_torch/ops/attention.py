"""Attention for prefill, the windowed decode and the dense-cache decode
(port of ``ops/attention.py``).

Prefill attention is plain tensor code in the JAX package (XLA, no
Pallas), so here it is plain PyTorch too: an einsum for the scores, a
masked softmax in fp32, an einsum against V — with the JAX dtype steps
(scores in the activation dtype, then fp32; probabilities cast back to V's
dtype before the second product). GQA reshapes Q to [B, T, Hkv, G, Dh]
and broadcasts K/V across the group axis.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

NEG_INF = -1e30   # large-but-finite: -inf rows would softmax to NaN

FP8 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
# the largest magnitude that rounds to a finite e4m3 value (448 + half an
# ulp; 464 itself ties to 448)
_FP8_LIMIT = 464.0


def is_fp8(dt: torch.dtype) -> bool:
    return dt in (FP8, E5M2)


def astype_kv(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype)`` as JAX rounds it, for a KV pool's dtype. Into
    e4m3 that is round to nearest even, and NaN (``0x7F``, with x's sign
    bit) for a magnitude past 464, for ±inf and for NaN: torch's own cast
    saturates those to ±448 instead. Into e5m2 torch rounds as JAX does
    (±inf from 61,440 up) but for NaN: JAX writes ``0x7E`` with x's sign
    from fp32 and ``0x7F`` whatever the sign from bf16, torch ``0x7F``
    with the sign. Every write into an fp8 pool, and every plain version
    that rounds through one, takes this cast; the kernels round as it does
    (``csrc/common.cuh`` ``from_f``)."""
    if not is_fp8(dtype):
        return x.to(dtype)
    bits = x.to(dtype).view(torch.uint8)
    if dtype == E5M2:
        if x.dtype == torch.bfloat16:
            nan = torch.full_like(bits, 0x7F)
        else:
            nan = (torch.signbit(x).to(torch.uint8) << 7) | 0x7E
        return torch.where(torch.isnan(x), nan, bits).view(dtype)
    over = ~(x.abs() <= _FP8_LIMIT)                 # NaN compares false
    nan = (torch.signbit(x).to(torch.uint8) << 7) | 0x7F
    return torch.where(over, nan, bits).view(dtype)


def raw_view(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor as its ``uint8`` bytes (a view), anything else as it
    is: torch lacks some ops for fp8 (``gather`` on the CPU), so pool
    bytes are indexed, selected and scattered through this view."""
    return t.view(torch.uint8) if is_fp8(t.dtype) else t


def upcast_kv(k: torch.Tensor, v: torch.Tensor, dt: torch.dtype
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp8 K/V widened to the query dtype at the attention boundary (the
    JAX ``_upcast_fp8``; e4m3 and e5m2 are exact in bf16 and fp32). Wider
    K/V keeps its dtype."""
    if is_fp8(k.dtype):
        return k.to(dt), v.to(dt)
    return k, v


def _group_query(q: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    """[B, T, H, Dh] -> [B, T, Hkv, G, Dh] where H = Hkv * G."""
    b, t, h, d = q.shape
    return q.reshape(b, t, n_kv_heads, h // n_kv_heads, d)


def _scale(dh: int) -> float:
    """1 / sqrt(Dh) rounded as fp32 arithmetic rounds it (the JAX code and
    the CUDA kernel both divide in fp32)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def _softmax_masked(scores: torch.Tensor, mask: torch.Tensor
                    ) -> torch.Tensor:
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return probs / probs.sum(dim=-1, keepdim=True)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     seq_lens: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Prefill attention, causal within the prompt, padding masked; with
    ``window`` > 0 query i sees keys j with i - j < window (Mistral's
    sliding window). q [B, T, H, Dh], k/v [B, T, Hkv, Dh], seq_lens [B] ->
    [B, T, H, Dh]."""
    b, t, h, dh = q.shape
    k, v = upcast_kv(k, v, q.dtype)
    qg = _group_query(q, k.shape[2])
    scores = torch.einsum("bikgd,bjkd->bkgij", qg, k).float() * _scale(dh)
    ar = torch.arange(t, device=q.device)
    causal = ar[None, :] <= ar[:, None]                         # [T, T]
    if window:
        causal &= (ar[:, None] - ar[None, :]) < window
    valid = ar[None, :] < seq_lens[:, None]                     # [B, T]
    mask = causal[None] & valid[:, None, :]                     # [B, T, T]
    probs = _softmax_masked(scores, mask[:, None, None])
    out = torch.einsum("bkgij,bjkd->bikgd", probs.to(v.dtype), v)
    return out.reshape(b, t, h, dh)


def suffix_attention(q: torch.Tensor, k_ctx: torch.Tensor,
                     v_ctx: torch.Tensor, n_ctx: torch.Tensor,
                     k_suf: torch.Tensor, v_suf: torch.Tensor,
                     suffix_lens: torch.Tensor, window: int = 0
                     ) -> torch.Tensor:
    """Prefill of a prompt suffix against cached prefix K/V: suffix query
    i sees every context key j < n_ctx and suffix keys causally; with
    ``window`` > 0 only keys whose absolute position is within ``window``
    of the query's (``n_ctx + i``).
    q [B, Ts, H, Dh], ctx [B, Tc, Hkv, Dh], suffix K/V [B, Ts, Hkv, Dh]."""
    b, ts, h, dh = q.shape
    tc = k_ctx.shape[1]
    k_ctx, v_ctx = upcast_kv(k_ctx, v_ctx, q.dtype)
    k_suf, v_suf = upcast_kv(k_suf, v_suf, q.dtype)
    qg = _group_query(q, k_ctx.shape[2])
    k_all = torch.cat([k_ctx, k_suf], dim=1)
    v_all = torch.cat([v_ctx, v_suf], dim=1)
    scores = torch.einsum("bikgd,bjkd->bkgij", qg, k_all).float() * \
        _scale(dh)
    i = torch.arange(ts, device=q.device)[:, None]
    j = torch.arange(tc + ts, device=q.device)[None, :]
    in_ctx = j < tc
    suf_j = j - tc
    causal = suf_j <= i                                         # [Ts, Tc+Ts]
    mask_ctx = in_ctx & (j < n_ctx[:, None, None])              # [B, 1, Tc+Ts]
    mask_suf = (~in_ctx) & causal[None] & \
        (suf_j[None] < suffix_lens[:, None, None])
    mask = mask_ctx | mask_suf                                  # [B, Ts, Tc+Ts]
    if window:
        # absolute positions: query n_ctx + i, context key j, suffix key
        # n_ctx + suf_j
        nc = n_ctx.long()[:, None, None]
        q_abs = nc + i[None]                                    # [B, Ts, 1]
        k_abs = torch.where(in_ctx, j, nc + suf_j)              # [B, 1, Tc+Ts]
        mask &= (q_abs - k_abs) < window
    probs = _softmax_masked(scores, mask[:, None, None])
    out = torch.einsum("bkgij,bjkd->bikgd", probs.to(v_all.dtype), v_all)
    return out.reshape(b, ts, h, dh).to(q.dtype)


def window_decode_attention(q: torch.Tensor, k_side: torch.Tensor,
                            v_side: torch.Tensor, n_valid: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Decode attention over the chunk's side window with flash stats:
    q [B, H, Dh], side [B, W, Hkv, Dh], n_valid [B] -> (out [B, H, Dh] in
    q's dtype, m [B, H] fp32, l [B, H] fp32). A slot with no valid entry
    has l = 0 (merge weight 0)."""
    b, h, dh = q.shape
    w = k_side.shape[1]
    n_kv = k_side.shape[2]
    k_side, v_side = upcast_kv(k_side, v_side, q.dtype)
    qg = q.reshape(b, n_kv, h // n_kv, dh)
    scores = torch.einsum("bkgd,bwkd->bkgw", qg, k_side).float() * \
        _scale(dh)
    valid = (torch.arange(w, device=q.device)[None, :]
             < n_valid[:, None])[:, None, None, :]              # [B,1,1,W]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)                                     # [B,Hkv,G]
    probs = torch.exp(scores - m[..., None])
    probs = torch.where(valid, probs, torch.zeros_like(probs))
    l = probs.sum(dim=-1)
    out = torch.einsum("bkgw,bwkd->bkgd", probs.to(v_side.dtype), v_side)
    out = out.float() / torch.clamp(l[..., None], min=1e-30)
    return (out.reshape(b, h, dh).to(q.dtype), m.reshape(b, h),
            l.reshape(b, h))


def merge_attention(parts: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]],
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Combine flash-style partials over disjoint key sets: the softmax
    over the union is the l * e^(m - m*)-weighted mean of the parts."""
    m_tot = parts[0][1]
    for _, m, _ in parts[1:]:
        m_tot = torch.maximum(m_tot, m)
    num: torch.Tensor = 0.0
    den: torch.Tensor = 0.0
    for out, m, l in parts:
        wgt = l * torch.exp(m - m_tot)                          # [B, H]
        num = num + out.float() * wgt[..., None]
        den = den + wgt
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.to(dtype or parts[0][0].dtype)


def cached_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, lengths: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """Decode attention of q [B, 1, H, Dh] against a dense cache [B, S,
    Hkv, Dh], masked to each slot's ``lengths`` live keys (the new token's
    included) and, with ``window`` > 0, to the last ``window`` of them ->
    [B, 1, H, Dh] in q's dtype. fp8 caches are widened to q's dtype
    first; a wider or narrower cache keeps its dtype for the probabilities'
    product, as the JAX einsum does (the scores promote)."""
    b, t, h, dh = q.shape
    s, n_kv = cache_k.shape[1], cache_k.shape[2]
    cache_k, cache_v = upcast_kv(cache_k, cache_v, q.dtype)
    qg = _group_query(q, n_kv)
    dt = torch.promote_types(q.dtype, cache_k.dtype)
    scores = torch.einsum("bikgd,bjkd->bkgij", qg.to(dt),
                          cache_k.to(dt)).float() * _scale(dh)
    pos = torch.arange(s, device=q.device)[None, :]
    valid = pos < lengths[:, None]                              # [B, S]
    if window:
        valid &= pos >= (lengths[:, None] - window)
    probs = _softmax_masked(scores, valid[:, None, None, None, :])
    out = torch.einsum("bkgij,bjkd->bikgd", probs.to(cache_v.dtype), cache_v)
    return out.reshape(b, t, h, dh).to(q.dtype)


__all__: List[str] = ["NEG_INF", "FP8", "E5M2", "astype_kv", "is_fp8", "raw_view",
                      "upcast_kv", "causal_attention", "suffix_attention",
                      "window_decode_attention", "merge_attention",
                      "cached_attention"]
