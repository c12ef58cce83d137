"""Paged decode attention with an optional sliding window and flash stats
(port of ``ops/paged_attention.py``).

Pools are ``[N, P, Hkv*Dh]`` per layer, or the stacked ``[L*N, P,
Hkv*Dh]`` pool with ``layer``: page p of slot b lives at row ``layer*N +
page_table[b, p]``. Keys ``j < lengths[b]`` are valid (the count includes
the current token); with ``window`` > 0 only ``j >= lengths[b] - window``
too (Mistral v0.1's sliding window).

``paged_attention`` launches the hand-written CUDA kernel
(``csrc/paged_attention.cuh``, replacing the TPU kernel
``ops/paged_attention.py:_paged_attn_kernel``) for a CUDA tensor and runs
the plain version ``paged_attention_xla`` for a CPU tensor. The plain
version also takes the stacked layer offset, which the JAX XLA path
leaves to its callers, so that the tests hold both of the kernel's routes.

The kernel has two routes, chosen by ``paged_plan`` from the dtypes and
shapes alone. bf16 q over bf16 pools at G >= 3, and over e4m3 or e5m2
pools at every G, runs on the tensor cores: a block takes
up to 16 query heads of one KV head as the rows of one m16 tile, so each
K/V tile is read once for all of them (above 16 in sub-groups of 16).
Every other case runs on the CUDA cores, whose instances hold sub-groups
of 1, 2, 4 or 8 query heads (``subgroup``, flash-decode's rule), a KV
head's G heads cut into ``ceil(G / GS)`` of them, the rows past G dead.
Either way each slot's valid keys are cut into ``n_split`` runs of
``chunk`` keys (``paged_split``), one block per (slot, KV head,
sub-group, run). The tensor-core route merges the runs' flash partials in
the same launch (the last run of each to arrive), the CUDA-core route in
a second kernel; a call counts one launch under ``paged_attention`` and
its route (``paged_attention.mma`` or ``.simt``).
The outputs are ``torch.empty`` per call, so inside a CUDA graph capture
they come from the graph's memory pool; the split workspace and arrival
counters are the stream's (``_cuda.split_scratch``), as flash-decode's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import _cuda
from .attention import NEG_INF, _scale, is_fp8, raw_view, upcast_kv


# split sizing: aim for this many blocks per SM over the whole grid, and
# give no block fewer keys than _MIN_CHUNK (a run of keys is walked 64 at a
# time by the CUDA-core route's 8 warps)
_BLOCKS_PER_SM = 4
_MIN_CHUNK = 256
_CHUNK_ALIGN = 64
# the tensor-core route: bf16 q over bf16 pools at G >= _MMA_MIN_G, over
# e4m3 pools at every G (its fragments widened in registers, it measured
# faster there, but for Dh 256 at G 1 with a window, which no registered
# model runs: PERF.md); its runs hold at most
# _MMA_RUN_TILES of its staged tiles (8 KB of K rows: 16 to 64 keys), since
# a block's time is its chain of tiles (csrc/paged_attention.cuh)
_MMA_MIN_G = 3
_MMA_RUN_TILES = 16


def paged_split(b: int, n_kv_heads: int, max_keys: int, sms: int,
                min_chunk: int = _MIN_CHUNK,
                max_chunk: Optional[int] = None) -> Tuple[int, int]:
    """(n_split, chunk) of the kernel's grid: the most keys a slot can hold
    (``mp * page_size``, or ``window`` when smaller) cut into ``n_split``
    runs of ``chunk`` keys, with ``n_split * chunk >= max_keys``, no run
    much below ``min_chunk`` keys nor, where given, above ``max_chunk``.
    Chosen from shapes only, so the inline decode never reads the lengths
    back."""
    want = -(-_BLOCKS_PER_SM * sms // max(1, b * n_kv_heads))
    n_split = max(1, min(want, -(-max_keys // min_chunk)))
    if max_chunk:
        n_split = max(n_split, -(-max_keys // max_chunk))
    chunk = -(-max_keys // n_split)
    chunk = max(_CHUNK_ALIGN, -(-chunk // _CHUNK_ALIGN) * _CHUNK_ALIGN)
    return -(-max_keys // chunk), chunk


def subgroup(g: int) -> Tuple[int, int]:
    """(GS, n_sub) for a query-head group ``g``: the attention kernels'
    instance of GS query heads (the least of 1, 2, 4, 8 that holds ``g``,
    8 above it) and the sub-groups of GS rows a KV head's ``g`` heads
    take (``csrc/flash_decode.cuh`` and ``csrc/paged_attention.cuh``)."""
    gs = next(s for s in (1, 2, 4, 8) if s >= min(g, 8))
    return gs, -(-g // gs)


def _layer_pools(k_pages, v_pages, layer, n_pages_per_layer):
    """One layer's pools out of the stacked pool (views, no copy)."""
    if layer is None:
        return k_pages, v_pages
    n = n_pages_per_layer or k_pages.shape[0]
    return (k_pages[layer * n:(layer + 1) * n],
            v_pages[layer * n:(layer + 1) * n])


def paged_attention_xla(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor, *, n_kv_heads: int,
                        window: int = 0, with_stats: bool = False,
                        layer: Optional[int] = None,
                        n_pages_per_layer: int = 0):
    """Gather the slot's pages, then masked attention. q [B, H, Dh] ->
    [B, H, Dh] in q's dtype, or (out, m, l) with ``with_stats`` (a slot
    with no valid key carries m = NEG_INF and l = 0)."""
    k_pages, v_pages = _layer_pools(k_pages, v_pages, layer,
                                    n_pages_per_layer)
    b, h, dh = q.shape
    _n, p, _fused = k_pages.shape
    mp = page_table.shape[1]
    g = h // n_kv_heads
    table = page_table.long()
    # gather first (fp8 pages as bytes), then widen the gathered pages
    # only, as the JAX reference does
    k = raw_view(k_pages)[table].view(k_pages.dtype).reshape(
        b, mp * p, n_kv_heads, dh)
    v = raw_view(v_pages)[table].view(v_pages.dtype).reshape(
        b, mp * p, n_kv_heads, dh)
    k, v = upcast_kv(k, v, q.dtype)
    qg = q.reshape(b, n_kv_heads, g, dh)
    ct = torch.promote_types(q.dtype, k.dtype)      # jnp.einsum promotion
    scores = torch.einsum("bkgd,bskd->bkgs", qg.to(ct), k.to(ct)).float() \
        * _scale(dh)
    pos = torch.arange(mp * p, device=q.device)[None, :]
    valid = pos < lengths[:, None]
    if window:
        valid &= pos >= (lengths[:, None] - window)
    valid = valid[:, None, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)
    probs = torch.exp(scores - m[..., None])
    # zero-valid rows: m == NEG_INF turns every exp into 1; zero them so l
    # is a true denominator (merge weight 0)
    probs = torch.where(valid, probs, torch.zeros_like(probs))
    l = probs.sum(dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(v.dtype), v)
    out = out.float() / torch.clamp(l[..., None], min=1e-30)
    out = out.reshape(b, h, dh).to(q.dtype)
    if with_stats:
        return out, m.reshape(b, h), l.reshape(b, h)
    return out


class PagedPlan(NamedTuple):
    """A launch of the kernel: its route (``mma``: the tensor cores, else
    the CUDA cores), the query rows a block holds, the sub-groups a KV
    head's G query heads take, and the split grid."""
    mma: bool
    rows: int
    n_sub: int
    n_split: int
    chunk: int


def paged_plan(b: int, h: int, n_kv_heads: int, dh: int, max_keys: int,
               sms: int, q_dtype: torch.dtype, kv_dtype: torch.dtype,
               mma: Optional[bool] = None) -> PagedPlan:
    """The kernel's launch from shapes and dtypes alone. bf16 q over bf16
    pools at G >= 3, and over e4m3 or e5m2 pools at every G, runs on the
    tensor cores, one 16-row tile a KV head (the 8-row form up to G 8),
    sub-groups of 16 above G 16, in runs of at most 16 staged tiles; every
    other case on the CUDA cores in ``subgroup``'s sub-groups (bf16 pools
    at G 1 and 2 are not slower there: PERF.md).
    ``max_keys`` is the most valid keys a slot can have (the window, or the
    table's keys). ``mma`` given instead of the rule's route: the card tests
    and ``chip_smoke.py`` hold and time both routes."""
    g = h // n_kv_heads
    if mma is None:
        mma = q_dtype == torch.bfloat16 and (
            is_fp8(kv_dtype)
            or (kv_dtype == torch.bfloat16 and g >= _MMA_MIN_G))
    rows = (8 if g <= 8 else 16) if mma else subgroup(g)[0]
    n_sub = -(-g // rows)
    tile_keys = min(64, max(16, 4096 // dh))    # 8 KB of bf16 K rows
    n_split, chunk = paged_split(
        b, n_kv_heads * n_sub, max(1, max_keys), sms,
        max_chunk=_MMA_RUN_TILES * tile_keys if mma else None)
    return PagedPlan(mma, rows, n_sub, n_split, chunk)


def _check(name, q, k_pages, v_pages, page_table, lengths, n_kv_heads,
           window, layer, n_pages_per_layer) -> int:
    """The wrapper's checks; returns the stacked pool's first row of
    ``layer``."""
    b, h, dh = q.shape
    rows, _page_size, fused = k_pages.shape
    _cuda.require(q.device.type == "cuda",
                  f"{name}: unsupported device {q.device}")
    _cuda.require(n_kv_heads > 0 and h % n_kv_heads == 0,
                  f"{name}: H = {h} is not a multiple of Hkv = {n_kv_heads}")
    _cuda.require(dh in (32, 64, 128, 256),
                  f"{name}: head_dim {dh} must be 32, 64, 128 or 256")
    _cuda.require(fused == n_kv_heads * dh and v_pages.shape ==
                  k_pages.shape, f"{name}: pool shape {tuple(k_pages.shape)}"
                  f" does not match Hkv*Dh = {n_kv_heads * dh}")
    _cuda.require(k_pages.dtype == v_pages.dtype,
                  f"{name}: K and V pools differ in dtype")
    _cuda.require(page_table.dim() == 2 and page_table.shape[0] == b
                  and tuple(lengths.shape) == (b,),
                  f"{name}: page_table/lengths batch mismatch")
    _cuda.require(int(window) >= 0, f"{name}: window {window} < 0")
    n = n_pages_per_layer or rows
    base = 0 if layer is None else int(layer) * n
    _cuda.require(0 <= base and base + n <= rows,
                  f"{name}: layer {layer} outside the stacked pool")
    _cuda.require_cuda(name, q, k_pages, v_pages, page_table, lengths)
    _cuda.require_int32(name, page_table, lengths)
    return base


def _max_keys(k_pages, page_table, window) -> int:
    max_keys = page_table.shape[1] * k_pages.shape[1]
    return min(max_keys, int(window)) if window else max_keys


def paged_attention_launch(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, plan: PagedPlan, *,
                           n_kv_heads: int, window: int = 0,
                           with_stats: bool = False,
                           layer: Optional[int] = None,
                           n_pages_per_layer: int = 0):
    """The CUDA kernel on a given ``plan``: ``paged_attention_cuda``
    passes ``paged_plan``'s; the card tests and ``chip_smoke.py`` pass the
    other route's to hold and time both."""
    name = "paged_attention"
    base = _check(name, q, k_pages, v_pages, page_table, lengths, n_kv_heads,
                  window, layer, n_pages_per_layer)
    b, h, dh = q.shape
    _cuda.require(plan.n_split * plan.chunk >=
                  _max_keys(k_pages, page_table, window),
                  f"{name}: {plan.n_split} runs of {plan.chunk} keys do "
                  "not cover a slot")
    out = torch.empty_like(q)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    ws, cnt = _cuda.split_scratch(q.device, b * h * plan.n_split * (dh + 2),
                                  b * n_kv_heads * plan.n_sub)
    err = _cuda.lib().die_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), ws.data_ptr(), cnt.data_ptr(),
        b, h, n_kv_heads, dh, k_pages.shape[1], page_table.shape[1],
        int(window), plan.n_split, plan.chunk, plan.rows, int(plan.mma),
        base, _cuda.dtype_code(q.dtype),
        _cuda.dtype_code(k_pages.dtype, pool=True),
        _cuda.stream_ptr(q.device))
    _cuda.check(err, f"{name} ({'mma' if plan.mma else 'simt'})")
    _cuda.count_launch(f"{name}.{'mma' if plan.mma else 'simt'}",
                       *_cuda.pool_instance(name, k_pages.dtype))
    if with_stats:
        return out, m, l
    return out


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         lengths: torch.Tensor, *, n_kv_heads: int,
                         window: int = 0, with_stats: bool = False,
                         layer: Optional[int] = None,
                         n_pages_per_layer: int = 0):
    """The CUDA kernel: q [B, H, Dh] (bf16 or fp32), pools in bf16, fp32
    e4m3 or e5m2 (the fp8 instances, counted also as
    ``paged_attention.fp8`` or ``paged_attention.e5m2``),
    int32 ``page_table``/``lengths`` -> out [B, H, Dh] in q's dtype, or
    (out, m, l) with ``with_stats``. Raises on what the kernel does not
    take."""
    _check("paged_attention", q, k_pages, v_pages, page_table, lengths,
           n_kv_heads, window, layer, n_pages_per_layer)
    b, h, dh = q.shape
    plan = paged_plan(b, h, n_kv_heads, dh,
                      _max_keys(k_pages, page_table, window),
                      _cuda.sm_count(q.device.index), q.dtype, k_pages.dtype)
    return paged_attention_launch(
        q, k_pages, v_pages, page_table, lengths, plan,
        n_kv_heads=n_kv_heads, window=window, with_stats=with_stats,
        layer=layer, n_pages_per_layer=n_pages_per_layer)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, *, n_kv_heads: int,
                    window: int = 0, with_stats: bool = False,
                    layer: Optional[int] = None, n_pages_per_layer: int = 0):
    """CUDA tensors launch the kernel (or raise); CPU tensors take the
    plain version."""
    kw = dict(n_kv_heads=n_kv_heads, window=window, with_stats=with_stats,
              layer=layer, n_pages_per_layer=n_pages_per_layer)
    if q.device.type == "cpu":
        return paged_attention_xla(q, k_pages, v_pages, page_table, lengths,
                                   **kw)
    return paged_attention_cuda(q, k_pages, v_pages, page_table, lengths,
                                **kw)
