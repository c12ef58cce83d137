"""Ragged mixed-batch attention: decode rows and prefill-chunk rows in one
launch per layer, with each row's fresh K/V written into its pages (port
of ``ops/ragged_attention.py``).

Row r carries ``q_lens[r]`` fresh queries (0: an inert row, 1: a decode
row, more: a prefill chunk) at absolute positions ``ctx_lens[r] + i``, and
``ctx_lens[r]`` context tokens already in its pages. Context key j is
visible iff ``j < ctx_lens[r]``; fresh key j is visible to query i iff
``j <= i < q_lens[r]``; output rows ``i >= q_lens[r]`` are 0. The fresh
K/V, cast to the pool dtype, lands at positions ``[ctx_lens[r],
ctx_lens[r] + q_lens[r])`` of the row's pages, straddling pages through
the table. A key a query may not see weighs exactly 0 (the TPU kernel's
``_ragged_block`` zeroes its probability), so a query whose visible keys
all score -inf gets 0.

``ragged_attention`` launches the hand-written CUDA kernel
(``csrc/ragged_attention.cuh``, replacing the TPU kernel
``ops/ragged_attention.py:_ragged_kernel``) for a CUDA tensor and runs
the plain version for a CPU tensor. The instance follows the dtypes
(``ragged_instance``): bf16 q over bf16, e4m3 or e5m2 pools runs the
tensor cores (``mma``), every other pair the CUDA cores (``simt``); an fp8
pool (counted also as ``ragged_attention.fp8`` for e4m3,
``ragged_attention.e5m2`` for e5m2) takes the fresh K/V rounded with the
JAX cast (``astype_kv``), attends to those bits and writes them; there
the tensor-core instance is warp specialised (a producer warpgroup widens
the fp8 tiles and rounds the fresh ones for the mma warps).
Any query-head group ``g = H / Hkv`` is taken, as the JAX launcher
takes it: a tile holds ``floor(rows / g)`` queries (``ragged_group``,
``ragged_plan``), the rows past them dead; above 64 heads a KV head's
heads are cut into sub-groups of 64, each its own items.
The launch is sized from the shapes (``ragged_plan``), never from the
lengths, which live on the card; there the tensor-core instance orders
its work by the lengths (``ragged_schedule`` is the same rule on the
host). Both update the pools IN PLACE (the
JAX function donated them and returned new ones); they still return
them, so call sites read as in the JAX package.

Stacked pools: the engine passes the whole ``[L*N, P, Hkv*Dh]`` pool and
``layer``; page p of row r lives at row ``layer*N + page_table[r, p]``.
Preconditions (``engine/paged_kv.py:ensure_backed``): rows own disjoint
pages, and every row's pages cover ``ctx_lens[r] + q_lens[r]`` tokens —
the kernel writes blindly.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from . import _cuda
from .attention import NEG_INF, _scale, astype_kv, is_fp8, raw_view


def _ragged_softmax(q, k_ctx, v_ctx, n_ctx, k_suf, v_suf, suffix_lens):
    """``suffix_attention``'s attention (q [R, Ts, H, Dh], context and
    fresh K/V in q's dtype) with the TPU kernel's rule for keys a query
    may not see (``ops/ragged_attention.py:_ragged_block``): the row max
    starts at NEG_INF and their probabilities are zeroed before they are
    summed or multiplied, and the sum is floored at 1e-30. A query whose
    visible keys all score -inf then gives 0, as the TPU kernel and the
    CUDA kernel do, where ``suffix_attention`` averages the masked keys'
    V. On finite inputs the result is ``suffix_attention``'s bit for bit:
    there a masked key's exp(-1e30 - m) is already 0 and the sum is at
    least 1."""
    r, ts, h, dh = q.shape
    tc, hkv = k_ctx.shape[1], k_ctx.shape[2]
    qg = q.reshape(r, ts, hkv, h // hkv, dh)
    k_all = torch.cat([k_ctx, k_suf], dim=1)
    v_all = torch.cat([v_ctx, v_suf], dim=1)
    scores = torch.einsum("bikgd,bjkd->bkgij", qg, k_all).float() * \
        _scale(dh)
    i = torch.arange(ts, device=q.device)[:, None]
    j = torch.arange(tc + ts, device=q.device)[None, :]
    suf_j = j - tc
    mask = (((j < tc) & (j < n_ctx[:, None, None]))
            | ((j >= tc) & (suf_j <= i)
               & (suf_j < suffix_lens[:, None, None])))[:, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = torch.clamp(scores.amax(dim=-1, keepdim=True), min=NEG_INF)
    probs = torch.where(mask, torch.exp(scores - m),
                        torch.zeros_like(scores))
    probs = probs / torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgij,bjkd->bikgd", probs.to(v_all.dtype), v_all)
    return out.reshape(r, ts, h, dh).to(q.dtype)


def ragged_attention_plain(
    q: torch.Tensor,            # [R, Qmax, H, Dh]
    k_pages: torch.Tensor,      # [N, P, Hkv*Dh] (or stacked [L*N, ...])
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # [R, MP] int32
    ctx_lens: torch.Tensor,     # [R] tokens already in the row's pages
    q_lens: torch.Tensor,       # [R] fresh queries per row
    fresh_k: torch.Tensor,      # [R, Qmax, Hkv, Dh] this step's K/V
    fresh_v: torch.Tensor,
    *,
    n_kv_heads: int,
    layer: Optional[int] = None,
    n_pages_per_layer: int = 0,
):
    """The JAX reference ``ragged_attention_xla`` on one layer of the
    stacked pools: round the fresh K/V through the pool dtype, gather
    each row's table, attend (``_ragged_softmax``: ``suffix_attention``
    with the TPU kernel's rule for invisible keys, so that a query whose
    visible keys all score -inf gets 0, as from the TPU and CUDA kernels),
    zero rows ``i >= q_len``, write the fresh K/V into the pages. Returns
    (out, k_pages, v_pages)."""
    if layer is not None:
        n = n_pages_per_layer or k_pages.shape[0]
        kp = k_pages[layer * n:(layer + 1) * n]           # views, no copy
        vp = v_pages[layer * n:(layer + 1) * n]
    else:
        kp, vp = k_pages, v_pages
    r, qmax, h, dh = q.shape
    n, p, fused = kp.shape
    mp = page_table.shape[1]
    dev = q.device
    ctx = ctx_lens.to(device=dev, dtype=torch.int64)
    ql = q_lens.to(device=dev, dtype=torch.int64)
    table = page_table.to(device=dev, dtype=torch.int64)
    # the kernel attends to the same bits it writes back
    fk = astype_kv(fresh_k, kp.dtype)
    fv = astype_kv(fresh_v, vp.dtype)
    ctx_k = raw_view(kp)[table].view(kp.dtype).reshape(r, mp * p,
                                                         n_kv_heads, dh)
    ctx_v = raw_view(vp)[table].view(vp.dtype).reshape(r, mp * p,
                                                         n_kv_heads, dh)
    out = _ragged_softmax(q, ctx_k.to(q.dtype), ctx_v.to(q.dtype), ctx,
                          fk.to(q.dtype), fv.to(q.dtype), ql)
    local = torch.arange(qmax, device=dev)[None, :]
    row_valid = local < ql[:, None]                               # [R, Qmax]
    out = torch.where(row_valid[..., None, None], out,
                      torch.zeros_like(out)).to(q.dtype)
    # fresh K/V -> positions [ctx, ctx + q_len) of the row's pages
    pos = local + ctx[:, None]
    logical = torch.clamp(pos // p, max=mp - 1)
    phys = torch.gather(table, 1, logical)
    flat = (phys * p + pos % p)[row_valid]
    raw_view(kp).view(n * p, fused)[flat] = raw_view(fk).reshape(
        r, qmax, fused)[row_valid]
    raw_view(vp).view(n * p, fused)[flat] = raw_view(fv).reshape(
        r, qmax, fused)[row_valid]
    return out, k_pages, v_pages


# (query, head) rows of one block, by instance, and the (row, query tile)
# pairs and rows the tensor-core instance ranks on the card
# (csrc/ragged_attention.cuh)
ROWS_PER_BLOCK = {"mma": 128, "simt": 64}
MMA_MAX_PAIRS, MMA_MAX_ROWS = 512, 256


def ragged_instance(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> str:
    """The kernel instance for these dtypes: ``mma`` (tensor cores) for
    bf16 q over bf16, e4m3 or e5m2 pools (both fp8 formats are exact in
    bf16), ``simt`` (CUDA cores) for every other pair."""
    if q_dtype == torch.bfloat16 and (kv_dtype == torch.bfloat16
                                      or is_fp8(kv_dtype)):
        return "mma"
    return "simt"


# the most query heads of one KV head an item holds
MAX_GROUP = 64


def ragged_group(h: int, hkv: int) -> Tuple[int, int]:
    """(gs, n_sub): the query heads an item holds (``g = h // hkv`` up to
    ``MAX_GROUP``) and the sub-groups a KV head's ``g`` heads take; the
    kernel's items run over ``hkv * n_sub`` such virtual heads."""
    g = h // hkv
    gs = min(g, MAX_GROUP)
    return gs, -(-g // gs)


def ragged_plan(r: int, qmax: int, h: int, hkv: int, instance: str,
                sms: int) -> Tuple[int, int, int]:
    """(queries per tile, query tiles per row, blocks) of the kernel's
    launch. A tile is ``ROWS_PER_BLOCK[instance]`` (query, head) rows, the
    ``gs`` heads (``ragged_group``) of each of its ``floor(rows / gs)``
    queries; an item is a (row, virtual KV head, query tile). ``simt``
    runs one block an item; ``mma`` is persistent, one block an SM
    (``sms``), the blocks taking the items in ``ragged_schedule`` order."""
    gs, n_sub = ragged_group(h, hkv)
    tq = ROWS_PER_BLOCK[instance] // gs
    n_tiles = -(-qmax // tq)
    items = r * hkv * n_sub * n_tiles
    return tq, n_tiles, items if instance == "simt" else min(items, sms)


def _pair_cost(p: int, r: int, n_tiles: int, tq: int, g: int, q_lens,
               ctx_lens, keys: int, max_ctx: int) -> int:
    """The kernel's work estimate of (row, query tile) pair ``p``: its key
    tiles, twice when more than 64 of its (query, head) rows are live; 0
    when no query is live."""
    row = r - 1 - p % r
    q0 = (n_tiles - 1 - p // r) * tq
    ql = int(q_lens[row])
    if q0 >= ql:
        return 0
    ctx = min(int(ctx_lens[row]), max_ctx)
    fresh_end = min(q0 + tq, ql)
    tiles = -(-ctx // keys) + -(-fresh_end // keys)
    return 2 * tiles if (fresh_end - q0) * g > 64 else tiles


def ragged_schedule(q_lens, ctx_lens, qmax: int, h: int, hkv: int, dh: int,
                    page_size: int, mp: int, n_blocks: int
                    ) -> List[List[Tuple[int, int, int, bool]]]:
    """The tensor-core instance's items, (row, virtual KV head, query
    tile, live) (the virtual head ``v`` is KV head ``v // n_sub``'s
    sub-group ``v % n_sub``; one per KV head up to 64 query heads),
    as each of its ``n_blocks`` persistent blocks takes them (the card
    computes this from the lengths; this host version is the rule the
    tests hold): the (row, query tile) pairs ranked by ``_pair_cost``,
    heaviest first, ties in ``ragged_block`` order, their KV heads
    together, dealt to the blocks in a snake (round k forwards when k is
    even, backwards when odd); dead pairs rank last. Past
    ``MMA_MAX_PAIRS`` pairs or ``MMA_MAX_ROWS`` rows, ``ragged_block``
    order round-robin."""
    r = len(q_lens)
    g, n_sub = ragged_group(h, hkv)
    vh = hkv * n_sub                     # the items' (virtual) KV heads
    tq, n_tiles, _ = ragged_plan(r, qmax, h, hkv, "mma", n_blocks)
    keys = 64 if dh <= 128 else 32
    n_pairs = r * n_tiles
    costs = [_pair_cost(p, r, n_tiles, tq, g, q_lens, ctx_lens, keys,
                        mp * page_size) for p in range(n_pairs)]
    out: List[List[Tuple[int, int, int, bool]]] = [
        [] for _ in range(n_blocks)]

    def item(i: int) -> Tuple[int, int, int, bool]:
        row, kh, tile = ragged_block(i, r, vh, n_tiles)
        return row, kh, tile, costs[i // vh] > 0

    if r > MMA_MAX_ROWS or n_pairs > MMA_MAX_PAIRS:
        for i in range(n_pairs * vh):
            out[i % n_blocks].append(item(i))
        return out
    order = sorted(range(n_pairs), key=lambda p: (-costs[p], p))
    for i in range(n_pairs * vh):
        k, pos = divmod(i, n_blocks)
        b = pos if k % 2 == 0 else n_blocks - 1 - pos
        out[b].append(item(order[i // vh] * vh + i % vh))
    return out


def ragged_block(item: int, r: int, hkv: int, n_tiles: int
                 ) -> Tuple[int, int, int]:
    """(row, KV head, query tile) of item ``item`` of the ``r * hkv *
    n_tiles`` items, as the kernel's ``block_of`` reads it: the highest
    query tile of every row first, then the next, the rows from the last
    (the engine's prefill rows follow its decode rows) to the first. The
    CUDA-core instance runs a block an item in this order; the
    tensor-core instance breaks its ranking's ties by it."""
    per_tile = r * hkv
    i, rem = divmod(item, per_tile)
    return r - 1 - rem // hkv, rem % hkv, n_tiles - 1 - i


def ragged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    ctx_lens: torch.Tensor,
    q_lens: torch.Tensor,
    fresh_k: torch.Tensor,
    fresh_v: torch.Tensor,
    *,
    n_kv_heads: int,
    layer: Optional[int] = None,
    n_pages_per_layer: int = 0,
):
    """(out [R, Qmax, H, Dh] in q's dtype, k_pages, v_pages), the pools
    written in place. CUDA tensors launch the kernel (or raise); CPU
    tensors take the plain version."""
    if q.device.type == "cpu":
        return ragged_attention_plain(
            q, k_pages, v_pages, page_table, ctx_lens, q_lens, fresh_k,
            fresh_v, n_kv_heads=n_kv_heads, layer=layer,
            n_pages_per_layer=n_pages_per_layer)
    name = "ragged_attention"
    _cuda.require(q.device.type == "cuda", f"{name}: unsupported device "
                  f"{q.device}")
    _cuda.require(q.dim() == 4, f"{name}: q must be [R, Qmax, H, Dh]")
    r, qmax, h, dh = q.shape
    rows, page_size, fused = k_pages.shape
    _cuda.require_cuda(name, q, k_pages, v_pages, page_table, ctx_lens,
                       q_lens, fresh_k, fresh_v)
    _cuda.require_int32(name, page_table, ctx_lens, q_lens)
    _cuda.require(n_kv_heads > 0 and h % n_kv_heads == 0,
                  f"{name}: H = {h} is not a multiple of Hkv = {n_kv_heads}")
    _cuda.require(dh % 32 == 0 and dh // 32 in (1, 2, 4, 8),
                  f"{name}: head_dim {dh} must be 32, 64, 128 or 256")
    _cuda.require(fused == n_kv_heads * dh and v_pages.shape ==
                  k_pages.shape and k_pages.dtype == v_pages.dtype,
                  f"{name}: pool shape {tuple(k_pages.shape)} does not "
                  f"match Hkv*Dh = {n_kv_heads * dh}")
    _cuda.require(tuple(fresh_k.shape) == (r, qmax, n_kv_heads, dh) and
                  fresh_v.shape == fresh_k.shape and
                  fresh_k.dtype == q.dtype == fresh_v.dtype,
                  f"{name}: fresh K/V must be [R, Qmax, Hkv, Dh] in q's "
                  "dtype")
    _cuda.require(page_table.dim() == 2 and page_table.shape[0] == r and
                  ctx_lens.shape == (r,) and q_lens.shape == (r,),
                  f"{name}: page_table/ctx_lens/q_lens row mismatch")
    n = n_pages_per_layer or rows
    base = 0 if layer is None else int(layer) * n
    _cuda.require(0 <= base and base + n <= rows,
                  f"{name}: layer {layer} outside the stacked pool")
    inst = ragged_instance(q.dtype, k_pages.dtype)
    if inst == "mma" and is_fp8(k_pages.dtype):
        # the fp8 instance copies a page's rows in boxes of the largest
        # power of two up to its tile's keys that divides the page size,
        # landing 128-byte aligned (csrc/ragged_attention.cuh launch_fp8)
        box = min(64 if dh <= 128 else 32, page_size & -page_size)
        _cuda.require(box * dh % 128 == 0,
                      f"{name}: page size {page_size} gives {box}-row "
                      f"copies of {dh} bytes, not whole 128-byte pieces")
    _, n_tiles, grid = ragged_plan(r, qmax, h, n_kv_heads, inst,
                                   _cuda.sm_count(q.device.index))
    out = torch.empty_like(q)
    err = _cuda.lib().die_ragged_attention(
        q.data_ptr(), fresh_k.data_ptr(), fresh_v.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        ctx_lens.data_ptr(), q_lens.data_ptr(), out.data_ptr(),
        r, qmax, h, n_kv_heads, dh, page_size, page_table.shape[1],
        n_tiles, grid, base, _cuda.dtype_code(q.dtype),
        _cuda.dtype_code(k_pages.dtype, pool=True),
        _cuda.stream_ptr(q.device))
    _cuda.check(err, name)
    _cuda.count_launch(f"{name}.{inst}",
                       *_cuda.pool_instance(name, k_pages.dtype))
    return out, k_pages, v_pages
