"""Flash-decode attention: paged prefix plus the chunk's side window, in
one kernel per layer (port of ``ops/flash_decode.py``).

``flash_decode_attention`` launches the hand-written CUDA kernel
(``csrc/flash_decode.cu``, replacing the TPU kernel
``ops/flash_decode.py:_flash_decode_kernel``) for a CUDA tensor and runs
the plain version for a CPU tensor. The plain version is the JAX
package's reference composition ``flash_decode_attention_xla``: paged
prefix attention with flash stats, side-window attention, merged.

``flash_decode_attention_fw`` is the writeback variant (replacing
``_flash_decode_fw_kernel``): this step's fresh K/V comes as its own
operand, is attended as one extra key and lands in the side window in
place (the JAX function donated the side buffers and returned new ones).

Stacked pools: the engine passes the whole ``[L*N, P, Hkv*Dh]`` pool and
``layer``; page p of slot b lives at row ``layer*N + page_table[b, p]``.

Both kernels take any query-head group ``G = H / Hkv``, as the JAX
launchers do: a KV head's G query heads are cut into sub-groups of the
kernels' 1, 2, 4 or 8-row instances, or 16 rows on the tensor cores at
head_dim 128 (``decode_subgroup``; Qwen2's G = 7 is one sub-group of 8,
its last row dead; G 9-16 one of 16, which reads each K/V tile once for
all of them), one block a sub-group. Both kernels cut each slot's prefix
into ``n_split`` runs of ``chunk`` keys (``decode_plan``: ``paged_split``
on ``mp * page_size`` keys: shapes only, the lengths
are never read back), one block per (slot, KV head, run); the last run also
takes the side window. The runs' fp32 partials merge in the same launch
(the last block of each (slot, KV head) to finish merges them), so a call
is one device launch and counts one under the kernel's name (and under
``<kernel>.rows16`` on the 16-row instance). bf16 q over bf16, e4m3 or
e5m2 pools runs on the tensor cores, every other dtype pair
on the CUDA cores. fp8 pools (the fp8 instances, counted also as
``<kernel>.fp8`` for e4m3 and ``<kernel>.e5m2`` for e5m2) are widened in
the kernel, exactly; the side window and the fresh row stay in q's dtype,
as in JAX.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from . import _cuda
from .attention import is_fp8, merge_attention, window_decode_attention
from .paged_attention import paged_attention_xla, paged_split, subgroup

# the shortest run of prefix keys a block takes (paged_split's
# min_chunk): a lone slot at 8 KV heads gets 32 runs, not the paged
# kernel's 8, where a block's time is mostly its fixed chain of steps
MIN_CHUNK = 64
# ... on the 16-row instance over fp8 pools: four of its 64-key tiles (at
# G 12 and 16, B 8, Hkv 4, runs of two measured no faster than the two
# 8-row sub-groups they replace: PERF.md)
ROWS16_FP8_MIN_CHUNK = 256

def flash_decode_attention_plain(
    q: torch.Tensor,            # [B, H, Dh]
    k_pages: torch.Tensor,      # [N, P, Hkv*Dh] (or stacked [L*N, ...])
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # [B, MP] int32
    prefix_lens: torch.Tensor,  # [B] frozen prefix length per slot
    side_k: torch.Tensor,       # [B, W, Hkv, Dh]
    side_v: torch.Tensor,
    n_side: torch.Tensor,       # [B] valid side entries (incl. this step's)
    *,
    n_kv_heads: int,
    layer: Optional[int] = None,
    n_pages_per_layer: int = 0,
) -> torch.Tensor:
    """Reference composition: paged prefix (with stats) ⊕ side window."""
    prefix = paged_attention_xla(q, k_pages, v_pages, page_table,
                                 prefix_lens, n_kv_heads=n_kv_heads,
                                 with_stats=True, layer=layer,
                                 n_pages_per_layer=n_pages_per_layer)
    window = window_decode_attention(q, side_k, side_v, n_side)
    return merge_attention([prefix, window], dtype=q.dtype)


def _check_decode(name, q, k_pages, v_pages, page_table, prefix_lens,
                  side_k, side_v, *, n_kv_heads, layer, n_pages_per_layer):
    """Shared wrapper checks of the two flash-decode kernels; returns the
    stacked pool's first row of ``layer``."""
    b, h, dh = q.shape
    rows, _page_size, fused = k_pages.shape
    w = side_k.shape[1]
    _cuda.require(q.device.type == "cuda", f"{name}: unsupported device "
                  f"{q.device}")
    _cuda.require(n_kv_heads > 0 and h % n_kv_heads == 0,
                  f"{name}: H = {h} is not a multiple of Hkv = {n_kv_heads}")
    _cuda.require(dh % 32 == 0 and dh // 32 in (1, 2, 4, 8),
                  f"{name}: head_dim {dh} must be 32, 64, 128 or 256")
    _cuda.require(fused == n_kv_heads * dh and v_pages.shape ==
                  k_pages.shape, f"{name}: pool shape {tuple(k_pages.shape)}"
                  f" does not match Hkv*Dh = {n_kv_heads * dh}")
    _cuda.require(tuple(side_k.shape) == (b, w, n_kv_heads, dh) and
                  side_v.shape == side_k.shape,
                  f"{name}: side window shape {tuple(side_k.shape)}")
    _cuda.require(side_k.dtype == q.dtype == side_v.dtype and
                  k_pages.dtype == v_pages.dtype,
                  f"{name}: side window must be in q's dtype")
    _cuda.require(page_table.dim() == 2 and page_table.shape[0] == b
                  and prefix_lens.shape == (b,),
                  f"{name}: page_table/prefix_lens batch mismatch")
    # cp.async copies 16-byte pieces of each K/V and side row
    _cuda.require(dh * k_pages.element_size() % 16 == 0 and
                  dh * q.element_size() % 16 == 0,
                  f"{name}: rows of head_dim {dh} are not whole 16-byte "
                  "pieces")
    n = n_pages_per_layer or rows
    base = 0 if layer is None else int(layer) * n
    _cuda.require(0 <= base and base + n <= rows,
                  f"{name}: layer {layer} outside the stacked pool")
    return base


def decode_subgroup(g: int, dh: int, q_dtype: torch.dtype,
                    kv_dtype: torch.dtype) -> Tuple[int, int]:
    """(GS, n_sub) of the kernels' launch for a query-head group ``g``:
    ``subgroup``'s 1, 2, 4 or 8 rows, but 16 above 8 where the tensor
    cores run (bf16 q over bf16, e4m3 or e5m2 pools) at head_dim 128, the
    only width with a 16-row instance (``csrc/common.cuh``
    subgroup_rows)."""
    mma = q_dtype == torch.bfloat16 and (kv_dtype == torch.bfloat16
                                         or is_fp8(kv_dtype))
    if mma and dh == 128 and g > 8:
        return 16, -(-g // 16)
    return subgroup(g)


def flash_decode_split(b: int, n_kv_heads: int, page_size: int, mp: int,
                       device: torch.device, n_sub: int = 1,
                       min_chunk: int = MIN_CHUNK) -> Tuple[int, int]:
    """(n_split, chunk) of the kernels' grid: the most prefix keys a slot
    can hold (``mp * page_size``) over ``paged_split``, for ``n_sub``
    query-head sub-groups a KV head (``decode_subgroup``), runs of at
    least ``min_chunk`` keys."""
    return paged_split(b, n_kv_heads * n_sub, max(1, mp * page_size),
                       _cuda.sm_count(device.index), min_chunk=min_chunk)


def decode_plan(b: int, h: int, n_kv_heads: int, dh: int, page_size: int,
                mp: int, device: torch.device, q_dtype: torch.dtype,
                kv_dtype: torch.dtype) -> Tuple[int, int, int, int]:
    """(GS, n_sub, n_split, chunk) of a launch of either kernel: the
    sub-groups (``decode_subgroup``) and the split grid
    (``flash_decode_split``; runs of ``ROWS16_FP8_MIN_CHUNK`` keys at
    least on the 16-row instance over fp8 pools)."""
    gs, n_sub = decode_subgroup(h // n_kv_heads, dh, q_dtype, kv_dtype)
    min_chunk = (ROWS16_FP8_MIN_CHUNK if gs == 16 and is_fp8(kv_dtype)
                 else MIN_CHUNK)
    return (gs, n_sub) + flash_decode_split(b, n_kv_heads, page_size, mp,
                                            device, n_sub, min_chunk)


def fp8_tile_keys(dh: int) -> int:
    """Keys an e4m3 K (and V) tile of the tensor-core path holds: 8 KB of
    one-byte rows, 16 to 64 of them (``csrc/flash_decode.cuh`` Tile8): 64
    up to Dh 128, 32 at Dh 256, twice a bf16 tile's. ``flash_decode_split``'s
    runs are whole multiples of it (``paged_split`` aligns them to 64)."""
    return min(64, max(16, 8192 // dh))


def fp8_fragment_dims(dh: int) -> Tuple[List[int], List[int]]:
    """The head-dim orders of the e4m3 fragments (``csrc/common.cuh``
    kdim, vdim): ``k[16 kk + j]`` is the dim that k index j of K-step kk
    of S = Q K^T reads (lane quad t reads dims kdim(kk, t) .. + 3 as k
    pairs 2t, 2t + 1 and 2t + 8, 2t + 9); ``v[4 (8 q + g) + j]`` is the dim
    that word q of lane row g holds as its byte j (its V^T rows and output
    columns). Both are permutations of ``range(dh)``."""
    def kdim(kk: int, t: int) -> int:
        if dh == 32:
            return 8 * t + 4 * kk
        if dh == 64:
            return 16 * t + 4 * kk
        return 16 * (2 * t + ((kk >> 2) & 1) + 8 * (kk >> 3)) + 4 * (kk & 3)

    def vdim(g: int, q: int) -> int:
        if dh == 32:
            return 4 * g
        if dh == 64:
            return 8 * g + 4 * q
        return 128 * (q >> 2) + 16 * g + 4 * (q & 3)

    k = [0] * dh
    for kk in range(dh // 16):
        for t in range(4):
            d = kdim(kk, t)
            k[16 * kk + 2 * t:16 * kk + 2 * t + 2] = [d, d + 1]
            k[16 * kk + 8 + 2 * t:16 * kk + 8 + 2 * t + 2] = [d + 2, d + 3]
    v = [vdim(g, q) + j for q in range(dh // 32) for g in range(8)
         for j in range(4)]
    return k, v


def _launch(name, fn, q, k_pages, page_table, side_k, n_kv_heads, base,
            pointers):
    """Size the split grid, take the scratch, launch ``fn`` and count."""
    b, h, dh = q.shape
    page_size, mp = k_pages.shape[1], page_table.shape[1]
    gs, n_sub, n_split, chunk = decode_plan(
        b, h, n_kv_heads, dh, page_size, mp, q.device, q.dtype,
        k_pages.dtype)
    ws, cnt = _cuda.split_scratch(q.device, b * h * n_split * (dh + 2),
                       b * n_kv_heads * n_sub)
    out = torch.empty_like(q)
    err = fn(*pointers, out.data_ptr(), ws.data_ptr(), cnt.data_ptr(),
             b, h, n_kv_heads, dh, page_size, mp, side_k.shape[1], n_split,
             chunk, base, _cuda.dtype_code(q.dtype),
             _cuda.dtype_code(k_pages.dtype, pool=True),
             _cuda.stream_ptr(q.device))
    _cuda.check(err, name)
    _cuda.count_launch(*_cuda.pool_instance(name, k_pages.dtype),
                       *((f"{name}.rows16",) if gs == 16 else ()))
    return out


def flash_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    prefix_lens: torch.Tensor,
    side_k: torch.Tensor,
    side_v: torch.Tensor,
    n_side: torch.Tensor,
    *,
    n_kv_heads: int,
    layer: Optional[int] = None,
    n_pages_per_layer: int = 0,
) -> torch.Tensor:
    """[B, H, Dh] attention output in q's dtype. CUDA tensors launch the
    kernel (or raise); CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_decode_attention_plain(
            q, k_pages, v_pages, page_table, prefix_lens, side_k, side_v,
            n_side, n_kv_heads=n_kv_heads, layer=layer,
            n_pages_per_layer=n_pages_per_layer)
    name = "flash_decode"
    b = q.shape[0]
    base = _check_decode(name, q, k_pages, v_pages, page_table, prefix_lens,
                         side_k, side_v, n_kv_heads=n_kv_heads, layer=layer,
                         n_pages_per_layer=n_pages_per_layer)
    _cuda.require_cuda(name, q, k_pages, v_pages, page_table, prefix_lens,
                       side_k, side_v, n_side)
    _cuda.require_int32(name, page_table, prefix_lens, n_side)
    _cuda.require(n_side.shape == (b,), f"{name}: n_side batch mismatch")
    return _launch(name, _cuda.lib().die_flash_decode, q, k_pages,
                   page_table, side_k, n_kv_heads, base, (
                       q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                       page_table.data_ptr(), prefix_lens.data_ptr(),
                       side_k.data_ptr(), side_v.data_ptr(),
                       n_side.data_ptr()))


def flash_decode_attention_fw_plain(
    q: torch.Tensor,            # [B, H, Dh]
    k_pages: torch.Tensor,      # [N, P, Hkv*Dh] (or stacked [L*N, ...])
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # [B, MP] int32
    prefix_lens: torch.Tensor,  # [B] frozen prefix length per slot
    side_k: torch.Tensor,       # [B, W, Hkv, Dh], written in place
    side_v: torch.Tensor,
    fresh_k: torch.Tensor,      # [B, 1, Hkv, Dh] this step's K/V
    fresh_v: torch.Tensor,
    side_idx: torch.Tensor,     # [B] side column this step writes
    active: torch.Tensor,       # [B] bool/int: inactive slots don't write
    *,
    n_kv_heads: int,
    layer: Optional[int] = None,
    n_pages_per_layer: int = 0,
):
    """Reference composition: the one-hot side write of the active slots
    (``side_idx < W``), then flash-decode with ``n_side = side_idx +
    active`` — what the JAX non-fw branch of ``forward_decode_window``
    computes. Returns (out, side_k, side_v)."""
    b, w = side_k.shape[:2]
    act = active.to(torch.bool)
    onehot = ((torch.arange(w, device=q.device)[None, :]
               == side_idx[:, None]) & act[:, None])[:, :, None, None]
    side_k.copy_(torch.where(onehot, fresh_k.reshape(b, 1, *side_k.shape[2:])
                             .to(side_k.dtype), side_k))
    side_v.copy_(torch.where(onehot, fresh_v.reshape(b, 1, *side_v.shape[2:])
                             .to(side_v.dtype), side_v))
    n_side = (side_idx + act.to(side_idx.dtype)).to(torch.int32)
    out = flash_decode_attention_plain(
        q, k_pages, v_pages, page_table, prefix_lens, side_k, side_v, n_side,
        n_kv_heads=n_kv_heads, layer=layer,
        n_pages_per_layer=n_pages_per_layer)
    return out, side_k, side_v


def flash_decode_attention_fw(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    prefix_lens: torch.Tensor,
    side_k: torch.Tensor,
    side_v: torch.Tensor,
    fresh_k: torch.Tensor,
    fresh_v: torch.Tensor,
    side_idx: torch.Tensor,
    active: torch.Tensor,
    *,
    n_kv_heads: int,
    layer: Optional[int] = None,
    n_pages_per_layer: int = 0,
):
    """Flash-decode with the side-window writeback -> (out [B, H, Dh] in
    q's dtype, side_k, side_v), the side buffers updated in place. CUDA
    tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    if q.device.type == "cpu":
        return flash_decode_attention_fw_plain(
            q, k_pages, v_pages, page_table, prefix_lens, side_k, side_v,
            fresh_k, fresh_v, side_idx, active, n_kv_heads=n_kv_heads,
            layer=layer, n_pages_per_layer=n_pages_per_layer)
    name = "flash_decode_fw"
    b, h, dh = q.shape
    base = _check_decode(name, q, k_pages, v_pages, page_table, prefix_lens,
                         side_k, side_v, n_kv_heads=n_kv_heads, layer=layer,
                         n_pages_per_layer=n_pages_per_layer)
    _cuda.require_cuda(name, q, k_pages, v_pages, page_table, prefix_lens,
                       side_k, side_v, fresh_k, fresh_v, side_idx, active)
    _cuda.require_int32(name, page_table, prefix_lens, side_idx, active)
    _cuda.require(tuple(fresh_k.shape) == (b, 1, n_kv_heads, dh) and
                  fresh_v.shape == fresh_k.shape and
                  fresh_k.dtype == q.dtype == fresh_v.dtype,
                  f"{name}: fresh K/V must be [B, 1, Hkv, Dh] in q's dtype")
    _cuda.require(side_idx.shape == (b,) and active.shape == (b,),
                  f"{name}: side_idx/active batch mismatch")
    out = _launch(name, _cuda.lib().die_flash_decode_fw, q, k_pages,
                  page_table, side_k, n_kv_heads, base, (
                      q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                      page_table.data_ptr(), prefix_lens.data_ptr(),
                      side_k.data_ptr(), side_v.data_ptr(),
                      fresh_k.data_ptr(), fresh_v.data_ptr(),
                      side_idx.data_ptr(), active.data_ptr()))
    return out, side_k, side_v
