"""Matmul against packed int4 weights (port of ``ops/int4_matmul.py``):

    int4_matmul(x, packed, scale) = (x[:, :K/2] @ lo(packed)
                                     + x[:, K/2:] @ hi(packed)) * scale

``x [M, K]`` (fp32 or bf16), ``packed [K/2, N]`` int8 in the split-half
nibble layout of ``ops/quant.py`` (low nibble of byte ``k``: weight row
``k``; high nibble: row ``K/2 + k``), ``scale [N]`` fp32; the result is
``[M, N]`` in x's dtype, summed in fp32 with the scale applied before the
one rounding, as the TPU kernel ``_kernel_stacked`` does.

CUDA tensors launch the hand-written kernel of ``csrc/int4_matmul.cu``
(replacing ``ops/int4_matmul.py:_kernel_stacked``) in one of four
instances, chosen by ``int4_instance`` from the shapes, the dtype and the
16-byte alignment of x and the payload, never by a failure:

- ``gemv``: M <= 16 rows (decode, the LM head): one launch on the tensor
  cores, the packed rows split over a thread-block cluster
  (``int4_gemv_plan``) whose blocks reduce in shared memory; an fp32 x is
  split exactly into three bf16 terms;
- ``wgmma``: larger bf16 M (prefill, the mixed step) where TMA can address
  the operands (K/2 % 8 == 0, N % 16 == 0, both aligned): TMA, a
  shared-memory ring and ``wgmma``, 128 columns by ``wgmma_tile`` tokens
  a block;
- ``wmma``: larger bf16 M at the other shapes, ``wmma`` tiles;
- ``simt``: larger fp32 M, CUDA cores.

Each call counts one launch of ``int4_matmul`` and one of
``int4_matmul.<instance>``. CPU tensors take the plain version below. The
TPU's kernel-mode switch, tiling gates and tuned block table have no
counterpart: the kernel takes any M and N and any even K.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import _cuda

GEMV_MAX_ROWS = 16            # csrc/int4_matmul.cu: larger M takes tiles
# instance codes of csrc/int4_matmul.cu (kInstGemv .. kInstSimt)
INSTANCES = {"gemv": 0, "wgmma": 1, "wmma": 2, "simt": 3}
# csrc/int4_matmul.cu int4_gemv_mma_kernel: output columns a block, packed
# rows a stage
_GEMV_COLS = 128
_GEMV_DEPTH = 64
_WGMMA_COLS = 128             # output columns per wgmma block
# a wgmma block's time is about (tile + _WGMMA_BLOCK_COST) token-steps of
# MMA work: its packed-weight stream and pipeline fill cost what 160
# tokens do (fitted to the tile timings of chip_smoke.py --profile)
_WGMMA_BLOCK_COST = 160


def unpack_int4(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed (lo, hi) nibbles of int8 bytes, as int32 (widened before the
    shifts, as the TPU kernel does)."""
    p = packed.to(torch.int32)
    return (p << 28) >> 28, p >> 4


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    k2 = packed.shape[0]
    lo, hi = unpack_int4(packed)
    xf = x.float()
    y = xf[:, :k2] @ lo.float() + xf[:, k2:] @ hi.float()
    return (y * scale.float()).to(x.dtype)


def int4_instance(m: int, k2: int, n: int, dtype: torch.dtype,
                  aligned: bool) -> str:
    """The kernel instance for x [m, 2 * k2] of ``dtype`` against packed
    [k2, n]; ``aligned``: x and the payload start on 16 bytes."""
    if m <= GEMV_MAX_ROWS:
        return "gemv"
    if dtype != torch.bfloat16:
        return "simt"
    if k2 % 8 == 0 and n % 16 == 0 and aligned:
        return "wgmma"
    return "wmma"


def wgmma_tile(m: int, n: int, sms: int) -> int:
    """Tokens per block of the wgmma instance (its wgmma N): the tile of
    64, 128 or 256 that minimises waves x (tile + _WGMMA_BLOCK_COST), where
    a wave is ``sms`` blocks of the grid; on a tie, the smaller tile."""
    col_tiles = -(-n // _WGMMA_COLS)

    def cost(tile: int) -> int:
        waves = -(-(-(-m // tile) * col_tiles) // sms)
        return waves * (tile + _WGMMA_BLOCK_COST)

    return min((64, 128, 256), key=cost)


def int4_gemv_plan(m: int, k2: int, n: int, sms: int) -> Dict[str, int]:
    """The GEMV's grid for x [m <= 16, 2 k2] against packed [k2, n]: column
    tiles of 128, one token tile (``tokens``: 8 or 16), and the packed rows
    split over ``ks`` blocks of one cluster (1, 2, 4 or 8), ``chunk`` rows
    each, a multiple of the 64-row stage. ``ks`` is the largest such count
    that keeps the grid within ~4 blocks an SM and gives each block at
    least one stage (``_cuda.cluster_split``); the last blocks' chunks may
    be short or empty."""
    tokens = 8 if m <= 8 else 16
    col_tiles = -(-n // _GEMV_COLS)
    ks, chunk_tiles = _cuda.cluster_split(-(-k2 // _GEMV_DEPTH), col_tiles,
                                          sms)
    chunk = chunk_tiles * _GEMV_DEPTH
    return dict(ks=ks, chunk=chunk, depth=_GEMV_DEPTH, tokens=tokens,
                col_tiles=col_tiles, blocks=col_tiles * ks)


def int4_matmul(x: torch.Tensor, packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``[M, K] x packed [K/2, N] * scale [N] -> [M, N]`` in x's dtype."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scale)
    name = "int4_matmul"
    _cuda.require(x.device.type == "cuda", f"{name}: unsupported device "
                  f"{x.device}")
    _cuda.require(x.dim() == 2 and packed.dim() == 2 and scale.dim() == 1,
                  f"{name}: needs x [M, K], packed [K/2, N], scale [N]; got "
                  f"{tuple(x.shape)}, {tuple(packed.shape)}, "
                  f"{tuple(scale.shape)}")
    m, k = x.shape
    k2, n = packed.shape
    _cuda.require(k == 2 * k2 and scale.shape[0] == n,
                  f"{name}: x [{m}, {k}] against packed [{k2}, {n}] and "
                  f"scale [{scale.shape[0]}]")
    _cuda.require(packed.dtype == torch.int8 and scale.dtype == torch.float32,
                  f"{name}: packed must be int8 and scale float32")
    for t in (x, packed, scale):
        _cuda.require(t.device == x.device,
                      f"{name}: tensors on different devices")
        _cuda.require(t.is_contiguous(), f"{name}: tensors must be "
                      "contiguous")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    code = _cuda.dtype_code(x.dtype)
    inst = int4_instance(m, k2, n, x.dtype, x.data_ptr() % 16 == 0
                         and packed.data_ptr() % 16 == 0)
    sms = _cuda.sm_count(x.device.index)
    ks, chunk, tile = 1, k2, 0
    if inst == "gemv":
        plan = int4_gemv_plan(m, k2, n, sms)
        ks, chunk = plan["ks"], plan["chunk"]
    elif inst == "wgmma":
        tile = wgmma_tile(m, n, sms)
    err = _cuda.lib().die_int4_matmul(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        m, k2, n, ks, chunk, code, INSTANCES[inst], tile,
        _cuda.stream_ptr(x.device))
    _cuda.check(err, f"{name} ({inst})")
    _cuda.count_launch(name, f"{name}.{inst}")
    return out
