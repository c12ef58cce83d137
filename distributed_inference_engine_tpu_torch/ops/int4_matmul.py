"""Matmul against packed int4 weights (port of ``ops/int4_matmul.py``):

    int4_matmul(x, packed, scale) = (x[:, :K/2] @ lo(packed)
                                     + x[:, K/2:] @ hi(packed)) * scale

``x [M, K]`` (fp32 or bf16), ``packed [K/2, N]`` int8 in the split-half
nibble layout of ``ops/quant.py`` (low nibble of byte ``k``: weight row
``k``; high nibble: row ``K/2 + k``), ``scale [N]`` fp32; the result is
``[M, N]`` in x's dtype, summed in fp32 with the scale applied before the
one rounding, as the TPU kernel ``_kernel_stacked`` does.

CUDA tensors launch the hand-written kernel of ``csrc/int4_matmul.cu``
(replacing ``ops/int4_matmul.py:_kernel_stacked``): a split-K GEMV for
M <= 16 rows (decode, the LM head), tensor cores for larger bf16 M
(prefill, the mixed step), CUDA cores for larger fp32 M. CPU tensors take
the plain version below. The TPU's kernel-mode switch, tiling gates and
tuned block table have no counterpart: the kernel takes any M and N and
any even K.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import _cuda

GEMV_MAX_ROWS = 16            # csrc/int4_matmul.cu: larger M takes tiles
_GEMV_BLOCK_COLS = 256        # 32 lanes x 8 columns
_GEMV_BLOCKS_PER_SM = 2       # resident split-K blocks aimed for per SM


@functools.lru_cache(maxsize=None)
def _target_blocks(device_index: int) -> int:
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return _GEMV_BLOCKS_PER_SM * sms


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


def _split(k2: int, n: int, target_blocks: int) -> Tuple[int, int]:
    """(ks, chunk) of the GEMV: split the packed rows so ~target_blocks
    blocks run."""
    col_blocks = -(-n // _GEMV_BLOCK_COLS)
    ks = max(1, -(-target_blocks // col_blocks))
    ks = min(ks, max(1, k2 // 64))
    chunk = -(-k2 // ks)
    chunk = -(-chunk // 8) * 8
    return -(-k2 // chunk), chunk


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
    if m <= GEMV_MAX_ROWS:
        ks, chunk = _split(k2, n, _target_blocks(x.device.index))
    else:
        ks, chunk = 1, k2
    ws = torch.empty((ks if ks > 1 else 0, m, n), dtype=torch.float32,
                     device=x.device)
    err = _cuda.lib().die_int4_matmul(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        ws.data_ptr(), m, k2, n, ks, chunk, _cuda.dtype_code(x.dtype),
        _cuda.stream_ptr(x.device))
    _cuda.check(err, name)
    _cuda.LAUNCHES[name] += 1
    return out
