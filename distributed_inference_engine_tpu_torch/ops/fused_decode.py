"""Decode-step GEMVs with the norm or the residual folded in (port of
``ops/fused_decode.py``):

    norm_matmul(x, gain, w)     = rms_norm(x, gain) @ w
    matmul_residual(x, w, res)  = res + x @ w

CUDA tensors launch the hand-written kernels of
``csrc/fused_decode.cu`` (replacing the TPU kernels
``ops/fused_decode.py:_norm_matmul_kernel`` and ``_matmul_residual_kernel``);
CPU tensors take the plain versions below. Both are one launch of one core:
the contraction splits over the blocks of a thread-block cluster
(``gemv_plan``), which reduce in shared memory; bf16 runs the tensor cores
(instance ``mma``), fp32 the CUDA cores (``simt``). norm_matmul's inverse
RMS is formed inside the launch: each block sums the squares of its own
chunk of x and the cluster adds the partials. Each call counts one launch of
its kernel and one of ``<kernel>.<instance>``. The JAX kernels are
bit-identical to the unfused XLA chain on a TPU; on the card the kernels are
held to their plain versions within a stated tolerance instead, and the
engine's tokens are checked teacher-forced.

Eligibility (``*_wants``) keeps only what the kernel needs: a plain 2-D
float weight in x's dtype (fp32 or bf16). The TPU's VMEM budget gate and
16-row batch pad have no counterpart here.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import _cuda
from .norms import rms_norm


def norm_matmul_wants(x: torch.Tensor, w) -> bool:
    if not isinstance(w, torch.Tensor) or w.dim() != 2 or x.dim() != 2:
        return False
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        return False
    return x.shape[1] == w.shape[0] and w.shape[1] % 2 == 0


def matmul_residual_wants(x: torch.Tensor, w) -> bool:
    return norm_matmul_wants(x, w)


def norm_matmul_plain(x: torch.Tensor, gain: torch.Tensor, w: torch.Tensor,
                      *, eps: float = 1e-6, plus_one: bool = False
                      ) -> torch.Tensor:
    g = gain.float() + 1.0 if plus_one else gain
    return rms_norm(x, g, eps) @ w


def matmul_residual_plain(x: torch.Tensor, w: torch.Tensor,
                          res: torch.Tensor) -> torch.Tensor:
    return res + x @ w


# csrc/fused_decode.cu cluster_gemv: output columns a block, tokens a block
_COLS = 128
_MAX_TOKENS = 32


def gemv_instance(dtype: torch.dtype) -> str:
    """``mma`` (tensor cores) for bf16, ``simt`` (CUDA cores) for fp32."""
    return "mma" if dtype == torch.bfloat16 else "simt"


def gemv_plan(b: int, d: int, n: int, dtype: torch.dtype,
              sms: int) -> Dict[str, int]:
    """The grid of both kernels for x [b, d] @ w [d, n]: column tiles of
    128, token tiles of up to 32 (``tokens``: 8, 16 or 32 a block), and the
    contraction split over ``ks`` blocks of one cluster (1, 2, 4 or 8),
    ``chunk`` rows each, a multiple of the stage depth (``depth``: 32 rows
    bf16, 16 fp32; a stage is 8 KB of weight). ``ks`` is the largest such
    count that keeps the grid within ~4 blocks an SM and gives each block
    at least one stage (``_cuda.cluster_split``); the last blocks' chunks
    may be short or empty."""
    depth = 32 if dtype == torch.bfloat16 else 16
    tokens = 8 if b <= 8 else 16 if b <= 16 else _MAX_TOKENS
    col_tiles = -(-n // _COLS)
    tok_tiles = -(-b // tokens)
    ks, chunk_tiles = _cuda.cluster_split(-(-d // depth),
                                          col_tiles * tok_tiles, sms)
    chunk = chunk_tiles * depth
    return dict(ks=ks, chunk=chunk, depth=depth, tokens=tokens,
                col_tiles=col_tiles, tok_tiles=tok_tiles,
                blocks=col_tiles * tok_tiles * ks)


def _check(name: str, x: torch.Tensor, w: torch.Tensor, *others) -> None:
    _cuda.require(x.device.type == "cuda", f"{name}: unsupported device "
                  f"{x.device}")
    _cuda.require_cuda(name, x, w, *others)
    _cuda.require(norm_matmul_wants(x, w), f"{name}: needs x [B, D] and a "
                  f"plain weight [D, N] (N even) of x's dtype (fp32/bf16); "
                  f"got {tuple(x.shape)} {x.dtype} @ {tuple(w.shape)} "
                  f"{w.dtype}")
    for t in others:
        _cuda.require(t.dtype == x.dtype, f"{name}: dtype mismatch")


def _count(name: str, dtype: torch.dtype) -> None:
    _cuda.count_launch(name, f"{name}.{gemv_instance(dtype)}")


def norm_matmul(x: torch.Tensor, gain: torch.Tensor, w: torch.Tensor, *,
                eps: float = 1e-6, plus_one: bool = False) -> torch.Tensor:
    """``rms_norm(x, gain, eps) @ w`` -> [B, N] in x's dtype."""
    if x.device.type == "cpu":
        return norm_matmul_plain(x, gain, w, eps=eps, plus_one=plus_one)
    name = "norm_matmul"
    _check(name, x, w, gain)
    b, d = x.shape
    n = w.shape[1]
    _cuda.require(gain.shape == (d,), f"{name}: gain must be [{d}]")
    plan = gemv_plan(b, d, n, x.dtype, _cuda.sm_count(x.device.index))
    out = torch.empty((b, n), dtype=x.dtype, device=x.device)
    err = _cuda.lib().die_norm_matmul(
        x.data_ptr(), gain.data_ptr(), w.data_ptr(), out.data_ptr(), b, d, n,
        float(eps), int(bool(plus_one)), plan["ks"], plan["chunk"],
        _cuda.dtype_code(x.dtype), _cuda.stream_ptr(x.device))
    _cuda.check(err, name)
    _count(name, x.dtype)
    return out


def matmul_residual(x: torch.Tensor, w: torch.Tensor,
                    res: torch.Tensor) -> torch.Tensor:
    """``res + x @ w`` -> [B, N] in x's dtype."""
    if x.device.type == "cpu":
        return matmul_residual_plain(x, w, res)
    name = "matmul_residual"
    _check(name, x, w, res)
    b, d = x.shape
    n = w.shape[1]
    _cuda.require(res.shape == (b, n), f"{name}: res must be [{b}, {n}]")
    plan = gemv_plan(b, d, n, x.dtype, _cuda.sm_count(x.device.index))
    out = torch.empty((b, n), dtype=x.dtype, device=x.device)
    err = _cuda.lib().die_matmul_residual(
        x.data_ptr(), w.data_ptr(), res.data_ptr(), out.data_ptr(), b, d, n,
        plan["ks"], plan["chunk"], _cuda.dtype_code(x.dtype),
        _cuda.stream_ptr(x.device))
    _cuda.check(err, name)
    _count(name, x.dtype)
    return out
