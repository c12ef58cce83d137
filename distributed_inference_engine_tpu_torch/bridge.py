"""Weights across the framework boundary, through numpy.

``params_from_numpy`` takes a JAX-layout parameter tree whose leaves are
numpy arrays (a caller on the JAX side runs ``jax.device_get``; the port
never sees JAX) and returns the port's parameter dict on ``device``, the
card unless the caller asks for the CPU, like every entry point of the
port. The layouts are the same, so this is a copy. bf16, e4m3 and e5m2
(fp8 KV pages) arrive with the ``ml_dtypes`` numpy dtypes; they are reinterpreted
bit for bit through ``uint16`` and ``uint8`` without importing
``ml_dtypes``. A quantized leaf (any object
with ``q``, ``s``, ``bits`` and ``pack_axis``, as ``jax.device_get`` of the
JAX ``QuantizedTensor`` gives) becomes the port's ``QuantizedTensor``,
payload and scales bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models.base import ModelSpec, Params, param_shapes
from .ops.quant import FUSED_GROUPS, QuantizedTensor

# the fp8 dtypes carried as their bytes, by numpy (ml_dtypes) name
_FP8 = {"float8_e4m3fn": torch.float8_e4m3fn,
        "float8_e5m2": torch.float8_e5m2}


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    """numpy array (fp32, int, or ml_dtypes bf16, e4m3 or e5m2) -> torch
    tensor, bit for bit."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    if arr.dtype.name in _FP8:
        bits = np.ascontiguousarray(arr).view(np.uint8)
        return torch.from_numpy(bits.copy()).view(_FP8[arr.dtype.name]).to(
            device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch tensor -> numpy; bf16 comes back as its raw ``uint16`` bits
    and e4m3 or e5m2 as its ``uint8`` bytes (compare with
    ``jax_array.view(np.uint16)`` / ``.view(np.uint8)``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype in _FP8.values():
        return t.view(torch.uint8).numpy()
    return t.numpy()


def leaf_from_numpy(leaf, device="cuda"):
    """A plain or quantized leaf -> the port's tensor or QuantizedTensor."""
    if all(hasattr(leaf, a) for a in ("q", "s", "bits", "pack_axis")):
        return QuantizedTensor(q=tensor_from_numpy(leaf.q, device),
                               s=tensor_from_numpy(leaf.s, device),
                               bits=int(leaf.bits),
                               pack_axis=int(leaf.pack_axis))
    return tensor_from_numpy(leaf, device)


def _check_block_keys(spec: ModelSpec, blocks) -> None:
    want = set(param_shapes(spec)["blocks"])
    for fused, members in FUSED_GROUPS.items():
        if fused in blocks:                  # a fused payload replaces them
            want = (want - set(members)) | {fused}
    missing = sorted(want - set(blocks))
    extra = sorted(set(blocks) - want)
    if missing or extra:
        raise ValueError(f"blocks keys: missing {missing}, unsupported "
                         f"{extra}")


def params_from_numpy(tree: Dict[str, Any], spec: ModelSpec,
                      device="cuda") -> Params:
    """JAX parameter tree (numpy leaves) -> port parameters on ``device``.
    Covers the tree of every family (``models/base.py:param_shapes``):
    ``tok_emb``, ``lnf_scale`` and the stacked ``blocks`` (a MoE tree's
    router and ``[L, E, ...]`` experts, plain or quantized), with
    ``lnf_bias``, ``pos_emb`` and the block biases where the spec has
    them, ``lm_head`` (vocab-padded when int4) only when the embeddings
    are untied, and the fused ``w_qkv``/``w_gate_up`` payloads in place of
    their members where the JAX engine fused them."""
    blocks = tree["blocks"]
    _check_block_keys(spec, blocks)
    out: Params = {
        "tok_emb": tensor_from_numpy(tree["tok_emb"], device),
        "lnf_scale": tensor_from_numpy(tree["lnf_scale"], device),
        "blocks": {k: leaf_from_numpy(v, device) for k, v in blocks.items()},
    }
    for name in ("lnf_bias", "pos_emb", "lm_head"):
        if name in param_shapes(spec):
            out[name] = leaf_from_numpy(tree[name], device)
    return out


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """Port parameters -> the same tree of numpy arrays (bf16 as uint16
    bits; a ``QuantizedTensor`` keeps its class, with numpy leaves), for
    round-trip checks."""
    def leaf(v):
        if isinstance(v, dict):
            return params_to_numpy(v)
        if isinstance(v, QuantizedTensor):
            return QuantizedTensor(q=tensor_to_numpy(v.q),
                                   s=tensor_to_numpy(v.s), bits=v.bits,
                                   pack_axis=v.pack_axis)
        return tensor_to_numpy(v)

    return {k: leaf(v) for k, v in params.items()}
