"""Weight-only quantization of the matmul weights (port of ``ops/quant.py``).

Symmetric per-output-channel scales over the contraction axis:

- ``bits=8``: ``q = round(w / s)`` in [-127, 127], ``s = max|w| / 127``;
  the matmul widens ``q`` to the activation dtype and multiplies the
  product by ``s`` (the JAX package's XLA einsum; no kernel).
- ``bits=4``: values in [-7, 7], ``s = max|w| / 7``, two per byte in the
  split-half layout: along the contraction axis (halved in the stored
  shape), source index ``k < K/2`` sits in the low nibble of byte ``k`` and
  ``K/2 + k`` in its high nibble. Every int4 product goes to the kernel of
  ``ops/int4_matmul.py``.

Activations, norms, embeddings and the KV cache stay in the compute dtype.

Parameter trees keep the JAX stacked layout: a block weight is a
``QuantizedTensor`` with a leading ``[L]`` layer axis on ``q`` and on its
keepdims scale ``s``; ``qt[layer]`` is the layer's ``QuantizedTensor`` of
views. The JAX package's ``IndexedQuant``/``split_indexed_blocks`` have no
counterpart: they keep a scanned layer slice away from an opaque custom
call, which XLA would copy first; here ``q[layer]`` of the contiguous
stacked payload is a zero-copy view whose pointer the kernel takes.

Checkpoints record the int4 layout (``INT4_LAYOUT_SPLIT_HALF``); an
int4 payload saved without it is in the older even/odd interleave and is
repacked once on restore (``repack_int4_interleaved_to_split``,
``utils/checkpoint.py``).

Mixture-of-experts trees (Mixtral) stack their experts' weights ``[L, E,
D_in, D_out]``: they are quantized over D_in (``_MOE_WEIGHTS``), an int4
payload packed there (``pack_axis`` -2). ``qt[layer][e]`` is one
expert's contiguous 2-D view (payload ``[D_in/2, D_out]``, scales ``[1,
D_out]``), so ``matmul_any`` sends each expert product to the int4
kernel (or the int8 widening) as it does a dense projection; at
Mixtral's shapes every view starts on 16 bytes, where the kernel's TMA
instance can take it. The router stays in full precision, as in JAX.

Not ported yet: ``resolve_kernel_modes`` and the ``kernel_mode`` stamp
(with tp, A13).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Sequence, Tuple

import torch

from .int4_matmul import int4_matmul, unpack_int4


@dataclass
class QuantizedTensor:
    """Quantized weight + per-channel scales (keepdims shape: the weight's
    shape with its contraction axes at size 1). ``bits=4`` packs along
    ``pack_axis``, stored negative (from the end) as in JAX, so taking the
    leading layer axis off leaves it pointing at the same dim."""

    q: Any                  # int8 payload (bits=4: the packed axis halved)
    s: Any                  # float32 scales
    bits: int = 8
    pack_axis: int = 0

    @property
    def shape(self) -> Tuple[int, ...]:
        if self.bits == 4:
            a = self.pack_axis % self.q.dim()
            return tuple(d * 2 if i == a else d
                         for i, d in enumerate(self.q.shape))
        return tuple(self.q.shape)

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.s.numel() * self.s.element_size())

    def __getitem__(self, idx) -> "QuantizedTensor":
        """Index the leading (layer) axis of payload and scale together."""
        return dataclasses.replace(self, q=self.q[idx], s=self.s[idx])

    def unpacked(self) -> torch.Tensor:
        """int8 values at the original shape (bits=4 unpacked)."""
        if self.bits != 4:
            return self.q
        lo, hi = unpack_int4(self.q)
        return torch.cat([lo, hi], dim=self.pack_axis).to(torch.int8)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.unpacked().float() * self.s).to(dtype)


def pack_int4(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Signed values in [-8, 7] -> int8 bytes, ``lo`` in the low nibble."""
    lo16, hi16 = lo.to(torch.int16), hi.to(torch.int16)
    return ((lo16 & 0xF) | ((hi16 & 0xF) << 4)).to(torch.uint8).view(
        torch.int8)


def quantize_weight(w: torch.Tensor, reduce_axes: Sequence[int],
                    bits: int = 8) -> QuantizedTensor:
    """Symmetric int8/int4 over ``reduce_axes`` (the contraction axes; the
    others are output channels, one scale each). ``bits=4`` packs along the
    first reduce axis, which must be even-sized. Rounds half to even, as
    ``jnp.round`` does."""
    w32 = w.float()
    axes = sorted(int(a) % w32.dim() for a in reduce_axes)
    amax = w32.abs().amax(dim=axes, keepdim=True)
    if bits == 8:
        scale = torch.clamp(amax, min=1e-8) / 127.0
        q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
        return QuantizedTensor(q=q, s=scale)
    if bits != 4:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    a = axes[0]
    if w32.shape[a] % 2:
        raise ValueError(f"int4 pack axis {a} has odd size {w32.shape[a]}")
    scale = torch.clamp(amax, min=1e-8) / 7.0
    q = torch.clamp(torch.round(w32 / scale), -7, 7).to(torch.int8)
    lo, hi = q.chunk(2, dim=a)
    return QuantizedTensor(q=pack_int4(lo, hi), s=scale, bits=4,
                           pack_axis=a - w32.dim())


def repack_int4_interleaved_to_split(qt: QuantizedTensor) -> QuantizedTensor:
    """An int4 payload in the older even/odd interleave (source index
    ``2k`` in byte ``k``'s low nibble, ``2k+1`` in its high one) repacked
    to the split-half layout every int4 product reads. Checkpoints store
    the packed bytes, so a restore calls this once for a payload saved
    without the layout marker; without it every weight would be silently
    row-permuted. Identity for int8."""
    if qt.bits != 4:
        return qt
    a = qt.pack_axis % qt.q.dim()
    q16 = qt.q.to(torch.int16)
    even = ((q16 & 0xF) ^ 8) - 8          # the low nibble, sign-extended
    odd = q16 >> 4                         # the high nibble, signed
    full = torch.stack([even, odd], dim=a + 1).reshape(qt.shape)
    lo, hi = full.chunk(2, dim=a)
    return dataclasses.replace(qt, q=pack_int4(lo, hi))


# the split-half int4 layout's version, stored with checkpoints (bits=4
# only): absent = the older even/odd interleave, 1 = split-half
INT4_LAYOUT_SPLIT_HALF = 1


# Same-input matmul groups whose int4 payloads concatenate along the output
# axis into one [L, K/2, sum(N)] payload: one launch per layer instead of
# 2-3, and the small k/v projections ride the wide one.
FUSED_GROUPS: Dict[str, Tuple[str, ...]] = {
    "w_qkv": ("wq", "wk", "wv"),
    "w_gate_up": ("w_gate", "w_up"),
}
_FUSE_BLOCKERS = {"w_qkv": ("bq", "bk", "bv"), "w_gate_up": ("b_up",)}


def _stacked_int4(w) -> bool:
    return (isinstance(w, QuantizedTensor) and w.bits == 4
            and w.q.dim() == 3 and w.pack_axis % 3 == 1)


def fuse_block_weights(params: Dict[str, Any]) -> Dict[str, Any]:
    """Concatenate each ``FUSED_GROUPS`` group along the output axis when
    all its members are stacked int4 payloads with the same ``[L, K/2]``
    and no bias key is present (a one-time device copy at engine init).
    Per-channel scales concatenate the same way, so the function is
    unchanged. Identity otherwise, and on an already fused tree. Unlike
    JAX (which fuses only where its kernel is engaged), every int4 tensor
    takes the kernel on the card."""
    blocks = dict(params["blocks"])
    changed = False
    for fused_name, members in FUSED_GROUPS.items():
        if fused_name in blocks:
            continue
        ws = [blocks.get(m) for m in members]
        if not all(_stacked_int4(w) for w in ws):
            continue
        if any(b in blocks for b in _FUSE_BLOCKERS[fused_name]):
            continue
        if len({tuple(w.q.shape[:2]) for w in ws}) != 1:
            continue
        fused = QuantizedTensor(q=torch.cat([w.q for w in ws], dim=-1),
                                s=torch.cat([w.s for w in ws], dim=-1),
                                bits=4, pack_axis=ws[0].pack_axis)
        for m in members:
            del blocks[m]
        blocks[fused_name] = fused
        changed = True
    if not changed:
        return params
    out = dict(params)
    out["blocks"] = blocks
    return out


def prepare_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Engine-init parameter preparation: the int4 payload fusion."""
    return fuse_block_weights(params)


def _out_scale(s: torch.Tensor) -> torch.Tensor:
    """The keepdims scale with its leading (contracted) size-1 axes
    dropped, so it broadcasts against the product."""
    while s.dim() > 0 and s.shape[0] == 1:
        s = s[0]
    return s


def matmul_any(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` for a plain weight or a per-layer ``QuantizedTensor``
    (contraction over x's last axis and the weight's first). int8 widens
    the payload to x's dtype and scales the product in x's dtype (a copy
    of the weight per call, as the JAX einsum materialises on a CPU);
    int4 goes to the kernel."""
    if not isinstance(w, QuantizedTensor):
        return x @ w
    if w.q.dim() != 2:
        raise ValueError(f"matmul_any takes a per-layer weight, got payload "
                         f"{tuple(w.q.shape)}")
    if w.bits == 8:
        return (x @ w.q.to(x.dtype)) * _out_scale(w.s).to(x.dtype)
    if w.pack_axis % 2 != 0:
        raise ValueError("int4 payload must be packed on its input axis")
    lead = x.shape[:-1]
    y = int4_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w.q,
                    _out_scale(w.s))
    return y.reshape(*lead, y.shape[-1])


# ------------------------------------------------------------ param trees

# block weights, stored [L, D_in, D_out]: quantized over D_in (axis 1)
_BLOCK_WEIGHTS = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")
# a MoE tree's expert weights, stored [L, E, D_in, D_out]: quantized over
# D_in (axis 2; one layer's slice: axis 1)
_MOE_WEIGHTS = ("w_up", "w_gate", "w_down")


def block_quant_axis(spec, name: str) -> int:
    """The contraction axis of block weight ``name`` within one layer's
    slice: 1 for a MoE tree's experts (``[E, D_in, D_out]``), else 0."""
    return 1 if getattr(spec, "n_experts", 0) and name in _MOE_WEIGHTS else 0


# the int4 LM head's vocab is padded to a multiple of this; the pad columns
# are zero weights (scale at the 1e-8 floor), so their logits are exactly
# 0, and models/base.py:unembed cuts them off
_LM_HEAD_PAD = 2048


def _pad_vocab(n: int) -> int:
    return -(-n // _LM_HEAD_PAD) * _LM_HEAD_PAD


class StackedQuantizer:
    """A stacked ``QuantizedTensor`` filled one layer at a time:
    ``put(layer, w_layer)`` quantizes that layer's slice over its axis
    ``axis`` (``quantize_weight``) into the stacked payload and scales,
    allocated at the first ``put``. The same bits as quantizing the stack
    at once (each layer's scales reduce over its own D_in), with an fp32
    transient of one layer."""

    def __init__(self, n_layers: int, axis: int, bits: int) -> None:
        self.n_layers, self.axis, self.bits = n_layers, axis, bits
        self.qt = None

    def put(self, layer: int, w: torch.Tensor) -> None:
        ql = quantize_weight(w, (self.axis,), bits=self.bits)
        if self.qt is None:
            self.qt = dataclasses.replace(ql, q=torch.empty(
                (self.n_layers, *ql.q.shape), dtype=ql.q.dtype,
                device=w.device), s=torch.empty(
                (self.n_layers, *ql.s.shape), dtype=ql.s.dtype,
                device=w.device))
        self.qt.q[layer], self.qt.s[layer] = ql.q, ql.s


def _quantize_stacked(w: torch.Tensor, bits: int,
                      axis: int = 0) -> QuantizedTensor:
    """``quantize_weight(w, (axis + 1,), bits)`` of a stacked weight,
    one layer at a time (``StackedQuantizer``)."""
    sq = StackedQuantizer(w.shape[0], axis, bits)
    for layer in range(w.shape[0]):
        sq.put(layer, w[layer])
    return sq.qt


def quantize_params(spec, params: Dict[str, Any],
                    bits: int = 8) -> Dict[str, Any]:
    """Quantize the block weights and an untied LM head (bits 8 or 4; the
    int4 head vocab-padded). Embeddings (``tok_emb``, a tied head with
    it, ``pos_emb``), norms, biases and the MoE router stay as they are,
    as in JAX; a MoE tree's experts are quantized over their D_in. The
    stacked block weights are quantized a layer at a time, and a leaf
    already quantized (a loader's) is kept."""
    out = dict(params)
    blocks = dict(params["blocks"])
    for name in _BLOCK_WEIGHTS:
        w = blocks.get(name)
        if w is None or isinstance(w, QuantizedTensor):
            continue
        blocks[name] = _quantize_stacked(w, bits,
                                         block_quant_axis(spec, name))
    out["blocks"] = blocks
    head = out.get("lm_head")
    if not spec.tie_embeddings and isinstance(head, torch.Tensor):
        pad = _pad_vocab(head.shape[1]) - head.shape[1] if bits == 4 else 0
        if pad:
            head = torch.nn.functional.pad(head, (0, pad))
        out["lm_head"] = quantize_weight(head, (0,), bits=bits)
    return out


def param_bytes(params: Any) -> int:
    """Total stored bytes of a (possibly quantized) parameter tree."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    if isinstance(params, QuantizedTensor):
        return params.nbytes
    return params.numel() * params.element_size()
