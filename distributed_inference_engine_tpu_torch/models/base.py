"""Decoder-only transformer forward in PyTorch: the Llama subset the
serving engine runs (port of ``models/base.py``).

Parameters are a plain dict of tensors in the JAX stacked layout —
``blocks[name]`` carries a leading ``[L]`` axis and weights are ``[in,
out]``, used as ``x @ w`` — so the weight bridge (``bridge.py``) is a copy
and every function here mirrors its JAX namesake. A weight may also be an
``ops/quant.py:QuantizedTensor`` (int8, or int4 with the q|k|v and
gate|up payloads fused): every projection goes through ``matmul_any``.
The JAX ``lax.scan`` over layers is a Python loop over layer views.

Page pools are updated IN PLACE (the JAX functions donate and return new
pools); functions that write pools still return them, so call sites read
the same as in the JAX package. The prefill writes compute their scatter
index lists on the host from host-known lengths and page tables, so a
pool write never synchronises with the device. The per-step paged decode
and the decode chunk's page flush (``write_pages_device``) compute theirs
on the device instead, since only the device knows which slots still
write, and so that they run inside a CUDA graph.

The static and speculative engines decode over dense caches ``[L, B, S,
Hkv, Dh]`` (``forward_decode``, ``forward_window``), made by
``dense_kv_cache`` with one spare row past their end: a write the JAX
scatter drops (a position past ``S``, a window slot past ``n_valid``) is
aimed at that row, since an out-of-range ``index_put_`` raises, or
asserts on the card.

Pools may be e4m3 or e5m2 (``kv_dtype="float8_e4m3fn"`` or
``"float8_e5m2"``; the compute dtype stays fp32, bf16 or fp16). Every pool
write rounds through ``astype_kv``, the JAX cast (e4m3's overflow to NaN,
where torch's saturates; e5m2's NaN bytes), and moves the bytes
through the pools' ``uint8`` view (``raw_view``). Each path rounds where
the JAX function does: the admission prefill attends to its fresh keys
unrounded, the inline decode writes the fresh row and then attends to the
stored bits, the mixed step rounds before attending (inside the ragged
kernel), and the window decode keeps its side window in the compute dtype
until the chunk-end flush.

The port carries every family of the JAX package: Llama and Mistral
(RoPE, RMSNorm, SwiGLU, GQA, Mistral's sliding window), Qwen2 (biases on
q/k/v), Gemma (head_dim apart from d_model/n_heads, embeddings scaled by
sqrt(d_model), RMSNorm over (1 + w), GeGLU, tied embeddings), GPT-2
(learned positions, LayerNorm with biases, biases on every projection,
an ungated GELU MLP), with the logit softcap, and Mixtral (experts, a
spec with ``n_experts``): its MLP is ``ops/moe.py:moe_mlp``, the JAX
serving path's drop-free form, over stacked expert weights ``[L, E, D_in,
D_out]`` and a router ``[L, D, E]``. The fused decode seams take their
kernels only where the JAX seams do (RMSNorm, no bias, a gated dense
MLP); every other spec takes the unfused chain.

Learned positions are gathered with the index clamped to the table, as a
JAX gather clamps: the padded rows of the mixed step's lattice and idle
decode slots carry positions past the table, which a torch index would
reject (on the card, with a device-side assert).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import _cuda
from ..ops.attention import (
    E5M2,
    FP8,
    astype_kv,
    cached_attention,
    causal_attention,
    merge_attention,
    raw_view,
    suffix_attention,
    window_decode_attention,
)
from ..ops.flash_decode import (
    flash_decode_attention,
    flash_decode_attention_fw,
)
from ..ops.fused_decode import (
    matmul_residual,
    matmul_residual_wants,
    norm_matmul,
    norm_matmul_wants,
)
from ..ops.moe import moe_mlp
from ..ops.norms import layer_norm, rms_norm
from ..ops.paged_attention import paged_attention
from ..ops.quant import (
    _BLOCK_WEIGHTS,
    QuantizedTensor,
    _pad_vocab,
    block_quant_axis,
    matmul_any,
    pack_int4,
)
from ..ops.ragged_attention import ragged_attention
from ..ops.rope import apply_rope

Params = Dict[str, Any]

# compute dtypes; a KV pool may also be e4m3 or e5m2 (kv_torch_dtype)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_KV_DTYPES = {**_DTYPES, "float8_e4m3fn": FP8, "float8_e5m2": E5M2}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _DTYPES[name]


def kv_torch_dtype(name: str) -> torch.dtype:
    """A KV pool's dtype: a compute dtype, ``float8_e4m3fn`` or
    ``float8_e5m2``."""
    if name not in _KV_DTYPES:
        raise ValueError(f"unsupported KV dtype {name!r}")
    return _KV_DTYPES[name]


@dataclass(frozen=True)
class ModelSpec:
    """Static architecture description (fields of the JAX ``ModelSpec``)."""

    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    max_seq_len: int = 2048
    pos_emb: str = "rope"
    norm: str = "rmsnorm"
    mlp: str = "swiglu"
    use_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    n_experts: int = 0
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    qkv_bias: bool = False
    head_dim_override: int = 0
    emb_scale: bool = False
    norm_plus_one: bool = False
    logit_softcap: float = 0.0
    sliding_window: int = 0

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def validate(self) -> "ModelSpec":
        """The JAX ``ModelSpec.validate`` checks."""
        if not self.head_dim_override and self.d_model % self.n_heads:
            raise ValueError("d_model must divide by n_heads")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must divide by n_kv_heads")
        if self.pos_emb not in ("rope", "learned"):
            raise ValueError(f"unknown pos_emb {self.pos_emb}")
        if self.mlp not in ("swiglu", "gelu", "geglu"):
            raise ValueError(f"unknown mlp {self.mlp}")
        if self.sliding_window < 0:
            raise ValueError("sliding_window must be >= 0")
        if self.n_experts:
            if not 1 <= self.experts_per_token <= self.n_experts:
                raise ValueError(
                    f"experts_per_token {self.experts_per_token} out of "
                    f"range for {self.n_experts} experts")
            if self.use_bias:
                raise ValueError("MoE experts do not support biases")
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def replace(self, **changes: Any) -> "ModelSpec":
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelSpec":
        from ..config import build_dataclass

        return build_dataclass(cls, d).validate()


# --------------------------------------------------------------------- init


def param_shapes(spec: ModelSpec) -> Dict[str, Any]:
    """Shapes of the JAX ``init_params`` tree for ``spec``: the stacked
    block weights, the gated MLP's ``w_gate`` (swiglu, geglu) or the
    ungated one's ``w_up``/``w_down`` alone (gelu); with experts the
    router ``w_router [L, D, E]`` and the experts' ``w_up``/``w_gate``
    ``[L, E, D, F]`` and ``w_down [L, E, F, D]`` in place of the dense MLP
    (``w_gate`` for swiglu only, as in JAX), LayerNorm biases,
    projection biases (``bq/bk/bv`` with ``qkv_bias`` or ``use_bias``;
    ``bo/b_up/b_down`` with ``use_bias``), ``pos_emb`` for learned
    positions, and ``lm_head`` only when the embeddings are untied."""
    L, D, Fd, V = spec.n_layers, spec.d_model, spec.d_ff, spec.vocab_size
    H, Hkv, Dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    blocks: Dict[str, Tuple[int, ...]] = {
        "ln1_scale": (L, D), "ln2_scale": (L, D),
        "wq": (L, D, H * Dh), "wk": (L, D, Hkv * Dh),
        "wv": (L, D, Hkv * Dh), "wo": (L, H * Dh, D)}
    if spec.n_experts:
        E = spec.n_experts
        blocks["w_router"] = (L, D, E)
        blocks["w_up"] = (L, E, D, Fd)
        blocks["w_down"] = (L, E, Fd, D)
        if spec.mlp == "swiglu":
            blocks["w_gate"] = (L, E, D, Fd)
    else:
        if spec.mlp in ("swiglu", "geglu"):
            blocks["w_gate"] = (L, D, Fd)
        blocks["w_up"] = (L, D, Fd)
        blocks["w_down"] = (L, Fd, D)
    if spec.norm == "layernorm":
        blocks["ln1_bias"] = (L, D)
        blocks["ln2_bias"] = (L, D)
    if spec.use_bias or spec.qkv_bias:
        blocks.update(bq=(L, H * Dh), bk=(L, Hkv * Dh), bv=(L, Hkv * Dh))
    if spec.use_bias:
        blocks.update(bo=(L, D), b_up=(L, Fd), b_down=(L, D))
    shapes: Dict[str, Any] = {"tok_emb": (V, D), "blocks": blocks,
                              "lnf_scale": (D,)}
    if spec.norm == "layernorm":
        shapes["lnf_bias"] = (D,)
    if spec.pos_emb == "learned":
        shapes["pos_emb"] = (spec.max_seq_len, D)
    if not spec.tie_embeddings:
        shapes["lm_head"] = (D, V)
    return shapes


def init_params(spec: ModelSpec, generator: torch.Generator) -> Params:
    """Random-init parameters on the generator's device: normal(0.02),
    depth-scaled output projections, norm scales at one and biases at zero
    (the JAX scheme; the draws differ). Stacked weights are drawn one
    layer (an expert weight one layer's expert) at a time in fp32 and
    cast, so the fp32 transient is one slice, not the model."""
    spec.validate()
    dev = generator.device
    dt = spec.torch_dtype
    L = spec.n_layers
    std = 0.02
    out_std = std / float(np.sqrt(2.0 * L))
    shapes = param_shapes(spec)

    def normal(shape, s=std, stacked=False):
        if not stacked:
            return (torch.randn(shape, generator=generator, device=dev)
                    * s).to(dt)
        out = torch.empty(shape, dtype=dt, device=dev)
        for dst in (out.flatten(0, 1) if len(shape) == 4 else out):
            dst.copy_(torch.randn(dst.shape, generator=generator,
                                  device=dev) * s)
        return out

    def fixed(shape, value: float):
        return torch.full(shape, value, dtype=dt, device=dev)

    # weights in the order the Llama tree has always drawn them
    blocks: Params = {}
    for name, shape in shapes["blocks"].items():
        if name.endswith("_scale"):
            blocks[name] = fixed(shape, 1.0)
        elif name.startswith("w"):
            blocks[name] = normal(shape, out_std if name in ("wo", "w_down")
                                  else std, stacked=True)
        else:                                    # biases
            blocks[name] = fixed(shape, 0.0)
    params: Params = {"tok_emb": normal(shapes["tok_emb"]), "blocks": blocks,
                      "lnf_scale": fixed(shapes["lnf_scale"], 1.0)}
    if "lnf_bias" in shapes:
        params["lnf_bias"] = fixed(shapes["lnf_bias"], 0.0)
    if "lm_head" in shapes:
        params["lm_head"] = normal(shapes["lm_head"])
    if "pos_emb" in shapes:
        params["pos_emb"] = normal(shapes["pos_emb"])
    return params


def random_quantized_params(spec, generator: torch.Generator,
                            w_std: float = 0.02,
                            bits: int = 8) -> Dict[str, Any]:
    """A quantized tree born quantized on the generator's device: no
    full-precision tree is built (an 8B bf16 tree plus its fp32 working
    copy would not be needed to serve int4). Payloads are uniform in
    [-127, 127] (int8) or two uniform nibbles in [-7, 7] per byte (int4,
    drawn packed), at a constant scale that puts the effective weight std
    at ``w_std``; norms are ones, biases zeros, embeddings (``pos_emb``
    too) ``normal * w_std``, the tree of ``param_shapes``
    (no ``lm_head`` when tied). A MoE tree's experts are born quantized
    over each expert's D_in (packed there for int4); its router is
    ``normal * w_std``, in full precision. The draws differ from the JAX
    package's; the statistics are the same. The int4 LM head is
    vocab-padded."""
    spec.validate()
    dev = generator.device
    dt = spec.torch_dtype

    def q_leaf(shape, axis: int) -> QuantizedTensor:
        s_shape = tuple(1 if i == axis else d for i, d in enumerate(shape))
        if bits == 8:
            # discrete-uniform std over [-n, n]: sqrt(n (n + 1) / 3)
            q = torch.randint(-127, 128, shape, generator=generator,
                              device=dev, dtype=torch.int8)
            std = (127 * 128 / 3.0) ** 0.5
            return QuantizedTensor(q=q, s=torch.full(
                s_shape, w_std / std, dtype=torch.float32, device=dev))
        if bits != 4:
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        if shape[axis] % 2:
            raise ValueError(f"int4 pack axis {axis} has odd size "
                             f"{shape[axis]}")
        half = tuple(d // 2 if i == axis else d for i, d in enumerate(shape))
        q = torch.empty(half, dtype=torch.int8, device=dev)
        # one layer (an expert weight one layer's expert; the head whole)
        # at a time: the int16 packing transient stays small
        slices = {2: [q], 3: q, 4: q.flatten(0, 1)}[len(half)]
        for dst in slices:
            lo = torch.randint(-7, 8, dst.shape, generator=generator,
                               device=dev, dtype=torch.int8)
            hi = torch.randint(-7, 8, dst.shape, generator=generator,
                               device=dev, dtype=torch.int8)
            dst.copy_(pack_int4(lo, hi))
        std = (7 * 8 / 3.0) ** 0.5
        return QuantizedTensor(
            q=q, s=torch.full(s_shape, w_std / std, dtype=torch.float32,
                              device=dev),
            bits=4, pack_axis=axis - len(shape))

    def f_leaf(name, shape) -> torch.Tensor:
        if "scale" in name:
            return torch.ones(shape, dtype=dt, device=dev)
        if "bias" in name or name.startswith("b"):     # as in JAX
            return torch.zeros(shape, dtype=dt, device=dev)
        return (torch.randn(shape, generator=generator, device=dev)
                * w_std).to(dt)

    shapes = param_shapes(spec)
    blocks = {name: (q_leaf(shape, 1 + block_quant_axis(spec, name))
                     if name in _BLOCK_WEIGHTS else f_leaf(name, shape))
              for name, shape in shapes["blocks"].items()}
    out: Dict[str, Any] = {}
    for name, shape in shapes.items():
        if name == "blocks":
            out[name] = blocks
        elif name == "lm_head":
            d, v = shape
            out[name] = q_leaf((d, _pad_vocab(v) if bits == 4 else v), 0)
        else:
            out[name] = f_leaf(name, shape)
    return out


def layer_view(params: Params, layer: int) -> Params:
    """One layer's weights as views into the stacked tensors."""
    return {k: v[layer] for k, v in params["blocks"].items()}


# ------------------------------------------------------------------ helpers


def _norm(spec: ModelSpec, x: torch.Tensor, scale: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    if spec.norm == "layernorm":
        return layer_norm(x, scale, bias, spec.norm_eps)
    if spec.norm_plus_one:
        scale = scale.float() + 1.0        # Gemma stores (w - 1)
    return rms_norm(x, scale, spec.norm_eps)


def _act(spec: ModelSpec, gate: torch.Tensor) -> torch.Tensor:
    if spec.mlp == "swiglu":
        return F.silu(gate.float())
    return F.gelu(gate.float(), approximate="tanh")       # geglu, gelu


def _gated(spec: ModelSpec) -> bool:
    return spec.mlp in ("swiglu", "geglu")


def _mlp(spec: ModelSpec, blk: Params, x: torch.Tensor) -> torch.Tensor:
    """Gated (swiglu, geglu): act(x W_gate) * x W_up, then W_down. GPT-2's
    ungated gelu: gelu(x W_up + b_up), then W_down + b_down. Experts:
    ``moe_mlp``."""
    if spec.n_experts:
        return moe_mlp(spec, blk, x)
    if not _gated(spec):
        h = matmul_any(x, blk["w_up"])
        if spec.use_bias:
            h = h + blk["b_up"]
        h = _act(spec, h).to(x.dtype)
    else:
        if "w_gate_up" in blk:
            # fused gate|up int4 payload (ops/quant.py:fuse_block_weights)
            gate, up = matmul_any(x, blk["w_gate_up"]).chunk(2, dim=-1)
        else:
            gate = matmul_any(x, blk["w_gate"])
            up = matmul_any(x, blk["w_up"])
        h = _act(spec, gate).to(x.dtype) * up
    out = matmul_any(h, blk["w_down"])
    if spec.use_bias:
        out = out + blk["b_down"]
    return out


def _qkv(spec: ModelSpec, blk: Params, x: torch.Tensor,
         positions: torch.Tensor):
    b, t, _ = x.shape
    H, Hkv, Dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    if "w_qkv" in blk:
        # fused q|k|v int4 payload (ops/quant.py:fuse_block_weights; never
        # built where q/k/v biases exist)
        q, k, v = matmul_any(x, blk["w_qkv"]).split(
            [H * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
    else:
        q = matmul_any(x, blk["wq"])
        k = matmul_any(x, blk["wk"])
        v = matmul_any(x, blk["wv"])
        if spec.use_bias or spec.qkv_bias:
            q, k, v = q + blk["bq"], k + blk["bk"], v + blk["bv"]
    q = q.reshape(b, t, H, Dh)
    k = k.reshape(b, t, Hkv, Dh)
    if spec.pos_emb == "rope":
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v.reshape(b, t, Hkv, Dh)


def _out_proj(spec: ModelSpec, blk: Params, attn_out: torch.Tensor
              ) -> torch.Tensor:
    b, t, h, dh = attn_out.shape
    out = matmul_any(attn_out.reshape(b, t, h * dh), blk["wo"])
    if spec.use_bias:
        out = out + blk["bo"]
    return out


# ------------------------------------------------ fused decode seams


def _qkv_norm(spec: ModelSpec, blk: Params, x: torch.Tensor,
              positions: torch.Tensor, fused: bool = False):
    """ln1 + QKV, the norm folded into three ``norm_matmul`` launches when
    the spec and the weights are eligible: RMSNorm and no bias, as in
    JAX, and plain weights (a quantized or fused tree takes the unfused
    chain, as in JAX)."""
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    if fused and spec.norm != "layernorm" and blk.get("ln1_bias") is None \
            and not (spec.use_bias or spec.qkv_bias) \
            and all(norm_matmul_wants(x2, blk.get(m))
                    for m in ("wq", "wk", "wv")):
        H, Hkv, Dh = spec.n_heads, spec.n_kv_heads, spec.head_dim

        def nm(w):
            return norm_matmul(x2, blk["ln1_scale"], w, eps=spec.norm_eps,
                               plus_one=spec.norm_plus_one)

        q = nm(blk["wq"]).reshape(b, t, H, Dh)
        k = nm(blk["wk"]).reshape(b, t, Hkv, Dh)
        v = nm(blk["wv"]).reshape(b, t, Hkv, Dh)
        if spec.pos_emb == "rope":
            # RoPE stays outside the kernel, as in the JAX package
            q = apply_rope(q, positions, spec.rope_theta)
            k = apply_rope(k, positions, spec.rope_theta)
        return q, k, v
    return _qkv(spec, blk, _norm(spec, x, blk["ln1_scale"],
                                 blk.get("ln1_bias")), positions)


def _out_residual(spec: ModelSpec, blk: Params, attn_out: torch.Tensor,
                  x: torch.Tensor, fused: bool = False) -> torch.Tensor:
    """x + out_proj(attn), the residual folded into the epilogue (not
    with an output bias, as in JAX)."""
    if fused and not spec.use_bias:
        b, t, h, dh = attn_out.shape
        a2 = attn_out.reshape(b * t, h * dh)
        if matmul_residual_wants(a2, blk["wo"]):
            return matmul_residual(a2, blk["wo"],
                                   x.reshape(b * t, -1)).reshape(x.shape)
    return x + _out_proj(spec, blk, attn_out)


def _mlp_residual(spec: ModelSpec, blk: Params, x: torch.Tensor,
                  fused: bool = False) -> torch.Tensor:
    """ln2 + MLP + residual; fused: ln2 rides the gate/up projections and
    the residual rides the down projection, where JAX fuses them (RMSNorm,
    a gated dense MLP, no bias; experts take the unfused chain)."""
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    if fused and spec.norm != "layernorm" and not spec.n_experts \
            and not spec.use_bias and _gated(spec) \
            and blk.get("ln2_bias") is None \
            and norm_matmul_wants(x2, blk.get("w_gate")) \
            and norm_matmul_wants(x2, blk.get("w_up")):
        def nm(w):
            return norm_matmul(x2, blk["ln2_scale"], w, eps=spec.norm_eps,
                               plus_one=spec.norm_plus_one)

        gate, up = nm(blk["w_gate"]), nm(blk["w_up"])
        h = _act(spec, gate).to(x.dtype) * up
        if matmul_residual_wants(h, blk["w_down"]):
            return matmul_residual(h, blk["w_down"], x2).reshape(b, t, d)
        return x + matmul_any(h, blk["w_down"]).reshape(b, t, d)
    return x + _mlp(spec, blk, _norm(spec, x, blk["ln2_scale"],
                                     blk.get("ln2_bias")))


def embed(spec: ModelSpec, params: Params, tokens: torch.Tensor,
          positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T] tokens -> [B, T, D] activations. Learned positions are
    gathered at ``positions`` clamped to the table (the JAX gather's
    clamp)."""
    x = params["tok_emb"][tokens.long()]
    if spec.emb_scale:
        x = x * torch.tensor(spec.d_model ** 0.5, dtype=x.dtype)
    if spec.pos_emb == "learned":
        table = params["pos_emb"]
        x = x + table[torch.clamp(positions.long(), 0, table.shape[0] - 1)]
    return x


def unembed(spec: ModelSpec, params: Params, hidden: torch.Tensor
            ) -> torch.Tensor:
    """Final norm + LM head -> fp32 logits [..., V], with no rounding to
    the weight dtype in between (the JAX code's fp32 accumulator output,
    ``preferred_element_type=float32``). The head stays in its storage
    dtype on the card: one cuBLAS call with an fp32 output
    (``aten::mm.dtype``), never an fp32 copy of the [D, V] weight. That
    overload has no CPU kernel, so a CPU tensor widens both operands:
    bf16 values are exact in fp32, and the arithmetic is the same.

    A quantized head takes the normed hidden state in fp32 through
    ``matmul_any`` (the int4 kernel); an int4 head is vocab-padded, and
    its zero pad columns are cut off here, before the softcap
    ``cap * tanh(logits / cap)``."""
    h = _norm(spec, hidden, params["lnf_scale"], params.get("lnf_bias"))
    w = params["tok_emb"].t() if spec.tie_embeddings else params["lm_head"]
    if isinstance(w, QuantizedTensor):
        logits = matmul_any(h.float(), w)[..., : spec.vocab_size]
    elif w.dtype == torch.float32:
        logits = h.to(w.dtype) @ w
    elif h.device.type == "cpu":
        logits = h.to(w.dtype).float() @ w.float()
    else:
        h2 = h.to(w.dtype).reshape(-1, h.shape[-1])
        logits = torch.mm(h2, w, out_dtype=torch.float32).reshape(
            *h.shape[:-1], w.shape[-1])
    if spec.logit_softcap:
        cap = spec.logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


# ------------------------------------------------------------------ prefill


def transformer_block(spec: ModelSpec, blk: Params, x: torch.Tensor,
                      positions: torch.Tensor, attn_fn):
    """One pre-norm block over fresh K/V -> (x_out, k, v)."""
    h = _norm(spec, x, blk["ln1_scale"], blk.get("ln1_bias"))
    q, k, v = _qkv(spec, blk, h, positions)
    x = x + _out_proj(spec, blk, attn_fn(q, k, v))
    h2 = _norm(spec, x, blk["ln2_scale"], blk.get("ln2_bias"))
    return x + _mlp(spec, blk, h2), k, v


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, device=device)[None, :].expand(b, t)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _device_ints(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32)
    return _cuda.upload(np.asarray(a, np.int32), device)


def scatter_indices(page_table, seq_lens, start, t: int, page_size: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Host index lists for writing rows ``[B, T]`` of fresh K/V into a
    layer's pool viewed as ``[N * P, fused]``: (src into the flattened
    [B * T] rows, dst into the pool). Row b's token i lands at absolute
    position ``start[b] + i`` for ``i < seq_lens[b]``; the rest (padding)
    is dropped — the JAX code's out-of-range ``mode="drop"`` scatter."""
    table = _host(page_table).astype(np.int64)
    lens = _host(seq_lens).astype(np.int64)
    b = lens.shape[0]
    local = np.broadcast_to(np.arange(t)[None, :], (b, t))
    valid = local < lens[:, None]
    pos = local if start is None else local + _host(start).astype(
        np.int64)[:, None]
    logical = np.minimum(pos // page_size, table.shape[1] - 1)
    phys = np.take_along_axis(table, logical, axis=1)
    dst = (phys * page_size + pos % page_size)[valid]
    src = (np.arange(b)[:, None] * t + local)[valid]
    return src, dst


def forward_prefill(spec: ModelSpec, params: Params, tokens: torch.Tensor,
                    seq_lens: torch.Tensor):
    """Prompts through every layer -> (hidden [B, T, D], k [L, B, T, Hkv,
    Dh], v)."""
    b, t = tokens.shape
    positions = _positions(b, t, tokens.device)
    x = embed(spec, params, tokens, positions)
    lens = _device_ints(seq_lens, tokens.device)
    ks, vs = [], []
    for layer in range(spec.n_layers):
        x, k, v = transformer_block(
            spec, layer_view(params, layer), x, positions,
            lambda q, k, v: causal_attention(q, k, v, lens,
                                             window=spec.sliding_window))
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def forward_prefill_into_pages(spec: ModelSpec, params: Params,
                               tokens: torch.Tensor, seq_lens,
                               k_pages: torch.Tensor, v_pages: torch.Tensor,
                               page_table):
    """Prefill with each layer's fresh K/V written straight into the page
    pools ``[L, N, P, Hkv*Dh]`` (in place) -> (hidden, k_pages, v_pages).
    ``seq_lens``/``page_table`` may be host arrays (no device sync)."""
    b, t = tokens.shape
    n, p, fused = k_pages.shape[1:]
    dev = tokens.device
    positions = _positions(b, t, dev)
    x = embed(spec, params, tokens, positions)
    lens = _device_ints(seq_lens, dev)
    src, dst = scatter_indices(page_table, seq_lens, None, t, p)
    src = _cuda.upload(src, dev)
    dst = _cuda.upload(dst, dev)
    for layer in range(spec.n_layers):
        x, k, v = transformer_block(
            spec, layer_view(params, layer), x, positions,
            lambda q, k, v: causal_attention(q, k, v, lens,
                                             window=spec.sliding_window))
        # attended unrounded above; the pool takes the JAX cast
        kp = raw_view(k_pages[layer].view(n * p, fused))
        vp = raw_view(v_pages[layer].view(n * p, fused))
        kp[dst] = raw_view(astype_kv(k.reshape(b * t, fused)[src],
                                     k_pages.dtype))
        vp[dst] = raw_view(astype_kv(v.reshape(b * t, fused)[src],
                                     v_pages.dtype))
    return x, k_pages, v_pages


def forward_prefill_suffix(spec: ModelSpec, params: Params,
                           tokens: torch.Tensor, suffix_lens, n_ctx,
                           k_ctx: torch.Tensor, v_ctx: torch.Tensor):
    """Prefill a prompt suffix on cached prefix K/V ``[L, B, Tc, Hkv, Dh]``
    (prefix-cache hit) -> (hidden [B, Ts, D], suffix K [L, B, Ts, Hkv, Dh],
    suffix V)."""
    b, ts = tokens.shape
    dev = tokens.device
    ctx = _device_ints(n_ctx, dev)
    slen = _device_ints(suffix_lens, dev)
    positions = ctx[:, None].long() + torch.arange(ts, device=dev)[None, :]
    x = embed(spec, params, tokens, positions)
    ks, vs = [], []
    for layer in range(spec.n_layers):
        blk = layer_view(params, layer)
        h = _norm(spec, x, blk["ln1_scale"], blk.get("ln1_bias"))
        q, k, v = _qkv(spec, blk, h, positions)
        attn = suffix_attention(q, k_ctx[layer], v_ctx[layer], ctx, k, v,
                                slen, window=spec.sliding_window)
        x = x + _out_proj(spec, blk, attn)
        x = x + _mlp(spec, blk, _norm(spec, x, blk["ln2_scale"],
                                      blk.get("ln2_bias")))
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


# ------------------------------------------------------------------- decode


def forward_decode_window(
    spec: ModelSpec,
    params: Params,
    tokens: torch.Tensor,         # [B] the most recent token per slot
    lengths: torch.Tensor,        # [B] position of `tokens`
    start_lengths: torch.Tensor,  # [B] length at chunk start (frozen prefix)
    k_pages: torch.Tensor,        # [L, N, P, Hkv*Dh] (read-only here)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,     # [B, MP] int32
    side_k: torch.Tensor,         # [L, B, W, Hkv, Dh] chunk side window
    side_v: torch.Tensor,
    active: torch.Tensor,         # [B] bool
    *,
    attn_impl: str = "auto",
    fused: bool = False,
):
    """One decode step with no pool write: the pools hold the frozen
    pre-chunk prefix, this step's K/V goes into the side window (in
    place), and attention over prefix ⊕ window is one flash-decode call
    per layer. Returns (hidden [B, D], side_k, side_v).

    ``attn_impl`` "auto" and "pallas-decode" both take the flash-decode
    kernel: the JAX default ("auto" -> dense XLA gather) is a TPU layout
    choice the port does not carry. "pallas-decode-fw" takes the
    writeback kernel instead: the fresh K/V goes in as its own operand
    and the kernel lands it in the side window, in place of the one-hot
    write. "pallas" takes the paged-attention kernel over the frozen
    prefix on the stacked pool, with flash stats, then the plain
    side-window attention and merge (the JAX package's XLA ops there)."""
    if attn_impl not in ("auto", "pallas", "pallas-decode",
                         "pallas-decode-fw"):
        raise ValueError(f"attn_impl {attn_impl!r} is not ported "
                         "(ROADMAP.md B)")
    fw = attn_impl == "pallas-decode-fw"
    b = tokens.shape[0]
    L, n_pages, page_size, fusedw = k_pages.shape
    w = side_k.shape[2]
    positions = lengths[:, None].long()
    x = embed(spec, params, tokens[:, None], positions)
    idx = (lengths - start_lengths).to(torch.int32)
    kp_flat = k_pages.view(L * n_pages, page_size, fusedw)
    vp_flat = v_pages.view(L * n_pages, page_size, fusedw)
    if fw:
        active_i = active.to(torch.int32)
    else:
        sel = ((torch.arange(w, device=tokens.device)[None, :]
                == idx[:, None]) & active[:, None])[:, :, None, None]
        n_side = (idx + active.to(idx.dtype)).to(torch.int32)
    for layer in range(L):
        blk = layer_view(params, layer)
        q, k, v = _qkv_norm(spec, blk, x, positions, fused=fused)
        sk, sv = side_k[layer], side_v[layer]
        kw = dict(n_kv_heads=spec.n_kv_heads, layer=layer,
                  n_pages_per_layer=n_pages)
        if fw:
            attn, _, _ = flash_decode_attention_fw(
                q[:, 0].contiguous(), kp_flat, vp_flat, page_table,
                start_lengths, sk, sv, k.to(sk.dtype).contiguous(),
                v.to(sv.dtype).contiguous(), idx, active_i, **kw)
        else:
            sk.copy_(torch.where(sel, k[:, 0][:, None].to(sk.dtype), sk))
            sv.copy_(torch.where(sel, v[:, 0][:, None].to(sv.dtype), sv))
            if attn_impl == "pallas":
                prefix = paged_attention(
                    q[:, 0].contiguous(), kp_flat, vp_flat, page_table,
                    start_lengths, with_stats=True, **kw)
                attn = merge_attention(
                    [prefix, window_decode_attention(q[:, 0], sk, sv,
                                                     n_side)],
                    dtype=q.dtype)
            else:
                attn = flash_decode_attention(
                    q[:, 0].contiguous(), kp_flat, vp_flat, page_table,
                    start_lengths, sk, sv, n_side, **kw)
        x = _out_residual(spec, blk, attn[:, None], x, fused=fused)
        x = _mlp_residual(spec, blk, x, fused=fused)
    return x[:, 0, :], side_k, side_v


def forward_decode_paged(
    spec: ModelSpec,
    params: Params,
    tokens: torch.Tensor,         # [B] the most recent token per slot
    lengths: torch.Tensor,        # [B] position of `tokens`
    k_pages: torch.Tensor,        # [L, N, P, Hkv*Dh] written in place
    v_pages: torch.Tensor,
    page_table: torch.Tensor,     # [B, MP] int32
    write_mask: Optional[torch.Tensor] = None,   # [B] bool: which write
    *,
    attn_impl: str = "auto",
    fused: bool = False,
):
    """One decode step against the paged pools: each layer writes every
    slot's fresh K/V into its page at position ``lengths`` (page
    ``lengths // P``, offset ``lengths % P``; capacity is reserved before
    the chunk), then the paged-attention kernel attends over the slot's
    ``lengths + 1`` keys, windowed by ``spec.sliding_window``. Returns
    (hidden [B, D], k_pages, v_pages), the pools updated in place.

    Every ``attn_impl`` takes the paged-attention kernel on the stacked
    pool: the JAX function sends "auto", "xla" and "pallas-decode*" to
    its XLA gather, a TPU layout choice the port does not carry.

    ``write_mask``: decode runs over all slots, and an inactive slot's
    table row points at pages it does not own (page 0, or past a slot that
    retired earlier in the chunk), so its write must not land; JAX drops
    it with an out-of-range scatter index. Which slots write is known only
    on the device, so the destination is computed there: a masked slot
    aims at the row of the first writing slot (``j``) with that slot's own
    value, so the duplicate rows of one ``index_put_`` all carry the same
    bytes; when no slot writes, every row aims at ``j``'s destination with
    the bytes already there."""
    del attn_impl              # one kernel whatever the JAX impl name
    b = tokens.shape[0]
    L, n, p, fusedw = k_pages.shape
    dev = tokens.device
    positions = lengths[:, None].long()
    x = embed(spec, params, tokens[:, None], positions)
    table = _device_ints(page_table, dev)
    logical = torch.clamp(lengths.long() // p, max=table.shape[1] - 1)
    rows = (table.gather(1, logical[:, None])[:, 0].long() * p
            + lengths.long() % p)                            # [B] in a layer
    if write_mask is None:
        write_mask = torch.ones((b,), dtype=torch.bool, device=dev)
    mask = write_mask.to(torch.bool)
    # [1] index tensors, not 0-d ones: indexing with a 0-d tensor reads it
    # on the host
    j = torch.argmax(mask.to(torch.int32)).reshape(1)       # first writer
    any_write = mask.any()
    dst = torch.where(mask, rows, rows[j])                   # [B]
    kp_rows = k_pages.view(L * n * p, fusedw)
    vp_rows = v_pages.view(L * n * p, fusedw)
    kp_flat = k_pages.view(L * n, p, fusedw)
    vp_flat = v_pages.view(L * n, p, fusedw)
    lens1 = (lengths + 1).to(torch.int32)

    def land(pool_rows, fresh, idx):
        # rounded into the pool dtype first: the kernel then attends to
        # the stored bits, as the JAX scatter-then-attend does
        fresh = raw_view(astype_kv(fresh.reshape(b, fusedw),
                                   pool_rows.dtype))
        rows_b = raw_view(pool_rows)
        anchor = torch.where(any_write, fresh[j], rows_b[idx[j]])
        rows_b.index_put_((idx,), torch.where(mask[:, None], fresh, anchor))

    for layer in range(L):
        blk = layer_view(params, layer)
        q, k, v = _qkv_norm(spec, blk, x, positions, fused=fused)
        idx = dst + layer * n * p
        land(kp_rows, k, idx)
        land(vp_rows, v, idx)
        attn = paged_attention(
            q[:, 0].contiguous(), kp_flat, vp_flat, table, lens1,
            n_kv_heads=spec.n_kv_heads, window=spec.sliding_window,
            layer=layer, n_pages_per_layer=n)
        x = _out_residual(spec, blk, attn[:, None], x, fused=fused)
        x = _mlp_residual(spec, blk, x, fused=fused)
    return x[:, 0, :], k_pages, v_pages


def forward_mixed_step(
    spec: ModelSpec,
    params: Params,
    tokens: torch.Tensor,       # [R, Qm] per-row fresh tokens (right-padded)
    ctx_lens: torch.Tensor,     # [R] tokens already in the row's pages
    q_lens: torch.Tensor,       # [R] 0 = inert row, 1 = decode, >1 = chunk
    k_pages: torch.Tensor,      # [L, N, P, Hkv*Dh] written in place
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # [R, MP] int32
    *,
    return_hidden_all: bool = False,
):
    """One ragged mixed-batch step (the JAX function's "pallas-ragged"
    branch): decode rows (one token) and prefill-chunk rows share one
    forward against the paged pools, one ragged attention call per layer
    on the stacked pools, and every row's fresh K/V lands in its reserved
    pages (``ops/ragged_attention.py``).

    Row r's token i sits at absolute position ``ctx_lens[r] + i``; rows
    ``i >= q_lens[r]`` are padding. Returns (the hidden state at each
    row's last valid token [R, D] — or the whole lattice [R, Qm, D] with
    ``return_hidden_all`` — plus the pools, updated in place where the
    JAX function donated them). Rows with ``q_lens == 0`` carry garbage
    hidden; callers mask them."""
    if spec.sliding_window:
        raise ValueError(
            "forward_mixed_step does not support sliding-window specs "
            "(the ragged kernel has no window mask); use the split "
            "prefill/decode path")
    r, qm = tokens.shape
    L, n, p, fusedw = k_pages.shape
    dev = tokens.device
    ctx = _device_ints(ctx_lens, dev)
    ql = _device_ints(q_lens, dev)
    positions = ctx[:, None].long() + torch.arange(qm, device=dev)[None, :]
    x = embed(spec, params, tokens, positions)
    table = _device_ints(page_table, dev)
    kp_flat = k_pages.view(L * n, p, fusedw)
    vp_flat = v_pages.view(L * n, p, fusedw)
    for layer in range(L):
        blk = layer_view(params, layer)
        h = _norm(spec, x, blk["ln1_scale"], blk.get("ln1_bias"))
        q, k, v = _qkv(spec, blk, h, positions)
        attn, _, _ = ragged_attention(
            q.contiguous(), kp_flat, vp_flat, table, ctx, ql,
            k.contiguous(), v.contiguous(), n_kv_heads=spec.n_kv_heads,
            layer=layer, n_pages_per_layer=n)
        x = x + _out_proj(spec, blk, attn)
        x = x + _mlp(spec, blk, _norm(spec, x, blk["ln2_scale"],
                                      blk.get("ln2_bias")))
    if return_hidden_all:
        return x, k_pages, v_pages
    last = x[torch.arange(r, device=dev), torch.clamp(ql.long() - 1, min=0)]
    return last, k_pages, v_pages


# ------------------------------------------------------ dense-cache decode


def dense_kv_cache(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """A zeroed dense KV cache ``[L, B, S, Hkv, Dh]`` (the static and
    speculative engines' layout) whose storage holds one spare row of
    ``Hkv * Dh`` past its end: the target of ``forward_decode``'s and
    ``forward_window``'s dropped writes (the JAX scatters' out-of-range
    ``mode="drop"``), which no read of the cache reaches."""
    L, b, s, hkv, dh = shape
    rows = torch.zeros((L * b * s + 1, hkv * dh * dtype.itemsize),
                       dtype=torch.uint8, device=device).view(dtype)
    return rows[:-1].view(L, b, s, hkv, dh)


def _cache_rows(cache: torch.Tensor) -> torch.Tensor:
    """A ``dense_kv_cache`` as its rows ``[L * B * S + 1, Hkv * Dh]``, the
    spare row last (a view: writes land in the cache)."""
    L, b, s, hkv, dh = cache.shape
    n, fused = L * b * s, hkv * dh
    need = (cache.storage_offset() + (n + 1) * fused) * cache.element_size()
    if not cache.is_contiguous() or cache.untyped_storage().nbytes() < need:
        raise ValueError("a dense KV cache needs its spare row for dropped "
                         "writes: make it with dense_kv_cache")
    return cache.as_strided((n + 1, fused), (fused, 1))


def _write_dense(rows: torch.Tensor, fresh: torch.Tensor, layer: int,
                 b: int, s: int, pos: torch.Tensor, valid: torch.Tensor
                 ) -> None:
    """Write ``fresh`` [B, W, Hkv, Dh] at ``(layer, b, pos[b, w])`` of a
    cache's rows, rounded into its dtype (the JAX cast); a position that
    is not ``valid`` or lies past ``S`` goes to the spare row."""
    w = pos.shape[1]
    keep = valid & (pos >= 0) & (pos < s)
    base = (layer * b + torch.arange(b, device=pos.device))[:, None] * s
    idx = torch.where(keep, base + pos.long(),
                      torch.full_like(pos, rows.shape[0] - 1, dtype=torch.long))
    vals = astype_kv(fresh.reshape(b * w, rows.shape[1]), rows.dtype)
    raw_view(rows).index_put_((idx.reshape(-1),), raw_view(vals))


def forward_window(spec: ModelSpec, params: Params, tokens: torch.Tensor,
                   n_valid: torch.Tensor, start: torch.Tensor,
                   cache_k: torch.Tensor, cache_v: torch.Tensor):
    """The W-token verify and catch-up step over a dense cache (the JAX
    ``forward_window``): window token i of slot b sits at position
    ``start[b] + i``; each layer writes the window's K/V into the cache
    (slots ``i >= n_valid[b]`` and positions past ``S`` dropped), then
    attends to the cache before ``start`` plus the causal window, its own
    K/V unrounded (``suffix_attention``). Returns (logits [B, W, V] fp32,
    cache_k, cache_v), the caches (``dense_kv_cache``) updated in place.
    Position i of the logits is the next-token distribution after window
    token i."""
    b, w = tokens.shape
    s = cache_k.shape[2]
    dev = tokens.device
    start = _device_ints(start, dev)
    n_valid = _device_ints(n_valid, dev)
    ar = torch.arange(w, device=dev)[None, :]
    positions = start[:, None].long() + ar
    valid = ar < n_valid[:, None]
    x = embed(spec, params, tokens, positions)
    k_rows, v_rows = _cache_rows(cache_k), _cache_rows(cache_v)
    for layer in range(cache_k.shape[0]):
        blk = layer_view(params, layer)
        h = _norm(spec, x, blk["ln1_scale"], blk.get("ln1_bias"))
        q, k, v = _qkv(spec, blk, h, positions)
        _write_dense(k_rows, k, layer, b, s, positions, valid)
        _write_dense(v_rows, v, layer, b, s, positions, valid)
        attn = suffix_attention(
            q, cache_k[layer].to(q.dtype), cache_v[layer].to(q.dtype),
            start, k, v, n_valid, window=spec.sliding_window)
        x = x + _out_proj(spec, blk, attn)
        x = x + _mlp(spec, blk, _norm(spec, x, blk["ln2_scale"],
                                      blk.get("ln2_bias")))
    return unembed(spec, params, x), cache_k, cache_v


def forward_decode(spec: ModelSpec, params: Params, tokens: torch.Tensor,
                   lengths: torch.Tensor, cache_k: torch.Tensor,
                   cache_v: torch.Tensor, *, fused: bool = False):
    """One decode step over a dense cache (the JAX ``forward_decode``):
    each layer writes every slot's fresh K/V at position ``lengths[b]``
    (past ``S``: dropped), then attends over the slot's ``lengths + 1``
    stored keys (``cached_attention``, windowed by the spec). ``fused``
    takes the fused decode seams, as in JAX. Returns (hidden [B, D],
    cache_k, cache_v), the caches (``dense_kv_cache``) updated in place.
    Lengths stay on the device: no host read."""
    b = tokens.shape[0]
    s = cache_k.shape[2]
    positions = lengths[:, None].long()
    x = embed(spec, params, tokens[:, None], positions)
    k_rows, v_rows = _cache_rows(cache_k), _cache_rows(cache_v)
    valid = torch.ones((b, 1), dtype=torch.bool, device=tokens.device)
    lens1 = lengths + 1
    for layer in range(cache_k.shape[0]):
        blk = layer_view(params, layer)
        q, k, v = _qkv_norm(spec, blk, x, positions, fused=fused)
        _write_dense(k_rows, k, layer, b, s, positions, valid)
        _write_dense(v_rows, v, layer, b, s, positions, valid)
        attn = cached_attention(q, cache_k[layer], cache_v[layer], lens1,
                                window=spec.sliding_window)
        x = _out_residual(spec, blk, attn, x, fused=fused)
        x = _mlp_residual(spec, blk, x, fused=fused)
    return x[:, 0, :], cache_k, cache_v


def write_prefill_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                        ks: torch.Tensor, vs: torch.Tensor, page_table,
                        seq_lens, start=None):
    """Write fresh K/V ``[L, B, T, Hkv, Dh]`` into the pools (in place):
    row b's token i goes to absolute position ``start[b] + i`` for ``i <
    seq_lens[b]``. ``page_table``/``seq_lens``/``start`` may be host
    arrays (no device sync). Returns (k_pages, v_pages)."""
    L, B, T, Hkv, Dh = ks.shape
    n, p, fused = k_pages.shape[1:]
    src, dst = scatter_indices(page_table, seq_lens, start, T, p)
    if dst.size == 0:
        return k_pages, v_pages
    dev = k_pages.device
    src = _cuda.upload(src, dev)
    dst = _cuda.upload(dst, dev)
    kflat = raw_view(k_pages.view(L, n * p, fused))
    vflat = raw_view(v_pages.view(L, n * p, fused))
    kflat[:, dst] = raw_view(astype_kv(ks.reshape(L, B * T, fused)[:, src],
                                       k_pages.dtype))
    vflat[:, dst] = raw_view(astype_kv(vs.reshape(L, B * T, fused)[:, src],
                                       v_pages.dtype))
    return k_pages, v_pages


def pages_with_drop_row(shape, dtype: torch.dtype, device
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A zeroed page pool ``shape = [L, N, P, fused]`` and its rows viewed
    as ``[L * N * P + 1, fused]``: one storage whose last row lies past
    every page, the target of ``write_pages_device``'s dropped writes (no
    page table names it, so the allocator never hands it out)."""
    L, n, p, fused = shape
    # zero bytes viewed in the pool dtype: no fill kernel of that dtype
    # (e4m3 included) is needed
    rows = torch.zeros((L * n * p + 1, fused * dtype.itemsize),
                       dtype=torch.uint8, device=device).view(dtype)
    return rows[:-1].view(L, n, p, fused), rows


def write_pages_device(k_rows: torch.Tensor, v_rows: torch.Tensor,
                       ks: torch.Tensor, vs: torch.Tensor,
                       page_table: torch.Tensor, seq_lens: torch.Tensor,
                       start: torch.Tensor, page_size: int):
    """``write_prefill_pages`` with the indices formed on the device, so it
    needs no host value and can run inside a CUDA graph (the decode chunk's
    page flush): row b's token i of ``ks``/``vs`` ``[L, B, T, Hkv, Dh]``
    goes to absolute position ``start[b] + i`` of its pages for ``i <
    seq_lens[b]`` (device tensors). ``k_rows``/``v_rows`` are the pools'
    rows with their drop row (``pages_with_drop_row``): every other token
    (a count of 0, padding) is aimed at that row, the JAX scatter's
    out-of-range ``mode="drop"``, so no page a slot owns and no shared
    prefix page is written. Returns (k_rows, v_rows), updated in place."""
    L, B, T, Hkv, Dh = ks.shape
    drop = k_rows.shape[0] - 1
    per_layer = drop // L
    dev = ks.device
    local = torch.arange(T, device=dev)[None, :]                   # [1, T]
    valid = local < seq_lens.to(dev).long()[:, None]               # [B, T]
    pos = local + start.to(dev).long()[:, None]
    logical = torch.clamp(pos // page_size, max=page_table.shape[1] - 1)
    phys = torch.gather(page_table.long(), 1, logical)
    dst = phys * page_size + pos % page_size                       # [B, T]
    layer0 = torch.arange(L, device=dev)[:, None, None] * per_layer
    idx = torch.where(valid[None], layer0 + dst[None],
                      torch.full_like(layer0 + dst[None], drop)).reshape(-1)
    fused = Hkv * Dh
    raw_view(k_rows).index_put_((idx,), raw_view(astype_kv(
        ks.reshape(L * B * T, fused), k_rows.dtype)))
    raw_view(v_rows).index_put_((idx,), raw_view(astype_kv(
        vs.reshape(L * B * T, fused), v_rows.dtype)))
    return k_rows, v_rows


# ---------------------------------------------------------------- training


def forward_train(spec: ModelSpec, params: Params, tokens: torch.Tensor,
                  seq_lens) -> torch.Tensor:
    """Full-sequence logits for scoring: [B, T, V] fp32."""
    hidden, _, _ = forward_prefill(spec, params, tokens, seq_lens)
    return unembed(spec, params, hidden)
