"""HF safetensors checkpoints into the stacked-layer parameter tree (port
of the JAX package's ``models/loader.py``).

``load_checkpoint`` maps a local HuggingFace checkpoint directory (GPT-2,
Llama naming: Llama, Mistral, Qwen2, Gemma, or Mixtral's, whose
``block_sparse_moe`` router and experts stack to ``[L, D, E]`` and ``[L,
E, ...]``) onto the stacked ``[L, ...]`` tree of ``models/base.py``, cast
to the spec's dtype; the casts round as the JAX ``astype`` does (fp32 to
bf16 to nearest even). The files
are read by the port's own reader (``utils/safetensors_io.py``); a sharded
directory's shards are globbed in name order and its index file is not
read, as in JAX.

The JAX loader reads every tensor into host memory, stacks the layers on
the host and then casts (about twice the model's bytes in host RAM at
Llama-3-8B). Here each stacked leaf is allocated once on ``device`` and
each layer's tensor is copied into its slice straight from the mapped
file, transposed (Llama's ``nn.Linear`` is ``[out, in]``) and cast there;
the file's pages are released once copied. The result is the same bits.
With ``bits`` (a quantized deploy) each block weight is quantized a layer
at a time as it is read (``ops/quant.py:StackedQuantizer``), so the
full-precision stack is never whole on the device (a published Mixtral
checkpoint is 93 GB in bf16); the bits are those of ``quantize_params``
over the loaded tree, which then quantizes the LM head.

``spec_from_hf_config`` reads ``config.json`` with the JAX package's
exact-match rule: a relative that shares a name prefix (``gemma2``,
``qwen3``) raises ``ValueError``. ``save_checkpoint_gpt2`` writes a tree
back in GPT-2 naming (a test fixture, as in JAX).

Nothing is downloaded: the weights must already be on local disk.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops.quant import StackedQuantizer
from ..utils.safetensors_io import SafetensorsFile, iter_checkpoint, save_file
from .base import ModelSpec, Params


class _Checkpoint:
    """The tensors of a checkpoint directory by name, across its shards;
    each is read by copying it into a destination tensor."""

    def __init__(self, path: pathlib.Path) -> None:
        self.files = [SafetensorsFile(str(p)) for p in iter_checkpoint(path)]
        self.where = {name: f for f in self.files for name in f.keys()}
        self.bytes_read = 0

    def __contains__(self, name: str) -> bool:
        return name in self.where

    def _file(self, name: str) -> SafetensorsFile:
        if name not in self.where:
            raise KeyError(f"checkpoint missing tensor {name}")
        return self.where[name]

    def shape(self, name: str, transpose: bool = False,
              cols: Optional[Tuple[int, int]] = None) -> Tuple[int, ...]:
        shape = list(self._file(name).shape(name))
        if cols is not None:
            shape[-1] = cols[1] - cols[0]
        return tuple(reversed(shape)) if transpose else tuple(shape)

    def copy_into(self, name: str, dst: torch.Tensor, transpose: bool = False,
                  cols: Optional[Tuple[int, int]] = None) -> None:
        """``dst.copy_`` of tensor ``name`` (its last axis cut to ``cols``,
        then transposed), moved to ``dst``'s device in the file's dtype and
        cast there."""
        f = self._file(name)
        src = f.get(name).to(dst.device)
        self.bytes_read += src.numel() * src.element_size()
        if cols is not None:
            src = src[..., cols[0]:cols[1]]
        dst.copy_(src.t() if transpose else src)
        del src
        f.release(name)

    def close(self) -> None:
        for f in self.files:
            f.close()


class _Leaves:
    """Leaf builders over a ``_Checkpoint``: every leaf is allocated once,
    in the spec's dtype, on the target device; with ``bits`` a block
    weight (``quant=True``) is quantized a layer at a time instead."""

    def __init__(self, ck: _Checkpoint, spec: ModelSpec, device,
                 bits: int = 0) -> None:
        self.ck, self.dtype, self.device = ck, spec.torch_dtype, device
        self.n_layers, self.n_experts = spec.n_layers, spec.n_experts
        self.bits = bits

    def one(self, name: str, transpose: bool = False) -> torch.Tensor:
        out = torch.empty(self.ck.shape(name, transpose), dtype=self.dtype,
                          device=self.device)
        self.ck.copy_into(name, out, transpose)
        return out

    def stack(self, template: str, transpose: bool = False,
              cols: Optional[Tuple[int, int]] = None, quant: bool = False):
        """``[L, ...]`` of the tensors ``template.format(layer)``."""
        shape = self.ck.shape(template.format(0), transpose, cols)
        return self._layers(shape, quant, 0, lambda layer, dst: (
            self.ck.copy_into(template.format(layer), dst, transpose, cols)))

    def experts(self, template: str, transpose: bool = False,
                quant: bool = False):
        """``[L, E, ...]`` of the tensors ``template.format(layer,
        expert)``."""
        shape = self.ck.shape(template.format(0, 0), transpose)

        def fill(layer, dst):
            for e in range(self.n_experts):
                self.ck.copy_into(template.format(layer, e), dst[e],
                                  transpose)

        return self._layers((self.n_experts, *shape), quant, 1, fill)

    def _layers(self, shape, quant: bool, axis: int, fill):
        """A stacked leaf of per-layer ``shape``, each layer written by
        ``fill(layer, dst)``; quantized over its ``axis`` when ``quant``
        and ``bits`` are set."""
        if not (quant and self.bits):
            out = torch.empty((self.n_layers, *shape), dtype=self.dtype,
                              device=self.device)
            for layer in range(self.n_layers):
                fill(layer, out[layer])
            return out
        sq = StackedQuantizer(self.n_layers, axis, self.bits)
        buf = torch.empty(shape, dtype=self.dtype, device=self.device)
        for layer in range(self.n_layers):
            fill(layer, buf)
            sq.put(layer, buf)
        return sq.qt


# HF GPT-2 Conv1D stores weights as [in, out] (no transpose for x @ W);
# HF Llama nn.Linear stores [out, in] (transposed to the [in, out] layout).

def _map_gpt2(ck: _Checkpoint, leaves: _Leaves, spec: ModelSpec
              ) -> Dict[str, Any]:
    D = spec.d_model
    pre = "" if "wte.weight" in ck else "transformer."
    h = pre + "h.{}."
    thirds = {"q": (0, D), "k": (D, 2 * D), "v": (2 * D, 3 * D)}
    blocks = {
        "ln1_scale": leaves.stack(h + "ln_1.weight"),
        "ln1_bias": leaves.stack(h + "ln_1.bias"),
        "ln2_scale": leaves.stack(h + "ln_2.weight"),
        "ln2_bias": leaves.stack(h + "ln_2.bias"),
        # the fused c_attn [D, 3D] and its bias [3D], split at D and 2D
        **{f"w{x}": leaves.stack(h + "attn.c_attn.weight", cols=c,
                                 quant=True)
           for x, c in thirds.items()},
        **{f"b{x}": leaves.stack(h + "attn.c_attn.bias", cols=c)
           for x, c in thirds.items()},
        "wo": leaves.stack(h + "attn.c_proj.weight", quant=True),
        "bo": leaves.stack(h + "attn.c_proj.bias"),
        "w_up": leaves.stack(h + "mlp.c_fc.weight", quant=True),
        "b_up": leaves.stack(h + "mlp.c_fc.bias"),
        "w_down": leaves.stack(h + "mlp.c_proj.weight", quant=True),
        "b_down": leaves.stack(h + "mlp.c_proj.bias"),
    }
    return {
        "tok_emb": leaves.one(pre + "wte.weight"),
        "pos_emb": leaves.one(pre + "wpe.weight"),
        "blocks": blocks,
        "lnf_scale": leaves.one(pre + "ln_f.weight"),
        "lnf_bias": leaves.one(pre + "ln_f.bias"),
    }


def _map_llama_attn(ck: _Checkpoint, leaves: _Leaves, spec: ModelSpec,
                    pre: str) -> Dict[str, Any]:
    """The Llama-family tree minus the MLP weights (shared with
    Mixtral)."""
    lay = pre + "layers.{}."
    attn = lay + "self_attn."
    blocks = {
        "ln1_scale": leaves.stack(lay + "input_layernorm.weight"),
        "ln2_scale": leaves.stack(lay + "post_attention_layernorm.weight"),
        "wq": leaves.stack(attn + "q_proj.weight", transpose=True,
                           quant=True),
        "wk": leaves.stack(attn + "k_proj.weight", transpose=True,
                           quant=True),
        "wv": leaves.stack(attn + "v_proj.weight", transpose=True,
                           quant=True),
        "wo": leaves.stack(attn + "o_proj.weight", transpose=True,
                           quant=True),
    }
    if spec.qkv_bias:   # Qwen2: biases on q/k/v only
        for x in "qkv":
            blocks[f"b{x}"] = leaves.stack(attn + f"{x}_proj.bias")
    emb_key = pre + "embed_tokens.weight"
    params = {
        "tok_emb": leaves.one(emb_key),
        "blocks": blocks,
        "lnf_scale": leaves.one(pre + "norm.weight"),
    }
    if not spec.tie_embeddings:
        # HF tied checkpoints omit lm_head: the embedding stands in for it
        params["lm_head"] = leaves.one(
            "lm_head.weight" if "lm_head.weight" in ck else emb_key,
            transpose=True)
    return params


def _map_llama(ck: _Checkpoint, leaves: _Leaves, spec: ModelSpec
               ) -> Dict[str, Any]:
    pre = "model." if "model.embed_tokens.weight" in ck else ""
    params = _map_llama_attn(ck, leaves, spec, pre)
    mlp = pre + "layers.{}.mlp."
    params["blocks"].update({
        name: leaves.stack(mlp + f"{hf}_proj.weight", transpose=True,
                           quant=True)
        for name, hf in (("w_gate", "gate"), ("w_up", "up"),
                         ("w_down", "down"))})
    return params


def _map_mixtral(ck: _Checkpoint, leaves: _Leaves, spec: ModelSpec
                 ) -> Dict[str, Any]:
    """HF Mixtral naming: the attention and norm tree is Llama's; the MLP
    is the router ``block_sparse_moe.gate`` ``[E, D]`` (transposed to
    ``[D, E]``) and each expert's ``w1`` (gate), ``w2`` (down) and ``w3``
    (up), transposed and stacked ``[L, E, ...]``."""
    pre = "model." if "model.embed_tokens.weight" in ck else ""
    params = _map_llama_attn(ck, leaves, spec, pre)
    moe = pre + "layers.{}.block_sparse_moe."
    params["blocks"]["w_router"] = leaves.stack(moe + "gate.weight",
                                                transpose=True)
    params["blocks"].update({
        name: leaves.experts(moe + "experts.{}." + hf + ".weight",
                             transpose=True, quant=True)
        for name, hf in (("w_gate", "w1"), ("w_down", "w2"),
                         ("w_up", "w3"))})
    return params


def load_checkpoint(path: str, spec: ModelSpec, device="cuda",
                    stats: Optional[Dict[str, Any]] = None,
                    bits: int = 0) -> Params:
    """Load a local HF checkpoint directory into the stacked parameter
    tree on ``device``, cast to ``spec.dtype``; with ``bits`` (8 or 4)
    the block weights quantized a layer at a time as they are read (the
    LM head is left to ``quantize_params``). ``stats`` (optional)
    receives ``bytes_read``, the file bytes the load copied."""
    ck = _Checkpoint(pathlib.Path(path))
    try:
        names = list(ck.where)
        if any(k.endswith("wte.weight") for k in names):
            mapper = _map_gpt2
        elif any("block_sparse_moe" in k for k in names):
            mapper = _map_mixtral
        elif any(k.endswith("embed_tokens.weight") for k in names):
            mapper = _map_llama
        else:
            raise ValueError(f"unrecognized checkpoint naming in {path}")
        with torch.no_grad():
            tree = mapper(ck, _Leaves(ck, spec, torch.device(device), bits),
                          spec)
        if stats is not None:
            stats["bytes_read"] = ck.bytes_read
        return tree
    finally:
        ck.close()


def _llama_like(cfg: Dict[str, Any], **quirks: Any) -> ModelSpec:
    """Common spec kwargs for every Llama-shaped HF config (llama, qwen2,
    mistral, gemma); the family branches pass only their distinguishing
    flags."""
    base: Dict[str, Any] = dict(
        vocab_size=cfg["vocab_size"],
        d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
        d_ff=cfg["intermediate_size"],
        max_seq_len=cfg.get("max_position_embeddings", 4096),
        pos_emb="rope",
        norm="rmsnorm",
        mlp="swiglu",
        use_bias=False,
        tie_embeddings=cfg.get("tie_word_embeddings", False),
        rope_theta=cfg.get("rope_theta", 10000.0),
        norm_eps=cfg.get("rms_norm_eps", 1e-5),
    )
    base.update(quirks)
    return ModelSpec(**base).validate()


def spec_from_hf_config(path: str, cfg: Optional[dict] = None) -> ModelSpec:
    """A ModelSpec from a HF ``config.json`` (``cfg``: the parsed dict, to
    skip the read). Matches ``model_type`` exactly, with the first
    ``architectures`` entry as fallback: a near-miss relative
    (``gemma2``, ``qwen3``) raises rather than load as the wrong family."""
    if cfg is None:
        cfg = json.loads((pathlib.Path(path) / "config.json").read_text())
    arch = (cfg.get("architectures") or [""])[0].lower()
    mt = cfg.get("model_type", "")

    def is_(family: str) -> bool:
        return mt == family or arch == f"{family}forcausallm"

    if mt == "gpt2" or "gpt2" in arch:
        return ModelSpec(
            vocab_size=cfg["vocab_size"],
            d_model=cfg["n_embd"],
            n_layers=cfg["n_layer"],
            n_heads=cfg["n_head"],
            n_kv_heads=cfg["n_head"],
            d_ff=4 * cfg["n_embd"],
            max_seq_len=cfg.get("n_positions", 1024),
            pos_emb="learned",
            norm="layernorm",
            mlp="gelu",
            use_bias=True,
            tie_embeddings=True,
            norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
        ).validate()
    if is_("mixtral"):
        return _llama_like(
            cfg,
            max_seq_len=cfg.get("max_position_embeddings", 32768),
            rope_theta=cfg.get("rope_theta", 1e6),
            n_experts=cfg["num_local_experts"],
            experts_per_token=cfg.get("num_experts_per_tok", 2),
        )
    if is_("qwen2"):
        return _llama_like(
            cfg,
            max_seq_len=cfg.get("max_position_embeddings", 32768),
            rope_theta=cfg.get("rope_theta", 1e6),
            norm_eps=cfg.get("rms_norm_eps", 1e-6),
            qkv_bias=True,
        )
    if is_("mistral"):
        return _llama_like(
            cfg,
            max_seq_len=cfg.get("max_position_embeddings", 32768),
            sliding_window=cfg.get("sliding_window") or 0,
        )
    if is_("gemma"):
        return _llama_like(
            cfg,
            max_seq_len=cfg.get("max_position_embeddings", 8192),
            mlp="geglu",
            tie_embeddings=True,   # Gemma always ties; HF omits lm_head
            norm_eps=cfg.get("rms_norm_eps", 1e-6),
            head_dim_override=cfg.get("head_dim", 0),
            emb_scale=True,
            norm_plus_one=True,
        )
    if is_("llama"):
        return _llama_like(cfg)
    raise ValueError(f"unsupported architecture in {path}: "
                     f"model_type={mt!r} architectures={arch!r}")


def save_checkpoint_gpt2(path: str, params: Params, spec: ModelSpec) -> None:
    """Write a GPT-2 tree back out in HF GPT-2 naming, fp32 (a test
    fixture and export, as in JAX)."""
    b = params["blocks"]

    def f32(t: torch.Tensor) -> torch.Tensor:
        return t.detach().float()

    raw: Dict[str, torch.Tensor] = {
        "wte.weight": f32(params["tok_emb"]),
        "wpe.weight": f32(params["pos_emb"]),
        "ln_f.weight": f32(params["lnf_scale"]),
        "ln_f.bias": f32(params["lnf_bias"]),
    }
    qkv = torch.cat([f32(b["wq"]), f32(b["wk"]), f32(b["wv"])], dim=-1)
    qkv_b = torch.cat([f32(b["bq"]), f32(b["bk"]), f32(b["bv"])], dim=-1)
    for layer in range(spec.n_layers):
        raw[f"h.{layer}.attn.c_attn.weight"] = qkv[layer]
        raw[f"h.{layer}.attn.c_attn.bias"] = qkv_b[layer]
        for ours, theirs in (
            ("ln1_scale", "ln_1.weight"), ("ln1_bias", "ln_1.bias"),
            ("ln2_scale", "ln_2.weight"), ("ln2_bias", "ln_2.bias"),
            ("wo", "attn.c_proj.weight"), ("bo", "attn.c_proj.bias"),
            ("w_up", "mlp.c_fc.weight"), ("b_up", "mlp.c_fc.bias"),
            ("w_down", "mlp.c_proj.weight"), ("b_down", "mlp.c_proj.bias"),
        ):
            raw[f"h.{layer}.{theirs}"] = f32(b[ours][layer])
    save_file(raw, str(pathlib.Path(path) / "model.safetensors"))
