"""GPT-2 family specs (copy of the JAX package's ``models/gpt2.py``
table; its ``BASELINE.json`` configs[1] is ``gpt2``, 124M): learned
positions, LayerNorm with biases, an ungated GELU MLP, biases on every
projection, tied embeddings, the GPT-2 BPE's 50,257-token vocab and 1,024
positions."""

from __future__ import annotations

from .base import ModelSpec

_FAMILY = {
    # name: (layers, d_model, heads)
    "gpt2": (12, 768, 12),          # 124M
    "gpt2-medium": (24, 1024, 16),  # 350M
    "gpt2-large": (36, 1280, 20),   # 774M
    "gpt2-xl": (48, 1600, 25),      # 1.5B
}


def gpt2_spec(size: str = "gpt2", **overrides) -> ModelSpec:
    if size not in _FAMILY:
        raise ValueError(f"unknown gpt2 size {size!r}; choose from {sorted(_FAMILY)}")
    layers, d_model, heads = _FAMILY[size]
    base = dict(
        vocab_size=50257,
        d_model=d_model,
        n_layers=layers,
        n_heads=heads,
        n_kv_heads=heads,
        d_ff=4 * d_model,
        max_seq_len=1024,
        pos_emb="learned",
        norm="layernorm",
        mlp="gelu",
        use_bias=True,
        tie_embeddings=True,
    )
    base.update(overrides)
    return ModelSpec(**base).validate()
