"""Gemma family specs (copy of the JAX package's ``models/gemma.py``
table): head_dim decoupled from d_model/n_heads (``head_dim_override``,
256 at the published sizes), embeddings scaled by sqrt(d_model)
(``emb_scale``), RMSNorm weights stored as (w - 1) (``norm_plus_one``), a
GeGLU MLP, tied embeddings, and one KV head for the 8 query heads of the
2B size. "-tiny" keeps every quirk at test scale, with a head_dim that
d_model/n_heads would not give."""

from __future__ import annotations

from .base import ModelSpec

_FAMILY = {
    # name: (layers, d_model, heads, kv_heads, head_dim, d_ff, vocab, max_seq)
    "gemma-7b": (28, 3072, 16, 16, 256, 24576, 256000, 8192),
    "gemma-2b": (18, 2048, 8, 1, 256, 16384, 256000, 8192),
    "gemma-tiny": (4, 256, 4, 1, 32, 512, 1024, 512),
}


def gemma_spec(size: str = "gemma-7b", **overrides) -> ModelSpec:
    if size not in _FAMILY:
        raise ValueError(
            f"unknown gemma size {size!r}; choose from {sorted(_FAMILY)}")
    layers, d_model, heads, kv_heads, head_dim, d_ff, vocab, max_seq = _FAMILY[size]
    base = dict(
        vocab_size=vocab,
        d_model=d_model,
        n_layers=layers,
        n_heads=heads,
        n_kv_heads=kv_heads,
        d_ff=d_ff,
        max_seq_len=max_seq,
        pos_emb="rope",
        norm="rmsnorm",
        mlp="geglu",
        use_bias=False,
        tie_embeddings=True,
        rope_theta=10000.0,
        norm_eps=1e-6,
        head_dim_override=head_dim,
        emb_scale=True,
        norm_plus_one=True,
    )
    base.update(overrides)
    return ModelSpec(**base).validate()
