"""Mistral family specs (copy of the JAX package's ``models/mistral.py``
table): Llama-shaped (RoPE, RMSNorm, SwiGLU, GQA, no biases) with the
family's sliding window carried as ``ModelSpec.sliding_window``. v0.1
attends only to the last 4096 positions; v0.3 dropped the window and
widened the vocab. "-tiny" uses a 64-token window so the CPU tests reach
the window masks at test scale."""

from __future__ import annotations

from .base import ModelSpec

_FAMILY = {
    # name: (layers, d_model, heads, kv_heads, d_ff, vocab, theta, max_seq, window)
    "mistral-7b": (32, 4096, 32, 8, 14336, 32768, 1e6, 32768, 0),       # v0.3
    "mistral-7b-v01": (32, 4096, 32, 8, 14336, 32000, 10000.0, 32768, 4096),
    "mistral-tiny": (4, 256, 8, 4, 688, 1024, 10000.0, 512, 64),
}


def mistral_spec(size: str = "mistral-7b", **overrides) -> ModelSpec:
    if size not in _FAMILY:
        raise ValueError(
            f"unknown mistral size {size!r}; choose from {sorted(_FAMILY)}")
    (layers, d_model, heads, kv_heads, d_ff, vocab, theta, max_seq,
     window) = _FAMILY[size]
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
        mlp="swiglu",
        use_bias=False,
        tie_embeddings=False,
        rope_theta=theta,
        norm_eps=1e-5,
        sliding_window=window,
    )
    base.update(overrides)
    return ModelSpec(**base).validate()
