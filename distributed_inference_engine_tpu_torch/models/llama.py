"""Llama and Mixtral family specs (copies of the JAX package's
``models/llama.py`` tables): RoPE, RMSNorm, SwiGLU, grouped-query
attention, no biases, untied embeddings; Mixtral's MLP is 8 routed
experts, 2 a token. "-tiny" is the test-scale shape used by the CPU
tests."""

from __future__ import annotations

from .base import ModelSpec

_FAMILY = {
    # name: (layers, d_model, heads, kv_heads, d_ff, vocab, rope_theta, max_seq)
    "llama3-8b": (32, 4096, 32, 8, 14336, 128256, 500000.0, 8192),
    "llama3-70b": (80, 8192, 64, 8, 28672, 128256, 500000.0, 8192),
    "llama2-7b": (32, 4096, 32, 32, 11008, 32000, 10000.0, 4096),
    "llama-tiny": (4, 256, 8, 4, 688, 1024, 10000.0, 512),
    "llama-mini": (8, 512, 8, 4, 1376, 32000, 10000.0, 2048),
}


def llama_spec(size: str = "llama3-8b", **overrides) -> ModelSpec:
    if size not in _FAMILY:
        raise ValueError(f"unknown llama size {size!r}; choose from {sorted(_FAMILY)}")
    layers, d_model, heads, kv_heads, d_ff, vocab, theta, max_seq = _FAMILY[size]
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
    )
    base.update(overrides)
    return ModelSpec(**base).validate()


# name: (layers, d_model, heads, kv_heads, d_ff, vocab, theta, max_seq, E, k)
_MOE_FAMILY = {
    "mixtral-8x7b": (32, 4096, 32, 8, 14336, 32000, 1e6, 32768, 8, 2),
    "mixtral-small": (8, 1024, 16, 8, 3584, 32000, 1e6, 4096, 8, 2),
    "mixtral-16g": (28, 2560, 20, 4, 7168, 32000, 1e6, 4096, 8, 2),
    "mixtral-tiny": (4, 256, 8, 4, 256, 1024, 10000.0, 512, 4, 2),
}


def mixtral_spec(size: str = "mixtral-8x7b", **overrides) -> ModelSpec:
    """Mixtral family: the Llama architecture with a routed-expert MLP
    (``ops/moe.py``)."""
    if size not in _MOE_FAMILY:
        raise ValueError(
            f"unknown mixtral size {size!r}; choose from {sorted(_MOE_FAMILY)}"
        )
    (layers, d_model, heads, kv_heads, d_ff, vocab, theta, max_seq,
     n_experts, k) = _MOE_FAMILY[size]
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
        n_experts=n_experts,
        experts_per_token=k,
    )
    base.update(overrides)
    return ModelSpec(**base).validate()
