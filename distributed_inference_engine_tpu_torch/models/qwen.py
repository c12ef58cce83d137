"""Qwen2/2.5 family specs (copy of the JAX package's ``models/qwen.py``
table): Llama-shaped (RoPE, RMSNorm, SwiGLU, GQA) with biases on the
q/k/v projections only (``qkv_bias``); the small sizes tie their
embeddings. Qwen2-7B and -0.5B group 7 query heads a KV head, -1.5B 6.
"-tiny" is the test-scale shape."""

from __future__ import annotations

from .base import ModelSpec

_FAMILY = {
    # name: (layers, d_model, heads, kv_heads, d_ff, vocab, theta, max_seq, tie)
    "qwen2-72b": (80, 8192, 64, 8, 29568, 152064, 1e6, 32768, False),
    "qwen2-7b": (28, 3584, 28, 4, 18944, 152064, 1e6, 32768, False),
    "qwen2-1.5b": (28, 1536, 12, 2, 8960, 151936, 1e6, 32768, True),
    "qwen2-0.5b": (24, 896, 14, 2, 4864, 151936, 1e6, 32768, True),
    "qwen-tiny": (4, 256, 8, 4, 688, 1024, 10000.0, 512, True),
}


def qwen_spec(size: str = "qwen2-7b", **overrides) -> ModelSpec:
    if size not in _FAMILY:
        raise ValueError(f"unknown qwen size {size!r}; choose from {sorted(_FAMILY)}")
    layers, d_model, heads, kv_heads, d_ff, vocab, theta, max_seq, tie = _FAMILY[size]
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
        qkv_bias=True,
        tie_embeddings=tie,
        rope_theta=theta,
        norm_eps=1e-6,
    )
    base.update(overrides)
    return ModelSpec(**base).validate()
