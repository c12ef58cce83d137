"""Serving engines of the port: continuous batching over paged KV, the
static engine over dense caches (``Engine``, ``SlotKVCache``) and
speculative decoding."""

from .types import GenerationRequest, GenerationResult  # noqa: F401


def __getattr__(name):
    # the JAX package's lazy exports: the request and result types import
    # without the model code
    if name == "Engine":
        from .engine import Engine

        return Engine
    if name == "SlotKVCache":
        from .kv_cache import SlotKVCache

        return SlotKVCache
    raise AttributeError(name)
