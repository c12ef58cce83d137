"""Model specs and the config-driven engine factory of the port (the
``models/__init__.py:engine_from_config`` subset for the dense families
``llama``, ``mistral``, ``qwen``, ``gemma`` and ``gpt2``, and ``fake``;
``mixtral`` raises).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import torch

from .base import ModelSpec, random_quantized_params
from .gemma import gemma_spec
from .gpt2 import gpt2_spec
from .llama import llama_spec
from .mistral import mistral_spec
from .qwen import qwen_spec


# family prefix -> (spec factory, default size), as in the JAX package;
# an architecture string like "qwen2-7b" selects the size directly
_FAMILIES = {
    "qwen": (qwen_spec, "qwen2-7b"),
    "mistral": (mistral_spec, "mistral-7b"),
    "gemma": (gemma_spec, "gemma-7b"),
    "llama": (llama_spec, "llama3-8b"),
}

# metadata keys the JAX factory copies into EngineConfig
# (models/__init__.py of the JAX package); the engine rejects the ones
# whose feature is not ported (EngineConfig.check_supported)
ENGINE_KEYS = ("page_size", "num_pages", "decode_steps_per_call",
               "attention_impl", "kv_dtype", "prefill_buckets",
               "prefix_cache", "prefill_chunk", "decode_mode",
               "max_waiting", "queue_deadline_s", "kv_offload",
               "kv_offload_bytes", "mixed_step_tokens", "stream_chunk_steps",
               "spec_async", "spec_draft_model", "spec_max_draft",
               "spec_bubble_floor_s")


def spec_for_architecture(architecture: str, size: str = "",
                          max_seq_len: int = 0) -> ModelSpec:
    """The JAX package's one spec-selection rule: ``gpt2*`` by its own
    name (an unknown size raises), else the first family prefix, sized by
    ``size``, the architecture string itself when it names a size, or the
    family default. Mixtral (mixture-of-experts) raises."""
    overrides = {"max_seq_len": max_seq_len} if max_seq_len else {}
    if architecture.startswith("mixtral"):
        raise NotImplementedError(
            f"architecture {architecture!r} (mixture-of-experts: "
            "ops/moe.py) is not ported to PyTorch yet (ROADMAP.md A9)")
    if architecture.startswith("gpt2"):
        return gpt2_spec(size or architecture, **overrides)
    for prefix, (factory, default) in _FAMILIES.items():
        if architecture.startswith(prefix):
            name = size or (architecture if "-" in architecture else default)
            return factory(name, **overrides)
    raise ValueError(f"unknown architecture {architecture!r}")


def _coerce(default: Any, value: Any) -> Any:
    """CLI metadata arrives as strings; give each value its field's type."""
    if not isinstance(value, str):
        return value
    if isinstance(default, bool):
        return value.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(value)
    if isinstance(default, float):
        return float(value)
    if isinstance(default, list):
        return [int(v) for v in json.loads(value)]
    return value


def fake_engine_from_config(cfg):
    """``architecture="fake"`` (the ``ModelConfig`` default): the fakes of
    ``models/fake.py`` from the JAX factory's metadata keys. ``continuous``
    gives the pumped ``FakeContinuousEngine``, else the batch
    ``FakeEngine``; ``load_sleep_s`` models a load's cost on the loader's
    clock. The prefill role and the speculation model raise."""
    import time

    from .fake import FakeContinuousEngine, FakeEngine

    md = cfg.metadata
    if md.get("role") == "prefill":
        raise NotImplementedError("the disaggregated prefill role is not "
                                  "ported to PyTorch yet (ROADMAP.md A10)")
    if _coerce(False, md.get("spec_async", False)):
        raise NotImplementedError("spec_async (async speculation) is not "
                                  "ported to PyTorch yet (ROADMAP.md A12)")
    load_sleep = float(md.get("load_sleep_s", 0) or 0)
    if load_sleep:
        time.sleep(load_sleep)
    if _coerce(False, md.get("continuous", False)):
        return FakeContinuousEngine(
            step_latency_s=float(md.get("step_latency_s", 0.0)),
            tokens_per_step=int(md.get("tokens_per_step", 1)),
            max_slots=int(md.get("max_slots", 8)),
            max_waiting=int(md.get("max_waiting", 0)),
            queue_deadline_s=float(md.get("queue_deadline_s", 0.0)),
            vocab_size=int(md.get("vocab_size", 997)),
            admit_latency_per_token_s=float(
                md.get("admit_latency_per_token_s", 0.0)),
            prefix_cache=_coerce(False, md.get("prefix_cache", False)),
            prefix_page_size=int(md.get("prefix_page_size", 64)),
            stream_chunk_tokens=int(md.get("stream_chunk_tokens", 0)),
            stream_dispatch_overhead_s=float(
                md.get("stream_dispatch_overhead_s", 0.0)))
    return FakeEngine(
        latency_s=float(md.get("latency_s", 0.0)),
        per_token_latency_s=float(md.get("per_token_latency_s", 0.0)),
        error_rate=float(md.get("error_rate", 0.0)))


def engine_from_config(cfg, device="cuda"):
    """``ModelConfig`` -> ``ContinuousEngine`` with random weights drawn
    from a seeded ``torch.Generator`` on ``device`` (metadata ``seed``).
    Reads ``size``, ``continuous=1``, ``dtype``, ``quantized`` (with
    metadata ``weight_bits``, 8 by default, or 4) and the engine metadata
    keys; what the port lacks raises ``NotImplementedError``. A quantized
    model is born quantized (``models/base.py:random_quantized_params``).
    ``architecture="fake"`` builds a fake engine
    (``fake_engine_from_config``)."""
    from ..config import EngineConfig
    from ..engine.continuous import ContinuousEngine

    arch = cfg.architecture.lower()
    if arch == "fake":
        return fake_engine_from_config(cfg)
    md = dict(cfg.metadata)

    def no(what: str, item: str) -> None:
        raise NotImplementedError(
            f"{what} is not ported to PyTorch yet (ROADMAP.md {item})")

    if cfg.path:
        no("checkpoint loading (path=)", "A11")
    bits = int(md.get("weight_bits", 8) or 8)
    if cfg.quantized and bits not in (4, 8):
        raise ValueError(f"weight_bits must be 4 or 8, got {bits}")
    if any(int(md.get(k, 1) or 1) > 1 for k in ("tp", "sp", "dp")):
        no("tp/sp/dp parallel serving", "A13")
    if int(md.get("speculative", 0) or 0):
        no("speculative decoding", "A12")
    if md.get("role") == "prefill":
        no("the disaggregated prefill role", "A10")
    if md.get("artifact"):
        no("serving artifacts (artifact=)", "A11")
    if not _coerce(False, md.get("continuous", False)):
        no("the static engine (continuous=0)", "A8")

    spec = spec_for_architecture(arch, size=md.get("size", ""),
                                 max_seq_len=cfg.max_seq_len)
    if cfg.dtype:
        spec = spec.replace(dtype=cfg.dtype)
    ecfg = EngineConfig(max_slots=cfg.max_batch_size,
                        max_seq_len=cfg.max_seq_len)
    defaults = {f.name: getattr(ecfg, f.name)
                for f in dataclasses.fields(ecfg)}
    for k in ENGINE_KEYS:
        if k in md:
            setattr(ecfg, k, _coerce(defaults[k], md[k]))
    seed = int(md.get("seed", 0) or 0)
    params = None
    if cfg.quantized:
        params = random_quantized_params(
            spec, torch.Generator(device=device).manual_seed(seed),
            bits=bits)
    return ContinuousEngine(spec, params=params, config=ecfg, seed=seed,
                            device=device)
