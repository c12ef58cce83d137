"""Model specs and the config-driven engine factory of the port (the
``models/__init__.py:engine_from_config`` subset for the families
``llama``, ``mistral``, ``qwen``, ``gemma``, ``mixtral`` and ``gpt2``, and
``fake``): random weights, HF and native checkpoints (``path=``) and
serving artifacts (``artifact=``).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import logging
import os
import time
from typing import Any, Dict

import torch

from ..ops.quant import quantize_params
from .base import ModelSpec, random_quantized_params
from .gemma import gemma_spec
from .gpt2 import gpt2_spec
from .llama import llama_spec, mixtral_spec
from .mistral import mistral_spec
from .qwen import qwen_spec

logger = logging.getLogger(__name__)

# family prefix -> (spec factory, default size), as in the JAX package;
# an architecture string like "qwen2-7b" selects the size directly
_FAMILIES = {
    "qwen": (qwen_spec, "qwen2-7b"),
    "mistral": (mistral_spec, "mistral-7b"),
    "gemma": (gemma_spec, "gemma-7b"),
    "mixtral": (mixtral_spec, "mixtral-8x7b"),
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
    family default."""
    overrides = {"max_seq_len": max_seq_len} if max_seq_len else {}
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
    clock; ``spec_async`` and its knobs, the speculation model. The
    prefill role raises."""
    import time

    from .fake import FakeContinuousEngine, FakeEngine

    md = cfg.metadata
    if md.get("role") == "prefill":
        raise NotImplementedError("the disaggregated prefill role is not "
                                  "ported to PyTorch yet (ROADMAP.md A10)")
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
                md.get("stream_dispatch_overhead_s", 0.0)),
            spec_async=_coerce(False, md.get("spec_async", False)),
            spec_max_draft=int(md.get("spec_max_draft", 4)),
            spec_accept_rate=float(md.get("spec_accept_rate", 0.7)),
            spec_bubble_floor_s=float(md.get("spec_bubble_floor_s", 0.0)))
    return FakeEngine(
        latency_s=float(md.get("latency_s", 0.0)),
        per_token_latency_s=float(md.get("per_token_latency_s", 0.0)),
        error_rate=float(md.get("error_rate", 0.0)))


def engine_config(cfg):
    """The ``EngineConfig`` of a ``ModelConfig``: its slots and sequence
    length, and the engine keys of its metadata (``ENGINE_KEYS``) in their
    fields' types."""
    from ..config import EngineConfig

    ecfg = EngineConfig(max_slots=cfg.max_batch_size,
                        max_seq_len=cfg.max_seq_len)
    defaults = {f.name: getattr(ecfg, f.name)
                for f in dataclasses.fields(ecfg)}
    for k in ENGINE_KEYS:
        if k in cfg.metadata:
            setattr(ecfg, k, _coerce(defaults[k], cfg.metadata[k]))
    return ecfg


def engine_from_config(cfg, device="cuda"):
    """``ModelConfig`` -> an engine on ``device``, in the JAX factory's
    order of branches:

    1. metadata ``artifact=<dir>``: a committed serving artifact whose
       feature hash matches restores the prepared tree
       (``engine/artifact.py``), its golden probe replayed unless
       ``artifact_selfcheck=0``. A mismatch or a corrupt artifact falls
       back to the slow path below, which rewrites it;
       ``artifact_required=1`` raises instead.
    2. ``path=<dir>`` of a native checkpoint (``utils/checkpoint.py``):
       its spec sidecar rules (dtype included), ``max_seq_len`` clamped to
       it. A JAX Orbax directory raises.
    3. ``path=<dir>`` of an HF checkpoint: ``spec_from_hf_config``, then
       ``load_checkpoint`` (``models/loader.py``), in ``dtype`` where the
       config names one.
    4. no path: random weights from a seeded ``torch.Generator`` on
       ``device`` (metadata ``seed``; ``size`` picks the family's size).

    ``quantized`` (with metadata ``weight_bits``, 8 by default, or 4)
    quantizes a loaded tree (an HF checkpoint's block weights a layer at
    a time as they are read, so ``quantize_s`` holds the rest: the LM
    head), and draws a random one born quantized
    (``models/base.py:random_quantized_params``). After a slow-path build
    with ``artifact=``, the artifact is (re)written, best-effort.

    The engine: ``speculative=K`` builds a ``SpeculativeEngine`` whose
    draft is ``draft_path`` (an HF checkpoint) or the random ``draft_size``
    spec of the same family; else ``continuous=1`` a ``ContinuousEngine``
    and ``continuous=0`` the static ``Engine``. A speculative deploy is not
    artifact-eligible (JAX's rule): ``artifact=`` is ignored with a
    warning, or raises with ``artifact_required=1``. The engine metadata
    keys configure the engine; what the port lacks raises
    ``NotImplementedError`` naming its ROADMAP.md item.
    ``architecture="fake"`` builds a fake engine
    (``fake_engine_from_config``). ``engine.load_info`` records the
    load's source and phases."""

    arch = cfg.architecture.lower()
    if arch == "fake":
        return fake_engine_from_config(cfg)
    md = dict(cfg.metadata)

    def no(what: str, item: str) -> None:
        raise NotImplementedError(
            f"{what} is not ported to PyTorch yet (ROADMAP.md {item})")

    bits = int(md.get("weight_bits", 8) or 8)
    if cfg.quantized and bits not in (4, 8):
        raise ValueError(f"weight_bits must be 4 or 8, got {bits}")
    spec_k = int(md.get("speculative", 0) or 0)
    tp, sp, dp = (int(md.get(k, 1) or 1) for k in ("tp", "sp", "dp"))
    if spec_k and (sp > 1 or dp > 1):
        raise ValueError(
            "speculative decoding composes with tp only (target "
            "sharded, draft replicated); sp/dp shard the prefill "
            "batch/sequence, which the speculative window forwards "
            "do not — drop sp/dp or deploy replicas via the load "
            "balancer")
    if spec_k and tp > 1:
        no("speculative decoding with tp", "A13")
    if max(tp, sp, dp) > 1:
        no("tp/sp/dp parallel serving", "A13")
    if md.get("role") == "prefill":
        no("the disaggregated prefill role", "A10")

    ecfg = engine_config(cfg)
    seed = int(md.get("seed", 0) or 0)
    continuous = bool(_coerce(False, md.get("continuous", False)))

    art = str(md.get("artifact", "") or "")
    art_required = bool(_coerce(False, md.get("artifact_required", False)))
    art_selfcheck = bool(_coerce(True, md.get("artifact_selfcheck", True)))
    if art and spec_k:
        if art_required:
            raise ValueError(
                "artifact_required is set but this deploy is not "
                "artifact-eligible: mesh/speculative/prefill engines "
                "cannot cold-start from a serving artifact")
        logger.warning(
            "artifact metadata ignored for model %s: only single-host "
            "Engine/ContinuousEngine deploys cold-start from artifacts",
            cfg.name)
        art = ""
    if art:
        eng = _from_artifact(cfg, art, ecfg, seed, device, art_required,
                             art_selfcheck, continuous)
        if eng is not None:
            return eng

    from ..utils.checkpoint import SPEC_FILE, load_params, load_spec

    info: Dict[str, Any] = {}
    t0 = time.perf_counter()
    if cfg.path and os.path.isfile(os.path.join(cfg.path, SPEC_FILE)):
        # the port's own checkpoint: the sidecar's spec rules, its dtype
        # included (the params are stored in it); load_params refuses a
        # JAX Orbax directory, which has a spec.json too
        ck_spec = load_spec(cfg.path)
        spec = ck_spec.replace(max_seq_len=min(cfg.max_seq_len,
                                               ck_spec.max_seq_len))
        params = load_params(cfg.path, device=device)
        info["source"] = "native"
    elif cfg.path and os.path.isdir(cfg.path):
        from .loader import load_checkpoint, spec_from_hf_config

        hf_spec = spec_from_hf_config(cfg.path)
        spec = hf_spec.replace(max_seq_len=min(cfg.max_seq_len,
                                               hf_spec.max_seq_len),
                               dtype=cfg.dtype or hf_spec.dtype)
        # a quantized deploy quantizes the block weights a layer at a time
        # as they are read
        params = load_checkpoint(cfg.path, spec, device=device, stats=info,
                                 bits=bits if cfg.quantized else 0)
        info["source"] = "hf"
    elif cfg.path:
        # JAX would serve random weights here; a checkpoint that is not
        # there must not be answered by a random model
        raise FileNotFoundError(
            f"checkpoint path {cfg.path!r} is not a directory")
    else:
        spec = spec_for_architecture(arch, size=md.get("size", ""),
                                     max_seq_len=cfg.max_seq_len)
        if cfg.dtype:
            spec = spec.replace(dtype=cfg.dtype)
        params = None
        info["source"] = "random"
    _sync(device)
    info["read_s"] = time.perf_counter() - t0
    if cfg.quantized:
        t0 = time.perf_counter()
        if params is None:
            params = random_quantized_params(
                spec, torch.Generator(device=device).manual_seed(seed),
                bits=bits)
        else:
            params = quantize_params(spec, params, bits=bits)
        _sync(device)
        info["quantize_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if spec_k:
        eng = _speculative_engine(cfg, arch, spec, params, ecfg, spec_k,
                                  seed, device)
    else:
        eng = _engine_class(continuous)(spec, params=params, config=ecfg,
                                        seed=seed, device=device)
    del params                 # the engine holds the prepared tree
    _sync(device)
    info["engine_s"] = time.perf_counter() - t0
    eng.load_info.update(info)
    if art:
        # the first (slow) boot commits the prepared tree, so the next one
        # cold-starts from it
        _refresh_artifact(art, cfg, eng, probe=art_selfcheck)
    return eng


def _engine_class(continuous: bool):
    """The continuous engine, or the static one (``continuous=0``)."""
    if continuous:
        from ..engine.continuous import ContinuousEngine

        return ContinuousEngine
    from ..engine.engine import Engine

    return Engine


def _speculative_engine(cfg, arch: str, spec, params, ecfg, spec_k: int,
                        seed: int, device):
    """The speculative branch (JAX's order and errors): metadata
    ``draft_size`` (a spec of the architecture's family, random weights)
    and/or ``draft_path`` (an HF checkpoint directory, which wins)."""
    from ..engine.speculative import SpeculativeEngine

    md = cfg.metadata
    draft_size = md.get("draft_size", "")
    if not draft_size and not md.get("draft_path"):
        raise ValueError(
            "speculative decoding needs metadata draft_size and/or "
            "draft_path")
    draft_path = md.get("draft_path", "")
    if draft_path and not os.path.isdir(draft_path):
        # a typo'd checkpoint must not fall back to a random-weight draft
        raise ValueError(f"draft_path {draft_path!r} is not a directory")
    if draft_path:
        from .loader import load_checkpoint, spec_from_hf_config

        d_spec = spec_from_hf_config(draft_path)
        d_spec = d_spec.replace(max_seq_len=min(cfg.max_seq_len,
                                                d_spec.max_seq_len))
        d_params = load_checkpoint(draft_path, d_spec, device=device)
    else:
        d_spec = spec_for_architecture(arch, size=draft_size,
                                       max_seq_len=cfg.max_seq_len)
        if cfg.dtype:
            d_spec = d_spec.replace(dtype=cfg.dtype)
        d_params = None
    return SpeculativeEngine(spec, d_spec, params=params,
                             draft_params=d_params, config=ecfg,
                             speculate_k=spec_k, seed=seed, device=device)


def _sync(device) -> None:
    """Wait for ``device``'s queued work, so a phase's seconds hold it."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _from_artifact(cfg, art: str, ecfg, seed: int, device,
                   required: bool, selfcheck: bool, continuous: bool):
    """The artifact fast path: a continuous or static engine restored from
    ``art``, or None (no committed artifact, or one that failed a check)
    for the slow path. With ``required`` every failure raises."""
    from ..engine.artifact import (
        ArtifactCorruptError,
        ArtifactError,
        ArtifactMismatchError,
        feature_hash,
        has_artifact,
        load_manifest,
    )
    if not has_artifact(art):
        if required:
            raise ArtifactCorruptError(
                f"artifact_required is set but no committed artifact "
                f"exists at {art}")
        return None
    try:
        manifest = load_manifest(art)
        if (manifest["feature_hash"]
                and manifest["feature_hash"] != feature_hash(cfg)):
            raise ArtifactMismatchError(
                f"artifact {art} was built for a different deploy config "
                "(feature hash differs) — refusing to serve it")
        t0 = time.perf_counter()
        eng = _engine_class(continuous)(
            None, config=ecfg, seed=seed, device=device, artifact_path=art,
            artifact_selfcheck=selfcheck)
        _sync(device)
        eng.load_info.update(source="artifact",
                             engine_s=time.perf_counter() - t0)
        return eng
    except ArtifactError as e:
        if required:
            raise
        logger.warning(
            "artifact %s rejected (%s: %s) — falling back to the slow path "
            "and rewriting it", art, type(e).__name__, e)
    # a rejected engine's restored tree and pools go before the slow path
    # builds its own
    gc.collect()
    return None


def _refresh_artifact(path: str, cfg, engine, probe: bool = True) -> None:
    """Best-effort artifact (re)write after a slow-path build: a failure is
    logged, never raised (the engine just built serves either way; the
    next boot pays the slow path again)."""
    from ..engine.artifact import save_artifact
    from ..engine.engine import _pow2_buckets

    t0 = time.perf_counter()
    try:
        # every batch bucket the engine serves (the static engine's own;
        # the continuous engine's admission buckets): a cold start warms
        # them all (warmup_from_manifest)
        buckets = {
            "batch": [int(x) for x in (
                getattr(engine, "batch_buckets", None)
                or _pow2_buckets(engine.max_slots))],
            "prefill": [int(x) for x in engine.prefill_buckets],
            "seq": [int(x) for x in getattr(engine, "seq_buckets", [])]}
        save_artifact(path, engine.spec, engine.params, cfg=cfg,
                      buckets=buckets, engine=engine if probe else None,
                      stats=engine.load_info)
        engine.load_info["artifact_save_s"] = time.perf_counter() - t0
    # best-effort local persistence: the slow-path engine serves either way
    except Exception:
        logger.exception(
            "serving-artifact write to %s failed — serving from the "
            "slow-path engine anyway", path)
