"""Pre-fused serving artifacts: a worker's cold start without the weights'
derivation (port of the JAX package's ``engine/artifact.py``).

An engine pays for its weights up to three times: the load (or random
init), the quantization, and ``ops/quant.py:prepare_params`` (the int4
q|k|v and gate|up payload fusion). An artifact stores the *prepared* tree
once, so a later boot of the same model is a restore plus a self-check.

Layout (one directory per model):

    <path>/spec.json       the ModelSpec sidecar (``utils/checkpoint.py``)
    <path>/params/         the PREPARED tree in the port's native format:
                           fused payloads, padded LM head, QuantizedTensor
                           nodes bit for bit
    <path>/manifest.json   the commit point, written LAST by an atomic
                           rename (``utils/files.py``)

Crash consistency is the manifest-last protocol: ``save_artifact`` writes
the params first and publishes the manifest after, so a crash mid-save
leaves a directory without a manifest, which ``has_artifact`` reads as
absent. A rewrite deletes the old manifest *first*, so it never vouches
for params being replaced.

Trust, but verify (three layers, cheapest first):

1. **Feature hash**: sha256 of the deploy config's identity fields, the
   JAX module's eight fields and JSON, so the digest equals JAX's for the
   same ``ModelConfig``. A drift raises ``ArtifactMismatchError`` before
   any weight is read.
2. **Tree checksum**: sha256 over every leaf's path, dtype, shape and
   bytes (read back from where the tree lives), sorted by path. A
   truncated file, a flipped bit or a failed restore raises
   ``ArtifactCorruptError``.
3. **Golden-token probe**: the manifest records a short greedy generation
   taken at save time; the engine replays it before it admits traffic
   (``ContinuousEngine(artifact_path=...)``). A mismatch raises
   ``ArtifactCorruptError`` and the factory falls back to the slow path.

The port's artifacts are its own (safetensors under ``params/``); a JAX
artifact's Orbax ``params/`` fails the restore, as corrupt.
"""

from __future__ import annotations

import hashlib
import json
import logging
import pathlib
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..utils import checkpoint
from ..utils.files import atomic_write_json

logger = logging.getLogger(__name__)

MANIFEST_FILE = "manifest.json"
ARTIFACT_VERSION = 1
# the probe prompt is arbitrary but FIXED: it must replay bit for bit at
# load time, and ids this small exist in every real vocabulary
GOLDEN_PROMPT: Tuple[int, ...] = (1, 2, 3, 5, 8, 13, 21)
GOLDEN_MAX_NEW = 8


class ArtifactError(RuntimeError):
    """Base of the artifact load and validation failures (the factory
    catches it to fall back to the slow path)."""


class ArtifactCorruptError(ArtifactError):
    """The artifact's bytes or numerics are wrong: an unreadable manifest,
    a checksum mismatch, a failed restore, or a golden-probe divergence."""


class ArtifactMismatchError(ArtifactError):
    """The artifact is consistent but was built for another deploy config
    (the feature hash differs)."""


# -------------------------------------------------------------- hashing

def feature_hash(cfg) -> str:
    """sha256 of the ``ModelConfig`` fields that change the prepared tree
    (the JAX function's fields and JSON: the same digest). Runtime knobs
    (buckets, page sizes, batcher limits) stay out: one artifact serves
    any of them."""
    ident = {
        "architecture": cfg.architecture,
        "path": cfg.path or "",
        "dtype": cfg.dtype or "",
        "max_seq_len": int(cfg.max_seq_len),
        "quantized": bool(cfg.quantized),
        "weight_bits": int(cfg.metadata.get("weight_bits", 8)),
        "size": str(cfg.metadata.get("size", "")),
        "seed": int(cfg.metadata.get("seed", 0)),
    }
    blob = json.dumps(ident, sort_keys=True)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def tree_checksum(params: Any) -> str:
    """sha256 over every leaf's (path, dtype, shape, bytes), leaves sorted
    by path. A QuantizedTensor's payload and scales are leaves
    (``<path>.q``, ``<path>.s``), so the int4 packing is covered. A leaf on
    the card is read back one at a time."""
    h = hashlib.sha256()
    for key, leaf in sorted(checkpoint.tree_leaves(params),
                            key=lambda kv: kv[0]):
        host = leaf.detach().contiguous().cpu()
        h.update(key.encode("utf-8"))
        h.update(str(host.dtype).encode("utf-8"))
        h.update(str(tuple(host.shape)).encode("utf-8"))
        if host.numel():
            h.update(memoryview(host.reshape(-1).view(torch.uint8).numpy()))
    return h.hexdigest()


def quant_summary(params: Any) -> Dict[str, int]:
    """``{"int4": n, "int8": m}``: QuantizedTensor nodes by bit width,
    recorded in the manifest so an operator reads the mode without a
    restore."""
    from ..ops.quant import QuantizedTensor

    out: Dict[str, int] = {}

    def walk(node: Any) -> None:
        if isinstance(node, QuantizedTensor):
            key = f"int{node.bits}"
            out[key] = out.get(key, 0) + 1
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)

    walk(params)
    return out


# ------------------------------------------------------------- manifest

def _manifest_path(path: str) -> pathlib.Path:
    return pathlib.Path(path).absolute() / MANIFEST_FILE


def has_artifact(path: str) -> bool:
    """True iff ``path`` holds a COMMITTED artifact (the manifest is
    written last, so its presence is the commit point)."""
    return _manifest_path(path).is_file()


def write_manifest(path: str, manifest: Dict[str, Any]) -> str:
    return atomic_write_json(str(_manifest_path(path)), manifest)


def load_manifest(path: str) -> Dict[str, Any]:
    p = _manifest_path(path)
    try:
        manifest = json.loads(p.read_text())
    except FileNotFoundError:
        raise ArtifactCorruptError(
            f"no artifact manifest at {p} (absent or uncommitted save)")
    except (OSError, ValueError) as e:
        raise ArtifactCorruptError(
            f"artifact manifest {p} unreadable ({e})") from e
    if not isinstance(manifest, dict):
        raise ArtifactCorruptError(f"artifact manifest {p} is not an object")
    version = manifest.get("version")
    if version != ARTIFACT_VERSION:
        raise ArtifactCorruptError(
            f"artifact manifest {p} has version {version!r}; this build "
            f"reads version {ARTIFACT_VERSION}")
    missing = [k for k in ("checksum", "feature_hash") if k not in manifest]
    if missing:
        raise ArtifactCorruptError(
            f"artifact manifest {p} is missing fields {missing}")
    return manifest


# ----------------------------------------------------------- save / load

def save_artifact(path: str, spec, params: Any, cfg=None,
                  buckets: Optional[Dict[str, List[int]]] = None,
                  engine=None,
                  golden_prompt: Optional[List[int]] = None,
                  golden_max_new: int = GOLDEN_MAX_NEW,
                  stats: Optional[Dict[str, Any]] = None) -> str:
    """Persist a PREPARED tree, its spec and the manifest; returns the
    path. ``engine`` (optional) records the golden probe, a short greedy
    generation run NOW on the tree being saved. ``stats`` (optional)
    receives ``artifact_write_s`` and ``artifact_checksum_s``."""
    p = pathlib.Path(path).absolute()
    stale = p / MANIFEST_FILE
    if stale.exists():
        # rewrite: retract the commit point FIRST so the old manifest
        # cannot vouch for half-replaced params if we crash below
        stale.unlink()
    t0 = time.perf_counter()
    checkpoint.save_params(str(p), spec, params)
    t1 = time.perf_counter()
    manifest: Dict[str, Any] = {
        "version": ARTIFACT_VERSION,
        "feature_hash": feature_hash(cfg) if cfg is not None else "",
        "checksum": tree_checksum(params),
        "quant": quant_summary(params),
        "buckets": dict(buckets or {}),
        "golden": None,
    }
    if stats is not None:
        stats.update(artifact_write_s=t1 - t0,
                     artifact_checksum_s=time.perf_counter() - t1)
    if engine is not None:
        prompt = [int(t) for t in (golden_prompt or GOLDEN_PROMPT)]
        tokens = run_probe(engine, prompt, golden_max_new)
        manifest["golden"] = {"prompt": prompt,
                              "max_new_tokens": int(golden_max_new),
                              "tokens": tokens}
    write_manifest(str(p), manifest)
    logger.info("serving artifact committed at %s (quant=%s, golden=%s)",
                p, manifest["quant"] or "none",
                "yes" if manifest["golden"] else "no")
    return str(p)


def load_artifact(path: str, cfg=None, device="cuda",
                  stats: Optional[Dict[str, Any]] = None
                  ) -> Tuple[Any, Any, Dict]:
    """``(spec, params, manifest)`` of a committed artifact, the params on
    ``device``.

    ``ArtifactMismatchError`` when ``cfg`` is given and its feature hash
    differs from the manifest's (before any weight is read);
    ``ArtifactCorruptError`` for an unreadable, truncated or bit-flipped
    tree: every restore failure is wrapped, so a caller needs one except
    clause to fall back. ``stats`` (optional) receives
    ``artifact_restore_s`` and ``artifact_checksum_s``."""
    manifest = load_manifest(path)
    if cfg is not None and manifest["feature_hash"]:
        want = feature_hash(cfg)
        if want != manifest["feature_hash"]:
            raise ArtifactMismatchError(
                f"artifact {path} was built for a different config "
                f"(feature hash {manifest['feature_hash'][:12]}… != "
                f"{want[:12]}…) — refusing to serve it")
    t0 = time.perf_counter()
    try:
        spec = checkpoint.load_spec(path)
        params = checkpoint.load_params(path, device=device)
    except ArtifactError:
        raise
    except Exception as e:
        raise ArtifactCorruptError(
            f"artifact {path} failed to restore ({type(e).__name__}: "
            f"{e})") from e
    t1 = time.perf_counter()
    got = tree_checksum(params)
    if stats is not None:
        stats.update(artifact_restore_s=t1 - t0,
                     artifact_checksum_s=time.perf_counter() - t1)
    if got != manifest["checksum"]:
        raise ArtifactCorruptError(
            f"artifact {path} checksum mismatch (manifest "
            f"{manifest['checksum'][:12]}…, restored {got[:12]}…) — "
            "params are corrupt")
    return spec, params, manifest


# ---------------------------------------------------------- golden probe

def run_probe(engine, prompt: List[int], max_new: int) -> List[int]:
    """One short greedy generation on ``engine``, as plain ints."""
    from .types import GenerationRequest

    req = GenerationRequest(prompt=[int(t) for t in prompt],
                            max_new_tokens=int(max_new),
                            temperature=0.0,
                            request_id="__artifact_probe__")
    return [int(t) for t in engine.generate([req])[0].tokens]


def verify_golden(engine, manifest: Optional[Dict[str, Any]]) -> bool:
    """Replay the manifest's golden probe on ``engine``: True when it ran
    and matched, False when the manifest records none. A divergence
    raises ``ArtifactCorruptError``: the caller must NOT admit traffic."""
    golden = (manifest or {}).get("golden")
    if not golden:
        return False
    want = [int(t) for t in golden["tokens"]]
    got = run_probe(engine, golden["prompt"], golden["max_new_tokens"])
    if got != want:
        raise ArtifactCorruptError(
            f"golden-token self-check FAILED: expected {want}, got {got} "
            "— artifact numerics are wrong, refusing to serve")
    return True
