"""Serving artifacts in the port (``engine/artifact.py``), case by case as
the JAX package's ``tests/test_artifact.py`` holds its own, on llama-tiny
engines on the CPU; then the worker's artifact accounting over RPC, its
metric families, ``--artifact-dir`` in the CLI, and the swap's gate on a
manifest's probe.

Held: the prepared tree round trip bit for bit (fp32, bf16, int8, int4
fused) with the checksum agreeing; the factory's cold start emitting the
slow path's tokens (greedy and sampled, fp32, bf16 and int4 from an HF
directory); ``feature_hash`` equal to JAX's; each trust check refusing
what the JAX module refuses (a feature-hash mismatch, a truncated file, a
flipped bit, a missing, torn, wrong-version or incomplete manifest, a
golden divergence, a JAX artifact's Orbax tree), the factory falling back
and rewriting, or raising under ``artifact_required=1``;
``artifact_selfcheck=0`` skipping the probe; ``warmup_from_manifest``
warming the recorded buckets. The cold start's speed is not held here
(no wall-clock floors in the port's tests)."""

import asyncio
import json
import pathlib
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu.config import ModelConfig as JModel
from distributed_inference_engine_tpu.engine import artifact as jart
from distributed_inference_engine_tpu.models import base as jb
from distributed_inference_engine_tpu.models.llama import llama_spec as jspec
from distributed_inference_engine_tpu_torch import models as tmodels
from distributed_inference_engine_tpu_torch.cluster.model_manager import (
    ModelProbeError,
)
from distributed_inference_engine_tpu_torch.cluster.worker import (
    WorkerClient,
    WorkerServer,
)
from distributed_inference_engine_tpu_torch.config import (
    ModelConfig,
    ServerConfig,
)
from distributed_inference_engine_tpu_torch.engine.artifact import (
    MANIFEST_FILE,
    ArtifactCorruptError,
    ArtifactMismatchError,
    feature_hash,
    has_artifact,
    load_artifact,
    load_manifest,
    save_artifact,
    tree_checksum,
    write_manifest,
)
from distributed_inference_engine_tpu_torch.engine.types import (
    GenerationRequest,
)
from distributed_inference_engine_tpu_torch.models.base import init_params
from distributed_inference_engine_tpu_torch.models.llama import (
    llama_spec as tspec,
)
from distributed_inference_engine_tpu_torch.ops import quant as tq
from distributed_inference_engine_tpu_torch.utils import checkpoint
from tests.test_torch_loader import FAMILY_CONFIGS, write_hf_llama

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENGINE_MD = {"continuous": "1", "page_size": "16", "num_pages": "32",
             "prefill_buckets": "[16, 32]"}


def _spec(dtype="float32"):
    return tspec("llama-tiny", max_seq_len=64, dtype=dtype)


def _cfg(art_dir, *, dtype="float32", quantized=False, bits=8, path="",
         **meta):
    md = {**ENGINE_MD, "size": "llama-tiny", "artifact": str(art_dir)}
    if quantized:
        md["weight_bits"] = bits
    md.update(meta)
    return ModelConfig(name="m", architecture="llama", dtype=dtype,
                       max_seq_len=64, max_batch_size=2, path=path,
                       quantized=quantized, metadata=md)


def _build(cfg):
    return tmodels.engine_from_config(cfg, device="cpu")


def _greedy(engine, prompt=(4, 9, 2), n=6):
    return engine.generate([GenerationRequest(
        prompt=list(prompt), max_new_tokens=n, temperature=0.0)])[0].tokens


def _sampled(engine, prompt=(4, 9, 2), n=6):
    return engine.generate([GenerationRequest(
        prompt=list(prompt), max_new_tokens=n, temperature=0.8,
        top_k=16)])[0].tokens


def _hit(engine) -> bool:
    return getattr(engine, "artifact_manifest", None) is not None


# ------------------------------------------------- save/load bit parity

@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "int4"])
def test_artifact_tree_roundtrip_bitexact(tmp_path, mode):
    """Every leaf of a prepared tree (int4: q|k|v and gate|up fused, the
    head vocab-padded) survives the round trip bit for bit, and the
    checksum agrees."""
    spec = _spec("bfloat16" if mode == "bf16" else "float32")
    params = init_params(spec, torch.Generator().manual_seed(0))
    if mode in ("int8", "int4"):
        params = tq.quantize_params(spec, params,
                                    bits=4 if mode == "int4" else 8)
    params = tq.prepare_params(params)
    path = save_artifact(str(tmp_path / "art"), spec, params)
    assert has_artifact(path)
    spec2, restored, manifest = load_artifact(path, device="cpu")
    assert spec2.to_dict() == spec.to_dict()
    assert manifest["checksum"] == tree_checksum(restored) == \
        tree_checksum(params)
    if mode in ("int8", "int4"):
        bits = 4 if mode == "int4" else 8
        # int4 fused: w_qkv, wo, w_gate_up, w_down and the head
        assert manifest["quant"][f"int{bits}"] == (5 if bits == 4 else 8)
    if mode == "int4":
        assert "w_qkv" in restored["blocks"]
    a = dict(checkpoint.tree_leaves(params))
    b = dict(checkpoint.tree_leaves(restored))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k].reshape(-1).view(torch.uint8),
                           b[k].reshape(-1).view(torch.uint8)), k


@pytest.mark.parametrize("mode", ["f32", "bf16", "int4"])
def test_factory_cold_start_token_identical(tmp_path, mode):
    """The contract: an engine cold-started from the artifact emits the
    slow-path engine's tokens, greedy and sampled. bf16 and int4 from an
    HF directory (``path=``), fp32 from the seed."""
    path = ""
    if mode != "f32":
        write_hf_llama(tmp_path, FAMILY_CONFIGS["llama"], seed=8)
        path = str(tmp_path)
    art = tmp_path / "art"
    cfg = _cfg(art, dtype="bfloat16" if mode == "bf16" else "float32",
               quantized=(mode == "int4"), bits=4, path=path)
    slow = _build(cfg)
    assert not _hit(slow) and has_artifact(str(art))
    assert slow.load_info["source"] == ("random" if mode == "f32" else "hf")
    fast = _build(cfg)
    assert _hit(fast), "the second build must cold-start from the artifact"
    assert fast.load_info["source"] == "artifact"
    assert "golden_probe_s" in fast.load_info
    assert tree_checksum(fast.params) == tree_checksum(slow.params)
    assert _greedy(fast) == _greedy(slow)
    assert _sampled(fast) == _sampled(slow)


@pytest.mark.parametrize("cfg", [
    dict(name="m", architecture="llama", dtype="float32", max_seq_len=64,
         metadata={"size": "llama-tiny", "seed": 3}),
    dict(name="q", architecture="llama", path="/ckpt/x", quantized=True,
         max_seq_len=1024, metadata={"weight_bits": 4, "size": "llama3-8b"}),
    dict(name="d", architecture="mistral", dtype="bfloat16",
         metadata={"weight_bits": "8", "seed": "0"}),
])
def test_feature_hash_equals_jax(cfg):
    assert feature_hash(ModelConfig(**cfg)) == jart.feature_hash(
        JModel(**cfg))


# ------------------------------------------- validation + commit point

def test_feature_hash_mismatch_rejected(tmp_path):
    art = str(tmp_path / "art")
    cfg = _cfg(tmp_path / "art")
    spec = _spec()
    save_artifact(art, spec, init_params(spec, torch.Generator()), cfg=cfg)
    drifted = _cfg(tmp_path / "art", seed=99)
    assert feature_hash(drifted) != feature_hash(cfg)
    with pytest.raises(ArtifactMismatchError):
        load_artifact(art, cfg=drifted, device="cpu")
    load_artifact(art, cfg=cfg, device="cpu")        # the same identity


def test_factory_rewrites_mismatched_artifact(tmp_path):
    """Config drift at the factory: the stale artifact is ignored (slow
    path) and rewritten for the new identity; ``artifact_required=1``
    makes the mismatch fatal."""
    art = tmp_path / "art"
    _build(_cfg(art))
    old_hash = load_manifest(str(art))["feature_hash"]
    drifted = _cfg(art, seed=99)
    eng = _build(drifted)
    assert not _hit(eng)
    assert load_manifest(str(art))["feature_hash"] == feature_hash(drifted)
    assert load_manifest(str(art))["feature_hash"] != old_hash
    with pytest.raises(ArtifactMismatchError):
        _build(_cfg(art, seed=7, artifact_required=1))


def test_truncated_and_bitflipped_params_rejected(tmp_path):
    art = str(tmp_path / "art")
    spec = _spec()
    save_artifact(art, spec, init_params(spec, torch.Generator()))
    victim = pathlib.Path(art) / checkpoint.PARAMS_DIR / \
        checkpoint.PARAMS_FILE
    blob = victim.read_bytes()
    assert len(blob) > 64
    victim.write_bytes(blob[: len(blob) // 2])          # truncation
    with pytest.raises(ArtifactCorruptError, match="restore"):
        load_artifact(art, device="cpu")
    flipped = bytearray(blob)
    flipped[len(flipped) // 2] ^= 0xFF                  # one flipped byte
    victim.write_bytes(bytes(flipped))
    with pytest.raises(ArtifactCorruptError, match="checksum"):
        load_artifact(art, device="cpu")
    # the factory falls back and rewrites a sound artifact
    cfg = _cfg(art)
    assert not _hit(_build(cfg)) and _hit(_build(cfg))


def test_manifest_is_the_commit_point(tmp_path):
    """A crash mid-save leaves params without a manifest: absent, and the
    factory rebuilds and commits. A torn manifest, another version and
    missing fields are corrupt."""
    art = tmp_path / "art"
    spec = _spec()
    checkpoint.save_params(str(art), spec, init_params(spec,
                                                       torch.Generator()))
    assert not has_artifact(str(art))
    with pytest.raises(ArtifactCorruptError):
        load_manifest(str(art))
    eng = _build(_cfg(art))
    assert not _hit(eng)                        # slow path
    assert has_artifact(str(art))               # now committed
    good = load_manifest(str(art))
    (art / MANIFEST_FILE).write_text("{")
    with pytest.raises(ArtifactCorruptError, match="unreadable"):
        load_manifest(str(art))
    (art / MANIFEST_FILE).write_text("[1, 2]")
    with pytest.raises(ArtifactCorruptError, match="not an object"):
        load_manifest(str(art))
    write_manifest(str(art), {**good, "version": 999})
    with pytest.raises(ArtifactCorruptError, match="version"):
        load_manifest(str(art))
    write_manifest(str(art), {k: v for k, v in good.items()
                              if k != "checksum"})
    with pytest.raises(ArtifactCorruptError, match="missing"):
        load_manifest(str(art))
    # each corrupt manifest falls back (and rewrites) at the factory
    assert not _hit(_build(_cfg(art)))
    assert _hit(_build(_cfg(art)))


def test_golden_probe_failure_falls_back(tmp_path):
    """Wrong numerics behind a sound checksum (what only the probe can
    catch): the self-check raises, the factory serves the slow path and
    rewrites the artifact; ``artifact_required=1`` raises instead."""
    art = tmp_path / "art"
    slow = _build(_cfg(art))
    want = _greedy(slow)
    manifest = load_manifest(str(art))
    assert manifest["golden"], "factory saves must record a golden probe"
    manifest["golden"]["tokens"] = [
        (t + 1) % 1024 for t in manifest["golden"]["tokens"]]
    write_manifest(str(art), manifest)
    eng = _build(_cfg(art))
    assert not _hit(eng)                         # fell back
    assert _greedy(eng) == want                  # still correct
    assert load_manifest(str(art))["golden"]["tokens"] != \
        manifest["golden"]["tokens"]             # rewritten
    assert _hit(_build(_cfg(art)))
    bad = load_manifest(str(art))
    bad["golden"]["tokens"] = [(t + 1) % 1024
                               for t in bad["golden"]["tokens"]]
    write_manifest(str(art), bad)
    with pytest.raises(ArtifactCorruptError, match="golden"):
        _build(_cfg(art, artifact_required=1, artifact_selfcheck=1))


def test_artifact_required_without_artifact_raises(tmp_path):
    with pytest.raises(ArtifactCorruptError, match="no committed"):
        _build(_cfg(tmp_path / "none", artifact_required="1"))


def test_artifact_skips_probe_when_selfcheck_off(tmp_path):
    art = tmp_path / "art"
    cfg = _cfg(art, artifact_selfcheck=0)
    slow = _build(cfg)
    assert load_manifest(str(art))["golden"] is None
    fast = _build(cfg)
    assert _hit(fast) and "golden_probe_s" not in fast.load_info
    assert _greedy(fast) == _greedy(slow)


def test_jax_artifact_is_refused_and_rewritten(tmp_path):
    """A JAX artifact (Orbax ``params/``) under the same identity fails
    the port's restore as corrupt; the factory falls back and writes its
    own artifact there."""
    art = str(tmp_path / "art")
    cfg = _cfg(art)
    js = jspec("llama-tiny", max_seq_len=64, dtype="float32")
    jart.save_artifact(art, js, jb.init_params(js, jax.random.key(0)),
                       cfg=JModel(**cfg.to_dict()))
    with pytest.raises(ArtifactCorruptError, match="restore"):
        load_artifact(art, cfg=cfg, device="cpu")
    assert not _hit(_build(cfg))
    assert checkpoint.is_native_checkpoint(art) and _hit(_build(cfg))


def test_warmup_from_manifest_warms_the_recorded_buckets(tmp_path):
    art = tmp_path / "art"
    cfg = _cfg(art)
    slow = _build(cfg)
    full = slow.warmup()
    fast = _build(cfg)
    assert load_manifest(str(art))["buckets"]["batch"] == [1, 2]
    assert fast.warmup_from_manifest() == full
    manifest = load_manifest(str(art))
    manifest["buckets"]["batch"] = [2]
    write_manifest(str(art), manifest)
    part = _build(cfg)
    assert _hit(part) and part.warmup_from_manifest() == full // 2
    part.artifact_manifest["buckets"] = {}
    assert part.warmup_from_manifest() == full


# ------------------------------------------------------------- the worker

def _metric(text: str, family: str) -> float:
    for line in text.splitlines():
        if line.startswith(family + "_total{") or \
                line.startswith(family + "{"):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"no sample of {family}")


async def test_worker_loads_path_and_artifact_over_rpc(tmp_path):
    """``load_model`` of an HF directory with ``artifact=`` and
    ``warmup=1`` over RPC: a miss (slow path, artifact written), then after
    an unload a hit (cold start, its manifest's warm-up) with the same
    tokens; ``metrics`` and ``metrics_text`` count both."""
    write_hf_llama(tmp_path, FAMILY_CONFIGS["llama"], seed=9)
    cfg = _cfg(tmp_path / "art", path=str(tmp_path), warmup="1")
    server = WorkerServer(ServerConfig(worker_id="aw", port=0), device="cpu")
    host, port = await server.start()
    c = WorkerClient(host, port, timeout=120.0)
    prompts = [[4, 9, 2], list(range(1, 30))]
    try:
        outs = []
        for _ in range(2):
            receipt = await c.load_model(cfg)
            assert receipt["loaded"] == "m" and receipt["load_s"] > 0
            res = await c.generate("m", [GenerationRequest(
                prompt=p, max_new_tokens=6) for p in prompts])
            outs.append([r.tokens for r in res])
            m = await c.metrics()
            assert m["models"]["m"]["load"]["source"] in ("hf", "artifact")
            assert m["model_warmup"]["m"][0] > 0
            assert await c.unload_model("m") is True
        assert outs[0] == outs[1]
        m = await c.metrics()
        assert (m["artifact_misses"], m["artifact_hits"]) == (1, 1)
        text = await c.metrics_text()
        assert _metric(text, "worker_artifact_hits") == 1.0
        assert _metric(text, "worker_artifact_misses") == 1.0
    finally:
        await c.close()
        await server.stop()


async def test_staged_artifact_swap_is_gated_by_its_own_probe(tmp_path):
    """A staged engine cold-started from an artifact (its self-check off)
    is gated at the swap by its manifest's recorded probe, with no probe
    from the caller: a sound manifest swaps in, a wrong golden is
    refused and the staged engine dropped."""
    art = tmp_path / "art"
    cfg = _cfg(art, artifact_selfcheck="0")
    _build(_cfg(art))                            # writes it, with a golden
    server = WorkerServer(ServerConfig(worker_id="sw", port=0), device="cpu")
    loop = asyncio.get_running_loop()
    server.stage_model(cfg)
    receipt = await loop.run_in_executor(None, server.swap_model, "m")
    assert receipt["swapped"] == "m" and _hit(server.engines["m"])
    await server.unload_model("m")
    bad = load_manifest(str(art))
    bad["golden"]["tokens"] = [(t + 1) % 1024
                               for t in bad["golden"]["tokens"]]
    write_manifest(str(art), bad)
    server.stage_model(cfg)
    with pytest.raises(ModelProbeError, match="golden"):
        await loop.run_in_executor(None, server.swap_model, "m")
    assert "m" not in server.engines
    await server.stop()


def _start_cli(args):
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_inference_engine_tpu_torch.cli."
         "worker", "--device", "cpu", "--log-level", "WARNING", *args],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []
    deadline = time.time() + 120
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if "listening on" in line:
            host, port = line.rsplit(" ", 1)[1].strip().split(":")
            return proc, host, int(port), lines
    proc.kill()
    raise AssertionError("worker did not come up:\n" + "".join(lines))


async def test_cli_artifact_dir(tmp_path):
    """``--artifact-dir DIR`` gives each ``--model`` the artifact
    ``DIR/<name>``: the first start writes it, the second cold-starts from
    it (its load line tagged ``[artifact cold-start]``)."""
    write_hf_llama(tmp_path, FAMILY_CONFIGS["llama"], seed=10)
    model = (f"name=hf,architecture=llama,path={tmp_path},dtype=float32,"
             "max_seq_len=64,max_batch_size=2,continuous=1,page_size=16,"
             "num_pages=32")
    args = ["--port", "0", "--artifact-dir", str(tmp_path / "arts"),
            "--model", model]
    got = []
    for start in range(2):
        proc, host, port, lines = _start_cli(args)
        c = WorkerClient(host, port, timeout=60.0)
        try:
            loaded = [x for x in lines if x.startswith("loaded model hf")]
            assert loaded and (("[artifact cold-start]" in loaded[0])
                               == (start == 1)), lines
            m = await c.metrics()
            assert (m["artifact_misses"], m["artifact_hits"]) == \
                ((1, 0) if start == 0 else (0, 1))
            got.append((await c.generate("hf", [GenerationRequest(
                prompt=[3, 1, 4], max_new_tokens=5)]))[0].tokens)
            await c.shutdown()
            assert proc.wait(timeout=60) == 0
        finally:
            await c.close()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert has_artifact(str(tmp_path / "arts" / "hf"))
    assert got[0] == got[1]
    manifest = json.loads((tmp_path / "arts" / "hf" / MANIFEST_FILE)
                          .read_text())
    assert manifest["feature_hash"] and np.asarray(
        manifest["golden"]["tokens"]).size == 8
