"""The port's worker on the wire: the JAX package's WorkerClient drives
the port's WorkerServer (CPU engine, bridged llama-tiny f32 weights) and
gets the JAX engine's tokens; frames are byte-identical; the CLI parses
--model as the JAX CLI does; and no module of the port imports JAX."""

import ast
import asyncio
import pathlib
import subprocess
import sys

import jax
import msgpack
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu.cli.worker import (
    parse_model_arg as j_parse,
)
from distributed_inference_engine_tpu.cluster.worker import (
    WorkerClient as JClient,
)
from distributed_inference_engine_tpu.config import EngineConfig as JCfg
from distributed_inference_engine_tpu.engine.continuous import (
    ContinuousEngine as JEngine,
)
from distributed_inference_engine_tpu.engine.types import (
    GenerationRequest as JReq,
)
from distributed_inference_engine_tpu.models.base import init_params
from distributed_inference_engine_tpu.models.llama import llama_spec as jspec
from distributed_inference_engine_tpu.utils import framing as jframing
from distributed_inference_engine_tpu_torch.bridge import params_from_numpy
from distributed_inference_engine_tpu_torch.cli.worker import (
    parse_model_arg as t_parse,
)
from distributed_inference_engine_tpu_torch.cluster.worker import (
    WorkerClient as TClient,
)
from distributed_inference_engine_tpu_torch.cluster.worker import (
    WorkerServer,
)
from distributed_inference_engine_tpu_torch.config import (
    EngineConfig,
    ModelConfig,
    ServerConfig,
)
from distributed_inference_engine_tpu_torch.engine.continuous import (
    ContinuousEngine,
)
from distributed_inference_engine_tpu_torch.engine.types import (
    GenerationRequest,
)
from distributed_inference_engine_tpu_torch.models import engine_from_config
from distributed_inference_engine_tpu_torch.models.llama import (
    llama_spec as tspec,
)
from distributed_inference_engine_tpu_torch.utils import framing as tframing

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_PKG = ROOT / "distributed_inference_engine_tpu_torch"
KW = dict(max_slots=4, max_seq_len=128, prefill_buckets=[16, 64],
          page_size=16, num_pages=48, decode_steps_per_call=4,
          kv_dtype="float32")


def _prompts():
    rs = np.random.RandomState(0)
    return [rs.randint(1, 1024, size=n).tolist() for n in (7, 19, 33, 50)]


async def test_jax_client_gets_jax_engine_tokens_from_port_worker():
    js = jspec("llama-tiny", dtype="float32")
    ts = tspec("llama-tiny", dtype="float32")
    jp = init_params(js, jax.random.key(0))
    tp = params_from_numpy(jax.device_get(jp), ts, "cpu")
    prompts = _prompts()
    want = JEngine(js, params=jp, config=JCfg(attention_impl="xla", **KW)
                   ).generate([JReq(prompt=p, max_new_tokens=9)
                               for p in prompts])

    def factory(cfg):
        return ContinuousEngine(ts, params=tp, config=EngineConfig(**KW),
                                device="cpu")

    server = WorkerServer(ServerConfig(worker_id="tw0", port=0),
                          engine_factory=factory)
    server.load_model(ModelConfig(name="tiny", architecture="llama"))
    host, port = await server.start()
    jc = JClient(host, port, timeout=60.0)
    tc = TClient(host, port, timeout=60.0)
    try:
        pong = await jc.ping()
        assert pong["worker_id"] == "tw0" and pong["models"] == ["tiny"]
        outs = await asyncio.gather(*[
            jc.generate("tiny", [JReq(prompt=p, max_new_tokens=9,
                                      request_id=f"q{i}")])
            for i, p in enumerate(prompts)])
        for i, (o, w) in enumerate(zip(outs, want)):
            assert o[0].request_id == f"q{i}"
            assert o[0].tokens == w.tokens
            assert o[0].finish_reason == w.finish_reason == "length"
        # the port's own client on the same server
        own = await tc.generate("tiny", [GenerationRequest(
            prompt=prompts[0], max_new_tokens=9)])
        assert own[0].tokens == want[0].tokens
        assert (await tc.kernel_counts()) == {}        # CPU: no launches
        models = (await tc.list_models())["models"]
        assert models["tiny"]["architecture"] == "llama"
        with pytest.raises(Exception, match="not loaded"):
            await jc.generate("nope", [JReq(prompt=[1, 2])])
    finally:
        await jc.close()
        await tc.close()
        await server.stop()


async def test_worker_counts_deadline_expiries():
    """Requests past their own ``deadline_s`` come back over the wire with
    finish_reason "deadline"; the worker counts them in
    ``deadline_expired_count`` (the JAX worker's key), the engine in
    ``deadline_expired``."""
    ts = tspec("llama-tiny", dtype="float32")

    def factory(cfg):
        return ContinuousEngine(ts, config=EngineConfig(**KW), device="cpu")

    server = WorkerServer(ServerConfig(worker_id="tw1", port=0),
                          engine_factory=factory)
    server.load_model(ModelConfig(name="tiny", architecture="llama"))
    host, port = await server.start()
    jc = JClient(host, port, timeout=60.0)
    try:
        prompts = _prompts()
        outs = await jc.generate("tiny", [
            JReq(prompt=p, max_new_tokens=3, request_id=f"d{i}",
                 deadline_s=0.0 if i % 2 else None)
            for i, p in enumerate(prompts)])
        assert [o.finish_reason for o in outs] == [
            "length", "deadline", "length", "deadline"]
        assert [len(o.tokens) for o in outs] == [3, 0, 3, 0]
        m = await jc.metrics()
        assert m["deadline_expired_count"] == 2 and m["error_count"] == 0
        assert m["models"]["tiny"]["deadline_expired"] == 2
    finally:
        await jc.close()
        await server.stop()


@pytest.mark.parametrize("obj", [
    {"method": "generate", "id": "7f-1", "model": "tiny",
     "requests": [{"prompt": [1, 300, 70000, 5_000_000_000],
                   "temperature": 0.7, "deadline_s": None,
                   "stop_sequences": [[1, 2]], "eos_id": -1,
                   "min_p": -0.5}]},
    {"ok": True, "neg": [-1, -33, -200, -40000, -3_000_000_000],
     "s": "x" * 40, "long": "y" * 300, "blob": b"\x00\x01" * 200,
     "many": list(range(20)), "big": {str(i): i for i in range(20)}},
])
def test_frames_byte_identical_to_jax(obj):
    assert tframing.packb(obj) == msgpack.packb(obj, use_bin_type=True)
    assert tframing.encode_frame(obj) == jframing.encode_frame(obj)
    back, n = tframing.decode_frame(jframing.encode_frame(obj))
    assert back == msgpack.unpackb(msgpack.packb(obj, use_bin_type=True),
                                   raw=False)
    assert n == len(jframing.encode_frame(obj))


@pytest.mark.parametrize("text", [
    "name=tiny,architecture=llama,size=llama-tiny,continuous=1",
    "name=m,architecture=llama,max_seq_len=1024,page_size=64,"
    "attention_impl=pallas-decode,dtype=float32,quantized=false,seed=3",
    "name=llama3-8b,architecture=llama,size=llama3-8b,continuous=1,"
    "attention_impl=pallas-ragged,prefill_chunk=256,mixed_step_tokens=512",
    "name=mistral-7b-v01,architecture=mistral,size=mistral-7b-v01,"
    "continuous=1,attention_impl=pallas,max_seq_len=8192,prefill_chunk=512,"
    "seed=0",
])
def test_parse_model_arg_matches_jax(text):
    assert t_parse(text).to_dict() == j_parse(text).to_dict()


def test_engine_from_config_rejects_unported():
    base = dict(name="m", architecture="llama",
                metadata={"size": "llama-tiny", "continuous": True,
                          "device": "cpu"})
    for change in (dict(metadata={**base["metadata"], "tp": 2}),
                   dict(metadata={**base["metadata"], "kv_offload": "1"})):
        with pytest.raises(NotImplementedError):
            engine_from_config(ModelConfig(**{**base, **change}),
                               device="cpu")
    # ported with the static engine and speculation (A8, A12): each builds
    # its engine, and serves
    from distributed_inference_engine_tpu_torch.engine.engine import Engine
    from distributed_inference_engine_tpu_torch.engine.speculative import (
        SpeculativeEngine,
    )

    for change, cls in (
            ({"speculative": 2, "draft_size": "llama-tiny"},
             SpeculativeEngine),
            ({"continuous": False}, Engine),
            ({"spec_async": "1", "spec_bubble_floor_s": "0"},
             ContinuousEngine)):
        eng = engine_from_config(ModelConfig(**{
            **base, "metadata": {**base["metadata"], **change}},
            dtype="float32", max_seq_len=64), device="cpu")
        assert type(eng) is cls
        out = eng.generate([GenerationRequest(prompt=[1, 2, 3],
                                              max_new_tokens=3)])
        assert len(out[0].tokens) == 3
    assert engine_from_config(ModelConfig(**{**base, "metadata": {
        **base["metadata"], "spec_async": "1"}}, max_seq_len=64),
        device="cpu").speculator is not None
    # ported with checkpoints and artifacts (A11): a path that is not a
    # checkpoint directory is refused as such, not as unported
    with pytest.raises(FileNotFoundError):
        engine_from_config(ModelConfig(**{**base, "path": "/ckpt"}),
                           device="cpu")
    # ported in the host-path slice: streaming, shedding and warmup=
    eng = engine_from_config(ModelConfig(**{**base, "metadata": {
        **base["metadata"], "stream_chunk_steps": "2", "max_waiting": "3",
        "queue_deadline_s": "0.5", "warmup": "1"}}, max_seq_len=64),
        device="cpu")
    assert (eng.config.stream_chunk_steps, eng.config.max_waiting,
            eng.config.queue_deadline_s) == (2, 3, 0.5)
    eng = engine_from_config(ModelConfig(**base, dtype="float32",
                                         max_seq_len=64), device="cpu")
    assert eng.spec.n_layers == 4 and eng.max_seq_len == 64
    assert str(eng.device) == "cpu"


# the card's machine has none of these (safetensors: the port carries its
# own reader and writer, utils/safetensors_io.py)
_BANNED = ("jax", "jaxlib", "ml_dtypes", "msgpack", "psutil", "safetensors",
           "distributed_inference_engine_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_anywhere():
    files = sorted(PORT_PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            for banned in _BANNED:
                assert not (mod == banned or mod.startswith(banned + ".")), \
                    f"{f.relative_to(ROOT)} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import distributed_inference_engine_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'msgpack', 'safetensors', "
        "'distributed_inference_engine_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


async def test_port_worker_serves_mistral_tiny():
    """``architecture=mistral,size=mistral-tiny`` through the port's worker
    (its own factory, weights drawn from the seed on the CPU) and the JAX
    client: prompts past the 64-token window, chunked on the split path,
    decoded inline. The tokens are the JAX engine's on the same weights
    (the port's tree bridged back through numpy)."""
    from distributed_inference_engine_tpu.models.mistral import (
        mistral_spec as jmistral)
    from distributed_inference_engine_tpu_torch.bridge import (
        params_to_numpy)

    cfg = t_parse("name=mistral,architecture=mistral,size=mistral-tiny,"
                  "continuous=1,dtype=float32,max_seq_len=256,page_size=16,"
                  "num_pages=64,prefill_chunk=32,kv_dtype=float32,seed=0")
    server = WorkerServer(ServerConfig(worker_id="tw1", port=0),
                          device="cpu")
    server.load_model(cfg)
    eng = server.engines["mistral"]
    tree = jax.tree_util.tree_map(np.asarray, params_to_numpy(eng.params))
    js = jmistral("mistral-tiny", dtype="float32", max_seq_len=256)
    jcfg = JCfg(attention_impl="xla", prefill_chunk=32, page_size=16,
                num_pages=64, max_seq_len=256, kv_dtype="float32")
    rs = np.random.RandomState(9)
    prompts = [rs.randint(1, 1024, size=n).tolist() for n in (20, 90, 140)]
    want = JEngine(js, params=tree, config=jcfg).generate(
        [JReq(prompt=p, max_new_tokens=7) for p in prompts])
    host, port = await server.start()
    jc = JClient(host, port, timeout=60.0)
    try:
        outs = await asyncio.gather(*[
            jc.generate("mistral", [JReq(prompt=p, max_new_tokens=7,
                                         request_id=f"m{i}")])
            for i, p in enumerate(prompts)])
        for o, w in zip(outs, want):
            assert o[0].tokens == w.tokens and len(w.tokens) == 7
        m = (await jc.metrics())["models"]["mistral"]
        assert m["decode_mode"] == "inline" and m["decode_steps"] > 0
        assert m["chunked_admissions"] == 2
    finally:
        await jc.close()
        await server.stop()


def test_engine_from_config_runs_the_mixed_step():
    """The CLI's metadata strings configure chunked prefill in the ragged
    mixed step, and the engine's metrics report it."""
    md = {"size": "llama-tiny", "continuous": "1",
          "attention_impl": "pallas-ragged", "prefill_chunk": "32",
          "mixed_step_tokens": "64", "page_size": "16", "num_pages": "64"}
    eng = engine_from_config(ModelConfig(
        name="m", architecture="llama", dtype="float32", max_seq_len=256,
        metadata=md), device="cpu")
    assert (eng.config.prefill_chunk, eng.config.mixed_step_tokens) == \
        (32, 64)
    prompt = np.random.RandomState(1).randint(1, 1024, size=100).tolist()
    res = eng.generate([GenerationRequest(prompt=prompt, max_new_tokens=5),
                        GenerationRequest(prompt=prompt[:9],
                                          max_new_tokens=5)])
    assert [len(r.tokens) for r in res] == [5, 5]
    m = eng.get_metrics()
    assert m["mixed_steps"] >= 2 and m["chunked_admissions"] == 1
    assert m["mixed_prefill_tokens"] == 100 - 32
    assert m["prefilling_slots"] == 0 and m["mixed_programs"] >= 1
