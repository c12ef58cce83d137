"""Weight-only quantized serving in the port against the JAX package: the
port's ContinuousEngine (device cpu) on a bridged JAX-quantized fp32
llama-tiny tree (int4, which the port fuses and runs through the int4
matmul's plain version, and int8) emits the JAX engine's greedy tokens
(attention_impl="xla", the same tree) through the flash-decode path and
through the ragged mixed step with chunked prefill, a prefix hit
included; logprobs within 1e-4. And the port's worker, built by its
factory with ``quantized=1,weight_bits=4``, answers the JAX package's
WorkerClient with the JAX engine's tokens on the same (born-quantized)
weights."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from distributed_inference_engine_tpu.models.llama import llama_spec as jspec
from distributed_inference_engine_tpu.ops import quant as jq
from distributed_inference_engine_tpu_torch.bridge import (
    params_from_numpy,
    params_to_numpy,
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
from distributed_inference_engine_tpu_torch.ops import quant as tq

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

KW = dict(max_slots=4, max_seq_len=128, prefill_buckets=[16, 64],
          page_size=16, num_pages=48, decode_steps_per_call=4,
          kv_dtype="float32")


def _waves():
    """Staggered waves: prompts of 3-45 tokens, a 45-token owner of a
    2-page prefix, then a prefix hit on it whose 40-token tail exceeds a
    16-token chunk (submitted once the owner's chunks are done)."""
    rs = np.random.RandomState(12)
    shared = rs.randint(1, 1024, size=32).tolist()
    first = [dict(prompt=rs.randint(1, 1024, size=n).tolist(),
                  max_new_tokens=m, request_id=f"a{i}")
             for i, (n, m) in enumerate(((9, 8), (28, 6), (3, 8)))]
    first.append(dict(prompt=shared + rs.randint(1, 1024, size=13).tolist(),
                      max_new_tokens=6, request_id="owner"))
    second = [dict(prompt=rs.randint(1, 1024, size=20).tolist(),
                   max_new_tokens=5, request_id="b0")]
    third = [dict(prompt=shared + rs.randint(1, 1024, size=40).tolist(),
                  max_new_tokens=8, request_id="hit")]
    return [first, second, third]


def _drive(engine, req_cls, waves, steps=3):
    out = {}
    for wave in waves:
        for kw in wave:
            engine.submit(req_cls(**kw))
        for _ in range(steps):
            engine.step()
            out.update({r.request_id: r for r in engine.drain_finished()})
    out.update({r.request_id: r for r in engine.run_until_idle()})
    return out


@pytest.fixture(scope="module", params=[4, 8], ids=["int4", "int8"])
def quantized(request):
    """A JAX-quantized fp32 llama-tiny tree (born quantized), bridged; and
    the JAX engine's results on it, whole-prompt and chunked (16)."""
    bits = request.param
    js = jspec("llama-tiny", dtype="float32")
    ts = tspec("llama-tiny", dtype="float32")
    jp = jq.random_quantized_params(js, jax.random.key(1), bits=bits)
    tp = params_from_numpy(jax.device_get(jp), ts, "cpu")
    want = {}
    for chunk in (0, 16):
        je = JEngine(js, params=jp, config=JCfg(
            attention_impl="xla", prefill_chunk=chunk, **KW))
        want[chunk] = _drive(je, JReq, _waves())
        assert je.get_metrics()["prefix_hit_admissions"] >= 1
    return bits, ts, tp, want


@pytest.mark.parametrize("impl,chunk", [("pallas-decode", 0),
                                        ("pallas-ragged", 16)])
def test_quantized_engine_matches_jax_engine(quantized, impl, chunk):
    bits, ts, tp, want = quantized
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(
        attention_impl=impl, prefill_chunk=chunk, **KW), device="cpu")
    assert ("w_qkv" in te.params["blocks"]) == (bits == 4)
    got = _drive(te, GenerationRequest, _waves())
    assert sorted(got) == sorted(want[chunk]) and len(got) == 6
    for rid, w in want[chunk].items():
        assert got[rid].tokens == w.tokens, rid
        assert got[rid].finish_reason == w.finish_reason, rid
        np.testing.assert_allclose(got[rid].logprobs, w.logprobs, rtol=0,
                                   atol=1e-4)
    m = te.get_metrics()
    assert m["prefix_hit_admissions"] >= 1
    if chunk:
        assert m["mixed_steps"] > 0 and m["chunked_admissions"] >= 2


def _jax_tree(tree):
    """The port's numpy tree (``params_to_numpy``) as a JAX tree."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, tq.QuantizedTensor):
        return jq.QuantizedTensor(q=jnp.asarray(tree.q),
                                  s=jnp.asarray(tree.s), bits=tree.bits,
                                  pack_axis=tree.pack_axis)
    return jnp.asarray(tree)


async def test_worker_factory_int4_through_jax_client():
    """``quantized=1,weight_bits=4`` through the CLI's metadata strings: the
    port's factory draws int4 weights from the seed (fused at engine init);
    the same weights in the JAX engine give the same tokens."""
    md = {"size": "llama-tiny", "continuous": "1", "weight_bits": "4",
          "seed": "3", "page_size": "16", "num_pages": "48",
          "prefill_buckets": "[16, 64]", "kv_dtype": "float32"}
    cfg = ModelConfig(name="q4", architecture="llama", dtype="float32",
                      max_seq_len=128, max_batch_size=4, quantized=True,
                      metadata=md)
    ref = engine_from_config(cfg, device="cpu")
    blocks = ref.params["blocks"]
    assert blocks["w_qkv"].bits == 4 and "w_gate_up" in blocks
    assert ref.params["lm_head"].q.shape == (128, 2048)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, 1024, size=n).tolist() for n in (7, 30, 50)]
    js = jspec("llama-tiny", dtype="float32")
    want = JEngine(js, params=_jax_tree(params_to_numpy(ref.params)),
                   config=JCfg(attention_impl="xla", **KW)).generate(
        [JReq(prompt=p, max_new_tokens=7) for p in prompts])

    server = WorkerServer(ServerConfig(worker_id="q0", port=0), device="cpu")
    server.load_model(cfg)
    host, port = await server.start()
    client = JClient(host, port, timeout=60.0)
    try:
        outs = await asyncio.gather(*[
            client.generate("q4", [JReq(prompt=p, max_new_tokens=7,
                                        request_id=f"q{i}")])
            for i, p in enumerate(prompts)])
        for o, w in zip(outs, want):
            assert o[0].tokens == w.tokens
            assert o[0].finish_reason == w.finish_reason == "length"
        assert (await client.ping())["models"] == ["q4"]
    finally:
        await client.close()
        await server.stop()


def test_weight_bits_must_be_4_or_8():
    cfg = ModelConfig(name="m", architecture="llama", quantized=True,
                      metadata={"size": "llama-tiny", "continuous": True,
                                "weight_bits": "3"})
    with pytest.raises(ValueError, match="weight_bits"):
        engine_from_config(cfg, device="cpu")
