"""The port's static engine (A8) against the JAX package, on the CPU: the
counterpart of ``tests/test_engine.py``.

- ``ops/attention.py:cached_attention``, ``models/base.py:forward_decode``
  and ``forward_window`` against the JAX functions on the same numpy
  inputs, over fp32, bf16, e4m3 and e5m2 caches, windowed and not: outputs
  and written caches within 1e-4 (fp32) and 2e-2 (bf16), atol and rtol;
  fp8 caches byte-equal. Writes past the cache and window slots past
  ``n_valid`` drop, as JAX's ``mode="drop"`` scatters do.
- ``ops/sampling.py:masked_sampling_probs`` within 1e-6 of JAX's for every
  knob.
- ``SlotKVCache`` against JAX's (slots, stats keys and values, written
  rows).
- ``Engine`` against the JAX ``Engine`` on bridged weights (``SPEC`` of
  ``tests/test_engine.py``, fp32): greedy tokens, finish reasons and
  logprobs (1e-4) for a batch against solo, per-request
  ``max_new_tokens``, eos, an overlong prompt and host stops; int8 and int4
  trees and e4m3/e5m2 caches on ``llama-tiny``; bf16 held teacher-forced
  through the JAX ``assert_greedy_parity``; metrics keys and warmup as
  JAX's; sampled runs seeded; ``shard_fn``/``sp_mesh`` raising (A13).
- The factory's ``continuous=0`` branch, an artifact round trip through it
  and a port worker serving it over RPC with the JAX engine's tokens.
"""

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
from distributed_inference_engine_tpu.engine import engine as jeng
from distributed_inference_engine_tpu.engine.kv_cache import (
    SlotKVCache as JSlotKVCache,
)
from distributed_inference_engine_tpu.engine.types import (
    GenerationRequest as JReq,
)
from distributed_inference_engine_tpu.models import base as jb
from distributed_inference_engine_tpu.models.llama import llama_spec as jspec
from distributed_inference_engine_tpu.ops import attention as jattn
from distributed_inference_engine_tpu.ops import quant as jq
from distributed_inference_engine_tpu.ops import sampling as jsamp
from distributed_inference_engine_tpu.utils.parity import (
    assert_greedy_parity,
)
from distributed_inference_engine_tpu_torch import bridge
from distributed_inference_engine_tpu_torch.cluster.worker import (
    WorkerServer,
)
from distributed_inference_engine_tpu_torch.config import (
    EngineConfig,
    ModelConfig,
    ServerConfig,
)
from distributed_inference_engine_tpu_torch.engine import continuous as tcont
from distributed_inference_engine_tpu_torch.engine import engine as teng
from distributed_inference_engine_tpu_torch.engine.artifact import (
    load_manifest,
)
from distributed_inference_engine_tpu_torch.engine.kv_cache import (
    SlotKVCache,
)
from distributed_inference_engine_tpu_torch.engine.types import (
    GenerationRequest,
)
from distributed_inference_engine_tpu_torch.models import base as tb
from distributed_inference_engine_tpu_torch.models import engine_from_config
from distributed_inference_engine_tpu_torch.models.llama import (
    llama_spec as tspec,
)
from distributed_inference_engine_tpu_torch.ops import attention as tattn
from distributed_inference_engine_tpu_torch.ops import sampling as tsamp
from distributed_inference_engine_tpu_torch.ops.quant import QuantizedTensor

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

SPEC_KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
               n_kv_heads=2, d_ff=48, max_seq_len=128, pos_emb="rope",
               norm="rmsnorm", mlp="swiglu", use_bias=False,
               tie_embeddings=False, dtype="float32")
CFG_KW = dict(max_seq_len=128, max_slots=4, prefill_buckets=[16, 32],
              decode_steps_per_call=4, dtype="float32", kv_dtype="float32")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (compute dtype, cache dtype)
DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
          ("float32", "bfloat16"), ("float32", "float8_e4m3fn"),
          ("float32", "float8_e5m2"), ("bfloat16", "float8_e4m3fn")]
DT_IDS = ["f32", "bf16", "f32-bf16kv", "f32-e4m3", "f32-e5m2", "bf16-e4m3"]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got: torch.Tensor, want, dt: str):
    tol = TOL[dt]
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)


def _cache_check(got: torch.Tensor, want, kv: str, dt: str):
    """Written caches: fp32/bf16 within the tolerance of the compute dtype.
    fp8 bytes are JAX's but where the two frameworks' fresh values (a few
    ulps apart) round to different codes: with fp32 compute JAX's
    neighbour (its magnitude one code off, or +0 against -0 for a value
    that rounds to zero), at under 0.1% of the bytes; with bf16 compute,
    whose values part by more over the layers, the decoded value within
    2e-2 plus one code (12.5% for e4m3, 25% for e5m2), at under 2%.
    ``test_dense_writes_hold_jax_bytes`` holds the same fresh values' bytes
    exactly."""
    if not kv.startswith("float8"):
        _close(got, want, dt if kv == "float32" else "bfloat16")
        return
    g = bridge.tensor_to_numpy(got).astype(np.int32)
    w = np.asarray(want).view(np.uint8).astype(np.int32)
    diff = g != w
    assert diff.mean() < (2e-2 if dt == "bfloat16" else 1e-3)
    if dt == "bfloat16":
        step = 0.125 if kv == "float8_e4m3fn" else 0.25
        wf = _np(want)
        assert (np.abs(got.float().numpy() - wf)
                <= 2e-2 + step * np.abs(wf)).all()
        return
    gd, wd = g[diff], w[diff]
    neighbour = ((gd >> 7) == (wd >> 7)) & (np.abs(gd - wd) == 1)
    signed_zero = ((gd & 0x7F) == 0) & ((wd & 0x7F) == 0)
    assert (neighbour | signed_zero).all()


def _caches(rs, shape, kv: str):
    """The same random cache in JAX (in ``kv``) and in the port (a
    ``dense_kv_cache`` holding the same bytes)."""
    jc = jnp.asarray(rs.randn(*shape).astype(np.float32)).astype(
        jnp.dtype(kv))
    tc = tb.dense_kv_cache(shape, tb.kv_torch_dtype(kv), "cpu")
    tc.copy_(bridge.tensor_from_numpy(np.asarray(jc), "cpu"))
    return jc, tc


@pytest.fixture(scope="module")
def tiny():
    """llama-tiny in fp32 and bf16: JAX spec and params, port spec and
    bridged params."""
    out = {}
    for dt in ("float32", "bfloat16"):
        js, ts = jspec("llama-tiny", dtype=dt), tspec("llama-tiny", dtype=dt)
        jp = jb.init_params(js, jax.random.key(0))
        out[dt] = (js, ts, jp, bridge.params_from_numpy(
            jax.device_get(jp), ts, "cpu"))
    return out


# ------------------------------------------------------------- buckets


def test_bucket_helpers_match_jax():
    for cap, start in ((8, 1), (6, 1), (2048, 128), (96, 128)):
        assert teng._pow2_buckets(cap, start) == jeng._pow2_buckets(
            cap, start)
    assert teng._next_bucket(3, [2, 4, 8]) == 4
    with pytest.raises(ValueError):
        teng._next_bucket(9, [2, 4, 8])
    # the continuous engine takes them from the static engine's module
    assert tcont._pow2_buckets is teng._pow2_buckets
    assert tcont._next_bucket is teng._next_bucket


# ----------------------------------------------------------- attention


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("dt,kv", DTYPES, ids=DT_IDS)
def test_cached_attention_matches_jax(dt, kv, window):
    rs = np.random.RandomState(3)
    b, s, h, hkv, dh = 4, 40, 8, 2, 32
    q = jnp.asarray(rs.randn(b, 1, h, dh).astype(np.float32)).astype(dt)
    jk, tk = _caches(rs, (1, b, s, hkv, dh), kv)
    jv, tv = _caches(rs, (1, b, s, hkv, dh), kv)
    lengths = np.array([1, 13, 39, 40], np.int32)
    want = jattn.cached_attention(q, jk[0], jv[0], jnp.asarray(lengths),
                                  window=window)
    got = tattn.cached_attention(
        bridge.tensor_from_numpy(np.asarray(q), "cpu"), tk[0], tv[0],
        torch.from_numpy(lengths), window=window)
    assert got.dtype == tb.torch_dtype(dt) and got.shape == (b, 1, h, dh)
    _close(got, want, dt)


# ------------------------------------------------- dense-cache forwards


def _spec_pair(tiny, dt, window):
    js, ts, jp, tp = tiny[dt]
    if window:
        js = js.replace(sliding_window=window)
        ts = ts.replace(sliding_window=window)
    return js, ts, jp, tp


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("dt,kv", DTYPES, ids=DT_IDS)
def test_forward_decode_matches_jax(tiny, dt, kv, window):
    """Rows at position 0, mid-cache, the last position, and ``S`` (its
    write drops: the JAX scatter's out-of-range index)."""
    js, ts, jp, tp = _spec_pair(tiny, dt, window)
    rs = np.random.RandomState(5)
    shape = (js.n_layers, 4, 24, js.n_kv_heads, js.head_dim)
    jk, tk = _caches(rs, shape, kv)
    jv, tv = _caches(rs, shape, kv)
    tokens = rs.randint(0, js.vocab_size, size=4).astype(np.int32)
    lengths = np.array([0, 9, 23, 24], np.int32)
    hid, jk2, jv2 = jb.forward_decode(js, jp, jnp.asarray(tokens),
                                      jnp.asarray(lengths), jk, jv)
    got, tk2, tv2 = tb.forward_decode(ts, tp, torch.from_numpy(tokens),
                                      torch.from_numpy(lengths), tk, tv)
    assert tk2 is tk and tv2 is tv                 # in place
    _close(got, hid, dt)
    _cache_check(tk, jk2, kv, dt)
    _cache_check(tv, jv2, kv, dt)


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("dt,kv", DTYPES, ids=DT_IDS)
def test_forward_window_matches_jax(tiny, dt, kv, window):
    """Window slots past ``n_valid`` and positions past ``S`` drop; a row
    at the sentinel ``start = S`` writes nothing; logits within the
    tolerance at every position (a row's invalid positions included)."""
    js, ts, jp, tp = _spec_pair(tiny, dt, window)
    rs = np.random.RandomState(6)
    s = 24
    shape = (js.n_layers, 5, s, js.n_kv_heads, js.head_dim)
    jk, tk = _caches(rs, shape, kv)
    jv, tv = _caches(rs, shape, kv)
    tokens = rs.randint(0, js.vocab_size, size=(5, 5)).astype(np.int32)
    n_valid = np.array([5, 2, 5, 0, 1], np.int32)
    start = np.array([0, 10, 21, s, 23], np.int32)
    lg, jk2, jv2 = jb.forward_window(js, jp, jnp.asarray(tokens),
                                     jnp.asarray(n_valid),
                                     jnp.asarray(start), jk, jv)
    got, _, _ = tb.forward_window(ts, tp, torch.from_numpy(tokens),
                                  torch.from_numpy(n_valid),
                                  torch.from_numpy(start), tk, tv)
    assert got.dtype == torch.float32 and got.shape == (5, 5, js.vocab_size)
    _close(got, lg, dt)
    _cache_check(tk, jk2, kv, dt)
    _cache_check(tv, jv2, kv, dt)


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "float8_e4m3fn",
                                "float8_e5m2"])
def test_dense_writes_hold_jax_bytes(kv):
    """The same fresh values written at the same (row, position) as JAX's
    ``.at[l, b, pos].set(x.astype(dtype), mode="drop")``: every byte equal,
    values past 464 and 61,440 and positions past ``S`` (dropped)
    included."""
    rs = np.random.RandomState(8)
    shape = (2, 3, 10, 2, 16)
    jc, tc = _caches(rs, shape, kv)
    fresh = (rs.randn(3, 4, 2, 16) * 300).astype(np.float32)
    fresh[0, 0, 0, :3] = [500.0, -7e4, np.inf]
    pos = np.array([[0, 1, 2, 3], [7, 8, 9, 10], [12, 13, 14, 15]])
    valid = np.array([[True] * 4, [True, True, False, True], [True] * 4])
    want = jc.at[1, np.arange(3)[:, None], np.where(valid, pos, 10)].set(
        jnp.asarray(fresh).astype(jnp.dtype(kv)), mode="drop")
    tb._write_dense(tb._cache_rows(tc), torch.from_numpy(fresh), 1, 3, 10,
                    torch.from_numpy(pos), torch.from_numpy(valid))
    np.testing.assert_array_equal(
        bridge.tensor_to_numpy(tc).view(np.uint8),
        np.asarray(want).view(np.uint8))


def test_dense_cache_needs_its_spare_row(tiny):
    js, ts, jp, tp = tiny["float32"]
    plain = torch.zeros((ts.n_layers, 1, 8, ts.n_kv_heads, ts.head_dim))
    with pytest.raises(ValueError, match="dense_kv_cache"):
        tb.forward_decode(ts, tp, torch.zeros(1, dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32), plain, plain)


# ------------------------------------------------------------ sampling


KNOBS = [dict(temperature=0.0), dict(temperature=0.7),
         dict(temperature=1.3, top_k=5), dict(temperature=0.9, top_p=0.6),
         dict(temperature=1.0, min_p=0.2),
         dict(temperature=0.8, top_k=9, top_p=0.8, min_p=0.05),
         dict(temperature=0.5, top_k=1)]


@pytest.mark.parametrize("positions", [0, 3])
@pytest.mark.parametrize("knobs", KNOBS + [None],
                         ids=[f"k{i}" for i in range(len(KNOBS))] + ["mix"])
def test_masked_sampling_probs_matches_jax(knobs, positions):
    rs = np.random.RandomState(9)
    b, v = 7, 50
    shape = (b, positions, v) if positions else (b, v)
    logits = (rs.randn(*shape) * 3).astype(np.float32)
    if knobs is None:           # one row of each knob set
        cols = {k: [kn.get(k, d) for kn in KNOBS] for k, d in (
            ("temperature", 0.0), ("top_k", 0), ("top_p", 1.0),
            ("min_p", 0.0))}
        jp = jsamp.SamplingParams(
            jnp.asarray(cols["temperature"], jnp.float32),
            jnp.asarray(cols["top_k"], jnp.int32),
            jnp.asarray(cols["top_p"], jnp.float32),
            jnp.asarray(cols["min_p"], jnp.float32))
        tp = tsamp.SamplingParams(
            torch.tensor(cols["temperature"], dtype=torch.float32),
            torch.tensor(cols["top_k"], dtype=torch.int32),
            torch.tensor(cols["top_p"], dtype=torch.float32),
            torch.tensor(cols["min_p"], dtype=torch.float32))
    else:
        jp = jsamp.SamplingParams.make(b, **knobs)
        tp = tsamp.SamplingParams.make(b, **knobs)
    want = np.asarray(jsamp.masked_sampling_probs(jnp.asarray(logits), jp))
    got = tsamp.masked_sampling_probs(torch.from_numpy(logits), tp)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # a top-k row keeps exactly k tokens in both
    k_rows = ([i for i, kn in enumerate(KNOBS) if set(kn) == {
        "temperature", "top_k"}] if knobs is None
        else list(range(b)) if set(knobs) == {"temperature", "top_k"}
        else [])
    for i in k_rows:
        k = (knobs or KNOBS[i])["top_k"]
        assert ((got.numpy()[i] > 0).sum(-1) == k).all()
        assert ((want[i] > 0).sum(-1) == k).all()


# ------------------------------------------------------------ KV cache


@pytest.mark.parametrize("kv", ["float32", "float8_e4m3fn"])
def test_slot_kv_cache_matches_jax(kv):
    js, ts = jb.ModelSpec(**SPEC_KW), tb.ModelSpec(**SPEC_KW)
    jc = JSlotKVCache(js, max_slots=3, max_seq_len=16, dtype=kv)
    tc = SlotKVCache(ts, max_slots=3, max_seq_len=16, dtype=kv,
                     device="cpu")
    for c in (jc, tc):
        assert [c.alloc(f"r{i}") for i in range(4)] == [0, 1, 2, None]
        c.free(1)
        c.free(1)                       # a second free is a no-op
        assert c.alloc("r9") == 1 and c.live_slots == {0: "r0", 1: "r9",
                                                       2: "r2"}
    assert tc.get_stats() == jc.get_stats()
    rs = np.random.RandomState(2)
    ks = rs.randn(js.n_layers, 2, 5, js.n_kv_heads,
                  js.head_dim).astype(np.float32) * 40
    vs = rs.randn(*ks.shape).astype(np.float32)
    jc.write_prefill(jnp.asarray(ks), jnp.asarray(vs), jnp.asarray([2, 0]))
    tc.write_prefill(torch.from_numpy(ks), torch.from_numpy(vs), [2, 0])
    for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
        if kv == "float32":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_array_equal(bridge.tensor_to_numpy(got),
                                          np.asarray(want).view(np.uint8))
    tc.reset()
    jc.reset()
    assert tc.n_free == jc.n_free == 3
    assert tc.get_stats() == jc.get_stats()


def test_lazy_engine_exports():
    from distributed_inference_engine_tpu_torch import engine as pkg

    assert pkg.Engine is teng.Engine and pkg.SlotKVCache is SlotKVCache
    with pytest.raises(AttributeError):
        pkg.NotThere


# ---------------------------------------------------------------- Engine


@pytest.fixture(scope="module")
def small():
    js, ts = jb.ModelSpec(**SPEC_KW), tb.ModelSpec(**SPEC_KW)
    jp = jb.init_params(js, jax.random.key(0))
    tp = bridge.params_from_numpy(jax.device_get(jp), ts, "cpu")
    je = jeng.Engine(js, params=jp, config=JCfg(**CFG_KW))
    te = teng.Engine(ts, params=tp, config=EngineConfig(**CFG_KW),
                     device="cpu")
    return je, te


def _same(got, want, lp_tol=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        assert g.finish_reason == w.finish_reason
        assert g.prompt_tokens == w.prompt_tokens
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=0,
                                   atol=lp_tol)


def _both(je, te, reqs):
    return (te.generate([GenerationRequest(**r) for r in reqs]),
            je.generate([JReq(**r) for r in reqs]))


def test_greedy_matches_jax_engine(small):
    """A batch against solo, per-request max_new_tokens, an overlong
    prompt (its tail kept), eos from the probed chain, host stop ids and a
    stop sequence: tokens, finish reasons and logprobs as JAX's."""
    je, te = small
    rs = np.random.RandomState(0)
    a = dict(prompt=[5, 6, 7, 8], max_new_tokens=6)
    batch = [a, dict(prompt=[9, 10], max_new_tokens=2),
             dict(prompt=[11], max_new_tokens=7),
             dict(prompt=rs.randint(0, 64, size=100).tolist(),
                  max_new_tokens=3)]
    got, want = _both(je, te, batch)
    _same(got, want)
    solo = te.generate([GenerationRequest(**a)])[0]
    assert solo.tokens == got[0].tokens
    assert [len(r.tokens) for r in got] == [6, 2, 7, 3]
    chain = got[0].tokens
    stops = [dict(prompt=a["prompt"], max_new_tokens=6, eos_id=chain[1]),
             dict(prompt=a["prompt"], max_new_tokens=6,
                  stop_ids=[chain[2]]),
             dict(prompt=a["prompt"], max_new_tokens=6,
                  stop_sequences=[chain[3:5]]),
             dict(prompt=a["prompt"], max_new_tokens=6,
                  stop_ids=[chain[0]])]        # the prefill's own token
    got, want = _both(je, te, stops)
    _same(got, want)
    assert [r.finish_reason for r in got] == ["stop"] * 4
    assert len(got[3].tokens) == 1
    with pytest.raises(ValueError):
        te.generate([GenerationRequest(prompt=[], max_new_tokens=2)])


def test_metrics_warmup_and_timeline_match_jax():
    js, ts = jb.ModelSpec(**SPEC_KW), tb.ModelSpec(**SPEC_KW)
    cfg = dict(CFG_KW, max_slots=2)
    je = jeng.Engine(js, config=JCfg(**cfg), seed=1)
    te = teng.Engine(ts, config=EngineConfig(**cfg), seed=1, device="cpu")
    assert (te.batch_buckets, te.prefill_buckets, te.seq_buckets) == (
        je.batch_buckets, je.prefill_buckets, je.seq_buckets)
    assert te.warmup() == je.warmup() == 4
    jm, tm = je.get_metrics(), te.get_metrics()
    assert set(tm) == set(jm)
    for k in ("total_requests", "total_prompt_tokens",
              "total_generated_tokens", "total_errors", "spec"):
        assert tm[k] == jm[k], k
    assert set(tm["prefill"]) == set(jm["prefill"])
    assert tm["prefill"]["count"] == tm["decode"]["count"] == 4
    tl = {(e["name"], bool(e["args"].get("compile")))
          for e in te.timeline.events()}
    assert tl == {(e["name"], bool(e["args"].get("compile")))
                  for e in je.timeline.events()}
    assert te.timeline.name == "static"


def test_sampled_runs_reproduce_from_the_seed(small):
    je, te = small
    ts = te.spec
    req = dict(prompt=[1], max_new_tokens=12, temperature=1.0, top_p=0.95)

    def run(seed):
        e = teng.Engine(ts, params=te.params, config=EngineConfig(**CFG_KW),
                        seed=seed, device="cpu")
        return [tuple(e.generate([GenerationRequest(**req)])[0].tokens)
                for _ in range(3)]

    first = run(4)
    assert run(4) == first
    assert len(set(first)) > 1          # the generator advances
    # a top-k of 1 is the greedy chain whatever the temperature
    g = te.generate([GenerationRequest(prompt=[3, 4], max_new_tokens=8)])
    k1 = te.generate([GenerationRequest(prompt=[3, 4], max_new_tokens=8,
                                        temperature=0.8, top_k=1)])
    assert g[0].tokens == k1[0].tokens


def test_parallel_arguments_raise():
    ts = tb.ModelSpec(**SPEC_KW)
    for kw in (dict(shard_fn=lambda p: p), dict(sp_mesh=object())):
        with pytest.raises(NotImplementedError, match="A13"):
            teng.Engine(ts, config=EngineConfig(**CFG_KW), device="cpu",
                        **kw)


# --------------------------------------------- weights and cache dtypes


TINY_CFG = dict(max_seq_len=128, max_slots=4, prefill_buckets=[16, 64],
                decode_steps_per_call=4, kv_dtype="float32")


def _tiny_reqs():
    rs = np.random.RandomState(12)
    return [dict(prompt=rs.randint(1, 1024, size=n).tolist(),
                 max_new_tokens=m, request_id=f"q{i}")
            for i, (n, m) in enumerate(((9, 8), (28, 6), (3, 8)))]


@pytest.mark.parametrize("bits", [4, 8], ids=["int4", "int8"])
def test_quantized_trees_match_jax(bits):
    """A JAX-quantized fp32 llama-tiny tree, bridged (the port fuses the
    int4 payloads and runs the int4 matmul's plain version): the JAX
    engine's tokens, and teacher-forced through the JAX forward."""
    js = jspec("llama-tiny", dtype="float32")
    ts = tspec("llama-tiny", dtype="float32")
    jp = jq.random_quantized_params(js, jax.random.key(1), bits=bits)
    tp = bridge.params_from_numpy(jax.device_get(jp), ts, "cpu")
    te = teng.Engine(ts, params=tp, config=EngineConfig(**TINY_CFG),
                     device="cpu")
    assert ("w_qkv" in te.params["blocks"]) == (bits == 4)
    je = jeng.Engine(js, params=jp, config=JCfg(**TINY_CFG))
    got, want = _both(je, te, _tiny_reqs())
    _same(got, want)
    for r, q in zip(got, _tiny_reqs()):
        assert_greedy_parity(js, jp, q["prompt"], r.tokens, min_matched=2)


@pytest.mark.parametrize("kv", ["float8_e4m3fn", "float8_e5m2"],
                         ids=["e4m3", "e5m2"])
def test_fp8_caches_match_jax(tiny, kv):
    js, ts, jp, tp = tiny["float32"]
    cfg = dict(TINY_CFG, kv_dtype=kv)
    te = teng.Engine(ts, params=tp, config=EngineConfig(**cfg),
                     device="cpu")
    je = jeng.Engine(js, params=jp, config=JCfg(**cfg))
    got, want = _both(je, te, _tiny_reqs())
    _same(got, want, lp_tol=1e-3)


def test_bf16_teacher_forced(tiny):
    """bf16 chains of two frameworks part at near-ties: each of the port's
    tokens is held to the JAX forward given the same prefix."""
    js, ts, jp, tp = tiny["bfloat16"]
    te = teng.Engine(ts, params=tp, config=EngineConfig(
        **dict(TINY_CFG, kv_dtype="bfloat16")), device="cpu")
    reqs = _tiny_reqs()
    for r, q in zip(te.generate([GenerationRequest(**q) for q in reqs]),
                    reqs):
        assert len(r.tokens) == q["max_new_tokens"]
        assert_greedy_parity(js, jp, q["prompt"], r.tokens, eps=2e-2,
                             min_matched=2)


# ------------------------------------------- factory, artifact, worker


def _static_cfg(**md):
    return ModelConfig(name="st", architecture="llama", dtype="float32",
                       max_seq_len=128, max_batch_size=4, metadata={
                           "size": "llama-tiny", "continuous": "0",
                           "seed": "2", "prefill_buckets": "[16, 64]",
                           "decode_steps_per_call": "4",
                           "kv_dtype": "float32", **md})


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return jq.QuantizedTensor(q=jnp.asarray(tree.q),
                                  s=jnp.asarray(tree.s), bits=tree.bits,
                                  pack_axis=tree.pack_axis)
    return jnp.asarray(tree)


def test_factory_static_branch_and_artifact_round_trip(tmp_path):
    """``continuous=0`` builds the static ``Engine``; with ``artifact=`` the
    slow boot writes the artifact (buckets from the engine's batch,
    prefill and sequence buckets; the golden probe from ``generate``) and
    the next boot restores it, probe replayed, with the slow path's
    tokens."""
    art = str(tmp_path / "art")
    slow = engine_from_config(_static_cfg(artifact=art), device="cpu")
    assert type(slow) is teng.Engine and slow.artifact_manifest is None
    m = load_manifest(art)
    assert m["buckets"] == {"batch": slow.batch_buckets,
                            "prefill": slow.prefill_buckets,
                            "seq": slow.seq_buckets}
    assert m["golden"]["tokens"]
    fast = engine_from_config(_static_cfg(artifact=art), device="cpu")
    assert type(fast) is teng.Engine
    assert fast.artifact_manifest is not None
    assert "golden_probe_s" in fast.load_info
    reqs = [GenerationRequest(**q) for q in _tiny_reqs()]
    assert [r.tokens for r in fast.generate(reqs)] == [
        r.tokens for r in slow.generate(reqs)]
    assert fast.warmup_from_manifest() == len(m["buckets"]["batch"]) * len(
        m["buckets"]["prefill"])


async def test_worker_serves_static_engine_over_rpc():
    """``continuous=0`` loaded over ``load_model``: no pump (the executor
    path), and the JAX ``WorkerClient`` gets the JAX ``Engine``'s tokens
    on the same weights."""
    cfg = _static_cfg()
    ref = engine_from_config(cfg, device="cpu")
    js = jspec("llama-tiny", dtype="float32")
    je = jeng.Engine(js, params=_jax_tree(bridge.params_to_numpy(
        ref.params)), config=JCfg(**TINY_CFG))
    reqs = _tiny_reqs()
    want = je.generate([JReq(**q) for q in reqs])

    server = WorkerServer(ServerConfig(worker_id="s0", port=0),
                          device="cpu")
    host, port = await server.start()
    client = JClient(host, port, timeout=60.0)
    try:
        await client.load_model(cfg)
        assert "st" not in server._pumps
        outs = await asyncio.gather(*[
            client.generate("st", [JReq(**q)]) for q in reqs])
        for o, w in zip(outs, want):
            assert o[0].tokens == w.tokens
            assert o[0].finish_reason == w.finish_reason
        batched = await client.generate("st", [JReq(**q) for q in reqs])
        assert [r.tokens for r in batched] == [w.tokens for w in want]
        em = server.get_metrics()["models"]["st"]
        assert set(em) == set(je.get_metrics())
        assert em["total_requests"] == 2 * len(reqs)
    finally:
        await client.close()
        await server.stop()


def test_unported_features_name_their_items():
    """What the port still lacks raises ``NotImplementedError`` naming its
    ROADMAP.md item: the host KV tier and the prefill role (A10, in the
    factory and the fakes' factory), tp with speculation and the static
    engine's parallel arguments (A13)."""
    from distributed_inference_engine_tpu_torch.models import (
        fake_engine_from_config,
    )

    def cfg(**md):
        return ModelConfig(name="u", architecture="llama", dtype="float32",
                           max_seq_len=64, metadata={"size": "llama-tiny",
                                                     **md})

    for md, item in (({"continuous": "1", "kv_offload": "1"}, "A10"),
                     ({"role": "prefill"}, "A10"),
                     ({"speculative": "2", "draft_size": "llama-tiny",
                       "tp": "2"}, "A13"),
                     ({"tp": "2"}, "A13")):
        with pytest.raises(NotImplementedError, match=item):
            engine_from_config(cfg(**md), device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        fake_engine_from_config(ModelConfig(name="f", metadata={
            "role": "prefill"}))
    with pytest.raises(NotImplementedError, match="A13"):
        teng.Engine(tb.ModelSpec(**SPEC_KW), config=EngineConfig(**CFG_KW),
                    sp_mesh=object(), device="cpu")
