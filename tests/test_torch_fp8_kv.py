"""fp8 (e4m3) KV pools in the port (CPU) against the JAX package: the
counterpart of ``tests/test_fp8_kv.py``.

- The cast: ``ops/attention.py:astype_kv`` is bit-equal to JAX's
  ``astype(float8_e4m3fn)`` on all 65,536 bf16 patterns and on 1e6 seeded
  fp32 values with ±inf and NaN (overflow past 464 to NaN, where torch's
  own cast saturates to ±448).
- The plain versions of the four kernels that take fp8 pools, on the same
  fp8 bytes (from a numpy seed) as ``paged_attention_xla``,
  ``flash_decode_attention_xla`` (with the fw variant's one-hot side write)
  and ``ragged_attention_xla``: fp32 q within 1e-5, bf16 q within 2e-2 (the
  bf16 tolerance of the other files), written pool bytes and side windows
  byte-equal, fresh K/V past 464 included.
- The engine: greedy tokens equal to the JAX ``ContinuousEngine`` with
  ``kv_dtype="float8_e4m3fn"`` on each path, against the JAX engine that
  rounds where the port's path does (the window scheme, fw and deferred
  admission against JAX's ``pallas_interpret`` engine, whose side window
  stays in the compute dtype; the inline decode, int4 weights and
  Mistral past its window against its XLA engine), with the window and
  mixed-step chains also teacher-forced through the JAX
  ``assert_greedy_parity``. Logprobs within 1e-3: the same fp32 value a
  few ulps apart in two frameworks can round to neighbouring e4m3 values
  (6% apart), which moves a logprob by more than fp32 noise. The ragged
  mixed step rounds its fresh K/V before attending, which no JAX engine
  runs off the TPU: its tokens are held to the JAX XLA engine (whose dense
  decode rounds each step too), its logprobs within 1e-2, and its layer
  step to the JAX ``forward_mixed_step(attn_impl="xla")``.
- ``hbm_bytes`` half of bf16's, one-byte pools, ``get_stats`` keys equal to
  JAX's; the worker loads ``kv_dtype`` from metadata and serves the JAX
  engine's tokens; ``float8_e5m2`` raises naming ROADMAP A5f-e5m2.
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
from distributed_inference_engine_tpu.engine.continuous import (
    ContinuousEngine as JEngine,
)
from distributed_inference_engine_tpu.engine.paged_kv import (
    PagedKVCache as JPagedKVCache,
)
from distributed_inference_engine_tpu.engine.types import (
    GenerationRequest as JReq,
)
from distributed_inference_engine_tpu.models import base as jb
from distributed_inference_engine_tpu.models.llama import llama_spec as jspec
from distributed_inference_engine_tpu.models.mistral import (
    mistral_spec as jmspec,
)
from distributed_inference_engine_tpu.ops import quant as jq
from distributed_inference_engine_tpu.ops.flash_decode import (
    flash_decode_attention_xla,
)
from distributed_inference_engine_tpu.ops.paged_attention import (
    paged_attention_xla as j_paged,
)
from distributed_inference_engine_tpu.ops.ragged_attention import (
    ragged_attention_xla,
)
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
from distributed_inference_engine_tpu_torch.engine.continuous import (
    ContinuousEngine,
)
from distributed_inference_engine_tpu_torch.engine.paged_kv import (
    PagedKVCache,
)
from distributed_inference_engine_tpu_torch.engine.types import (
    GenerationRequest,
)
from distributed_inference_engine_tpu_torch.models import (
    base as tb,
    engine_from_config,
)
from distributed_inference_engine_tpu_torch.models.llama import (
    llama_spec as tspec,
)
from distributed_inference_engine_tpu_torch.models.mistral import (
    mistral_spec as tmspec,
)
from distributed_inference_engine_tpu_torch.ops import _cuda
from distributed_inference_engine_tpu_torch.ops.attention import astype_kv
from distributed_inference_engine_tpu_torch.ops.flash_decode import (
    flash_decode_attention,
    flash_decode_attention_fw,
)
from distributed_inference_engine_tpu_torch.ops.paged_attention import (
    paged_attention,
)
from distributed_inference_engine_tpu_torch.ops.ragged_attention import (
    ragged_attention,
    ragged_instance,
)

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

FP8 = "float8_e4m3fn"
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
LP_ATOL = 1e-3


def _t(a):
    return bridge.tensor_from_numpy(np.asarray(a), "cpu")


def _f32(x):
    if hasattr(x, "detach"):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bytes(x):
    """The raw bytes of a port tensor or a JAX/numpy array."""
    if hasattr(x, "detach"):
        return bridge.tensor_to_numpy(x).view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _cast(a, dtype):
    return np.asarray(jnp.asarray(a, dtype))


# ------------------------------------------------------------------ cast


def _jax_bytes(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(
        np.uint8)


def test_cast_matches_jax_on_every_bf16_pattern():
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    jx = jnp.asarray(bits).view(jnp.bfloat16)
    tx = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    got = astype_kv(tx, torch.float8_e4m3fn).view(torch.uint8).numpy()
    want = _jax_bytes(jx)
    assert np.array_equal(got, want)
    # torch's own cast saturates the overflows: the cast exists for them
    assert not np.array_equal(
        tx.to(torch.float8_e4m3fn).view(torch.uint8).numpy(), want)


def test_cast_matches_jax_on_seeded_fp32():
    rs = np.random.RandomState(0)
    x = (rs.randn(1_000_000) * rs.choice([0.01, 1.0, 60.0, 400.0],
                                         1_000_000)).astype(np.float32)
    x[:8] = [np.inf, -np.inf, np.nan, -np.nan, 464.0, -464.0, 464.00003,
             448.0]
    got = astype_kv(torch.from_numpy(x), torch.float8_e4m3fn)
    assert np.array_equal(got.view(torch.uint8).numpy(), _jax_bytes(x))
    assert (np.abs(x) > 464).sum() > 1000          # overflows were drawn


def test_bridge_carries_fp8_bit_for_bit():
    a = _cast(np.random.RandomState(1).randn(3, 5) * 300, FP8)
    t = _t(a)
    assert t.dtype == torch.float8_e4m3fn
    assert np.array_equal(bridge.tensor_to_numpy(t), a.view(np.uint8))


def test_kernel_dtype_codes():
    assert _cuda.dtype_code(torch.float8_e4m3fn, pool=True) == _cuda.FP8
    with pytest.raises(TypeError):
        _cuda.dtype_code(torch.float8_e4m3fn)     # never a q/out dtype
    assert ragged_instance(torch.bfloat16, torch.float8_e4m3fn) == "mma"
    assert ragged_instance(torch.float32, torch.float8_e4m3fn) == "simt"
    assert _cuda.pool_instance("k", torch.float8_e4m3fn) == ("k", "k.fp8")
    assert _cuda.pool_instance("k", torch.bfloat16) == ("k",)


# ------------------------------------------------- the kernels' plain versions

P, MP, W, DH = 16, 4, 4, 32
PREFIX = np.array([0, 1, P - 1, P, 2 * P + 7, MP * P], np.int32)
N_SIDE = np.array([0, 1, 2, W, 3, W], np.int32)


def _pools(rs, rows, hkv, scale=2.0):
    kp = _cast(rs.randn(rows, P, hkv * DH) * scale, FP8)
    vp = _cast(rs.randn(rows, P, hkv * DH) * scale, FP8)
    return kp, vp


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_jax_on_fp8_pools(dtype, window):
    rs = np.random.RandomState(2)
    b, h, hkv, n, layers = len(PREFIX), 8, 2, 24, 2
    q = _cast(rs.randn(b, h, DH), dtype)
    kp, vp = _pools(rs, layers * n, hkv)
    table = np.stack([rs.permutation(n)[:MP] for _ in range(b)]).astype(
        np.int32)
    lens = np.maximum(PREFIX, 1).astype(np.int32)
    for layer in range(layers):
        out, m, l = paged_attention(
            _t(q), _t(kp), _t(vp), _t(table), _t(lens), n_kv_heads=hkv,
            window=window, with_stats=True, layer=layer,
            n_pages_per_layer=n)
        sl = slice(layer * n, (layer + 1) * n)
        jo, jm, jl = j_paged(*(jnp.asarray(a) for a in (
            q, kp[sl], vp[sl], table, lens)), n_kv_heads=hkv,
            window=window, with_stats=True)
        np.testing.assert_allclose(_f32(out), _f32(jo), rtol=0,
                                   atol=ATOL[dtype])
        np.testing.assert_allclose(_f32(m), _f32(jm), rtol=0,
                                   atol=ATOL[dtype])
        np.testing.assert_allclose(_f32(l), _f32(jl), rtol=1e-5,
                                   atol=ATOL[dtype])


def _fd_case(seed, dtype, h=8, hkv=2, layers=2):
    rs = np.random.RandomState(seed)
    b = len(PREFIX)
    n = b * MP
    kp, vp = _pools(rs, layers * n, hkv)
    return dict(
        q=_cast(rs.randn(b, h, DH), dtype), kp=kp, vp=vp, n=n, hkv=hkv,
        table=np.stack([rs.permutation(n)[:MP] for _ in range(b)]).astype(
            np.int32),
        sk=_cast(rs.randn(b, W, hkv, DH) * 2, dtype),
        sv=_cast(rs.randn(b, W, hkv, DH) * 2, dtype),
        fk=_cast(rs.randn(b, 1, hkv, DH) * 300, dtype),   # past 464 too
        fv=_cast(rs.randn(b, 1, hkv, DH) * 300, dtype))


def _jax_fd(c, layer, sk, sv, n_side):
    n = c["n"]
    sl = slice(layer * n, (layer + 1) * n)
    return flash_decode_attention_xla(
        *(jnp.asarray(a) for a in (c["q"], c["kp"][sl], c["vp"][sl],
                                   c["table"], PREFIX, sk, sv, n_side)),
        n_kv_heads=c["hkv"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_jax_on_fp8_pools(dtype):
    c = _fd_case(3, dtype)
    for layer in (0, 1):
        out = flash_decode_attention(
            _t(c["q"]), _t(c["kp"]), _t(c["vp"]), _t(c["table"]),
            _t(PREFIX), _t(c["sk"]), _t(c["sv"]), _t(N_SIDE),
            n_kv_heads=c["hkv"], layer=layer, n_pages_per_layer=c["n"])
        assert out.dtype == _t(c["q"]).dtype
        np.testing.assert_allclose(
            _f32(out), _f32(_jax_fd(c, layer, c["sk"], c["sv"], N_SIDE)),
            rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_fw_plain_matches_jax_on_fp8_pools(dtype):
    """The writeback variant: the fresh row (values past 464 included)
    lands in the side window in q's dtype, byte-equal to the JAX one-hot
    write, and the output matches the JAX composition over it."""
    c = _fd_case(4, dtype)
    b = len(PREFIX)
    side_idx = np.array([0, 1, 2, 3, 3, W], np.int32)   # the last drops
    active = np.array([1, 1, 0, 1, 1, 1], np.int32)
    sk, sv = _t(c["sk"]), _t(c["sv"])
    out, sk, sv = flash_decode_attention_fw(
        _t(c["q"]), _t(c["kp"]), _t(c["vp"]), _t(c["table"]), _t(PREFIX),
        sk, sv, _t(c["fk"]), _t(c["fv"]), _t(side_idx), _t(active),
        n_kv_heads=c["hkv"], layer=1, n_pages_per_layer=c["n"])
    onehot = ((np.arange(W)[None] == side_idx[:, None])
              & (active[:, None] > 0))[:, :, None, None]
    jsk = jnp.where(onehot, jnp.asarray(c["fk"]).reshape(b, 1, c["hkv"], DH),
                    jnp.asarray(c["sk"]))
    jsv = jnp.where(onehot, jnp.asarray(c["fv"]).reshape(b, 1, c["hkv"], DH),
                    jnp.asarray(c["sv"]))
    assert np.array_equal(_bytes(sk), _bytes(jsk))
    assert np.array_equal(_bytes(sv), _bytes(jsv))
    want = _jax_fd(c, 1, jsk, jsv, side_idx + active)
    np.testing.assert_allclose(_f32(out), _f32(want), rtol=0,
                               atol=ATOL[dtype] * 300)


def _ragged_case(seed, dtype, fresh_scale, h=8, hkv=2, layers=2):
    rs = np.random.RandomState(seed)
    q_lens = np.array([1, 1, 0, 5, 9, 1], np.int32)
    ctx = np.array([0, 17, 3, 16, 21, 40], np.int32)
    r, qmax, mp = len(q_lens), int(q_lens.max()), 4
    n = r * mp
    kp, vp = _pools(rs, layers * n, hkv)
    return dict(q=_cast(rs.randn(r, qmax, h, DH), dtype), kp=kp, vp=vp,
                table=np.stack([rs.permutation(n)[:mp]
                                for _ in range(r)]).astype(np.int32),
                ctx=ctx, q_lens=q_lens, n=n, hkv=hkv,
                fk=_cast(rs.randn(r, qmax, hkv, DH) * fresh_scale, dtype),
                fv=_cast(rs.randn(r, qmax, hkv, DH) * fresh_scale, dtype))


@pytest.mark.parametrize("fresh_scale", [2.0, 300.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_plain_matches_jax_on_fp8_pools(dtype, fresh_scale):
    """The fresh K/V is rounded with the JAX cast, attended as stored and
    written back byte-equal to ``ragged_attention_xla``'s pools; at scale
    300 a fifth of it overflows to NaN bytes (the outputs of the rows that
    see one are NaN in both)."""
    c = _ragged_case(5, dtype, fresh_scale)
    layer, n = 1, c["n"]
    kp, vp = _t(c["kp"]), _t(c["vp"])
    out, kp, vp = ragged_attention(
        _t(c["q"]), kp, vp, _t(c["table"]), _t(c["ctx"]), _t(c["q_lens"]),
        _t(c["fk"]), _t(c["fv"]), n_kv_heads=c["hkv"], layer=layer,
        n_pages_per_layer=n)
    sl = slice(layer * n, (layer + 1) * n)
    jo, jkp, jvp = ragged_attention_xla(
        *(jnp.asarray(a) for a in (c["q"], c["kp"][sl], c["vp"][sl],
                                   c["table"], c["ctx"], c["q_lens"],
                                   c["fk"], c["fv"])), n_kv_heads=c["hkv"])
    assert np.array_equal(_bytes(kp[sl]), _bytes(jkp))
    assert np.array_equal(_bytes(vp[sl]), _bytes(jvp))
    assert np.array_equal(_bytes(kp[:n]), c["kp"][:n].view(np.uint8))
    np.testing.assert_allclose(_f32(out), _f32(jo), rtol=0,
                               atol=ATOL[dtype])
    if fresh_scale > 100:
        assert np.isnan(_f32(jkp)).any()


def test_mixed_step_matches_jax_on_fp8_pools():
    """The port's ragged mixed step against the JAX ``forward_mixed_step``
    on its XLA path (the same rounding point), llama-tiny fp32: hidden
    states within 1e-4 and the pools' written rows within one e4m3 step."""
    js = jspec("llama-tiny", dtype="float32")
    ts = tspec("llama-tiny", dtype="float32")
    jp = jb.init_params(js, jax.random.key(0))
    tp = bridge.params_from_numpy(jax.device_get(jp), ts, "cpu")
    rs = np.random.RandomState(7)
    L, n, p, mp = js.n_layers, 24, 16, 4
    fused = js.n_kv_heads * js.head_dim
    kp = _cast(rs.randn(L, n, p, fused), FP8)
    vp = _cast(rs.randn(L, n, p, fused), FP8)
    q_lens = np.array([1, 0, 7, 12], np.int32)
    ctx = np.array([20, 0, 9, 0], np.int32)
    table = np.stack([rs.permutation(n)[:mp] for _ in range(4)]).astype(
        np.int32)
    tokens = rs.randint(1, 1024, size=(4, 12)).astype(np.int32)
    jh, jkp, jvp = jb.forward_mixed_step(
        js, jp, *(jnp.asarray(a) for a in (tokens, ctx, q_lens, kp, vp,
                                           table)), attn_impl="xla")
    tkp, tvp = _t(kp), _t(vp)
    th, tkp, tvp = tb.forward_mixed_step(
        ts, tp, _t(tokens), _t(ctx), _t(q_lens), tkp, tvp, _t(table))
    live = q_lens > 0
    np.testing.assert_allclose(_f32(th)[live], _f32(jh)[live], rtol=0,
                               atol=1e-4)
    for got, want in ((tkp, jkp), (tvp, jvp)):
        g, w = _f32(got), _f32(want)
        np.testing.assert_allclose(g, w, rtol=0.07, atol=1e-3)
        assert (g == w).mean() > 0.999


# ---------------------------------------------------------------- engines

ENGINE_KW = dict(max_slots=4, max_seq_len=128, prefill_buckets=[16, 64],
                 page_size=16, num_pages=48, decode_steps_per_call=4,
                 kv_dtype=FP8)


@pytest.fixture(scope="module")
def weights():
    js = jspec("llama-tiny", dtype="float32")
    ts = tspec("llama-tiny", dtype="float32")
    jp = jb.init_params(js, jax.random.key(0))
    return js, ts, jp, bridge.params_from_numpy(jax.device_get(jp), ts,
                                                "cpu")


def _drive(engine, req_cls, waves, steps=2):
    out = {}
    for wave in waves:
        for kw in wave:
            engine.submit(req_cls(**kw))
        for _ in range(steps):
            engine.step()
            out.update({r.request_id: r for r in engine.drain_finished()})
    out.update({r.request_id: r for r in engine.run_until_idle()})
    return out


def _waves():
    """Staggered waves with a prefix hit (through the suffix prefill)."""
    rs = np.random.RandomState(0)
    shared = rs.randint(1, 1024, size=40).tolist()

    def req(i, n, m=8):
        return dict(prompt=rs.randint(1, 1024, size=n).tolist(),
                    max_new_tokens=m, request_id=f"r{i}")

    return [[req(0, 9), req(1, 45), dict(prompt=shared + [7, 8, 9],
                                         max_new_tokens=8, request_id="p0")],
            [req(2, 12, 5), dict(prompt=shared + [11, 12], max_new_tokens=9,
                                 request_id="p1")],
            [req(3, 20, 12)]]


def _staggered(engine, req_cls):
    """Two requests, one step, three more: the later ones are admitted
    under decode pressure, so deferred (the JAX default, as the port's)."""
    rs = np.random.RandomState(9)
    reqs = [req_cls(prompt=rs.randint(1, 1024, size=n).tolist(),
                    max_new_tokens=m, request_id=f"h{i}")
            for i, (n, m) in enumerate(((9, 12), (30, 7), (45, 10),
                                        (12, 5), (20, 14)))]
    for r in reqs[:2]:
        engine.submit(r)
    engine.step()
    for r in reqs[2:]:
        engine.submit(r)
    return {r.request_id: r for r in engine.run_until_idle()}


def _same(got, want, n, lp_atol=LP_ATOL):
    assert sorted(got) == sorted(want) and len(got) == n
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason, rid
        np.testing.assert_allclose(got[rid].logprobs, want[rid].logprobs,
                                   rtol=0, atol=lp_atol)


def _teacher_forced(spec, params, prompts, results):
    """Every chain through the JAX ``assert_greedy_parity``, its tie band
    widened to the fp8 pools' logit noise (unrounded fp32 reference)."""
    for rid, res in results.items():
        if len(res.tokens) >= 3:
            assert_greedy_parity(spec, params, prompts[rid], res.tokens,
                                 eps=2e-2, min_matched=1,
                                 label=f"fp8 {rid}")


def _prompts(waves):
    return {kw["request_id"]: kw["prompt"] for wave in waves for kw in wave}


@pytest.fixture(scope="module")
def jax_window(weights):
    """The JAX window scheme on fp8 pools (side window in the compute
    dtype, paged prefix through the paged kernel's interpreter): the
    waves, then a staggered wave admitted deferred."""
    js, _, jp, _ = weights
    je = JEngine(js, params=jp, config=JCfg(attention_impl="pallas_interpret",
                                            **ENGINE_KW))
    waves = _drive(je, JReq, _waves())
    deferred0 = je.get_metrics()["deferred_admissions"]
    staggered = _staggered(je, JReq)
    assert je.get_metrics()["deferred_admissions"] - deferred0 == 3
    assert je.get_metrics()["prefix_hit_admissions"] >= 1
    return waves, staggered


@pytest.mark.parametrize("impl", ["auto", "pallas-decode-fw"])
def test_window_decode_matches_jax_engine(weights, jax_window, impl):
    """The window scheme through flash-decode and its writeback form
    (plain versions here), with a prefix hit through the suffix prefill,
    then deferred admission (the default engine)."""
    js, ts, jp, tp = weights
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(
        attention_impl=impl, **ENGINE_KW), device="cpu")
    got = _drive(te, GenerationRequest, _waves())
    _same(got, jax_window[0], 6)
    assert te.kv.k_pages.element_size() == 1
    assert te.get_metrics()["prefix_hit_admissions"] >= 1
    _teacher_forced(js, jp, _prompts(_waves()), got)
    if impl == "auto":
        deferred0 = te.get_metrics()["deferred_admissions"]
        staggered = _staggered(te, GenerationRequest)
        _same(staggered, jax_window[1], 5)
        assert te.get_metrics()["deferred_admissions"] - deferred0 == 3


def test_inline_decode_matches_jax_engine(weights):
    js, ts, jp, tp = weights
    je = JEngine(js, params=jp, config=JCfg(
        attention_impl="xla", decode_mode="inline", **ENGINE_KW))
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(
        decode_mode="inline", **ENGINE_KW), device="cpu")
    got = _drive(te, GenerationRequest, _waves())
    _same(got, _drive(je, JReq, _waves()), 6)
    assert te.get_metrics()["decode_mode"] == "inline"


def _chunk_waves():
    """Chunked prompts (16-token chunks), a 45-token owner of a 2-page
    prefix, then a prefix hit on it whose tail exceeds the chunk."""
    rs = np.random.RandomState(6)
    shared = rs.randint(1, 1024, size=32).tolist()
    first = [dict(prompt=rs.randint(1, 1024, size=28).tolist(),
                  max_new_tokens=8, request_id="long"),
             dict(prompt=[5, 9, 13], max_new_tokens=8, request_id="short"),
             dict(prompt=shared + rs.randint(1, 1024, size=13).tolist(),
                  max_new_tokens=6, request_id="owner")]
    second = [dict(prompt=rs.randint(1, 1024, size=37).tolist(),
                   max_new_tokens=7, request_id="w0")]
    third = [dict(prompt=shared + rs.randint(1, 1024, size=40).tolist(),
                  max_new_tokens=8, request_id="hit")]
    return [first, second, third]


def test_chunked_prefill_in_the_mixed_step_matches_jax_engine(weights):
    """Chunked prefill in the ragged mixed step, a prefix hit resuming
    chunked: the JAX XLA engine's tokens (its split path; logprobs within
    1e-2, the rounding points differing), every chain teacher-forced."""
    js, ts, jp, tp = weights
    kw = dict(ENGINE_KW, prefill_chunk=16)
    je = JEngine(js, params=jp, config=JCfg(attention_impl="xla", **kw))
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(
        attention_impl="pallas-ragged", **kw), device="cpu")
    got = _drive(te, GenerationRequest, _chunk_waves(), steps=3)
    _same(got, _drive(je, JReq, _chunk_waves(), steps=3), 5, 1e-2)
    m = te.get_metrics()
    assert m["chunked_admissions"] >= 2 and m["prefix_hit_admissions"] >= 1
    assert m["mixed_steps"] > 0
    _teacher_forced(js, jp, _prompts(_chunk_waves()), got)


def test_mistral_past_its_window_matches_jax_engine():
    """mistral-tiny (window 64) decodes inline on fp8 pools past its
    window, through a chunked prompt and a prefix hit."""
    js = jmspec("mistral-tiny", dtype="float32")
    ts = tmspec("mistral-tiny", dtype="float32")
    jp = jb.init_params(js, jax.random.key(0))
    tp = bridge.params_from_numpy(jax.device_get(jp), ts, "cpu")
    kw = dict(max_slots=4, max_seq_len=256, prefill_buckets=[64, 128],
              page_size=16, num_pages=72, decode_steps_per_call=4,
              prefill_chunk=64, kv_dtype=FP8)
    rs = np.random.RandomState(11)
    shared = rs.randint(1, 1024, size=64).tolist()
    waves = [[dict(prompt=rs.randint(1, 1024, size=90).tolist(),
                   max_new_tokens=30, request_id="long"),
              dict(prompt=shared + [3, 4], max_new_tokens=20,
                   request_id="owner")],
             [dict(prompt=shared + rs.randint(1, 1024, size=70).tolist(),
                   max_new_tokens=12, request_id="hit")]]
    je = JEngine(js, params=jp, config=JCfg(attention_impl="xla", **kw))
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(**kw),
                          device="cpu")
    got = _drive(te, GenerationRequest, waves, steps=3)
    _same(got, _drive(je, JReq, waves, steps=3), 3)
    m = te.get_metrics()
    assert m["decode_mode"] == "inline" and m["prefix_hit_admissions"] >= 1
    assert len(waves[0][0]["prompt"]) + 30 > js.sliding_window


def test_int4_weights_with_fp8_pools_match_jax_engine():
    """int4 weights (fused q|k|v and gate|up) over fp8 pools, through the
    inline decode in both engines."""
    js = jspec("llama-tiny", dtype="float32")
    ts = tspec("llama-tiny", dtype="float32")
    jp = jq.random_quantized_params(js, jax.random.key(1), bits=4)
    tp = bridge.params_from_numpy(jax.device_get(jp), ts, "cpu")
    kw = dict(ENGINE_KW, decode_mode="inline")
    je = JEngine(js, params=jp, config=JCfg(attention_impl="xla", **kw))
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(**kw),
                          device="cpu")
    assert "w_qkv" in te.params["blocks"]
    _same(_drive(te, GenerationRequest, _waves()),
          _drive(je, JReq, _waves()), 6)


def test_hbm_bytes_half_of_bf16_and_stats_keys_match_jax(weights):
    js, ts, _, _ = weights
    kw = dict(max_slots=2, page_size=16, num_pages=24, max_seq_len=128)
    bf16 = PagedKVCache(ts, device="cpu", dtype="bfloat16", **kw)
    fp8 = PagedKVCache(ts, device="cpu", dtype=FP8, **kw)
    assert fp8.k_pages.element_size() == fp8.v_pages.element_size() == 1
    assert fp8.k_rows.dtype == torch.float8_e4m3fn
    assert fp8.get_stats()["hbm_bytes"] * 2 == bf16.get_stats()["hbm_bytes"]
    jfp8 = JPagedKVCache(js, dtype=FP8, **kw)
    assert fp8.get_stats()["hbm_bytes"] == jfp8.get_stats()["hbm_bytes"]
    assert set(fp8.get_stats()) == set(jfp8.get_stats())
    assert set(bf16.get_stats()) == set(JPagedKVCache(
        js, dtype="bfloat16", **kw).get_stats())


def test_e5m2_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="A5f-e5m2"):
        EngineConfig(kv_dtype="float8_e5m2").check_supported()
    EngineConfig(kv_dtype=FP8).check_supported()
    cfg = ModelConfig(name="m", architecture="llama", metadata={
        "size": "llama-tiny", "continuous": True,
        "kv_dtype": "float8_e5m2"})
    with pytest.raises(NotImplementedError, match="A5f-e5m2"):
        engine_from_config(cfg, device="cpu")


def test_worker_serves_fp8_pools_from_metadata(weights):
    """``load_model`` with ``kv_dtype`` in its metadata builds fp8 pools
    and serves the JAX engine's tokens on the same (seeded) weights."""
    js, ts, _, _ = weights
    md = {"size": "llama-tiny", "continuous": "1", "seed": "3",
          "page_size": "16", "num_pages": "48",
          "prefill_buckets": "[16, 64]", "kv_dtype": FP8,
          "attention_impl": "pallas-decode"}
    cfg = ModelConfig(name="f8", architecture="llama", dtype="float32",
                      max_seq_len=128, max_batch_size=4, metadata=md)
    ref = engine_from_config(cfg, device="cpu")
    assert ref.kv.k_pages.dtype == torch.float8_e4m3fn
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, 1024, size=n).tolist() for n in (7, 30, 50)]
    jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(ref.params))
    want = JEngine(js, params=jp, config=JCfg(
        attention_impl="pallas_interpret", **ENGINE_KW)).generate(
        [JReq(prompt=p, max_new_tokens=7) for p in prompts])

    async def serve():
        server = WorkerServer(ServerConfig(worker_id="f0", port=0),
                              device="cpu")
        server.load_model(cfg)
        host, port = await server.start()
        client = JClient(host, port, timeout=60.0)
        try:
            return await asyncio.gather(*[
                client.generate("f8", [JReq(prompt=p, max_new_tokens=7,
                                            request_id=f"q{i}")])
                for i, p in enumerate(prompts)])
        finally:
            await client.close()
            await server.stop()

    outs = asyncio.run(serve())
    for o, w in zip(outs, want):
        assert o[0].tokens == w.tokens
        assert o[0].finish_reason == w.finish_reason == "length"
