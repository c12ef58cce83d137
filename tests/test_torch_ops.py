"""PyTorch port vs the JAX reference: norms, RoPE, the attentions and
sampling, on the same numpy inputs (CPU, f32 atol 1e-5 unless stated)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu.ops import attention as jatt
from distributed_inference_engine_tpu.ops import norms as jnorms
from distributed_inference_engine_tpu.ops import paged_attention as jpaged
from distributed_inference_engine_tpu.ops import rope as jrope
from distributed_inference_engine_tpu.ops import sampling as jsamp
from distributed_inference_engine_tpu_torch.bridge import (
    tensor_from_numpy,
    tensor_to_numpy,
)
from distributed_inference_engine_tpu_torch.ops import attention as tatt
from distributed_inference_engine_tpu_torch.ops import norms as tnorms
from distributed_inference_engine_tpu_torch.ops import paged_attention as tpaged
from distributed_inference_engine_tpu_torch.ops import rope as trope
from distributed_inference_engine_tpu_torch.ops import sampling as tsamp

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

ATOL = 1e-5


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x.float())
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype,atol", [("float32", ATOL),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm(dtype, atol, plus_one):
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5, 64).astype(np.float32)
    g = (0.1 * rs.randn(64)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    jg = jnp.asarray(g, dtype)
    tx = _t(np.asarray(jx))
    tg = _t(np.asarray(jg))
    if plus_one:            # the Gemma form: gain + 1 added in fp32
        jg = jg.astype(jnp.float32) + 1.0
        tg = tg.float() + 1.0
    _close(tnorms.rms_norm(tx, tg, 1e-5), jnorms.rms_norm(jx, jg, 1e-5),
           atol)


def test_apply_rope():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 7, 4, 32).astype(np.float32)
    pos = rs.randint(0, 500, size=(2, 7)).astype(np.int32)
    _close(trope.apply_rope(_t(x), _t(pos), 500000.0),
           jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))


def _qkv(rs, b, t, h, hkv, dh):
    q = rs.randn(b, t, h, dh).astype(np.float32)
    k = rs.randn(b, t, hkv, dh).astype(np.float32)
    v = rs.randn(b, t, hkv, dh).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
def test_causal_attention(h, hkv):
    rs = np.random.RandomState(2)
    q, k, v = _qkv(rs, 3, 9, h, hkv, 16)
    lens = np.array([9, 4, 1], np.int32)
    got = tatt.causal_attention(_t(q), _t(k), _t(v), _t(lens))
    want = jatt.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lens))
    _close(got, want)


def test_suffix_attention():
    rs = np.random.RandomState(3)
    b, ts, tc, h, hkv, dh = 3, 5, 8, 8, 4, 16
    q, ks, vs = _qkv(rs, b, ts, h, hkv, dh)
    kc = rs.randn(b, tc, hkv, dh).astype(np.float32)
    vc = rs.randn(b, tc, hkv, dh).astype(np.float32)
    n_ctx = np.array([8, 3, 0], np.int32)
    slen = np.array([5, 2, 4], np.int32)
    got = tatt.suffix_attention(_t(q), _t(kc), _t(vc), _t(n_ctx), _t(ks),
                                _t(vs), _t(slen))
    want = jatt.suffix_attention(*(jnp.asarray(a) for a in (
        q, kc, vc, n_ctx, ks, vs, slen)))
    _close(got, want)


def test_window_decode_attention_and_merge():
    rs = np.random.RandomState(4)
    b, h, hkv, dh, w = 4, 8, 2, 32, 6
    q = rs.randn(b, h, dh).astype(np.float32)
    sk = rs.randn(b, w, hkv, dh).astype(np.float32)
    sv = rs.randn(b, w, hkv, dh).astype(np.float32)
    sk2 = rs.randn(b, w, hkv, dh).astype(np.float32)
    sv2 = rs.randn(b, w, hkv, dh).astype(np.float32)
    n1 = np.array([0, 1, 3, 6], np.int32)
    n2 = np.array([2, 0, 6, 1], np.int32)
    tparts, jparts = [], []
    for k, v, n in ((sk, sv, n1), (sk2, sv2, n2)):
        tp = tatt.window_decode_attention(_t(q), _t(k), _t(v), _t(n))
        jp = jatt.window_decode_attention(*(jnp.asarray(a)
                                            for a in (q, k, v, n)))
        for a, c in zip(tp, jp):
            _close(a, c)
        tparts.append(tp)
        jparts.append(jp)
    _close(tatt.merge_attention(tparts), jatt.merge_attention(jparts))


@pytest.mark.parametrize("with_stats", [False, True])
def test_paged_attention_xla(with_stats):
    rs = np.random.RandomState(5)
    b, h, hkv, dh, n, p, mp = 3, 8, 4, 32, 10, 16, 3
    q = rs.randn(b, h, dh).astype(np.float32)
    kp = rs.randn(n, p, hkv * dh).astype(np.float32)
    vp = rs.randn(n, p, hkv * dh).astype(np.float32)
    table = rs.randint(0, n, size=(b, mp)).astype(np.int32)
    lens = np.array([0, 17, 48], np.int32)
    got = tpaged.paged_attention_xla(_t(q), _t(kp), _t(vp), _t(table),
                                     _t(lens), n_kv_heads=hkv,
                                     with_stats=with_stats)
    want = jpaged.paged_attention_xla(
        *(jnp.asarray(a) for a in (q, kp, vp, table, lens)),
        n_kv_heads=hkv, with_stats=with_stats)
    if not with_stats:
        got, want = (got,), (want,)
    for a, c in zip(got, want):
        _close(a, c)


_MODES = {
    "greedy": dict(temperature=0.0),
    "temperature": dict(temperature=0.7),
    "top_k": dict(temperature=1.0, top_k=5),
    "top_p": dict(temperature=0.9, top_p=0.8),
    "min_p": dict(temperature=1.0, min_p=0.1),
}


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_sampling_with_injected_uniform(mode):
    """Same logits + the JAX draw -> identical tokens; logprobs equal to
    fp32 rounding of the two log_softmax implementations (1e-6)."""
    rs = np.random.RandomState(6)
    b, v = 6, 64
    logits = (2.0 * rs.randn(b, v)).astype(np.float32)
    knobs = _MODES[mode]
    jparams = jsamp.SamplingParams.make(b, **knobs)
    tparams = tsamp.SamplingParams.make(b, **knobs)
    key = jax.random.key(11)
    uniform = np.asarray(jax.random.uniform(key, (b, v), minval=1e-20,
                                            maxval=1.0))
    jt, jl = jsamp.sample_tokens_with_logprobs(jnp.asarray(logits), jparams,
                                               key)
    tt, tl = tsamp.sample_tokens_with_logprobs(_t(logits), tparams,
                                               uniform=_t(uniform))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-6)


def test_sampling_mixed_rows_and_generator_draw():
    """Per-row knobs in one batch, and the generator draw path: greedy
    rows are the argmax whatever the noise."""
    rs = np.random.RandomState(7)
    b, v = 5, 50
    logits = rs.randn(b, v).astype(np.float32)
    temps = np.array([0.0, 0.8, 1.0, 0.0, 1.2], np.float32)
    top_k = np.array([0, 3, 0, 4, 0], np.int32)
    top_p = np.array([1.0, 1.0, 0.7, 1.0, 0.9], np.float32)
    min_p = np.array([0.0, 0.0, 0.0, 0.2, 0.05], np.float32)
    jparams = jsamp.SamplingParams(*(jnp.asarray(a) for a in (
        temps, top_k, top_p, min_p)))
    tparams = tsamp.SamplingParams(*(_t(a) for a in (
        temps, top_k, top_p, min_p)))
    key = jax.random.key(3)
    uniform = np.asarray(jax.random.uniform(key, (b, v), minval=1e-20,
                                            maxval=1.0))
    jt, _ = jsamp.sample_tokens_with_logprobs(jnp.asarray(logits), jparams,
                                              key)
    tt, _ = tsamp.sample_tokens_with_logprobs(_t(logits), tparams,
                                              uniform=_t(uniform))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    gen = torch.Generator().manual_seed(0)
    tg, _ = tsamp.sample_tokens_with_logprobs(_t(logits), tparams,
                                              generator=gen)
    greedy = temps == 0.0
    np.testing.assert_array_equal(tg.numpy()[greedy],
                                  np.asarray(jt)[greedy])
