"""The port's paged decode attention (plain version, CPU) against the JAX
package's ``paged_attention_xla`` and its Pallas kernel in interpret mode
(``paged_attention_pallas(interpret=True)``, as ``tests/test_paged.py``
runs it), with sliding windows, GQA, a partial last page, an empty slot,
lengths at and around the window and page edges, flash stats and the
stacked-pool layer offset; the windowed prefill attentions against JAX's.
Tolerances: fp32 1e-5; bf16 2e-2 against the interpreted kernel (the
XLA path rounds the scores to bf16 first, the kernel does not)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu.ops import attention as jatt
from distributed_inference_engine_tpu.ops import paged_attention as jpaged
from distributed_inference_engine_tpu_torch.bridge import (
    tensor_from_numpy,
    tensor_to_numpy,
)
from distributed_inference_engine_tpu_torch.ops import attention as tatt
from distributed_inference_engine_tpu_torch.ops import paged_attention as tpa

pytestmark = pytest.mark.torch_port

ATOL = 1e-5
P, MP, N = 16, 8, 128           # page size, pages per slot, pages per layer
# lengths (this step's token included): empty, one key, around the first
# page edge, window 16 and 64 at, one past, and with len - window on a page
# boundary (len 32 / 80) and one past it (33 / 81), a partial last page, a
# full table
LENS = np.array([0, 1, 15, 16, 17, 32, 33, 64, 65, 80, 81, 100, 128],
                np.int32)
# (H, Hkv, Dh): G = 1, 2, 4, every fused width 128 (the TPU kernel's lane
# rule)
SHAPES = [(4, 4, 32), (4, 2, 64), (8, 2, 64)]


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x.float())
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol)


def _case(seed, h, hkv, dh, n_layers=1, dtype=jnp.float32):
    """Inputs as jnp arrays in ``dtype`` (the port gets the same values):
    distinct physical pages per slot, stacked pools of ``n_layers``."""
    rs = np.random.RandomState(seed)
    b = len(LENS)
    q = jnp.asarray(rs.randn(b, h, dh), dtype)
    kp = jnp.asarray(rs.randn(n_layers * N, P, hkv * dh), dtype)
    vp = jnp.asarray(rs.randn(n_layers * N, P, hkv * dh), dtype)
    table = rs.permutation(N)[:b * MP].reshape(b, MP)
    return q, kp, vp, jnp.asarray(table, jnp.int32), jnp.asarray(LENS)


def _port(case, hkv, **kw):
    return tpa.paged_attention(*(_t(np.asarray(a)) for a in case),
                               n_kv_heads=hkv, **kw)


@pytest.mark.parametrize("window", [0, 16, 64])
@pytest.mark.parametrize("h,hkv,dh", SHAPES)
def test_plain_matches_jax_xla_and_interpreted_kernel(window, h, hkv, dh):
    case = _case(window + h + dh, h, hkv, dh)
    got, m, l = _port(case, hkv, window=window, with_stats=True)
    xla = jpaged.paged_attention_xla(*case, n_kv_heads=hkv, window=window,
                                     with_stats=True)
    kern = jpaged.paged_attention_pallas(*case, n_kv_heads=hkv,
                                         window=window, interpret=True,
                                         with_stats=True)
    for want in (xla, kern):
        _close(got, want[0])
        np.testing.assert_allclose(_np(l), _np(want[2]), rtol=1e-5,
                                   atol=ATOL)
    _close(m, xla[1])
    # the empty slot: out 0, l 0 (merge weight 0), m at NEG_INF
    assert float(got[0].abs().max()) == 0.0 and float(l[0].max()) == 0.0
    assert float(m[0].max()) <= -1e29


@pytest.mark.parametrize("window", [0, 16, 64])
def test_stats_on_the_stacked_pool(window):
    """Layer 1 of a 3-layer stacked pool with flash stats: the port's
    ``layer`` offset against the JAX kernel's and against the XLA path on
    the layer's slice."""
    h, hkv, dh = 8, 2, 64
    case = _case(40 + window, h, hkv, dh, n_layers=3)
    q, kp, vp, table, lens = case
    got = _port(case, hkv, window=window, with_stats=True, layer=1,
                n_pages_per_layer=N)
    kern = jpaged.paged_attention_pallas(
        *case, n_kv_heads=hkv, window=window, interpret=True,
        with_stats=True, layer=jnp.asarray(1), n_pages_per_layer=N)
    xla = jpaged.paged_attention_xla(
        q, kp[N:2 * N], vp[N:2 * N], table, lens, n_kv_heads=hkv,
        window=window, with_stats=True)
    for a, b_, c in zip(got, kern, xla):
        _close(a, c)
        np.testing.assert_allclose(_np(a), _np(b_), rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("window", [0, 64])
def test_bf16_against_interpreted_kernel(window):
    h, hkv, dh = 8, 2, 64
    case = _case(50 + window, h, hkv, dh, dtype=jnp.bfloat16)
    got = _port(case, hkv, window=window)
    assert got.dtype == torch.bfloat16
    want = jpaged.paged_attention_pallas(*case, n_kv_heads=hkv,
                                         window=window, interpret=True)
    _close(got, want, atol=2e-2)


def test_window_reads_only_live_keys():
    """Keys before ``len - window`` and at or past ``len`` change nothing:
    overwrite them with large values and the output stays bit for bit."""
    h, hkv, dh, window = 4, 2, 64, 16
    q, kp, vp, table, lens = (np.asarray(a) for a in _case(60, h, hkv, dh))
    base = tpa.paged_attention(*(_t(a) for a in (q, kp, vp, table, lens)),
                               n_kv_heads=hkv, window=window)
    kp2, vp2 = kp.copy(), vp.copy()
    for b, n in enumerate(lens):
        for t in range(MP * P):
            if not (n - window <= t < n):
                kp2[table[b, t // P], t % P] = 50.0
                vp2[table[b, t // P], t % P] = -50.0
    other = tpa.paged_attention(*(_t(a) for a in (q, kp2, vp2, table, lens)),
                                n_kv_heads=hkv, window=window)
    assert torch.equal(base, other)


@pytest.mark.parametrize("window", [0, 8, 64])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
def test_windowed_causal_attention(window, h, hkv):
    rs = np.random.RandomState(7 + window)
    b, t, dh = 3, 80, 16
    q = rs.randn(b, t, h, dh).astype(np.float32)
    k = rs.randn(b, t, hkv, dh).astype(np.float32)
    v = rs.randn(b, t, hkv, dh).astype(np.float32)
    lens = np.array([80, 65, 9], np.int32)
    got = tatt.causal_attention(_t(q), _t(k), _t(v), _t(lens), window=window)
    want = jatt.causal_attention(*(jnp.asarray(a) for a in (q, k, v, lens)),
                                 window=window)
    _close(got[0], want[0])
    _close(got[1, :65], want[1, :65])
    _close(got[2, :9], want[2, :9])


@pytest.mark.parametrize("window", [0, 8, 64])
def test_windowed_suffix_attention(window):
    """Suffix queries at absolute positions n_ctx + i against cached
    context and causal suffix keys, the window counted in absolute
    positions (contexts of 0, 30 and 96 tokens)."""
    rs = np.random.RandomState(8 + window)
    b, ts, tc, h, hkv, dh = 3, 20, 96, 8, 4, 16
    q = rs.randn(b, ts, h, dh).astype(np.float32)
    ks = rs.randn(b, ts, hkv, dh).astype(np.float32)
    vs = rs.randn(b, ts, hkv, dh).astype(np.float32)
    kc = rs.randn(b, tc, hkv, dh).astype(np.float32)
    vc = rs.randn(b, tc, hkv, dh).astype(np.float32)
    n_ctx = np.array([96, 30, 0], np.int32)
    slen = np.array([20, 7, 13], np.int32)
    got = tatt.suffix_attention(_t(q), _t(kc), _t(vc), _t(n_ctx), _t(ks),
                                _t(vs), _t(slen), window=window)
    want = jatt.suffix_attention(*(jnp.asarray(a) for a in (
        q, kc, vc, n_ctx, ks, vs, slen)), window=window)
    for i, n in enumerate(slen):
        _close(got[i, :n], want[i, :n])
