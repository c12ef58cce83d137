"""The port's paged decode attention (plain version, CPU) against the JAX
package's ``paged_attention_xla`` and its Pallas kernel in interpret mode
(``paged_attention_pallas(interpret=True)``, as ``tests/test_paged.py``
runs it), with sliding windows, GQA, a partial last page, an empty slot,
lengths at and around the window and page edges, flash stats and the
stacked-pool layer offset; the windowed prefill attentions against JAX's;
the CUDA kernel's split-KV rule (each slot's keys cut into runs, each run
a plain paged attention with stats, merged) against JAX's attention over
all keys; and the kernel's split sizing. Tolerances: fp32 1e-5; bf16 2e-2
against the interpreted kernel (the XLA path rounds the scores to bf16
first, the kernel does not)."""

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

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

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


def _runs_merged(case, hkv, window, chunk):
    """The CUDA kernel's split-KV rule on the port's plain version: slot
    b's valid keys [lo, hi) are cut into runs of ``chunk`` keys from lo, as
    many as the longest possible slot needs; run [s0, s1) is
    ``paged_attention_xla`` with lengths s1 and window s1 - s0 (an empty
    run: lengths 0), and the runs' (out, m, l) merge as
    ``merge_attention`` and the merge kernel do."""
    q, kp, vp, table, lens = (np.asarray(a) for a in case)
    max_keys = MP * P if not window else min(MP * P, window)
    n_split = -(-max_keys // chunk)
    outs, ms, ls = [], [], []
    for b, n in enumerate(lens):
        hi = min(int(n), MP * P)
        lo = max(0, int(n) - window) if window else 0
        parts = []
        for i in range(n_split):
            s0 = lo + i * chunk
            s1 = min(hi, s0 + chunk)
            length, win = (s1, s1 - s0) if s1 > s0 else (0, 0)
            parts.append(tpa.paged_attention_xla(
                _t(q[b:b + 1]), _t(kp), _t(vp), _t(table[b:b + 1]),
                _t(np.array([length], np.int32)), n_kv_heads=hkv,
                window=win, with_stats=True))
        m = torch.stack([pm for _, pm, _ in parts]).amax(0)
        l = sum(pl * torch.exp(pm - m) for _, pm, pl in parts)
        outs.append(tatt.merge_attention(parts))
        ms.append(m)
        ls.append(l)
    return torch.cat(outs), torch.cat(ms), torch.cat(ls), n_split


# runs of 5 keys (most slots end in empty runs), 12 and 24 (runs cut pages
# of 16 mid-page; the first run starts at the window's edge, mid-page for
# most lengths, and the last is partial; at window 16 runs of 24 are one
# run, the kernel's route without a merge)
@pytest.mark.parametrize("chunk", [5, 12, 24])
@pytest.mark.parametrize("window", [0, 16, 64])
def test_split_kv_rule_matches_jax(window, chunk):
    h, hkv, dh = 8, 2, 64
    case = _case(70 + window + chunk, h, hkv, dh)
    out, m, l, n_split = _runs_merged(case, hkv, window, chunk)
    assert n_split == -(-(window or MP * P) // chunk)
    want = jpaged.paged_attention_xla(*case, n_kv_heads=hkv, window=window,
                                      with_stats=True)
    _close(out, want[0])
    np.testing.assert_allclose(_np(l), _np(want[2]), rtol=1e-5, atol=ATOL)
    live = np.asarray(LENS) > 0
    _close(m[live], np.asarray(want[1])[live])
    assert float(out[0].abs().max()) == 0.0 and float(l[0].max()) == 0.0
    assert float(m[0].max()) <= -1e29


@pytest.mark.parametrize("b,hkv,max_keys,sms,want", [
    (8, 8, 4096, 132, (8, 512)),      # Mistral decode, window 4096
    (8, 8, 6144, 132, (9, 704)),      # window 0, 48 pages of 128
    (1, 8, 6144, 132, (24, 256)),     # one long slot: runs of 256 keys
    (64, 8, 6144, 132, (2, 3072)),    # 512 (slot, head) pairs fill the card
    (8, 8, 100, 132, (1, 128)),       # short slots: one run, no merge
])
def test_paged_split_sizing(b, hkv, max_keys, sms, want):
    """The kernel's grid from shapes alone: n_split runs of chunk keys
    cover the longest possible slot, the last run is not empty, and a run
    is a multiple of 64 keys."""
    n_split, chunk = tpa.paged_split(b, hkv, max_keys, sms)
    assert (n_split, chunk) == want
    assert n_split * chunk >= max_keys > (n_split - 1) * chunk
    assert chunk % 64 == 0


# (b, H, Hkv, Dh, max_keys, q dtype, pool dtype) -> the kernel's launch plan
# at 132 SMs: the route, the rows a block, the sub-groups a KV head, the
# runs
BF, F32, E4 = torch.bfloat16, torch.float32, torch.float8_e4m3fn


@pytest.mark.parametrize("b,h,hkv,dh,max_keys,qd,kvd,want", [
    # Mistral decode (G 4): one 8-row tile a KV head; at window 0 the runs
    # are held to 16 tiles of 32 keys
    (8, 32, 8, 128, 4096, BF, BF, (True, 8, 1, 8, 512)),
    (8, 32, 8, 128, 6144, BF, BF, (True, 8, 1, 12, 512)),
    # Qwen2-7B's G 7 and G 8 (Llama-3-70B, Qwen2-72B) at Hkv 4, and G 3
    (8, 28, 4, 128, 4096, BF, BF, (True, 8, 1, 16, 256)),
    (8, 32, 4, 128, 4096, BF, E4, (True, 8, 1, 16, 256)),
    (8, 12, 4, 128, 6144, BF, BF, (True, 8, 1, 16, 384)),
    # G 9-16: the 16-row tile, one block a (slot, KV head, run)
    (8, 36, 4, 128, 4096, BF, BF, (True, 16, 1, 16, 256)),
    (8, 64, 4, 128, 4096, BF, E4, (True, 16, 1, 16, 256)),
    # G 17 and 96: sub-groups of 16
    (8, 68, 4, 128, 4096, BF, BF, (True, 16, 2, 8, 512)),
    (8, 96, 1, 128, 4096, BF, BF, (True, 16, 6, 11, 384)),
    # Dh 256: runs of at most 16 tiles of 16 keys (Gemma-2B's 8 over 1 at
    # window 0; G 4 over 8 KV heads)
    (8, 8, 1, 256, 6144, BF, BF, (True, 8, 1, 24, 256)),
    (8, 32, 8, 256, 4096, BF, BF, (True, 8, 1, 16, 256)),
    # G 1 and 2 over bf16 pools stay on the CUDA cores (Gemma-7B's 16 over
    # 16); over e4m3 pools G 2 takes the tensor cores
    (8, 16, 16, 256, 6144, BF, BF, (False, 1, 1, 5, 1280)),
    (8, 16, 8, 128, 4096, BF, E4, (True, 8, 1, 8, 512)),
    # every other pair: the CUDA cores in subgroup()'s sub-groups of 8
    (8, 28, 4, 128, 4096, F32, F32, (False, 8, 1, 16, 256)),
    (8, 48, 4, 128, 4096, F32, E4, (False, 8, 2, 8, 512)),
    (8, 32, 8, 128, 4096, BF, F32, (False, 4, 1, 8, 512)),
    (1, 4, 4, 128, 100, F32, BF, (False, 1, 1, 1, 128)),
    # e4m3 pools at G 1: the tensor cores at every width (Gemma-7B's 16
    # over 16 at Dh 256)
    (8, 8, 8, 128, 4096, BF, E4, (True, 8, 1, 8, 512)),
    (8, 16, 16, 256, 6144, BF, E4, (True, 8, 1, 24, 256)),
])
def test_paged_grid_rule(b, h, hkv, dh, max_keys, qd, kvd, want):
    """The kernel's launch plan from shapes and dtypes alone: bf16 q over
    bf16 pools at G >= 3 and over e4m3 pools at every G on the tensor
    cores with up to 16 query heads a block (8 rows up to G 8) in runs of
    at most 16 staged tiles, everything else on the CUDA cores, and the
    split grid over the (slot, KV head, sub-group) blocks."""
    plan = tpa.paged_plan(b, h, hkv, dh, max_keys, 132, qd, kvd)
    assert tuple(plan) == want
    assert plan.rows * plan.n_sub >= h // hkv > plan.rows * (plan.n_sub - 1)
    assert plan.n_split * plan.chunk >= max_keys
    if not plan.mma:
        assert (plan.n_split, plan.chunk) == tpa.paged_split(
            b, hkv * plan.n_sub, max_keys, 132)
    # the other route on request, on its own grid rule
    other = tpa.paged_plan(b, h, hkv, dh, max_keys, 132, qd, kvd,
                           mma=not plan.mma)
    assert other.mma != plan.mma
    assert other.rows == ((8 if h // hkv <= 8 else 16) if other.mma
                          else tpa.subgroup(h // hkv)[0])
    assert other.n_split * other.chunk >= max_keys


@pytest.mark.parametrize("g,want", [
    (1, (1, 1)), (2, (2, 1)), (3, (4, 1)), (4, (4, 1)), (5, (8, 1)),
    (7, (8, 1)), (8, (8, 1)), (9, (8, 2)), (12, (8, 2)), (16, (8, 2)),
    (17, (8, 3)), (96, (8, 12))])
def test_flash_decode_subgroup_unchanged(g, want):
    """Flash-decode's sub-group rule (1, 2, 4 or 8 rows, 8 above) and its
    split grid stay as they were: the paged kernel's rule is its own."""
    assert tpa.subgroup(g) == want
    assert tpa.paged_split(8, 8, 2048, 132, min_chunk=64) == (8, 256)
    assert tpa.paged_split(1, 8, 2048, 132, min_chunk=64) == (32, 64)


# (H, Hkv, Dh): G 9, 15, 16 and 17 around the 16-row tile, and Gemma-2B's
# 8 query heads over one KV head at Dh 256
GROUPS_16 = [(9, 1, 128), (15, 1, 64), (32, 2, 64), (17, 1, 128),
             (8, 1, 256)]


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("h,hkv,dh", GROUPS_16)
def test_plain_matches_jax_xla_at_wide_groups(window, h, hkv, dh):
    """The plain version, which the tensor-core route is held to on the
    card, against JAX's XLA paged attention at the groups the 16-row tile
    takes: out, m and l in fp32 within 1e-5."""
    case = _case(90 + window + h + dh, h, hkv, dh)
    got, m, l = _port(case, hkv, window=window, with_stats=True)
    want = jpaged.paged_attention_xla(*case, n_kv_heads=hkv, window=window,
                                      with_stats=True)
    _close(got, want[0])
    np.testing.assert_allclose(_np(l), _np(want[2]), rtol=1e-5, atol=ATOL)
    live = np.asarray(LENS) > 0
    _close(m[live], np.asarray(want[1])[live])
    assert float(got[0].abs().max()) == 0.0 and float(l[0].max()) == 0.0
