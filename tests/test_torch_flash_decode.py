"""Flash-decode attention of the port (its plain version, which a CPU
tensor takes) against the JAX package's reference composition
``flash_decode_attention_xla`` and against ``cached_attention`` ground
truth; the writeback variant against the JAX one-hot side write plus
``flash_decode_attention_xla``, and the port's ``forward_decode_window``
with it against the JAX window step. The CUDA kernels themselves are held
to these plain versions on the card by chip_smoke.py. Tolerances: f32
atol 1e-5 (hidden 1e-4 after four layers), bf16 pools atol 2e-2; side
buffers equal, and within 1e-5 where a model step computed the K/V
written. The CUDA kernels' split-KV rule (runs of ``chunk`` prefix keys,
the side window and fw's fresh row in the last run, runs merged with
``SplitMerge``'s weights) is composed in plain PyTorch and held to
``flash_decode_attention_xla`` at fp32 atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu.models import base as jb
from distributed_inference_engine_tpu.models.llama import llama_spec as jspec
from distributed_inference_engine_tpu.ops.attention import cached_attention
from distributed_inference_engine_tpu.ops.flash_decode import (
    flash_decode_attention_xla,
)
from distributed_inference_engine_tpu_torch.bridge import (
    params_from_numpy,
    tensor_from_numpy,
    tensor_to_numpy,
)
from distributed_inference_engine_tpu_torch.models import base as tb
from distributed_inference_engine_tpu_torch.models.llama import (
    llama_spec as tspec,
)
from distributed_inference_engine_tpu_torch.ops import flash_decode as tfd
from distributed_inference_engine_tpu_torch.ops.flash_decode import (
    MIN_CHUNK,
    decode_subgroup,
    flash_decode_attention,
    flash_decode_attention_fw,
    flash_decode_split,
    fp8_fragment_dims,
    fp8_tile_keys,
)
from distributed_inference_engine_tpu_torch.ops.paged_attention import (
    paged_split,
)

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)


def _t(a):
    return tensor_from_numpy(a, "cpu")

P, MP, W, DH = 16, 4, 4, 32
# prefix lengths 0, 1, P-1, P, several pages, full table; side 0..W
PREFIX = np.array([0, 1, P - 1, P, 2 * P + 7, MP * P], np.int32)
N_SIDE = np.array([0, 1, 2, W, 3, W], np.int32)


def _case(seed, h, hkv, n_layers=1, dtype="float32"):
    rs = np.random.RandomState(seed)
    b = len(PREFIX)
    n = b * MP
    q = rs.randn(b, h, DH).astype(np.float32)
    kp = rs.randn(n_layers * n, P, hkv * DH).astype(np.float32)
    vp = rs.randn(n_layers * n, P, hkv * DH).astype(np.float32)
    table = np.stack([rs.permutation(n)[:MP] for _ in range(b)]).astype(
        np.int32)
    sk = rs.randn(b, W, hkv, DH).astype(np.float32)
    sv = rs.randn(b, W, hkv, DH).astype(np.float32)
    cast = (lambda a: np.asarray(jnp.asarray(a, dtype)))
    return dict(q=cast(q), kp=cast(kp), vp=cast(vp), table=table,
                sk=cast(sk), sv=cast(sv), n=n)


def _port(c, hkv, layer=None):
    t = {k: _t(v) for k, v in c.items() if k != "n"}
    out = flash_decode_attention(
        t["q"], t["kp"], t["vp"], t["table"], _t(PREFIX),
        t["sk"], t["sv"], _t(N_SIDE), n_kv_heads=hkv,
        layer=layer, n_pages_per_layer=c["n"])
    return tensor_to_numpy(out.float())


def _jax(c, hkv, layer=0):
    n = c["n"]
    kp = c["kp"][layer * n:(layer + 1) * n]
    vp = c["vp"][layer * n:(layer + 1) * n]
    out = flash_decode_attention_xla(
        *(jnp.asarray(a) for a in (c["q"], kp, vp, c["table"], PREFIX,
                                   c["sk"], c["sv"], N_SIDE)),
        n_kv_heads=hkv)
    return np.asarray(out.astype(jnp.float32)), kp, vp


def _ground_truth(c, kp, vp, hkv):
    """cached_attention over each row's prefix tokens ++ its side entries
    laid out contiguously (rows with no key at all are skipped: the
    kernel returns 0 there, the dense softmax a uniform mean)."""
    b = len(PREFIX)
    s = MP * P + W
    ck = np.zeros((b, s, hkv, DH), np.float32)
    cv = np.zeros((b, s, hkv, DH), np.float32)
    for i in range(b):
        pk = kp[c["table"][i]].reshape(MP * P, hkv, DH)[:PREFIX[i]]
        pv = vp[c["table"][i]].reshape(MP * P, hkv, DH)[:PREFIX[i]]
        keys = np.concatenate([pk, c["sk"][i][:N_SIDE[i]]])
        vals = np.concatenate([pv, c["sv"][i][:N_SIDE[i]]])
        ck[i, :len(keys)] = keys
        cv[i, :len(vals)] = vals
    out = cached_attention(jnp.asarray(c["q"])[:, None], jnp.asarray(ck),
                           jnp.asarray(cv), jnp.asarray(PREFIX + N_SIDE))
    return np.asarray(out)[:, 0]


# G 1, 2, 4, and G 12 and 16 (the kernels' 16-row instance at Dh 128)
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (8, 2), (24, 2), (32, 2)])
def test_plain_matches_xla_and_ground_truth(h, hkv):
    c = _case(0, h, hkv)
    got = _port(c, hkv)
    want, kp, vp = _jax(c, hkv)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    live = (PREFIX + N_SIDE) > 0
    truth = _ground_truth(c, kp, vp, hkv)
    np.testing.assert_allclose(got[live], truth[live], rtol=0, atol=1e-5)
    assert not got[~live].any()          # no valid key -> exactly 0


def test_stacked_layer_indexing():
    """Stacked [L*N, P, fused] pools with layer > 0 read layer l's rows."""
    c = _case(1, 8, 2, n_layers=3)
    for layer in (1, 2):
        got = _port(c, 2, layer=layer)
        want, _, _ = _jax(c, 2, layer=layer)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_bf16_pools():
    c = _case(2, 8, 2, dtype="bfloat16")
    got = _port(c, 2)
    want, _, _ = _jax(c, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


# fw: this step's side column per slot (W = a full window) and activity
SIDE_IDX = np.array([0, 1, 2, W, 3, W - 1], np.int32)
ACTIVE = np.array([1, 1, 0, 0, 1, 1], np.int32)


@pytest.mark.parametrize("h,hkv", [(4, 2), (8, 2), (24, 2), (32, 2)])
def test_fw_plain_matches_onehot_write_and_xla(h, hkv):
    """The fw plain version: the fresh K/V lands at side_idx for active
    slots only (not for inactive ones, nor at side_idx = W), and the
    output is flash-decode over the written window with n_side =
    side_idx + active."""
    c = _case(3, h, hkv)
    rs = np.random.RandomState(4)
    b = len(PREFIX)
    fk = rs.randn(b, 1, hkv, DH).astype(np.float32)
    fv = rs.randn(b, 1, hkv, DH).astype(np.float32)
    onehot = ((np.arange(W)[None, :] == SIDE_IDX[:, None])
              & (ACTIVE[:, None] > 0))[:, :, None, None]
    sk_ref = np.where(onehot, fk, c["sk"])
    sv_ref = np.where(onehot, fv, c["sv"])
    n_side = SIDE_IDX + ACTIVE
    want = np.asarray(flash_decode_attention_xla(
        *(jnp.asarray(a) for a in (c["q"], c["kp"], c["vp"], c["table"],
                                   PREFIX, sk_ref, sv_ref, n_side)),
        n_kv_heads=hkv))
    t = {k: _t(c[k]) for k in ("q", "kp", "vp", "sk", "sv")}
    out, sk, sv = flash_decode_attention_fw(
        t["q"], t["kp"], t["vp"], _t(c["table"]),
        _t(PREFIX), t["sk"], t["sv"], _t(fk),
        _t(fv), _t(SIDE_IDX),
        _t(ACTIVE), n_kv_heads=hkv, layer=0,
        n_pages_per_layer=c["n"])
    assert sk is t["sk"] and sv is t["sv"]          # written in place
    np.testing.assert_allclose(tensor_to_numpy(out), want, rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(tensor_to_numpy(sk), sk_ref)
    np.testing.assert_array_equal(tensor_to_numpy(sv), sv_ref)
    # the inactive and the full-window slots kept their side rows
    for i in (2, 3):
        np.testing.assert_array_equal(tensor_to_numpy(sk)[i], c["sk"][i])


@pytest.fixture(scope="module")
def tiny():
    js = jspec("llama-tiny", dtype="float32")
    ts = tspec("llama-tiny", dtype="float32")
    jp = jb.init_params(js, jax.random.key(0))
    return js, ts, jp, params_from_numpy(jax.device_get(jp), ts, "cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_forward_decode_window_fw_matches_jax(tiny, fused):
    """One window step with attn_impl="pallas-decode-fw" against the JAX
    step on the xla path: hidden within 1e-4, the side entries written
    within 1e-5 and the rest unchanged."""
    js, ts, jp, tp = tiny
    rs = np.random.RandomState(5)
    L, n, b, w, hkv = js.n_layers, 24, 4, 3, js.n_kv_heads
    kp = rs.randn(L, n, P, hkv * DH).astype(np.float32)
    vp = rs.randn(L, n, P, hkv * DH).astype(np.float32)
    table = rs.randint(0, n, size=(b, MP)).astype(np.int32)
    start = np.array([0, 5, 16, 40], np.int32)
    lengths = start + np.array([0, 1, 2, 1], np.int32)
    active = np.array([True, True, True, False])
    toks = rs.randint(1, 1024, size=(b,)).astype(np.int32)
    side = rs.randn(2, L, b, w, hkv, DH).astype(np.float32)
    jx, jsk, jsv = jb.forward_decode_window(
        js, jp, *(jnp.asarray(a) for a in (toks, lengths, start, kp, vp,
                                           table, side[0], side[1], active)),
        attn_impl="xla", fused=fused)
    tsk, tsv = _t(side[0]), _t(side[1])
    tx, _, _ = tb.forward_decode_window(
        ts, tp, *(_t(a) for a in (toks, lengths, start, kp,
                                                 vp, table)),
        tsk, tsv, _t(active), attn_impl="pallas-decode-fw",
        fused=fused)
    np.testing.assert_allclose(tensor_to_numpy(tx), np.asarray(jx), rtol=0,
                               atol=1e-4)
    # the written entries hold this step's K/V (its projection rounds in
    # another order than XLA's: 1e-5); every other entry keeps its bytes
    written = np.zeros((b, w), bool)
    written[np.arange(b), lengths - start] = active
    for got, want, orig in ((tsk, jsk, side[0]), (tsv, jsv, side[1])):
        got = tensor_to_numpy(got)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[:, ~written], orig[:, ~written])


# ------------------------------------------------------- the split-KV rule

def _state(q, k, v):
    """The flash partial (m, l, unnormalised acc) of q [H, Dh] over keys
    k, v [n, Hkv, Dh] (query head i reads KV head i // G); no key: m =
    -1e30, l = 0, acc = 0, the state SplitMerge weighs 0."""
    h, dh = q.shape
    if k.shape[0] == 0:
        return (torch.full((h,), -1e30), torch.zeros(h),
                torch.zeros(h, dh))
    g = h // k.shape[1]
    kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    s = torch.einsum("hd,nhd->hn", q, kk) / np.sqrt(dh)
    m = s.amax(-1)
    p = torch.exp(s - m[:, None])
    return m, p.sum(-1), torch.einsum("hn,nhd->hd", p, vv)


def _merge_runs(states):
    """SplitMerge (csrc/common.cuh): m = max m_s, l = sum l_s exp(m_s - m),
    weights exp(m_s - m) / max(l, 1e-30) on the runs' acc."""
    m = torch.stack([s[0] for s in states]).amax(0)
    l = sum(s[1] * torch.exp(s[0] - m) for s in states)
    inv_l = 1.0 / torch.clamp(l, min=1e-30)
    return sum(s[2] * (torch.exp(s[0] - m) * inv_l)[:, None]
               for s in states)


def _split_rule(c, prefix, chunk, mp, side_k, side_v, n_read, fresh=None):
    """The kernels' grid on plain tensors: slot b's prefix keys (at most
    mp * P) cut into runs of ``chunk``, as many runs as mp * P needs; the
    last run also takes side entries j < n_read[b] and, where ``fresh``
    holds (k, v) for the slot, the fresh row; the runs merged."""
    kp, vp = torch.from_numpy(c["kp"]), torch.from_numpy(c["vp"])
    q = torch.from_numpy(c["q"])
    hkv, dh = side_k.shape[2:]
    n_split = -(-mp * P // chunk)
    outs = []
    for b, plen in enumerate(prefix):
        pages = torch.from_numpy(c["table"][b]).long()
        keys = kp[pages].reshape(mp * P, hkv, dh)[:min(plen, mp * P)]
        vals = vp[pages].reshape(mp * P, hkv, dh)[:min(plen, mp * P)]
        states = []
        for i in range(n_split):
            k, v = keys[i * chunk:(i + 1) * chunk], vals[i * chunk:
                                                        (i + 1) * chunk]
            if i == n_split - 1:
                k = torch.cat([k, torch.from_numpy(side_k[b, :n_read[b]])])
                v = torch.cat([v, torch.from_numpy(side_v[b, :n_read[b]])])
                if fresh is not None and fresh[b] is not None:
                    k = torch.cat([k, torch.from_numpy(fresh[b][0])])
                    v = torch.cat([v, torch.from_numpy(fresh[b][1])])
            states.append(_state(q[b], k, v))
        outs.append(_merge_runs(states))
    return torch.stack(outs).numpy(), n_split


def _edge_case(seed, chunk, mp, h=8, hkv=2):
    """Prefix lengths on the runs' edges (0, 1, chunk - 1, chunk, chunk
    + 1, the full prefix, a slot with no key at all, a mid-run length)."""
    full = mp * P
    prefix = [0, 1, chunk - 1, chunk, min(chunk + 1, full), full, 0,
              min(2 * chunk + 3, full)]
    rs = np.random.RandomState(seed)
    b = len(prefix)
    n = b * mp
    c = dict(q=rs.randn(b, h, DH).astype(np.float32),
             kp=rs.randn(n, P, hkv * DH).astype(np.float32),
             vp=rs.randn(n, P, hkv * DH).astype(np.float32),
             table=np.stack([rs.permutation(n)[:mp] for _ in range(b)]
                            ).astype(np.int32),
             sk=rs.randn(b, W, hkv, DH).astype(np.float32),
             sv=rs.randn(b, W, hkv, DH).astype(np.float32),
             fk=rs.randn(b, 1, hkv, DH).astype(np.float32),
             fv=rs.randn(b, 1, hkv, DH).astype(np.float32))
    return c, np.array(prefix, np.int32)


# (chunk, mp): runs mid-page (12), on pages (16), two runs with a partial
# second (64), one run (96: no merge), and paged_split's own grid at
# 1,024 keys (4 runs of 256)
SPLITS = [(12, 6), (16, 6), (64, 6), (96, 6),
          (paged_split(8, 2, 64 * P, 132)[1], 64)]


@pytest.mark.parametrize("chunk,mp", SPLITS)
def test_split_rule_matches_xla(chunk, mp):
    """flash_decode: the runs plus the side window in the last run, merged,
    against the JAX composition; a slot with no key gives exactly 0."""
    hkv = 2
    c, prefix = _edge_case(60 + chunk, chunk, mp)
    n_side = np.array([0, 1, W, 2, 0, W, 3, 1], np.int32)
    got, n_split = _split_rule(c, prefix, chunk, mp, c["sk"], c["sv"],
                               n_side)
    assert n_split * chunk >= mp * P
    want = np.asarray(flash_decode_attention_xla(
        *(jnp.asarray(a) for a in (c["q"], c["kp"], c["vp"], c["table"],
                                   prefix, c["sk"], c["sv"], n_side)),
        n_kv_heads=hkv))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[0].any()          # no prefix, no side entry: exactly 0


@pytest.mark.parametrize("chunk,mp", SPLITS)
def test_fw_split_rule_matches_xla(chunk, mp):
    """flash_decode_fw: the last run reads side entries j < min(side_idx,
    W) and attends the fresh row of an active slot with side_idx < W (an
    inactive slot and one at side_idx = W attend none); against the JAX
    one-hot write plus flash_decode_attention_xla."""
    hkv = 2
    c, prefix = _edge_case(80 + chunk, chunk, mp)
    side_idx = np.array([0, 1, W, 2, 0, W - 1, 3, W], np.int32)
    active = np.array([0, 1, 1, 0, 1, 1, 1, 0], np.int32)
    wrote = (active > 0) & (side_idx < W)
    fresh = [(c["fk"][b], c["fv"][b]) if wrote[b] else None
             for b in range(len(prefix))]
    got, _ = _split_rule(c, prefix, chunk, mp, c["sk"], c["sv"],
                         np.minimum(side_idx, W), fresh)
    onehot = ((np.arange(W)[None, :] == side_idx[:, None])
              & (active[:, None] > 0))[:, :, None, None]
    want = np.asarray(flash_decode_attention_xla(
        *(jnp.asarray(a) for a in (
            c["q"], c["kp"], c["vp"], c["table"], prefix,
            np.where(onehot, c["fk"], c["sk"]),
            np.where(onehot, c["fv"], c["sv"]), side_idx + active)),
        n_kv_heads=hkv))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[0].any()          # inactive, no prefix: no key at all


@pytest.mark.parametrize("b,max_keys,want", [
    (8, 16 * 128, (8, 256)),     # the Llama-3-8B decode batch (MP 16)
    (1, 16 * 128, (32, 64)),     # one slot alone: 256 blocks, not 8
    (8, 8 * 128, (8, 128)),      # max_seq_len 1024 (MP 8), the served grid
])
def test_flash_decode_grid_at_llama3_8b_shapes(b, max_keys, want):
    """The kernels' grid on a 132-SM card at 8 KV heads (paged_split with
    flash-decode's shortest run), from shapes only."""
    assert paged_split(b, 8, max_keys, 132, min_chunk=MIN_CHUNK) == want


@pytest.mark.parametrize("kv", ["bfloat16", "float8_e4m3fn", "float8_e5m2",
                                "float32"])
@pytest.mark.parametrize("q", ["bfloat16", "float32"])
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_decode_subgroup_plan(dh, q, kv):
    """The kernels' sub-groups for G 1-32 (``csrc/common.cuh``
    subgroup_rows, ``flash_decode.cuh`` by_group): 1, 2, 4 or 8 rows up
    to G 8; above it one 16-row sub-group per 16 heads where the tensor
    cores run (bf16 q over bf16, e4m3 or e5m2 pools) at Dh 128, else
    sub-groups of 8. G 12 and 16 take one 16-row block a KV head there."""
    wide = (q == "bfloat16" and kv != "float32" and dh == 128)
    for g in range(1, 33):
        gs = (1 if g == 1 else 2 if g == 2 else 4 if g <= 4 else
              8 if g <= 8 or not wide else 16)
        assert decode_subgroup(g, dh, getattr(torch, q),
                               getattr(torch, kv)) == (gs, -(-g // gs)), g
    assert decode_subgroup(12, 128, torch.bfloat16, torch.bfloat16) == (16, 1)
    assert decode_subgroup(16, 128, torch.bfloat16,
                           torch.float8_e5m2) == (16, 1)
    assert decode_subgroup(24, 128, torch.bfloat16,
                           torch.float8_e4m3fn) == (16, 2)
    assert decode_subgroup(12, 128, torch.float32, torch.bfloat16) == (8, 2)


@pytest.mark.parametrize("g,kv,want", [
    (12, "bfloat16", (16, 1, 16, 128)),
    (16, "float8_e4m3fn", (16, 1, 8, 256)),    # runs of four fp8 tiles
    (12, "float8_e5m2", (16, 1, 8, 256)),
    (24, "float8_e4m3fn", (16, 2, 8, 256)),
    (7, "float8_e4m3fn", (8, 1, 16, 128)),     # the 8-row grid as before
    (4, "bfloat16", (4, 1, 16, 128)),
])
def test_decode_plan_at_b8_hkv4(monkeypatch, g, kv, want):
    """The kernels' launch (sub-groups and split grid) on a 132-SM card
    at B 8, Hkv 4, Dh 128, 2,048 keys a slot: the 16-row instance over
    fp8 pools takes runs of ``ROWS16_FP8_MIN_CHUNK`` keys, every other
    launch ``MIN_CHUNK``'s grid."""
    monkeypatch.setattr(tfd._cuda, "sm_count", lambda index: 132)
    assert tfd.decode_plan(8, 4 * g, 4, 128, 128, 16, torch.device("cpu"),
                           torch.bfloat16, getattr(torch, kv)) == want


@pytest.mark.parametrize("dh", [32, 64, 128, 256])
def test_split_runs_are_whole_e4m3_tiles(monkeypatch, dh):
    """``flash_decode_split`` on a 132-SM card at B 1-128: every run a
    whole number of the e4m3 tile's keys (64, 32 at Dh 256), and the runs
    cover each of the slot's keys once (none starts past them)."""
    monkeypatch.setattr(tfd._cuda, "sm_count", lambda index: 132)
    keys = fp8_tile_keys(dh)
    assert keys == {32: 64, 64: 64, 128: 64, 256: 32}[dh]
    for b in range(1, 129):
        for hkv, n_sub in ((1, 1), (4, 2), (8, 1), (16, 1)):
            for page_size, mp in ((16, 40), (128, 8), (128, 16), (128, 48)):
                n_split, chunk = flash_decode_split(
                    b, hkv, page_size, mp, torch.device("cpu"), n_sub)
                total = mp * page_size
                assert chunk % keys == 0, (b, hkv, page_size, mp)
                assert n_split * chunk >= total > (n_split - 1) * chunk


@pytest.mark.parametrize("dh", [32, 64, 128, 256])
def test_fp8_fragment_dims(dh):
    """The e4m3 fragments' dim orders (csrc/common.cuh kdim, vdim): both
    permutations of the head dims; a lane quad's k pairs (2t, 2t + 1) and
    (2t + 8, 2t + 9) of a K-step are four consecutive dims (one word of
    e4m3), and so are the four bytes of a V word; Q K^T through the K
    order and P V through the V order, put back, equal the plain products
    in fp32."""
    k, v = fp8_fragment_dims(dh)
    assert sorted(k) == list(range(dh)) and sorted(v) == list(range(dh))
    for kk in range(dh // 16):
        for t in range(4):
            d = k[16 * kk + 2 * t]
            assert [k[16 * kk + 2 * t + 1], k[16 * kk + 8 + 2 * t],
                    k[16 * kk + 8 + 2 * t + 1]] == [d + 1, d + 2, d + 3]
    assert all(v[i + j] == v[i] + j for i in range(0, dh, 4)
               for j in range(4))
    rng = np.random.default_rng(dh)
    q = torch.from_numpy(rng.standard_normal((8, dh)).astype(np.float32))
    kt = torch.from_numpy(rng.standard_normal((16, dh)).astype(np.float32))
    p = torch.from_numpy(rng.random((8, 16)).astype(np.float32))
    vt = torch.from_numpy(rng.standard_normal((16, dh)).astype(np.float32))
    torch.testing.assert_close(q[:, k] @ kt[:, k].T, q @ kt.T, rtol=1e-6,
                               atol=1e-5)
    o = torch.empty((8, dh))
    o[:, v] = p @ vt[:, v]
    torch.testing.assert_close(o, p @ vt, rtol=0, atol=0)


@pytest.mark.parametrize("dh", [128, 256])
def test_fp8_k_loads_hit_distinct_banks(dh):
    """At Dh 128 and 256 a quarter-warp's 16-byte K loads (lane rows 0 and
    1, quads 0-3, rows at the e4m3 stride Dh + 16) land in eight distinct
    16-byte bank groups: the pieces of quads t and t + 1 are two apart."""
    k, _ = fp8_fragment_dims(dh)
    stride = dh + 16
    for c in range(dh // 64):
        groups = {(g * stride + k[16 * 4 * c + 2 * t]) // 16 % 8
                  for g in range(2) for t in range(4)}
        assert len(groups) == 8
