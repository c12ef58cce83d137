"""Ragged mixed-batch attention of the port (its plain version, which a
CPU tensor takes) against the JAX package's reference
``ragged_attention_xla``, and the port's ``forward_mixed_step`` against
JAX ``forward_mixed_step(attn_impl="xla")`` on bridged llama-tiny f32
weights. The CUDA kernel itself is held to this plain version on the card
by chip_smoke.py and tests/test_torch_cuda.py. Tolerances: f32 atol 1e-5
(hidden 2e-4, pools 1e-6 after four layers), bf16 atol 2e-2; written
pages bit-equal, every other pool element unchanged. The kernel's grid
(``ragged_plan``, ``ragged_block``: plain functions of the shapes) is
checked here too: every (row, KV head, query tile) exactly once, heavy
tiles first."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu.models import base as jb
from distributed_inference_engine_tpu.models.llama import llama_spec as jspec
from distributed_inference_engine_tpu.ops.ragged_attention import (
    ragged_attention_xla,
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
from distributed_inference_engine_tpu_torch.ops.ragged_attention import (
    ROWS_PER_BLOCK,
    ragged_attention,
    ragged_block,
    ragged_instance,
    ragged_plan,
    ragged_schedule,
)

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)


def _t(a):
    return tensor_from_numpy(a, "cpu")

P, MP, DH = 16, 4, 32
# per row: (ctx_len, q_len). Row 0 a chunk from position 0, rows 1-2
# decode at ctx P-1 and P, row 3 a chunk straddling a page, row 4 inert
# with its table on row 3's live pages, row 5 a chunk straddling into its
# last page, row 6 q_len 0 over a non-empty context
ROWS = [(0, 5), (P - 1, 1), (P, 1), (10, 9), (0, 0), (2 * P + 7, 12),
        (20, 0)]
CTX = np.array([c for c, _ in ROWS], np.int32)
QLEN = np.array([q for _, q in ROWS], np.int32)
QMAX = int(QLEN.max())


def _case(seed, h, hkv, n_layers=1, q_dtype="float32", kv_dtype="float32"):
    rs = np.random.RandomState(seed)
    r = len(ROWS)
    n = r * MP + 3                      # a few pages no row owns
    cast = (lambda a, dt: np.asarray(jnp.asarray(a, dt)))
    table = rs.permutation(n)[: r * MP].reshape(r, MP).astype(np.int32)
    table[4] = table[3]                 # the inert row aims at live pages
    return dict(
        q=cast(rs.randn(r, QMAX, h, DH), q_dtype),
        fk=cast(rs.randn(r, QMAX, hkv, DH), q_dtype),
        fv=cast(rs.randn(r, QMAX, hkv, DH), q_dtype),
        kp=cast(rs.randn(n_layers * n, P, hkv * DH), kv_dtype),
        vp=cast(rs.randn(n_layers * n, P, hkv * DH), kv_dtype),
        table=table, n=n)


def _written(table, n_pool_pages):
    """Flat [N * P] mask of the pool positions a launch writes."""
    mask = np.zeros(n_pool_pages * P, bool)
    for (ctx, ql), row in zip(ROWS, table):
        for pos in range(ctx, ctx + ql):
            mask[row[pos // P] * P + pos % P] = True
    return mask


def _port(c, hkv, layer=None):
    t = {k: _t(c[k]) for k in ("q", "fk", "fv", "kp", "vp")}
    out, kp, vp = ragged_attention(
        t["q"], t["kp"], t["vp"], _t(c["table"]),
        _t(CTX), _t(QLEN), t["fk"], t["fv"],
        n_kv_heads=hkv, layer=layer, n_pages_per_layer=c["n"])
    assert kp is t["kp"] and vp is t["vp"]          # written in place
    return (tensor_to_numpy(out.float()), tensor_to_numpy(kp),
            tensor_to_numpy(vp))


def _jax(c, hkv, layer=0):
    n = c["n"]
    kp = c["kp"][layer * n:(layer + 1) * n]
    vp = c["vp"][layer * n:(layer + 1) * n]
    out, kp2, vp2 = ragged_attention_xla(
        *(jnp.asarray(a) for a in (c["q"], kp, vp, c["table"], CTX, QLEN,
                                   c["fk"], c["fv"])), n_kv_heads=hkv)
    bits = (lambda a: np.asarray(a).view(np.uint16)
            if a.dtype == jnp.bfloat16 else np.asarray(a))
    return np.asarray(out.astype(jnp.float32)), bits(kp2), bits(vp2)


def _check(c, hkv, atol, layer=None):
    got, gkp, gvp = _port(c, hkv, layer=layer)
    want, wkp, wvp = _jax(c, hkv, layer=layer or 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    for i, ql in enumerate(QLEN):               # rows i >= q_len are 0
        assert not got[i, ql:].any()
    n = c["n"]
    lo = (layer or 0) * n
    gkp_l, gvp_l = gkp[lo:lo + n], gvp[lo:lo + n]
    np.testing.assert_array_equal(gkp_l, wkp)   # written pages bit-equal
    np.testing.assert_array_equal(gvp_l, wvp)
    # every element the launch does not write keeps its bytes, this
    # layer's and the other layers'
    bits = (lambda a: a.view(np.uint16) if a.dtype.name == "bfloat16"
            else a)
    keep = ~_written(c["table"], n)
    fused = gkp.shape[-1]
    for got_pool, orig in ((gkp, bits(c["kp"])), (gvp, bits(c["vp"]))):
        flat_got = got_pool[lo:lo + n].reshape(n * P, fused)
        flat_orig = orig[lo:lo + n].reshape(n * P, fused)
        np.testing.assert_array_equal(flat_got[keep], flat_orig[keep])
        np.testing.assert_array_equal(np.delete(got_pool, np.s_[lo:lo + n], 0),
                                      np.delete(orig, np.s_[lo:lo + n], 0))
    assert _written(c["table"], n).sum() == int(QLEN.sum())


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (8, 2)])
def test_plain_matches_xla(h, hkv):
    _check(_case(0, h, hkv), hkv, atol=1e-5)


def test_stacked_layer_indexing():
    """Stacked [L*N, P, fused] pools with layer > 0 read and write layer
    l's rows only."""
    c = _case(1, 8, 2, n_layers=3)
    for layer in (1, 2):
        _check(c, 2, atol=1e-5, layer=layer)


@pytest.mark.parametrize("q_dtype,kv_dtype,atol", [
    ("bfloat16", "bfloat16", 2e-2),
    # f32 activations over a bf16 pool: the fresh K/V is attended after
    # its round trip through the pool dtype, as it is written
    ("float32", "bfloat16", 1e-5)])
def test_low_precision_pools(q_dtype, kv_dtype, atol):
    _check(_case(2, 8, 2, q_dtype=q_dtype, kv_dtype=kv_dtype), 2, atol=atol)


def _ragged_block_rule(q, kc, vc, ctx, fk, fv, qlen, scale):
    """The TPU kernel's rule (``_ragged_block``) in numpy, one (row,
    query, head) at a time over its visible keys only: the max starts at
    NEG_INF, the probabilities of the keys it may not see are 0 (so they
    are left out), out = sum(p v) / max(sum p, 1e-30); rows past q_len
    are 0."""
    r, qmax, h, dh = q.shape
    hkv = kc.shape[2]
    out = np.zeros(q.shape, np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        for b in range(r):
            for i in range(qlen[b]):
                for hh in range(h):
                    kv = hh // (h // hkv)
                    k = np.concatenate([kc[b, :ctx[b], kv], fk[b, :i + 1, kv]])
                    v = np.concatenate([vc[b, :ctx[b], kv], fv[b, :i + 1, kv]])
                    s = (k.astype(np.float64) @ q[b, i, hh]) * scale
                    m = max(-1e30, s.max())
                    p = np.exp(s - m)
                    out[b, i, hh] = (p @ v) / max(p.sum(), 1e-30)
    return out


def test_plain_gives_zero_where_every_visible_key_scores_neg_inf():
    """C2: a query whose visible keys all score -inf gets 0 from the plain
    version, as from the TPU kernel's ``_ragged_block`` (and the CUDA
    kernel), held against a numpy reference of that rule; +inf rows are
    NaN in both, finite rows agree within 1e-5. KV head 0's keys of both
    rows (context and fresh) hold +inf in dim 0, so a head of that group
    scores -inf where its q[0] < 0 and +inf where it is > 0; V is
    finite."""
    rs = np.random.RandomState(17)
    r, h, hkv, mp = 2, 4, 2, 2
    rows = [(3, 4), (5, 1)]                  # a chunk and a decode row
    ctx = np.array([c for c, _ in rows], np.int32)
    ql = np.array([q for _, q in rows], np.int32)
    qmax = int(ql.max())
    q = rs.randn(r, qmax, h, DH).astype(np.float32)
    q[..., 0, 0] = -np.abs(q[..., 0, 0]) - 0.5   # head 0: -inf scores
    q[..., 1, 0] = np.abs(q[..., 1, 0]) + 0.5    # head 1: +inf scores
    fk = rs.randn(r, qmax, hkv, DH).astype(np.float32)
    fv = rs.randn(r, qmax, hkv, DH).astype(np.float32)
    kp = rs.randn(r * mp, P, hkv * DH).astype(np.float32)
    vp = rs.randn(r * mp, P, hkv * DH).astype(np.float32)
    kp.reshape(r * mp, P, hkv, DH)[:, :, 0, 0] = np.inf
    fk[:, :, 0, 0] = np.inf
    table = np.arange(r * mp, dtype=np.int32).reshape(r, mp)
    kc = kp.reshape(r, mp * P, hkv, DH)
    vc = vp.reshape(r, mp * P, hkv, DH)
    want = _ragged_block_rule(q, kc, vc, ctx, fk, fv, ql,
                              1.0 / np.sqrt(np.float32(DH)))
    got, _, _ = ragged_attention(
        *(_t(a) for a in (q, kp, vp, table, ctx, ql, fk, fv)),
        n_kv_heads=hkv)
    got = tensor_to_numpy(got)
    valid = np.arange(qmax)[None, :] < ql[:, None]
    assert (got[valid][:, 0] == 0).all() and (want[valid][:, 0] == 0).all()
    assert np.isnan(got[valid][:, 1]).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, equal_nan=True)


def test_plain_on_finite_inputs_is_suffix_attention_bit_for_bit():
    """On finite inputs the plain version's attention is the shared
    ``suffix_attention`` (the JAX ``ragged_attention_xla``'s) exactly on
    every live query: the zeroed probabilities were already 0 there."""
    from distributed_inference_engine_tpu_torch.ops.attention import (
        suffix_attention)
    from distributed_inference_engine_tpu_torch.ops.ragged_attention import (
        _ragged_softmax)
    for q_dtype in ("float32", "bfloat16"):
        c = _case(4, 8, 2, q_dtype=q_dtype, kv_dtype=q_dtype)
        r = len(ROWS)
        kc = _t(c["kp"])[torch.as_tensor(c["table"]).long()].reshape(
            r, MP * P, 2, DH)
        vc = _t(c["vp"])[torch.as_tensor(c["table"]).long()].reshape(
            r, MP * P, 2, DH)
        args = (_t(c["q"]), kc, vc, _t(CTX).long(), _t(c["fk"]),
                _t(c["fv"]), _t(QLEN).long())
        # the live queries (an inert row sees no key: suffix_attention
        # averages, this gives 0, and the plain version stores 0 there)
        live = torch.arange(QMAX)[None, :] < _t(QLEN)[:, None]
        assert torch.equal(_ragged_softmax(*args)[live],
                           suffix_attention(*args)[live])


def test_forward_mixed_step_matches_jax():
    """One mixed step of decode and chunk rows through every layer (one
    ragged call per layer on the stacked pools): the last-token hidden
    within 2e-4, the pools within 1e-6 (tests/test_ragged_attention.py's
    model-level check, on llama-tiny)."""
    js = jspec("llama-tiny", dtype="float32")
    ts = tspec("llama-tiny", dtype="float32")
    jp = jb.init_params(js, jax.random.key(0))
    tp = params_from_numpy(jax.device_get(jp), ts, "cpu")
    rs = np.random.RandomState(3)
    L, n, r, qmax = js.n_layers, 16, 3, 8
    fused = js.n_kv_heads * js.head_dim
    kp = rs.randn(L, n, P, fused).astype(np.float32)
    vp = rs.randn(L, n, P, fused).astype(np.float32)
    table = rs.permutation(n)[: r * MP].reshape(r, MP).astype(np.int32)
    tokens = rs.randint(1, 1024, size=(r, qmax)).astype(np.int32)
    ctx = np.array([5, 0, 17], np.int32)
    qlens = np.array([1, 8, 3], np.int32)
    h_ref, kp_ref, vp_ref = jb.forward_mixed_step(
        js, jp, *(jnp.asarray(a) for a in (tokens, ctx, qlens, kp, vp,
                                           table)), attn_impl="xla")
    tkp, tvp = _t(kp), _t(vp)
    h_got, kp_got, vp_got = tb.forward_mixed_step(
        ts, tp, _t(tokens), ctx, qlens, tkp, tvp,
        _t(table))
    assert kp_got is tkp and vp_got is tvp
    np.testing.assert_allclose(tensor_to_numpy(h_got), np.asarray(h_ref),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tensor_to_numpy(tkp), np.asarray(kp_ref),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tensor_to_numpy(tvp), np.asarray(vp_ref),
                               rtol=1e-6, atol=1e-6)
    full, _, _ = tb.forward_mixed_step(
        ts, tp, _t(tokens), ctx, qlens,
        _t(kp), _t(vp),
        _t(table), return_hidden_all=True)
    assert tuple(full.shape) == (r, qmax, js.d_model)
    np.testing.assert_allclose(
        tensor_to_numpy(full)[np.arange(r), qlens - 1],
        tensor_to_numpy(h_got), rtol=0, atol=1e-6)


def test_instance_follows_the_dtypes():
    bf, f32 = torch.bfloat16, torch.float32
    assert ragged_instance(bf, bf) == "mma"
    assert {ragged_instance(a, b) for a, b in ((f32, f32), (bf, f32),
                                               (f32, bf))} == {"simt"}


# the engine's mixed-step lattices: 8 decode rows and 1 or 2 prefill rows
# at Qmax 32-256 (prefill_chunk), and the heads of llama-tiny, Llama-3-8B
# (G 4), G 1 and G 8
@pytest.mark.parametrize("instance", ["mma", "simt"])
@pytest.mark.parametrize("r", [9, 10])
@pytest.mark.parametrize("qmax", [32, 100, 256])
@pytest.mark.parametrize("h,hkv", [(4, 2), (32, 8), (8, 8), (32, 4)])
def test_plan_covers_every_query_tile_once(instance, r, qmax, h, hkv):
    tq, n_tiles, grid = ragged_plan(r, qmax, h, hkv, instance, 132)
    assert tq * (h // hkv) == ROWS_PER_BLOCK[instance]
    # the tiles cover the queries [0, qmax) once, none starts past qmax
    covered = np.zeros(qmax, int)
    for t in range(n_tiles):
        assert t * tq < qmax
        covered[t * tq:min(qmax, (t + 1) * tq)] += 1
    assert (covered == 1).all()
    items = r * hkv * n_tiles
    blocks = [ragged_block(b, r, hkv, n_tiles) for b in range(items)]
    assert sorted(blocks) == [(row, kh, t) for row in range(r)
                              for kh in range(hkv) for t in range(n_tiles)]
    # simt: a block an item; mma: persistent blocks, block b taking items
    # b, b + grid, ...: every item exactly once
    assert grid == (items if instance == "simt" else min(items, 132))
    walked = sorted(i for b in range(grid) for i in range(b, items, grid))
    assert walked == list(range(items))


def test_block_order_runs_heavy_tiles_first():
    """Tiles from the highest down; within a tile the rows from the last
    (the engine's prefill rows) down, each row's KV heads together."""
    r, hkv = 10, 8
    tq, n_tiles, grid = ragged_plan(r, 256, 32, hkv, "mma", 132)
    assert (tq, n_tiles, grid) == (32, 8, 132)
    order = [ragged_block(b, r, hkv, n_tiles)
             for b in range(r * hkv * n_tiles)]
    assert order[0] == (r - 1, 0, n_tiles - 1)
    assert order[-1] == (0, hkv - 1, 0)
    keys = [(-t, -row, kh) for row, kh, t in order]
    assert keys == sorted(keys)


# engine-like lattices: 8 decode rows (two inert, contexts up to 1,000)
# beside 1 or 2 prefill rows (at context 0 and past it), Qmax 32-256
ENGINE_ROWS = [
    [(0, 0), (1, 1), (127, 1), (128, 1), (383, 1), (640, 1), (1000, 1),
     (0, 0), (0, 256), (444, 177)],
    [(900, 1), (700, 1), (0, 0), (300, 1), (850, 1), (120, 1), (60, 1),
     (990, 1), (300, 200)],
    [(5, 1), (0, 0), (17, 1), (30, 1), (0, 0), (0, 0), (2, 1), (9, 1),
     (0, 32), (40, 20)],
]


@pytest.mark.parametrize("rows", ENGINE_ROWS)
@pytest.mark.parametrize("h,hkv,dh", [(32, 8, 128), (8, 8, 64), (32, 4, 256)])
@pytest.mark.parametrize("n_blocks", [132, 7])
def test_schedule_takes_every_item_once(rows, h, hkv, dh, n_blocks):
    """The tensor-core instance's device schedule (its host mirror): every
    (row, KV head, query tile) item exactly once over the blocks, live
    exactly when a query of the tile is live, each block's live items
    before its dead ones, and the heaviest items on different blocks."""
    q_lens = [q for _, q in rows]
    ctx_lens = [c for c, _ in rows]
    qmax = max(max(q_lens), 1)
    r = len(rows)
    tq, n_tiles, _ = ragged_plan(r, qmax, h, hkv, "mma", n_blocks)
    sched = ragged_schedule(q_lens, ctx_lens, qmax, h, hkv, dh, 128, 8,
                            n_blocks)
    assert len(sched) == n_blocks
    items = [it for blk in sched for it in blk]
    assert sorted((row, kh, t) for row, kh, t, _ in items) == [
        (row, kh, t) for row in range(r) for kh in range(hkv)
        for t in range(n_tiles)]
    for row, _, t, live in items:
        assert live == (t * tq < q_lens[row])
    for blk in sched:
        flags = [live for *_, live in blk]
        assert flags == sorted(flags, reverse=True)
    # round 0: the first n_blocks items (the heaviest), one a block
    n_live = sum(live for *_, live in items)
    firsts = [blk[0] for blk in sched if blk and blk[0][3]]
    assert len(firsts) == min(n_blocks, n_live)


@pytest.mark.parametrize("rows", ENGINE_ROWS)
@pytest.mark.parametrize("dh", [128, 256])
def test_schedule_ranks_items_by_key_tiles(rows, dh):
    """One block takes every item in the schedule's rank order: the (row,
    query tile) pairs by their key tiles of 64 keys (32 at Dh 256; twice
    when more than 64 of the tile's rows are live), heaviest first, ties
    in block order, each pair's KV heads together."""
    h, hkv, page_size, mp = 32, 8, 128, 8
    q_lens = [q for _, q in rows]
    ctx_lens = [c for c, _ in rows]
    qmax = max(q_lens)
    r = len(rows)
    g = h // hkv
    tq, n_tiles, _ = ragged_plan(r, qmax, h, hkv, "mma", 1)
    keys = 64 if dh <= 128 else 32

    def cost(row, tile):
        q0 = tile * tq
        if q0 >= q_lens[row]:
            return 0
        fresh_end = min(q0 + tq, q_lens[row])
        ctx = min(ctx_lens[row], mp * page_size)
        tiles = -(-ctx // keys) + -(-fresh_end // keys)
        return 2 * tiles if (fresh_end - q0) * g > 64 else tiles

    (items,) = ragged_schedule(q_lens, ctx_lens, qmax, h, hkv, dh,
                               page_size, mp, 1)
    pairs = [(row, t) for row, _, t, _ in items[::hkv]]
    assert [(row, kh, t) for row, kh, t, _ in items] == [
        (row, kh, t) for row, t in pairs for kh in range(hkv)]
    block_order = [(row, t) for t in reversed(range(n_tiles))
                   for row in reversed(range(r))]
    assert pairs == sorted(block_order, key=lambda p: (
        -cost(*p), block_order.index(p)))
