"""The port's Llama forward against the JAX forward with bridged weights
(llama-tiny, f32; hidden and logits atol 1e-4), the weight bridge's round
trip, the page writes, and the prefix-cache chain hashes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu.engine.paged_kv import (
    PagedKVCache as JCache,
)
from distributed_inference_engine_tpu.engine.paged_kv import (
    page_chain_hashes as j_hashes,
)
from distributed_inference_engine_tpu.models import base as jb
from distributed_inference_engine_tpu.models.llama import llama_spec as jspec
from distributed_inference_engine_tpu_torch.bridge import (
    params_from_numpy,
    params_to_numpy,
    tensor_from_numpy,
    tensor_to_numpy,
)
from distributed_inference_engine_tpu_torch.engine.paged_kv import (
    PagedKVCache as TCache,
)
from distributed_inference_engine_tpu_torch.engine.paged_kv import (
    page_chain_hashes as t_hashes,
)
from distributed_inference_engine_tpu_torch.models import base as tb
from distributed_inference_engine_tpu_torch.models.llama import (
    llama_spec as tspec,
)

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

ATOL = 1e-4
L_, N_, P_ = 4, 24, 16           # llama-tiny layers; pool pages; page size


@pytest.fixture(scope="module")
def tiny():
    js = jspec("llama-tiny", dtype="float32")
    ts = tspec("llama-tiny", dtype="float32")
    jp = jb.init_params(js, jax.random.key(0))
    tp = params_from_numpy(jax.device_get(jp), ts, "cpu")
    return js, ts, jp, tp


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x.float())
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip(dtype):
    js = jspec("llama-tiny", dtype=dtype)
    ts = tspec("llama-tiny", dtype=dtype)
    tree = jax.device_get(jb.init_params(js, jax.random.key(1)))
    back = params_to_numpy(params_from_numpy(tree, ts, "cpu"))
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_j) == 12
    for path, leaf in flat_j:
        node = back
        for k in path:
            node = node[k.key]
        want = np.asarray(leaf)
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        np.testing.assert_array_equal(node, want)
    t = params_from_numpy(tree, ts, "cpu")["blocks"]["wq"]
    assert t.dtype == ts.torch_dtype and tuple(t.shape) == (4, 256, 256)


def _pools(seed):
    rs = np.random.RandomState(seed)
    shape = (L_, N_, P_, 4 * 32)
    return (rs.randn(*shape).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


def test_forward_train_logits(tiny):
    js, ts, jp, tp = tiny
    rs = np.random.RandomState(2)
    toks = rs.randint(1, 1024, size=(2, 13)).astype(np.int32)
    lens = np.array([13, 9], np.int32)
    want = jb.forward_train(js, jp, jnp.asarray(toks), jnp.asarray(lens))
    got = tb.forward_train(ts, tp, _t(toks), lens)
    _close(got[0], want[0])
    _close(got[1, :9], want[1, :9])


def test_forward_prefill_into_pages(tiny):
    js, ts, jp, tp = tiny
    rs = np.random.RandomState(3)
    toks = rs.randint(1, 1024, size=(3, 32)).astype(np.int32)
    lens = np.array([32, 17, 0], np.int32)          # row 2 is padding
    table = np.array([[3, 4, 0, 0], [9, 1, 0, 0], [0, 0, 0, 0]], np.int32)
    kp, vp = _pools(4)
    jh, jkp, jvp = jb.forward_prefill_into_pages(
        js, jp, *(jnp.asarray(a) for a in (toks, lens, kp, vp, table)))
    tkp, tvp = _t(kp), _t(vp)
    th, tkp2, _ = tb.forward_prefill_into_pages(ts, tp, _t(toks), lens, tkp,
                                                tvp, table)
    assert tkp2 is tkp                          # written in place
    _close(th[0], jh[0])
    _close(th[1, :17], jh[1, :17])
    _close(tkp, jkp, atol=1e-5)
    _close(tvp, jvp, atol=1e-5)
    # untouched pages keep their bytes exactly
    np.testing.assert_array_equal(_np(tkp)[:, 5], kp[:, 5])


@pytest.mark.parametrize("fused", [False, True])
def test_forward_decode_window(tiny, fused):
    """One window step (fused and unfused) vs the JAX step on the xla
    attention path: hidden, logits and the side windows."""
    js, ts, jp, tp = tiny
    rs = np.random.RandomState(5)
    b, w = 4, 3
    kp, vp = _pools(6)
    table = rs.randint(0, N_, size=(b, 4)).astype(np.int32)
    start = np.array([0, 5, 16, 40], np.int32)
    lengths = start + np.array([0, 1, 2, 1], np.int32)
    active = np.array([True, True, True, False])
    toks = rs.randint(1, 1024, size=(b,)).astype(np.int32)
    side = rs.randn(2, L_, b, w, 4, 32).astype(np.float32)
    jx, jsk, jsv = jb.forward_decode_window(
        js, jp, *(jnp.asarray(a) for a in (toks, lengths, start, kp, vp,
                                           table, side[0], side[1], active)),
        attn_impl="xla", fused=fused)
    tsk, tsv = _t(side[0]), _t(side[1])
    tx, _, _ = tb.forward_decode_window(
        ts, tp, _t(toks), _t(lengths), _t(start), _t(kp), _t(vp), _t(table),
        tsk, tsv, _t(active), attn_impl="pallas-decode", fused=fused)
    _close(tx, jx)
    _close(tb.unembed(ts, tp, tx), jb.unembed(js, jp, jx))
    _close(tsk, jsk, atol=1e-5)
    _close(tsv, jsv, atol=1e-5)


def test_bf16_unembed_logits_are_fp32_accumulated():
    """bf16 weights: the port's logits are the fp32 accumulator output of
    the bf16 product, as JAX's ``preferred_element_type=float32`` gives,
    with no bf16 rounding in between. The LM head is scaled so logits sit
    at |4-8|, where one bf16 ulp of a logit is 0.03."""
    js = jspec("llama-tiny", dtype="bfloat16")
    ts = tspec("llama-tiny", dtype="bfloat16")
    tree = jax.device_get(jb.init_params(js, jax.random.key(4)))
    tree["lm_head"] = np.asarray(jnp.asarray(tree["lm_head"], jnp.float32)
                                 * 20.0, jnp.bfloat16)
    tp = params_from_numpy(tree, ts, "cpu")
    hidden = np.asarray(jnp.asarray(np.random.RandomState(8).randn(
        3, 5, 256), jnp.bfloat16))
    want = np.asarray(jb.unembed(js, tree, jnp.asarray(hidden)))
    got = tb.unembed(ts, tp, tensor_from_numpy(hidden, "cpu"))
    assert got.dtype == torch.float32
    assert np.abs(want).max() > 4.0
    np.testing.assert_allclose(tensor_to_numpy(got), want, rtol=0,
                               atol=1e-3)


def test_write_prefill_pages():
    rs = np.random.RandomState(7)
    b, t = 3, 10
    kp, vp = _pools(8)
    ks = rs.randn(L_, b, t, 4, 32).astype(np.float32)
    vs = rs.randn(L_, b, t, 4, 32).astype(np.float32)
    table = np.array([[2, 5, 7, 0], [11, 12, 0, 0], [1, 0, 0, 0]], np.int32)
    lens = np.array([10, 3, 0], np.int32)
    start = np.array([12, 16, 4], np.int32)       # row 0 straddles a page
    jkp, jvp = jb.write_prefill_pages(
        *(jnp.asarray(a) for a in (kp, vp, ks, vs, table, lens)),
        start=jnp.asarray(start))
    tkp, tvp = _t(kp), _t(vp)
    tb.write_prefill_pages(tkp, tvp, _t(ks), _t(vs), table, lens,
                           start=start)
    np.testing.assert_array_equal(_np(tkp), np.asarray(jkp))
    np.testing.assert_array_equal(_np(tvp), np.asarray(jvp))


@pytest.mark.parametrize("n_tokens,page", [(0, 16), (15, 16), (16, 16),
                                           (100, 16), (300, 128)])
def test_page_chain_hashes_byte_identical(n_tokens, page):
    rs = np.random.RandomState(n_tokens)
    toks = rs.randint(0, 128256, size=n_tokens).tolist()
    n_pages = n_tokens // page
    assert t_hashes(toks, n_pages, page) == j_hashes(toks, n_pages, page)


def test_paged_kv_accounting_matches_jax():
    """The same allocation script on both caches (slots, reservations,
    prefix hits, frees, reclaim under pressure): every return value, the
    page table and the page counts agree step by step."""
    kw = dict(max_slots=3, page_size=P_, num_pages=10, max_seq_len=96,
              dtype="float32")
    caches = (JCache(jspec("llama-tiny", dtype="float32"), **kw),
              TCache(tspec("llama-tiny", dtype="float32"), device="cpu", **kw))
    rs = np.random.RandomState(3)
    shared = rs.randint(1, 1000, size=2 * P_).tolist()
    a, b = shared + [1, 2, 3], shared + [4, 5]
    script = [
        ("alloc_slot_prefix", a), ("register_prefix", 0, a),
        ("alloc_slot_prefix", b), ("reserve", 1, 20),
        ("ensure_capacity", 0, 70), ("alloc_slot", 40),
        ("alloc_slot", 5), ("ensure_backed", 1, 2 * P_ + 2),
        ("free_slot", 0), ("free_slot", 1), ("free_slot", 2),
        ("alloc_slot", 90), ("alloc_slot_prefix", a), ("free_slot", 1),
        ("alloc_slot", 60), ("free_slot", 2), ("alloc_slot_prefix", a),
    ]
    keys = ("pages_used", "pages_free", "pages_cached", "live_slots",
            "prefix_hit_pages", "prefix_reclaimed", "prefix_indexed")
    for op, *args in script:
        got = [getattr(c, op)(*args) for c in caches]
        assert got[0] == got[1], (op, args, got)
        np.testing.assert_array_equal(caches[0]._table, caches[1]._table)
        stats = [c.get_stats() for c in caches]
        assert [stats[0][k] for k in keys] == [stats[1][k] for k in keys]
    for c in caches:
        with pytest.raises(RuntimeError):
            c.ensure_backed(0, 10 ** 4)


def test_unsupported_spec_features_raise():
    # every spec feature of the JAX package is ported, experts (Mixtral)
    # included; what JAX refuses is refused
    assert tspec("llama-tiny", n_experts=4).n_experts == 4
    with pytest.raises(ValueError, match="experts_per_token"):
        tspec("llama-tiny", n_experts=4, experts_per_token=5)
    with pytest.raises(ValueError, match="biases"):
        tspec("llama-tiny", n_experts=4, use_bias=True)
    for kw in (dict(pos_emb="learned"), dict(use_bias=True),
               dict(norm="layernorm"), dict(logit_softcap=30.0),
               dict(qkv_bias=True), dict(mlp="gelu")):
        assert tspec("llama-tiny", **kw).to_dict().items() >= kw.items()
    for kw in (dict(pos_emb="alibi"), dict(mlp="relu")):
        with pytest.raises(ValueError):
            tspec("llama-tiny", **kw)
    with pytest.raises(ValueError):
        tspec("llama-tiny", sliding_window=-1)
    assert tspec("llama-tiny", sliding_window=8).sliding_window == 8
