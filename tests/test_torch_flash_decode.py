"""Flash-decode attention of the port (its plain version, which a CPU
tensor takes) against the JAX package's reference composition
``flash_decode_attention_xla`` and against ``cached_attention`` ground
truth; the writeback variant against the JAX one-hot side write plus
``flash_decode_attention_xla``, and the port's ``forward_decode_window``
with it against the JAX window step. The CUDA kernels themselves are held
to these plain versions on the card by chip_smoke.py. Tolerances: f32
atol 1e-5 (hidden 1e-4 after four layers), bf16 pools atol 2e-2; side
buffers equal, and within 1e-5 where a model step computed the K/V
written."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
from distributed_inference_engine_tpu_torch.ops.flash_decode import (
    flash_decode_attention,
    flash_decode_attention_fw,
)

pytestmark = pytest.mark.torch_port


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


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (8, 2)])
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


@pytest.mark.parametrize("h,hkv", [(4, 2), (8, 2)])
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
