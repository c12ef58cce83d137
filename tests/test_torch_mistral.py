"""Sliding-window Mistral in the port (CPU) against the JAX package on the
same bridged ``mistral-tiny`` f32 weights (4 layers, window 64):
``forward_train`` logits past the window, the per-step paged decode
(``forward_decode_paged``) with an inactive slot whose writes must be
dropped, and the greedy tokens of the two ``ContinuousEngine``s with
prompts past the window, chunked, and through a prefix hit. Hidden states
and logits atol 1e-4, pools 1e-5 (the untouched bytes exactly), logprobs
1e-4."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu.config import EngineConfig as JCfg
from distributed_inference_engine_tpu.engine.continuous import (
    ContinuousEngine as JEngine,
)
from distributed_inference_engine_tpu.engine.types import (
    GenerationRequest as JReq,
)
from distributed_inference_engine_tpu.models import base as jb
from distributed_inference_engine_tpu.models.mistral import (
    mistral_spec as jspec,
)
from distributed_inference_engine_tpu_torch import bridge
from distributed_inference_engine_tpu_torch.config import EngineConfig
from distributed_inference_engine_tpu_torch.engine.continuous import (
    ContinuousEngine,
)
from distributed_inference_engine_tpu_torch.engine.types import (
    GenerationRequest,
)
from distributed_inference_engine_tpu_torch.models import (
    spec_for_architecture,
)
from distributed_inference_engine_tpu_torch.models import base as tb
from distributed_inference_engine_tpu_torch.models.mistral import (
    mistral_spec as tspec,
)

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

ATOL = 1e-4
WINDOW = 64
KW = dict(max_slots=4, max_seq_len=256, prefill_buckets=[64, 128],
          page_size=16, num_pages=72, decode_steps_per_call=4,
          kv_dtype="float32")


@pytest.fixture(scope="module")
def tiny():
    js = jspec("mistral-tiny", dtype="float32")
    ts = tspec("mistral-tiny", dtype="float32")
    assert js.sliding_window == ts.sliding_window == WINDOW
    jp = jb.init_params(js, jax.random.key(0))
    return js, ts, jp, bridge.params_from_numpy(jax.device_get(jp), ts,
                                                "cpu")


def _t(a):
    return bridge.tensor_from_numpy(np.asarray(a), "cpu")


def _np(x):
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "detach"):
        return bridge.tensor_to_numpy(x.float())
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_the_mistral_tree_bit_for_bit(dtype):
    """The Mistral tree has Llama's keys; every leaf crosses bit for bit.
    The bridge's entry points default to the card, like the rest of the
    port."""
    js = jspec("mistral-tiny", dtype=dtype)
    ts = tspec("mistral-tiny", dtype=dtype)
    tree = jax.device_get(jb.init_params(js, jax.random.key(3)))
    back = bridge.params_to_numpy(bridge.params_from_numpy(tree, ts, "cpu"))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == 12
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        want = np.asarray(leaf)
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        np.testing.assert_array_equal(node, want)
    for fn in (bridge.tensor_from_numpy, bridge.leaf_from_numpy,
               bridge.params_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_specs_match_jax():
    for size in ("mistral-7b", "mistral-7b-v01", "mistral-tiny"):
        assert tspec(size).to_dict() == jspec(size).to_dict()
    s = spec_for_architecture("mistral", size="mistral-7b-v01",
                              max_seq_len=8192)
    assert (s.sliding_window, s.vocab_size, s.rope_theta, s.max_seq_len) \
        == (4096, 32000, 10000.0, 8192)
    assert spec_for_architecture("mistral").sliding_window == 0   # v0.3
    assert spec_for_architecture("mistral-tiny").n_layers == 4


def test_forward_train_logits_past_the_window(tiny):
    js, ts, jp, tp = tiny
    rs = np.random.RandomState(1)
    toks = rs.randint(1, 1024, size=(2, 150)).astype(np.int32)
    lens = np.array([150, 97], np.int32)
    want = jb.forward_train(js, jp, jnp.asarray(toks), jnp.asarray(lens))
    got = tb.forward_train(ts, tp, _t(toks), lens)
    _close(got[0], want[0])
    _close(got[1, :97], want[1, :97])
    # the window matters at this length: full attention differs
    full = tb.forward_train(ts.replace(sliding_window=0), tp, _t(toks), lens)
    assert float((full[0, 100:] - got[0, 100:]).abs().max()) > 1e-2


def test_forward_decode_paged_matches_jax(tiny):
    """Four steps of the per-step paged decode on both sides: slot 2 is
    inactive and its table row points at slot 0's first page, whose bytes
    must stay; slot 3 crosses a page edge; the last step masks every
    slot. Hidden states, logits and the whole pools agree."""
    js, ts, jp, tp = tiny
    rs = np.random.RandomState(2)
    L, n, p, fused = 4, 48, 16, 4 * 32
    b, mp = 4, 10
    kp = rs.randn(L, n, p, fused).astype(np.float32)
    vp = rs.randn(L, n, p, fused).astype(np.float32)
    # distinct pages 1..47 per slot; slot 0 owns page 0, the free slot 2's
    # row is all page 0
    table = (1 + rs.permutation(n - 1)[: b * mp]).reshape(b, mp).astype(
        np.int32)
    table[0, 0] = 0
    table[2] = 0
    lengths = np.array([70, 100, 5, 62], np.int32)
    active = np.array([True, True, False, True])
    jkp, jvp = jnp.asarray(kp), jnp.asarray(vp)
    tkp, tvp = _t(kp), _t(vp)
    for step in range(4):
        if step == 3:
            active[:] = False
        toks = rs.randint(1, 1024, size=(b,)).astype(np.int32)
        jx, jkp, jvp = jb.forward_decode_paged(
            js, jp, jnp.asarray(toks), jnp.asarray(lengths), jkp, jvp,
            jnp.asarray(table), jnp.asarray(active), attn_impl="xla")
        tx, tkp2, _ = tb.forward_decode_paged(
            ts, tp, _t(toks), _t(lengths), tkp, tvp, _t(table),
            _t(active), attn_impl="auto")
        assert tkp2 is tkp                         # written in place
        _close(tx, jx)
        _close(tb.unembed(ts, tp, tx), jb.unembed(js, jp, jx))
        _close(tkp, jkp, atol=1e-5)
        _close(tvp, jvp, atol=1e-5)
        lengths = lengths + active
    # the inactive slot's would-be rows (slot 0's page 0) kept their bytes
    np.testing.assert_array_equal(_np(tkp)[:, 0, 5], kp[:, 0, 5])
    np.testing.assert_array_equal(_np(tvp)[:, 0, 5], vp[:, 0, 5])


def _waves():
    """Prompts of 80-150 tokens (past the 64-token window), two sharing a
    48-token prefix, then a prefix hit on the first of them."""
    rs = np.random.RandomState(4)
    shared = rs.randint(1, 1024, size=48).tolist()

    def req(i, n, m=10):
        return dict(prompt=rs.randint(1, 1024, size=n).tolist(),
                    max_new_tokens=m, request_id=f"m{i}")

    first = [req(0, 80), req(1, 150, 6), dict(
        prompt=shared + rs.randint(1, 1024, size=60).tolist(),
        max_new_tokens=12, request_id="own")]
    second = [req(2, 97), req(3, 120, 8)]
    third = [dict(prompt=shared + rs.randint(1, 1024, size=70).tolist(),
                  max_new_tokens=9, request_id="hit")]
    return [first, second, third]


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


def _assert_same(got, want, n):
    assert sorted(got) == sorted(want) and len(got) == n
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason, rid
        np.testing.assert_allclose(got[rid].logprobs, want[rid].logprobs,
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("chunk", [0, 32])
def test_greedy_tokens_match_jax_engine(tiny, chunk):
    """Whole-prompt admission (chunk 0) and chunked prefill (32-token
    chunks on 16-token pages, the split path's windowed suffix prefill),
    with a prefix hit, then the inline decode: the JAX engine's tokens,
    finish reasons and logprobs."""
    js, ts, jp, tp = tiny
    je = JEngine(js, params=jp, config=JCfg(attention_impl="xla",
                                            prefill_chunk=chunk, **KW))
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(
        prefill_chunk=chunk, **KW), device="cpu")
    waves = _waves()
    _assert_same(_drive(te, GenerationRequest, waves),
                 _drive(je, JReq, waves), 6)
    m = te.get_metrics()
    assert m["decode_mode"] == "inline" and m["decode_steps"] > 0
    assert m["prefix_hit_admissions"] >= 1
    assert m["chunked_admissions"] >= (3 if chunk else 0)
    assert je.get_metrics()["prefix_hit_admissions"] >= 1


def test_windowed_spec_errors_match_jax(tiny):
    js, ts, jp, tp = tiny
    for make, params, cfg_cls, spec in ((JEngine, jp, JCfg, js),
                                        (ContinuousEngine, tp, EngineConfig,
                                         ts)):
        kw = dict(device="cpu") if make is ContinuousEngine else {}
        with pytest.raises(ValueError, match="sliding-window"):
            make(spec, params=params, config=cfg_cls(
                attention_impl="pallas-ragged", prefill_chunk=32, **KW),
                **kw)
        with pytest.raises(ValueError, match="is not 'window'"):
            make(spec, params=params, config=cfg_cls(decode_mode="paged",
                                                     **KW), **kw)
    with pytest.raises(ValueError, match="sliding-window"):
        tb.forward_mixed_step(ts, tp, _t(np.ones((1, 2), np.int32)),
                              np.zeros(1), np.ones(1), _t(np.zeros(
                                  (4, 2, 16, 128), np.float32)),
                              _t(np.zeros((4, 2, 16, 128), np.float32)),
                              np.zeros((1, 2), np.int32))
