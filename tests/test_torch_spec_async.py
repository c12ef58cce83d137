"""The port's async speculation (A12: ``engine/spec_async.py``, the shared
rule of ``engine/spec_accept.py`` and the continuous engine's verify step)
against the JAX package, on the CPU: the counterpart of
``tests/test_spec_async.py``, on its 2-layer d128 fp32 spec.

- The rule: ``rejection_accept`` bit-equal to JAX's and to the frozen r5
  loop form (``n_acc``, ``final``, ``accept``), greedy and sampled, masked
  and not, with the randomness injected: the JAX ``uniform`` and
  ``gumbel`` of the keys the JAX call takes (``jax.random.categorical`` is
  ``argmax(gumbel + logits)``); ``draft_sample`` likewise; plain rows
  reduce to the plain decode sample.
- The engine: greedy streams with the drafter on equal to the drafter off
  and to the JAX async engine's, fp32 and int4, with the JAX engine's
  drafter counters; accept-all (``scale_top_blocks`` eps 0) and reject-all
  extremes; saturation auto-idle; same-seed determinism of sampled runs;
  the ``defer_sync`` and sliding-window refusals; ``resolve_draft``'s
  clamp; the pump's order (stream poll, then draft); a mid-flight
  schedule only catching up.
- Serving: a port worker loading ``spec_async=1`` over RPC streams the JAX
  engine's tokens with verify steps run; the fake's speculation model
  equals the JAX fake's.
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
from distributed_inference_engine_tpu.engine import spec_accept as jacc
from distributed_inference_engine_tpu.engine.types import (
    GenerationRequest as JReq,
)
from distributed_inference_engine_tpu.models import base as jb
from distributed_inference_engine_tpu.models import fake as jfake
from distributed_inference_engine_tpu.ops import quant as jq
from distributed_inference_engine_tpu.ops import sampling as jsamp
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
from distributed_inference_engine_tpu_torch.engine.spec_accept import (
    draft_sample,
    rejection_accept,
)
from distributed_inference_engine_tpu_torch.engine.spec_async import (
    resolve_draft,
)
from distributed_inference_engine_tpu_torch.engine.speculative import (
    scale_top_blocks,
)
from distributed_inference_engine_tpu_torch.engine.types import (
    GenerationRequest,
)
from distributed_inference_engine_tpu_torch.models import base as tb
from distributed_inference_engine_tpu_torch.models import fake as tfake
from distributed_inference_engine_tpu_torch.models import (
    fake_engine_from_config,
)
from distributed_inference_engine_tpu_torch.obs.timeline import (
    busy_gap_split,
)
from distributed_inference_engine_tpu_torch.ops.sampling import (
    SamplingParams,
)
from distributed_inference_engine_tpu_torch.serving.pump import EnginePump

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

# n_kv_heads * head_dim a multiple of 128 (the paged layout's rule)
SPEC_KW = dict(vocab_size=128, d_model=128, n_layers=2, n_heads=2,
               n_kv_heads=2, d_ff=128, max_seq_len=128, dtype="float32")


def _cfg(cls, spec_async, floor=0.0, k=4, **kw):
    return cls(max_slots=4, page_size=16, num_pages=64, max_seq_len=96,
               decode_steps_per_call=6, spec_async=spec_async,
               spec_draft_model="layers:1", spec_max_draft=k,
               spec_bubble_floor_s=floor, **kw)


@pytest.fixture(scope="module")
def w():
    js, ts = jb.ModelSpec(**SPEC_KW), tb.ModelSpec(**SPEC_KW)
    jp = jb.init_params(js, jax.random.key(0))
    tp = bridge.params_from_numpy(jax.device_get(jp), ts, "cpu")
    return js, ts, jp, tp


def _run(spec, params, cfg, *, jax_engine=False, temp=0.0, n_req=3, nt=20,
         seed=0, draft=None):
    """``n_req`` streamed requests pumped to completion -> (streamed tokens
    per request, engine)."""
    kw = {}
    if draft is not None:
        kw = {"draft_spec": draft[0], "draft_params": draft[1]}
    if jax_engine:
        eng, req = JEngine(spec, params, cfg, seed=seed, **kw), JReq
    else:
        eng = ContinuousEngine(spec, params, cfg, seed=seed, device="cpu",
                               **kw)
        req = GenerationRequest
    streamed = {i: [] for i in range(n_req)}
    for i in range(n_req):
        eng.submit(req(prompt=[7 + i, 11, 13], max_new_tokens=nt,
                       temperature=temp),
                   on_tokens=(lambda t, i=i: streamed[i].extend(t)))
    for _ in range(400):
        if eng.step() == 0 and not eng.n_waiting:
            break
    return streamed, eng


COUNTERS = ("spec_async_drafted_tokens", "spec_async_accepted_tokens",
            "spec_async_wasted_tokens", "spec_async_catchup_tokens",
            "spec_async_draft_rounds", "spec_async_propose_rounds",
            "spec_async_verify_steps", "spec_async_auto_idles",
            "spec_async_pending")


# -------------------------------------------------------------- the rule


def _frozen_r5_accept(p, q, drafts, greedy, u, gumbel, valid=None):
    """The r5 acceptance block in loop form (``tests/test_spec_async.py``'s
    frozen copy), its randomness given: ``u`` for the acceptance test and
    ``gumbel`` for the final categorical draw."""
    b, k = drafts.shape
    accept = np.zeros((b, k), bool)
    for i in range(b):
        for j in range(k):
            d = int(drafts[i, j])
            if greedy[i]:
                accept[i, j] = int(np.argmax(p[i, j])) == d
            else:
                accept[i, j] = u[i, j] * q[i, j, d] < p[i, j, d]
            if valid is not None and not valid[i, j]:
                accept[i, j] = False
    n_acc = np.zeros(b, np.int32)
    for i in range(b):
        while n_acc[i] < k and accept[i, n_acc[i]]:
            n_acc[i] += 1
    final_dist = np.zeros((b, p.shape[-1]))
    for i in range(b):
        if n_acc[i] == k:
            final_dist[i] = p[i, k]
        else:
            pos = min(int(n_acc[i]), k - 1)
            resid = np.maximum(p[i, pos] - q[i, pos], 0.0)
            if resid.sum() <= 1e-9:
                resid = p[i, pos]
            final_dist[i] = resid / resid.sum()
    f_samp = np.argmax(gumbel + np.log(np.maximum(final_dist, 1e-30)), -1)
    final = np.where(greedy, final_dist.argmax(-1), f_samp)
    return n_acc, final.astype(np.int32), accept


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("greedy_all", [True, False, None],
                         ids=["greedy", "sampled", "mixed"])
@pytest.mark.parametrize("masked", [False, True])
def test_rejection_accept_bit_parity(greedy_all, masked, seed):
    b, k, v = 5, 4, 32
    rng = np.random.RandomState(7 + masked + 10 * seed)
    p = rng.dirichlet(np.ones(v) * 0.3, size=(b, k + 1)).astype(np.float32)
    q = rng.dirichlet(np.ones(v) * 0.3, size=(b, k)).astype(np.float32)
    drafts = rng.randint(0, v, size=(b, k)).astype(np.int32)
    # some drafts at the target's argmax, so greedy rows accept runs
    drafts[:2] = p[:2, :k].argmax(-1)
    greedy = (np.full(b, greedy_all) if greedy_all is not None
              else np.arange(b) % 2 == 0)
    valid = (rng.rand(b, k) < 0.6) if masked else None
    kr, kb = jax.random.split(jax.random.key(seed))
    u = np.array(jax.random.uniform(kr, (b, k)))
    g = np.array(jax.random.gumbel(kb, (b, v), jnp.float32))
    jn, jf, ja = jacc.rejection_accept(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(drafts),
        jnp.asarray(greedy), kr, kb,
        valid=None if valid is None else jnp.asarray(valid))
    tn, tf, ta = rejection_accept(
        torch.from_numpy(p), torch.from_numpy(q), torch.from_numpy(drafts),
        torch.from_numpy(greedy), torch.from_numpy(u), torch.from_numpy(g),
        valid=None if valid is None else torch.from_numpy(valid))
    rn, rf, ra = _frozen_r5_accept(p, q, drafts, greedy, u, g, valid)
    for got, jx, ref in ((tn, jn, rn), (tf, jf, rf), (ta, ja, ra)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(got.numpy(), ref)
    assert tn.dtype == tf.dtype == torch.int32


def test_plain_rows_reduce_to_plain_decode():
    """Zero draft columns (an all-False mask, zero q) sample position 0 of
    the target: what lets plain rows ride the verify step."""
    b, k, v = 3, 4, 16
    rng = np.random.RandomState(11)
    p = rng.dirichlet(np.ones(v), size=(b, k + 1)).astype(np.float32)
    n, f, _ = rejection_accept(
        torch.from_numpy(p), torch.zeros((b, k, v)),
        torch.zeros((b, k), dtype=torch.int32),
        torch.ones(b, dtype=torch.bool), torch.rand(b, k), None,
        valid=torch.zeros((b, k), dtype=torch.bool))
    assert n.tolist() == [0] * b
    np.testing.assert_array_equal(f.numpy(), p[:, 0].argmax(-1))


@pytest.mark.parametrize("knobs", [dict(temperature=0.8),
                                   dict(temperature=1.1, top_k=6),
                                   dict(temperature=0.7, top_p=0.5)])
def test_draft_sample_matches_jax(knobs):
    b, v = 6, 40
    rng = np.random.RandomState(2)
    logits = (rng.randn(b, v) * 2).astype(np.float32)
    greedy = np.array([True, False, False, True, False, False])
    key = jax.random.key(5)
    g = np.asarray(jax.random.gumbel(key, (b, v), jnp.float32))
    temps = np.where(greedy, 0.0, knobs["temperature"]).astype(np.float32)
    kn = {k_: v_ for k_, v_ in knobs.items() if k_ != "temperature"}
    jsp = jsamp.SamplingParams.make(b, **kn)._replace(
        temperature=jnp.asarray(temps))
    tsp = SamplingParams.make(b, **kn)._replace(
        temperature=torch.from_numpy(temps))
    jt, jpr = jacc.draft_sample(jnp.asarray(logits), jsp,
                                jnp.asarray(greedy), key)
    tt, tpr = draft_sample(torch.from_numpy(logits), tsp,
                           torch.from_numpy(greedy), torch.from_numpy(g))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tpr.numpy(), np.asarray(jpr), rtol=0,
                               atol=1e-6)


# ------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def base_off(w):
    js, ts, jp, tp = w
    return _run(ts, tp, _cfg(EngineConfig, False))[0]


def _assert_counters_equal(te, je):
    tm, jm = te.get_metrics(), je.get_metrics()
    for k in COUNTERS:
        assert tm[k] == jm[k], k
    assert tm["spec_async_accept_rate"] == pytest.approx(
        jm["spec_async_accept_rate"])


def test_greedy_exact_f32_and_jax_async_engine(w, base_off):
    js, ts, jp, tp = w
    streamed, te = _run(ts, tp, _cfg(EngineConfig, True))
    assert streamed == base_off
    m = te.get_metrics()
    assert m["spec_async_drafted_tokens"] > 0, "drafter never engaged"
    assert m["spec_async_verify_steps"] > 0, "verify path never ran"
    # the verify step's program keys: one fixed [B, k+1] window, keyed on
    # the stop mask (and the sampler's mask and noise flags)
    verify = {p for p in te._tl_programs
              if isinstance(p, tuple) and p[0] == "verify"}
    assert 0 < len(verify) <= 2, verify
    jstreamed, je = _run(js, jp, _cfg(JCfg, True), jax_engine=True)
    assert jstreamed == streamed
    _assert_counters_equal(te, je)


def test_greedy_exact_int4(w):
    js, ts, jp, tp = w
    jq4 = jq.quantize_params(js, jp, bits=4)
    tq4 = bridge.params_from_numpy(jax.device_get(jq4), ts, "cpu")
    off, _ = _run(ts, tq4, _cfg(EngineConfig, False))
    on, te = _run(ts, tq4, _cfg(EngineConfig, True))
    assert on == off
    assert te.get_metrics()["spec_async_drafted_tokens"] > 0
    jon, je = _run(js, jq4, _cfg(JCfg, True), jax_engine=True)
    assert jon == on
    _assert_counters_equal(te, je)


def test_accept_all_extreme(w):
    js, ts, jp, tp = w
    sp = scale_top_blocks(ts, tp, n_shared=1, eps=0.0)
    off, _ = _run(ts, sp, _cfg(EngineConfig, False))
    on, te = _run(ts, sp, _cfg(EngineConfig, True))
    assert on == off
    assert te.get_metrics()["spec_async_accept_rate"] >= 0.9


def test_reject_all_extreme(w, base_off):
    js, ts, jp, tp = w
    d_spec = ts.replace(n_layers=1)
    d_params = bridge.params_from_numpy(jax.device_get(jb.init_params(
        js.replace(n_layers=1), jax.random.key(99))), d_spec, "cpu")
    streamed, te = _run(ts, tp, _cfg(EngineConfig, True),
                        draft=(d_spec, d_params))
    assert streamed == base_off
    m = te.get_metrics()
    assert m["spec_async_drafted_tokens"] > 0
    assert m["spec_async_accept_rate"] < 0.2


def test_saturation_auto_idle(w, base_off):
    js, ts, jp, tp = w
    streamed, te = _run(ts, tp, _cfg(EngineConfig, True, floor=10.0))
    assert streamed == base_off
    m = te.get_metrics()
    assert m["spec_async_drafted_tokens"] == 0
    assert m["spec_async_verify_steps"] == 0
    assert m["spec_async_auto_idles"] > 0


def test_same_seed_determinism(w):
    js, ts, jp, tp = w
    a, ea = _run(ts, tp, _cfg(EngineConfig, True), temp=0.8)
    b, eb = _run(ts, tp, _cfg(EngineConfig, True), temp=0.8)
    assert a == b
    ma, mb = ea.get_metrics(), eb.get_metrics()
    for key in ("spec_async_drafted_tokens", "spec_async_accepted_tokens",
                "spec_async_wasted_tokens", "spec_async_verify_steps"):
        assert ma[key] == mb[key], key
    assert ma["spec_async_verify_steps"] > 0


def test_refusals_and_resolve_draft(w):
    js, ts, jp, tp = w
    cfg = _cfg(EngineConfig, True, defer_sync=True)
    cfg.num_pages = 4 * (96 // 16)    # fully backed: the spec gate raises
    with pytest.raises(ValueError, match="spec_async"):
        ContinuousEngine(ts, tp, cfg, device="cpu")
    with pytest.raises(ValueError, match="sliding-window"):
        ContinuousEngine(ts.replace(sliding_window=16), tp,
                         _cfg(EngineConfig, True), device="cpu")
    d_spec, d_params = resolve_draft(ts, tp, "layers:9")
    assert d_spec.n_layers == ts.n_layers - 1
    assert d_params["blocks"]["wq"].shape[0] == 1
    assert resolve_draft(ts, tp, "")[0].n_layers == 1   # layers:2, clamped
    one = ts.replace(n_layers=1)
    with pytest.raises(ValueError, match="n_layers >= 2"):
        resolve_draft(one, tp, "layers:1")
    with pytest.raises(ValueError, match="layers:N"):
        resolve_draft(ts, tp, "bogus")


def test_pump_overlap_hook_runs_poll_before_draft():
    calls = []

    class _Spec:
        def schedule(self):
            calls.append("draft")
            return 1

    class _Eng:
        config = EngineConfig()
        overlap_hook = None
        speculator = _Spec()

        def poll_stream(self):
            calls.append("poll")
            return 0

        def step(self):
            return 0

        def drain_finished(self):
            return []

        def get_metrics(self):
            return {}

    eng = _Eng()
    pump = EnginePump(eng)
    eng.overlap_hook()
    assert calls == ["poll", "draft"]
    assert pump.get_stats()["spec_overlap_rounds"] == 1


def test_midflight_schedule_is_catchup_only(w):
    js, ts, jp, tp = w
    eng = ContinuousEngine(ts, tp, _cfg(EngineConfig, True), seed=0,
                           device="cpu")
    spec = eng.speculator
    seen = []
    orig = spec.schedule

    def wrapped():
        before = set(spec._pending)
        n = orig()
        seen.append((eng._inflight_chunks, set(spec._pending) - before))
        return n

    spec.schedule = wrapped
    eng.overlap_hook = wrapped
    eng.submit(GenerationRequest(prompt=[3, 5, 7], max_new_tokens=24),
               on_tokens=lambda t: None)
    for _ in range(400):
        if eng.step() == 0 and not eng.n_waiting:
            break
    midflight = [s for s in seen if s[0] >= 1]
    assert midflight, "overlap hook never invoked the drafter"
    assert all(not new for _, new in midflight)
    assert any(new for infl, new in seen if infl == 0)
    split = busy_gap_split(eng.timeline.events())
    assert split["n_events"] > 0 and split["busy_s"] > 0
    assert 0.0 <= split["bubble_frac"] <= 1.0


def test_busy_gap_split_matches_jax():
    from distributed_inference_engine_tpu.obs.timeline import (
        busy_gap_split as j_split,
    )

    evs = [{"t": 0.0, "dur": 1.0}, {"t": 1.5, "dur": 0.5},
           {"t": 1.7, "dur": 1.0}, {"t": 3.0, "dur": None},
           {"t": 4.0, "dur": 0.25}]
    assert busy_gap_split(evs) == j_split(evs)
    assert busy_gap_split([]) == j_split([])


# ------------------------------------------------------------- serving


async def test_worker_streams_spec_async_over_rpc(w):
    """``spec_async=1`` loaded over ``load_model`` (the factory's
    truncated self-draft of the prepared tree): streams through the JAX
    ``WorkerClient`` carry the JAX async engine's tokens, and the worker's
    engine ran verify steps."""
    js, ts, jp, tp = w

    def factory(cfg):
        return ContinuousEngine(ts, params=tp, config=_cfg(EngineConfig,
                                                          True),
                                device="cpu")

    server = WorkerServer(ServerConfig(worker_id="sa", port=0),
                          engine_factory=factory, device="cpu")
    host, port = await server.start()
    client = JClient(host, port, timeout=60.0)
    prompts = [[7, 11, 13], [8, 11, 13]]
    want, _ = _run(js, jp, _cfg(JCfg, True), jax_engine=True, n_req=2)
    try:
        await client.load_model(ModelConfig(
            name="sa", architecture="llama",
            metadata={"continuous": True, "spec_async": True}))
        outs = await asyncio.gather(*[
            client.generate_stream("sa", JReq(prompt=p, max_new_tokens=20),
                                   on_tokens=lambda t: None)
            for p in prompts])
        assert {i: o.tokens for i, o in enumerate(outs)} == want
        m = server.get_metrics()["models"]["sa"]
        assert m["spec_async_verify_steps"] > 0
        assert m["spec_async_drafted_tokens"] > 0
    finally:
        await client.close()
        await server.stop()


def test_factory_spec_async_engine():
    eng = fake_engine_from_config(ModelConfig(
        name="f", metadata={"continuous": "1", "spec_async": "1"}))
    assert eng.spec_async
    eng = ContinuousEngine(tb.ModelSpec(**SPEC_KW), None,
                           _cfg(EngineConfig, True), device="cpu")
    assert eng.speculator is not None and eng.speculator.k == 4
    assert eng.speculator.draft_spec.n_layers == 1


def test_fake_speculation_model_matches_jax():
    kw = dict(step_latency_s=0.0, tokens_per_step=2, max_slots=4,
              spec_async=True, spec_max_draft=3, spec_accept_rate=0.6)
    out = []
    for mod in (jfake, tfake):
        eng = mod.FakeContinuousEngine(**kw)
        got = {}
        for i in range(3):
            eng.submit(mod.GenerationRequest(
                prompt=[i + 1, 5, 9], max_new_tokens=11,
                request_id=f"r{i}"),
                on_tokens=(lambda t, i=i: got.setdefault(i, []).extend(t)))
        eng.submit(mod.GenerationRequest(prompt=[4], max_new_tokens=7,
                                         request_id="plain"))
        res = {}
        for _ in range(50):
            eng.step()
            res.update({r.request_id: r.tokens
                        for r in eng.drain_finished()})
        m = eng.get_metrics()
        out.append((got, res, {k: m[k] for k in m
                               if k.startswith("spec_async_")}))
    assert out[0] == out[1]
    assert out[1][2]["spec_async_accepted_tokens"] > 0
