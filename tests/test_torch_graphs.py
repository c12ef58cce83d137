"""The port's one-dispatch-per-chunk machinery on the CPU, where every body
runs eagerly (the graphs themselves are held on the card in
``tests/test_torch_cuda.py``):

- the device-side page write (``write_pages_device``, the decode chunk's
  flush inside the chunk) against the JAX ``write_prefill_pages`` on the
  same numpy inputs: exact in fp32 (the same dtype, a copy of bytes), with
  counts of 0, a write that crosses a page boundary, and a shared prefix
  page that stays untouched;
- the engine's per-slot state, capacity buffer and page table keep their
  addresses across admissions, chunks, mixed steps and retirements;
- ``decode_programs`` equals the distinct decode keys the bodies saw and
  is bounded by ``decode_steps_per_call`` x 8;
- the launch-accounting helpers: a recorded delta added on every replay
  (a stub graph), and a recording that leaves the counts as they were;
- sampled runs (decode chunks and mixed steps) reproduce from the seed
  and differ from step to step.
"""

import collections
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu.models.base import (
    write_prefill_pages as jax_write_prefill_pages,
)
from distributed_inference_engine_tpu_torch.config import EngineConfig
from distributed_inference_engine_tpu_torch.engine.continuous import (
    ContinuousEngine,
)
from distributed_inference_engine_tpu_torch.engine.paged_kv import (
    PagedKVCache,
)
from distributed_inference_engine_tpu_torch.engine.types import (
    GenerationRequest,
)
from distributed_inference_engine_tpu_torch.models.base import (
    init_params,
    pages_with_drop_row,
    write_pages_device,
    write_prefill_pages,
)
from distributed_inference_engine_tpu_torch.models.llama import llama_spec
from distributed_inference_engine_tpu_torch.ops import _cuda

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

L, N, P, HKV, DH = 2, 10, 4, 2, 4

# (label, page table rows, start, counts): row 0 and row 1 share page 1 as
# their first (full prefix) page, and write after it
WRITE_CASES = [
    ("counts of 0", [[1, 2, 3], [1, 4, 5], [6, 7, 8]], [4, 5, 0],
     [0, 0, 0]),
    ("page boundary", [[1, 2, 3], [1, 4, 5], [6, 7, 8]], [4, 6, 1],
     [3, 5, 6]),
    ("shared prefix", [[1, 2, 3], [1, 4, 5], [6, 7, 8]], [4, 4, 2],
     [1, 0, 4]),
    ("full window", [[9, 2, 3], [1, 4, 5], [6, 7, 8]], [0, 4, 4],
     [6, 6, 2]),
]


@pytest.mark.parametrize("label,table,start,counts", WRITE_CASES,
                         ids=[c[0] for c in WRITE_CASES])
def test_device_page_write_matches_jax(label, table, start, counts):
    """Pools and fresh K/V from numpy; the JAX scatter (``mode="drop"``)
    and the device write land the same bytes on every page (fp32: exact),
    the host write too; the shared page 1 and every page no row writes
    keep their bytes."""
    rs = np.random.RandomState(len(label))
    b, t = len(table), 6
    pools = rs.randn(2, L, N, P, HKV * DH).astype(np.float32)
    fresh = rs.randn(2, L, b, t, HKV, DH).astype(np.float32)
    table = np.asarray(table, np.int32)
    start = np.asarray(start, np.int32)
    counts = np.asarray(counts, np.int32)

    jk, jv = jax_write_prefill_pages(
        jnp.asarray(pools[0]), jnp.asarray(pools[1]), jnp.asarray(fresh[0]),
        jnp.asarray(fresh[1]), jnp.asarray(table), jnp.asarray(counts),
        jnp.asarray(start))
    want = np.stack([np.asarray(jax.device_get(jk)),
                     np.asarray(jax.device_get(jv))])

    kp, krows = pages_with_drop_row(pools[0].shape, torch.float32, "cpu")
    vp, vrows = pages_with_drop_row(pools[1].shape, torch.float32, "cpu")
    kp.copy_(torch.from_numpy(pools[0]))
    vp.copy_(torch.from_numpy(pools[1]))
    assert kp.data_ptr() == krows.data_ptr()
    assert krows.shape == (L * N * P + 1, HKV * DH)
    write_pages_device(krows, vrows, torch.from_numpy(fresh[0]),
                       torch.from_numpy(fresh[1]), torch.from_numpy(table),
                       torch.from_numpy(counts), torch.from_numpy(start), P)
    got = np.stack([kp.numpy(), vp.numpy()])
    np.testing.assert_array_equal(got, want)

    hk = torch.from_numpy(pools[0].copy())
    hv = torch.from_numpy(pools[1].copy())
    write_prefill_pages(hk, hv, torch.from_numpy(fresh[0]),
                        torch.from_numpy(fresh[1]), table, counts,
                        start=start)
    np.testing.assert_array_equal(np.stack([hk.numpy(), hv.numpy()]), want)

    written = {int(table[r, (s + i) // P]) for r in range(b)
               for s, c in [(start[r], counts[r])] for i in range(c)}
    for page in sorted(set(range(N)) - written):
        np.testing.assert_array_equal(got[:, :, page], pools[:, :, page])
    assert 1 not in written
    if not counts.any():
        np.testing.assert_array_equal(got, pools)


ENGINE_KW = dict(max_slots=4, max_seq_len=64, prefill_buckets=[16, 32],
                 page_size=8, num_pages=40, decode_steps_per_call=4,
                 kv_dtype="float32")


@pytest.fixture(scope="module")
def tiny():
    spec = llama_spec("llama-tiny", dtype="float32")
    params = init_params(spec, torch.Generator().manual_seed(0))
    return spec, params


def _prompts(seed, lens):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 1000, size=n).tolist() for n in lens]


def test_state_buffers_keep_their_addresses(tiny):
    """A ragged engine with chunked prefill: admissions (one mid-run),
    mixed steps, decode chunks, a stop-id request, ``max_new_tokens`` and
    capacity finishes and an abort leave every buffer a graph reads at its
    address."""
    spec, params = tiny
    eng = ContinuousEngine(spec, params=params, config=EngineConfig(
        attention_impl="pallas-ragged", prefill_chunk=16, **ENGINE_KW),
        device="cpu")
    bufs = dict(lengths=eng._lengths, last=eng._last, active=eng._active,
                produced=eng._produced, cap=eng._cap,
                table=eng.kv.page_table, k_pages=eng.kv.k_pages)
    ptrs = {k: v.data_ptr() for k, v in bufs.items()}

    def same():
        now = dict(lengths=eng._lengths, last=eng._last, active=eng._active,
                   produced=eng._produced, cap=eng._cap,
                   table=eng.kv.page_table, k_pages=eng.kv.k_pages)
        assert {k: v.data_ptr() for k, v in now.items()} == ptrs

    prompts = _prompts(1, (5, 40, 12, 60))
    for i, p in enumerate(prompts):
        eng.submit(GenerationRequest(
            prompt=p, max_new_tokens=(12 if i != 3 else 40),
            request_id=f"s{i}", stop_ids=[7] if i == 2 else None))
    steps = 0
    while eng.n_live or eng.n_waiting:
        eng.step()
        same()
        steps += 1
        if steps == 3:
            eng.submit(GenerationRequest(prompt=_prompts(2, (20,))[0],
                                         max_new_tokens=6, request_id="late"))
    m = eng.get_metrics()
    assert m["mixed_steps"] > 0 and m["decode_steps"] > 0
    assert m["chunked_admissions"] >= 2
    assert len(eng.drain_finished()) == 5
    eng.submit(GenerationRequest(prompt=prompts[1], max_new_tokens=30,
                                 request_id="aborted"))
    eng.step()
    assert eng.abort_all() == 1
    same()
    assert not bool(eng._active.any())


def test_decode_programs_count_the_distinct_keys(tiny):
    """Greedy, sampled with a top-k mask, and stop-id requests, and a
    capacity-shortened chunk near ``max_seq_len``: the engine's
    ``decode_programs`` is the number of distinct (n_steps, stops, mask,
    noise) keys its bodies ran with, at most ``decode_steps_per_call`` x
    8."""
    spec, params = tiny
    eng = ContinuousEngine(spec, params=params, config=EngineConfig(
        attention_impl="pallas-decode", **ENGINE_KW), device="cpu")
    seen = set()
    body = eng._decode_body

    def spy(n_steps, use_stops, needs_mask, needs_noise, table):
        seen.add((n_steps, use_stops, needs_mask, needs_noise))
        return body(n_steps, use_stops, needs_mask, needs_noise, table)

    eng._decode_body = spy
    prompts = _prompts(3, (10, 20, 30, 58))
    eng.generate([GenerationRequest(prompt=prompts[0], max_new_tokens=9,
                                    request_id="g")])
    eng.generate([GenerationRequest(prompt=prompts[1], max_new_tokens=9,
                                    temperature=0.8, top_k=5,
                                    request_id="s")])
    eng.generate([GenerationRequest(prompt=prompts[2], max_new_tokens=9,
                                    stop_ids=[3], request_id="x")])
    # 58 + 1 tokens in a 64-token cache: the chunk shortens to the grant
    res = eng.generate([GenerationRequest(prompt=prompts[3],
                                          max_new_tokens=20,
                                          request_id="cap")])
    assert res[0].finish_reason == "length"
    m = eng.get_metrics()
    assert {k[0] for k in seen} >= {4} and len({k[0] for k in seen}) >= 2
    assert any(k[2] and k[3] for k in seen) and any(k[1] for k in seen)
    assert m["decode_programs"] == len(seen)
    assert m["decode_programs"] <= ENGINE_KW["decode_steps_per_call"] * 8
    assert m["cuda_graphs"] == 0 and m["graph_warmup_launches"] == 0


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_adds_the_recorded_launches():
    """``recording_launches`` hands back what its block counted and
    leaves ``LAUNCHES`` as it was (a capture launches nothing); each
    ``CapturedGraph.replay`` adds that delta again."""
    saved = _cuda.LAUNCHES.copy()
    try:
        _cuda.reset_launch_counts()
        _cuda.count_launch(*["flash_decode"] * 3)
        with _cuda.recording_launches() as delta:
            _cuda.count_launch(*["flash_decode"] * 32)
            _cuda.count_launch(*["norm_matmul"] * 160)
        assert delta == collections.Counter(flash_decode=32,
                                            norm_matmul=160)
        assert _cuda.launch_counts() == {"flash_decode": 3}
        stub = _StubGraph()
        graph = _cuda.CapturedGraph(stub, delta, outputs="packed")
        for i in range(1, 4):
            assert graph.replay() == "packed"
            assert stub.replays == i
            assert _cuda.launch_counts() == {"flash_decode": 3 + 32 * i,
                                             "norm_matmul": 160 * i}
        with pytest.raises(RuntimeError):
            with _cuda.recording_launches():
                _cuda.count_launch("paged_attention")
                raise RuntimeError("capture failed")
        assert "paged_attention" not in _cuda.launch_counts()
    finally:
        _cuda.LAUNCHES.clear()
        _cuda.LAUNCHES.update(saved)


def test_scratch_is_released_only_with_no_graph_alive():
    """``release_scratch`` keeps the split scratch while any captured
    graph is alive (a replay writes into it) and frees it, retired
    buffers included, once none is."""
    import gc

    saved = dict(_cuda._SCRATCH), list(_cuda._RETIRED)
    try:
        _cuda._SCRATCH[(0, 1)] = (torch.empty(8), torch.zeros(2))
        _cuda._RETIRED.append(torch.empty(4))
        graph = _cuda.CapturedGraph(_StubGraph(), {}, outputs=None)
        assert _cuda.release_scratch() is False
        assert (0, 1) in _cuda._SCRATCH and _cuda._RETIRED
        del graph
        gc.collect()
        assert _cuda.release_scratch() is True
        assert not _cuda._SCRATCH and not _cuda._RETIRED
    finally:
        _cuda._SCRATCH.clear()
        _cuda._SCRATCH.update(saved[0])
        _cuda._RETIRED[:] = saved[1]


def test_recording_holds_its_own_thread_only():
    """A recording on one thread (a graph captured while a worker stages
    a model) takes none of the launches another thread counts meanwhile
    (the serving pump's): those reach ``LAUNCHES``, the recording keeps
    its own, and a replay inside a recording counts into it."""
    saved = _cuda.LAUNCHES.copy()
    try:
        _cuda.reset_launch_counts()
        inside = threading.Event()
        done = threading.Event()

        def other():
            inside.wait(5)
            _cuda.count_launch("flash_decode", "flash_decode")
            done.set()

        t = threading.Thread(target=other)
        t.start()
        with _cuda.recording_launches() as delta:
            _cuda.count_launch("int4_matmul", "int4_matmul.wgmma")
            inside.set()
            done.wait(5)
            with _cuda.recording_launches() as inner:
                _cuda.CapturedGraph(_StubGraph(), {"ragged_attention": 32},
                                    outputs=None).replay()
        t.join()
        assert delta == collections.Counter(
            {"int4_matmul": 1, "int4_matmul.wgmma": 1})
        assert inner == collections.Counter(ragged_attention=32)
        assert _cuda.launch_counts() == {"flash_decode": 2}
    finally:
        _cuda.LAUNCHES.clear()
        _cuda.LAUNCHES.update(saved)


@pytest.mark.parametrize("impl,chunk", [("pallas-decode", 0),
                                        ("pallas-ragged", 16)])
def test_sampled_runs_reproduce_from_the_seed(tiny, impl, chunk):
    """Two engines from one seed sample the same chains (decode chunks,
    and mixed steps while prompts prefill in chunks); another seed
    samples others; a chain's tokens vary from step to step."""
    spec, params = tiny
    prompts = _prompts(4, (6, 30, 45))

    def run(seed):
        eng = ContinuousEngine(spec, params=params, seed=seed,
                               config=EngineConfig(
                                   attention_impl=impl, prefill_chunk=chunk,
                                   **ENGINE_KW), device="cpu")
        out = eng.generate([GenerationRequest(
            prompt=p, max_new_tokens=12, temperature=1.5, top_p=0.95,
            request_id=f"r{i}") for i, p in enumerate(prompts)])
        if chunk:
            assert eng.get_metrics()["mixed_steps"] > 0
        return [r.tokens for r in out]

    a, b, c = run(5), run(5), run(6)
    assert a == b
    assert a != c
    assert all(len(set(toks)) > 3 for toks in a)


def test_mixed_bucket_inputs_round_trip(tiny):
    """The mixed step's one int32 input buffer per bucket: prefill rows'
    tokens, context, length, top-k, table and the bits of the float knobs
    round-trip to what the body reads (a sampled prefill row keeps its
    temperature, a pad row stays greedy with top_p 1)."""
    spec, params = tiny
    eng = ContinuousEngine(spec, params=params, config=EngineConfig(
        attention_impl="pallas-ragged", prefill_chunk=16, **ENGINE_KW),
        device="cpu")
    seen = []
    body = eng._mixed_body

    def spy(buf, qb, *rest):
        seen.append((buf.clone(), qb))
        return body(buf, qb, *rest)

    eng._mixed_body = spy
    prompt = _prompts(7, (40,))[0]
    eng.generate([GenerationRequest(prompt=prompt, max_new_tokens=3,
                                    temperature=0.7, top_k=4, top_p=0.9,
                                    min_p=0.05, request_id="m")])
    assert seen
    buf, qb = seen[0]
    mp = eng.kv.max_pages_per_seq
    assert buf.shape == (1, qb + 3 + mp + 3)
    assert buf[0, :qb].tolist() == prompt[16:16 + qb]
    assert buf[0, qb: qb + 3].tolist() == [16, 16, 4]
    knobs = buf[:, qb + 3 + mp:].contiguous().view(torch.float32)
    np.testing.assert_array_equal(knobs[0].numpy(),
                                  np.float32([0.7, 0.9, 0.05]))
    assert eng.get_metrics()["mixed_programs"] >= 1


def test_pools_carry_a_drop_row_and_one_table():
    """The page pools keep their drop row behind the last page: the
    cache's rows view holds one row more than its pages, on one storage."""
    spec = llama_spec("llama-tiny", dtype="float32")
    kv = PagedKVCache(spec, max_slots=2, page_size=8, num_pages=6,
                      max_seq_len=32, device="cpu")
    fused = spec.n_kv_heads * spec.head_dim
    assert kv.k_rows.shape == (spec.n_layers * 6 * 8 + 1, fused)
    assert kv.k_pages.data_ptr() == kv.k_rows.data_ptr()
    assert kv.v_pages.data_ptr() == kv.v_rows.data_ptr()
    kv.k_rows[-1] = 5.0
    assert float(kv.k_pages.abs().sum()) == 0.0
    t0 = kv.page_table
    slot = kv.alloc_slot(20)
    assert kv.page_table is t0 and kv.page_table[slot, :3].tolist() == \
        kv._table[slot, :3].tolist()
