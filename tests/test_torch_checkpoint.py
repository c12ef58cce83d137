"""The port's native checkpoints (``utils/checkpoint.py``: ``spec.json``
and ``params/params.safetensors``) against the JAX package's Orbax
checkpoints, and the int4 layout's repack (``ops/quant.py``).

Held: ``save_params``/``load_params`` bit-exact for fp32, bf16, int8 and
int4 trees (``QuantizedTensor`` nodes with their ``bits`` and
``pack_axis``); a JAX Orbax tree and the port's native tree of the same
weights equal through numpy; an int4 node saved without its layout
marker repacked once, equal to JAX's ``repack_int4_interleaved_to_split``;
a node without ``bits`` read as int8; a JAX Orbax directory refused by
``load_params`` and by the factory; an engine built from a native
directory emitting the tokens of an engine built on the tree it saved,
its sidecar's dtype ruling and ``max_seq_len`` clamped to it."""

import json

import jax
import numpy as np
import pytest
import torch

from distributed_inference_engine_tpu.models import base as jb
from distributed_inference_engine_tpu.models.llama import llama_spec as jspec
from distributed_inference_engine_tpu.ops import quant as jq
from distributed_inference_engine_tpu.utils import checkpoint as jck
from distributed_inference_engine_tpu_torch import models as tmodels
from distributed_inference_engine_tpu_torch.bridge import params_from_numpy
from distributed_inference_engine_tpu_torch.config import (
    EngineConfig,
    ModelConfig,
)
from distributed_inference_engine_tpu_torch.engine.continuous import (
    ContinuousEngine,
)
from distributed_inference_engine_tpu_torch.engine.types import (
    GenerationRequest,
)
from distributed_inference_engine_tpu_torch.models.base import init_params
from distributed_inference_engine_tpu_torch.models.llama import (
    llama_spec as tspec,
)
from distributed_inference_engine_tpu_torch.ops import quant as tq
from distributed_inference_engine_tpu_torch.utils import checkpoint as tck
from distributed_inference_engine_tpu_torch.utils import safetensors_io as sio
from tests.test_torch_loader import assert_trees_bit_equal

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

MODES = ["f32", "bf16", "int8", "int4"]


def _port_tree(mode, seed=0):
    """A llama-tiny tree of the port (drawn from ``seed``), quantized by
    the port for int8/int4."""
    spec = tspec("llama-tiny", max_seq_len=64,
                 dtype="bfloat16" if mode == "bf16" else "float32")
    params = init_params(spec, torch.Generator().manual_seed(seed))
    if mode in ("int8", "int4"):
        params = tq.quantize_params(spec, params,
                                    bits=4 if mode == "int4" else 8)
    return spec, params


def _jax_tree(mode, seed=0):
    spec = jspec("llama-tiny", max_seq_len=64,
                 dtype="bfloat16" if mode == "bf16" else "float32")
    params = jb.init_params(spec, jax.random.key(seed))
    if mode in ("int8", "int4"):
        params = jq.quantize_params(spec, params,
                                    bits=4 if mode == "int4" else 8)
    return spec, params


@pytest.mark.parametrize("mode", MODES)
def test_native_roundtrip_bitexact(tmp_path, mode):
    spec, params = _port_tree(mode)
    path = tck.save_params(str(tmp_path / "ck"), spec, params)
    assert tck.is_native_checkpoint(path)
    assert tck.load_spec(path).to_dict() == spec.to_dict()
    restored = tck.load_params(path, device="cpu")
    flat_a, flat_b = tck.flatten_tree(params), tck.flatten_tree(restored)
    assert sorted(flat_a) == sorted(flat_b)
    for k, a in flat_a.items():
        b = flat_b[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8)), k
    if mode in ("int8", "int4"):
        qt = restored["blocks"]["wq"]
        assert isinstance(qt, tq.QuantizedTensor)
        assert (qt.bits, qt.pack_axis) == (params["blocks"]["wq"].bits,
                                           params["blocks"]["wq"].pack_axis)
        assert isinstance(restored["lm_head"], tq.QuantizedTensor)


@pytest.mark.parametrize("mode", MODES)
def test_orbax_and_native_trees_of_the_same_weights_equal(tmp_path, mode):
    """The same JAX weights saved by the JAX package (Orbax) and, bridged,
    by the port (native) restore to the same bits."""
    js, jp = _jax_tree(mode, seed=2)
    ts = tspec("llama-tiny", max_seq_len=64, dtype=js.dtype)
    tp = params_from_numpy(jax.device_get(jp), ts, "cpu")
    jck.save_params(str(tmp_path / "orbax"), js, jp)
    tck.save_params(str(tmp_path / "native"), ts, tp)
    j_restored = jck.load_params(str(tmp_path / "orbax"))
    t_restored = tck.load_params(str(tmp_path / "native"), device="cpu")
    assert_trees_bit_equal(t_restored, j_restored)
    assert tck.load_spec(str(tmp_path / "native")).to_dict() == \
        jck.load_spec(str(tmp_path / "orbax")).to_dict()


def _interleave(split_q: np.ndarray, axis: int) -> np.ndarray:
    """Split-half int4 bytes -> the older even/odd interleave: unpack to
    values, then source ``2k`` in byte k's low nibble, ``2k+1`` high."""
    q = split_q.astype(np.int16)
    lo = ((q & 0xF) ^ 8) - 8
    hi = q >> 4
    full = np.concatenate([lo, hi], axis=axis)
    even = np.take(full, np.arange(0, full.shape[axis], 2), axis=axis)
    odd = np.take(full, np.arange(1, full.shape[axis], 2), axis=axis)
    return ((even & 0xF) | ((odd & 0xF) << 4)).astype(np.uint8).view(np.int8)


def test_int4_without_layout_is_repacked_once(tmp_path):
    """A native file whose int4 nodes carry no layout marker holds the
    older interleave: the restore repacks it once, to JAX's
    ``repack_int4_interleaved_to_split`` of the same bytes, which is the
    split-half payload it came from."""
    js, jp = _jax_tree("int4", seed=3)
    ts = tspec("llama-tiny", max_seq_len=64, dtype="float32")
    tp = params_from_numpy(jax.device_get(jp), ts, "cpu")
    flat = tck.flatten_tree(tp)
    old = {}
    for name in [k[: -len(".layout")] for k in flat if k.endswith(".layout")]:
        qt = tp["blocks"][name.split(".")[-1]] if name.startswith(
            "blocks.") else tp[name]
        axis = qt.pack_axis % qt.q.dim()
        inter = _interleave(qt.q.numpy(), axis)
        flat[name + ".q"] = torch.from_numpy(inter.copy())
        del flat[name + ".layout"]
        old[name] = (inter, qt)
    assert len(old) == 8          # seven block weights and the LM head
    path = tmp_path / "old"
    (path / tck.PARAMS_DIR).mkdir(parents=True)
    (path / tck.SPEC_FILE).write_text(json.dumps(ts.to_dict()))
    sio.save_file(flat, str(path / tck.PARAMS_DIR / tck.PARAMS_FILE))
    restored = tck.load_params(str(path), device="cpu")
    for name, (inter, qt) in old.items():
        got = (restored["blocks"][name.split(".")[-1]]
               if name.startswith("blocks.") else restored[name])
        want = jq.repack_int4_interleaved_to_split(jq.QuantizedTensor(
            q=jax.numpy.asarray(inter), s=jax.numpy.asarray(qt.s.numpy()),
            bits=4, pack_axis=qt.pack_axis))
        assert np.array_equal(got.q.numpy(), np.asarray(want.q)), name
        assert torch.equal(got.q, qt.q), name
        # and the port's repack alone is JAX's
        mine = tq.repack_int4_interleaved_to_split(tq.QuantizedTensor(
            q=torch.from_numpy(inter.copy()), s=qt.s, bits=4,
            pack_axis=qt.pack_axis))
        assert torch.equal(mine.q, qt.q), name


def test_node_without_bits_is_int8(tmp_path):
    spec, params = _port_tree("int8", seed=4)
    flat = tck.flatten_tree(params)
    for k in [k for k in flat if k.endswith(".bits")]:
        del flat[k]
    path = tmp_path / "nobits"
    (path / tck.PARAMS_DIR).mkdir(parents=True)
    (path / tck.SPEC_FILE).write_text(json.dumps(spec.to_dict()))
    sio.save_file(flat, str(path / tck.PARAMS_DIR / tck.PARAMS_FILE))
    restored = tck.load_params(str(path), device="cpu")
    assert restored["blocks"]["wq"].bits == 8
    assert torch.equal(restored["blocks"]["wq"].q, params["blocks"]["wq"].q)


def test_orbax_directory_is_refused(tmp_path):
    js, jp = _jax_tree("f32", seed=5)
    path = jck.save_params(str(tmp_path / "orbax"), js, jp)
    assert jck.is_native_checkpoint(path)
    assert not tck.is_native_checkpoint(path)
    with pytest.raises(ValueError, match="Orbax"):
        tck.load_params(path, device="cpu")
    with pytest.raises(ValueError, match="Orbax"):
        tmodels.engine_from_config(ModelConfig(
            name="m", architecture="llama", path=path, dtype="float32",
            max_seq_len=64, metadata={"continuous": True}), device="cpu")


def _greedy(engine, prompts, n=6):
    return [r.tokens for r in engine.generate(
        [GenerationRequest(prompt=p, max_new_tokens=n) for p in prompts])]


KW = dict(page_size=16, num_pages=32, prefill_buckets=[16, 32])


@pytest.mark.parametrize("mode", ["f32", "int4"])
def test_engine_from_native_checkpoint_reproduces_outputs(tmp_path, mode):
    """A native directory through the factory: the sidecar's spec (its
    dtype over the config's; ``max_seq_len`` clamped to it), the stored
    tree as saved (an int4 tree with ``quantized=1`` is not quantized
    again), and the tokens of an engine on the tree it saved."""
    spec, params = _port_tree(mode, seed=6)
    path = tck.save_params(str(tmp_path / "ck"), spec, params)
    ref = ContinuousEngine(spec, params=params, config=EngineConfig(
        max_slots=2, max_seq_len=64, **KW), device="cpu")
    rs = np.random.RandomState(7)
    prompts = [rs.randint(1, 1024, size=n).tolist() for n in (3, 12, 25)]
    eng = tmodels.engine_from_config(ModelConfig(
        name="m", architecture="llama", path=path, dtype="bfloat16",
        max_seq_len=4096, max_batch_size=2, quantized=(mode == "int4"),
        metadata={"continuous": True, "weight_bits": 4,
                  **{k: str(v) if isinstance(v, int) else json.dumps(v)
                     for k, v in KW.items()}}), device="cpu")
    assert eng.load_info["source"] == "native"
    assert eng.spec.dtype == "float32" and eng.spec.max_seq_len == 64
    if mode == "int4":
        assert torch.equal(eng.params["blocks"]["w_qkv"].q,
                           ref.params["blocks"]["w_qkv"].q)
    assert _greedy(eng, prompts) == _greedy(ref, prompts)
