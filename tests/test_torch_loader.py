"""The port's HF checkpoint path against the JAX package: its own
safetensors reader and writer (``utils/safetensors_io.py``) against the
``safetensors`` package in both directions, ``spec_from_hf_config`` and
``load_checkpoint`` (``models/loader.py``) against the JAX loader on the
same files, and an engine built from an HF directory by the factory
against the JAX engine built from the same directory.

Checkpoints are synthetic (nothing is downloaded): tiny HF-named trees
drawn from a numpy seed, in fp32 and bf16 files, with and without the
``model.`` prefix, tied (Gemma) and untied with and without ``lm_head``,
Qwen2's q/k/v biases, GPT-2 (with and without ``transformer.``), and a
sharded directory with its index file. Held: every loaded leaf bit-equal
to ``jax.device_get`` of the JAX loader's (the fp32-to-bf16 casts
included), every spec's ``to_dict`` equal to JAX's, and the engine's
greedy tokens equal to the JAX engine's in fp32 and inside the JAX
reference's tie band (``utils/parity.py``) in bf16 and int4."""

import json
import struct

import jax
import ml_dtypes
import numpy as np
import pytest
import safetensors.numpy as stnp
import safetensors.torch as stt
import torch

from distributed_inference_engine_tpu import models as jmodels
from distributed_inference_engine_tpu.config import ModelConfig as JModel
from distributed_inference_engine_tpu.engine.types import (
    GenerationRequest as JReq,
)
from distributed_inference_engine_tpu.models import base as jb
from distributed_inference_engine_tpu.models import loader as jl
from distributed_inference_engine_tpu.ops import quant as jq
from distributed_inference_engine_tpu.utils.parity import (
    assert_greedy_parity,
)
from distributed_inference_engine_tpu_torch import models as tmodels
from distributed_inference_engine_tpu_torch.bridge import (
    params_from_numpy,
    tensor_from_numpy,
    tensor_to_numpy,
)
from distributed_inference_engine_tpu_torch.config import ModelConfig
from distributed_inference_engine_tpu_torch.engine.types import (
    GenerationRequest,
)
from distributed_inference_engine_tpu_torch.models import loader as tl
from distributed_inference_engine_tpu_torch.models.base import ModelSpec
from distributed_inference_engine_tpu_torch.ops.quant import QuantizedTensor
from distributed_inference_engine_tpu_torch.utils import safetensors_io as sio

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

# numpy dtype of each safetensors name safetensors.numpy takes (fp8: the
# package's numpy side has no fp8 dtype here; its torch side is used)
NP_DTYPES = {"F32": np.float32, "F16": np.float16,
             "BF16": ml_dtypes.bfloat16, "I8": np.int8, "U8": np.uint8,
             "I32": np.int32, "I64": np.int64}
SHAPES = [(3, 5), (7,), (), (0, 4), (2, 3, 4)]


def _array(rs, name, shape):
    dt = NP_DTYPES[name]
    if np.issubdtype(np.dtype(dt), np.integer):
        info = np.iinfo(dt)
        return rs.randint(max(info.min, -1000), min(info.max, 1000),
                          size=shape).astype(dt)
    x = (np.asarray(rs.randn(*shape)) * 3).astype(np.float32)
    return np.asarray(x.astype(dt)).reshape(shape)


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = tensor_to_numpy(x)
    return np.ascontiguousarray(x).tobytes()


# ----------------------------------------------------- reader and writer

@pytest.mark.parametrize("dtype", sorted(NP_DTYPES))
def test_reader_reads_what_safetensors_writes(tmp_path, dtype):
    rs = np.random.RandomState(1)
    arrs = {f"t{i}": _array(rs, dtype, s) for i, s in enumerate(SHAPES)}
    path = str(tmp_path / "a.safetensors")
    stnp.save_file(arrs, path, metadata={"format": "np", "note": "x"})
    header, start = sio.read_header(path)
    assert header["__metadata__"] == {"format": "np", "note": "x"}
    assert start % 8 == 0 and {header[k]["dtype"] for k in arrs} == {dtype}
    got = sio.load_file(path, device="cpu")
    assert sorted(got) == sorted(arrs)
    for k, a in arrs.items():
        assert got[k].dtype == sio.DTYPES[dtype]
        assert tuple(got[k].shape) == a.shape
        assert _bytes(got[k]) == _bytes(a), k
    with sio.SafetensorsFile(path) as f:
        assert f.metadata == {"format": "np", "note": "x"}
        assert f.keys() == sorted(arrs)


@pytest.mark.parametrize("dtype", sorted(NP_DTYPES))
def test_safetensors_reads_what_the_writer_writes(tmp_path, dtype):
    from safetensors import safe_open

    rs = np.random.RandomState(2)
    arrs = {f"t{i}": _array(rs, dtype, s) for i, s in enumerate(SHAPES)}
    # a transposed view too: the writer takes views
    mats = {k: tensor_from_numpy(a, "cpu") for k, a in arrs.items()}
    mats["view"] = tensor_from_numpy(_array(rs, dtype, (4, 6)), "cpu").t()
    path = str(tmp_path / "b.safetensors")
    sio.save_file(mats, path, metadata={"format": "pt"})
    back = stnp.load_file(path)
    assert sorted(back) == sorted(mats)
    for k, t in mats.items():
        assert back[k].shape == tuple(t.shape)
        assert _bytes(back[k]) == _bytes(t.contiguous()), k
    with safe_open(path, framework="numpy") as f:
        assert f.metadata() == {"format": "pt"}


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2],
                         ids=["e4m3", "e5m2"])
def test_fp8_both_ways_against_safetensors(tmp_path, dtype):
    """e4m3 and e5m2, every byte pattern, through the package's torch side
    (its numpy side has no fp8 dtype) in both directions."""
    patterns = torch.arange(256, dtype=torch.uint8).view(dtype)
    t = {"all": patterns, "mat": patterns.reshape(16, 16).t()}
    a, b = str(tmp_path / "a.safetensors"), str(tmp_path / "b.safetensors")
    stt.save_file({k: v.contiguous() for k, v in t.items()}, a)
    got = sio.load_file(a, device="cpu")
    sio.save_file(t, b)
    back = stt.load_file(b)
    for k, v in t.items():
        want = v.contiguous().view(torch.uint8)
        assert got[k].dtype == back[k].dtype == dtype
        assert torch.equal(got[k].view(torch.uint8), want)
        assert torch.equal(back[k].view(torch.uint8), want)


def test_reader_refuses_truncated_and_malformed_files(tmp_path):
    path = tmp_path / "c.safetensors"
    stnp.save_file({"w": np.ones((64, 64), np.float32)}, str(path))
    blob = path.read_bytes()
    path.write_bytes(blob[:-1])
    with pytest.raises(ValueError, match="truncated"):
        sio.load_file(str(path), device="cpu")
    path.write_bytes(blob[:6])
    with pytest.raises(ValueError):
        sio.read_header(str(path))
    path.write_bytes(struct.pack("<Q", 5) + b"{nope")
    with pytest.raises(ValueError, match="JSON"):
        sio.read_header(str(path))
    bad = json.dumps({"w": {"dtype": "F32", "shape": [4],
                            "data_offsets": [0, 12]}}).encode()
    path.write_bytes(struct.pack("<Q", len(bad)) + bad + bytes(16))
    with pytest.raises(ValueError, match="spans"):
        sio.load_file(str(path), device="cpu")


# ------------------------------------------------------ spec_from_hf_config

_LLAMA = {"model_type": "llama", "architectures": ["LlamaForCausalLM"],
          "vocab_size": 128256, "hidden_size": 4096,
          "num_hidden_layers": 32, "num_attention_heads": 32,
          "num_key_value_heads": 8, "intermediate_size": 14336,
          "max_position_embeddings": 8192, "rope_theta": 500000.0,
          "rms_norm_eps": 1e-5}
HF_CONFIGS = {
    "llama": _LLAMA,
    "llama-by-architecture": {k: v for k, v in _LLAMA.items()
                              if k != "model_type"},
    "mistral": {**_LLAMA, "model_type": "mistral",
                "architectures": ["MistralForCausalLM"], "vocab_size": 32000,
                "intermediate_size": 14336, "max_position_embeddings": 32768,
                "rope_theta": 10000.0, "sliding_window": 4096},
    "qwen2": {"model_type": "qwen2", "architectures": ["Qwen2ForCausalLM"],
              "vocab_size": 152064, "hidden_size": 3584,
              "num_hidden_layers": 28, "num_attention_heads": 28,
              "num_key_value_heads": 4, "intermediate_size": 18944,
              "max_position_embeddings": 32768, "rope_theta": 1e6,
              "rms_norm_eps": 1e-6, "tie_word_embeddings": False},
    "gemma": {"model_type": "gemma", "architectures": ["GemmaForCausalLM"],
              "vocab_size": 256000, "hidden_size": 3072,
              "num_hidden_layers": 28, "num_attention_heads": 16,
              "num_key_value_heads": 16, "head_dim": 256,
              "intermediate_size": 24576, "max_position_embeddings": 8192,
              "rms_norm_eps": 1e-6},
    "gpt2": {"model_type": "gpt2", "architectures": ["GPT2LMHeadModel"],
             "vocab_size": 50257, "n_embd": 768, "n_layer": 12,
             "n_head": 12, "n_positions": 1024},
}


@pytest.mark.parametrize("family", sorted(HF_CONFIGS))
def test_spec_from_hf_config_matches_jax(tmp_path, family):
    (tmp_path / "config.json").write_text(json.dumps(HF_CONFIGS[family]))
    want = jl.spec_from_hf_config(str(tmp_path)).to_dict()
    assert tl.spec_from_hf_config(str(tmp_path)).to_dict() == want
    assert tl.spec_from_hf_config("", cfg=HF_CONFIGS[family]).to_dict() \
        == want


@pytest.mark.parametrize("model_type,arch", [
    ("gemma2", "Gemma2ForCausalLM"), ("qwen3", "Qwen3ForCausalLM"),
    ("llama4", "Llama4ForCausalLM")])
def test_near_miss_relatives_raise_as_in_jax(model_type, arch):
    cfg = {**_LLAMA, "model_type": model_type, "architectures": [arch]}
    with pytest.raises(ValueError, match="unsupported architecture"):
        jl.spec_from_hf_config("", cfg=cfg)
    with pytest.raises(ValueError, match="unsupported architecture"):
        tl.spec_from_hf_config("", cfg=cfg)


def test_mixtral_raises_naming_a9(tmp_path):
    """Mixtral (A9) no longer raises: its HF config gives JAX's spec, and
    a checkpoint with expert tensors takes the Mixtral mapping, which
    names the first tensor it misses (the full load against JAX:
    ``tests/test_torch_moe.py``)."""
    cfg = {**_LLAMA, "model_type": "mixtral",
           "architectures": ["MixtralForCausalLM"], "num_local_experts": 8}
    want = jl.spec_from_hf_config("", cfg=cfg)
    assert tl.spec_from_hf_config("", cfg=cfg).to_dict() == want.to_dict()
    assert (want.n_experts, want.experts_per_token) == (8, 2)
    stnp.save_file({"model.embed_tokens.weight": np.ones((4, 4), np.float32),
                    "model.layers.0.block_sparse_moe.gate.weight":
                        np.ones((2, 4), np.float32)},
                   str(tmp_path / "model.safetensors"))
    spec = tmodels.spec_for_architecture("mixtral", "mixtral-tiny")
    with pytest.raises(KeyError, match="input_layernorm"):
        tl.load_checkpoint(str(tmp_path), spec, device="cpu")


# ---------------------------------------------------------- load_checkpoint

def _tiny_llama_config(**over):
    # n_kv_heads * head_dim = 128 (the JAX paged cache's rule)
    cfg = {"model_type": "llama", "architectures": ["LlamaForCausalLM"],
           "vocab_size": 300, "hidden_size": 128, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 4,
           "intermediate_size": 96, "max_position_embeddings": 64,
           "rope_theta": 10000.0, "rms_norm_eps": 1e-5}
    cfg.update(over)
    return cfg


FAMILY_CONFIGS = {
    "llama": _tiny_llama_config(),
    "mistral": _tiny_llama_config(model_type="mistral",
                                  architectures=["MistralForCausalLM"],
                                  sliding_window=16),
    "qwen2": _tiny_llama_config(model_type="qwen2",
                                architectures=["Qwen2ForCausalLM"],
                                num_attention_heads=14,
                                num_key_value_heads=2, hidden_size=112,
                                head_dim=64),
    "gemma": _tiny_llama_config(model_type="gemma",
                                architectures=["GemmaForCausalLM"],
                                num_attention_heads=4, num_key_value_heads=1,
                                head_dim=128),
}


def write_hf_llama(path, cfg, *, dtype=np.float32, prefix="model.",
                   lm_head=True, seed=0, shards=1):
    """An HF Llama-named checkpoint of ``cfg``'s widths (Qwen2 with q/k/v
    biases, Gemma tied: no ``lm_head``), drawn from ``seed``, split into
    ``shards`` files with an index, plus ``config.json``."""
    rs = np.random.RandomState(seed)
    D, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh = cfg.get("head_dim") or D // H

    def w(*shape):
        return (rs.randn(*shape) * 0.05).astype(np.float32).astype(dtype)

    raw = {prefix + "embed_tokens.weight": w(V, D),
           prefix + "norm.weight": (1 + w(D)).astype(dtype)}
    for layer in range(cfg["num_hidden_layers"]):
        p = f"{prefix}layers.{layer}."
        raw[p + "input_layernorm.weight"] = (1 + w(D)).astype(dtype)
        raw[p + "post_attention_layernorm.weight"] = (1 + w(D)).astype(dtype)
        for n, shape in (("q", (H * Dh, D)), ("k", (Hkv * Dh, D)),
                         ("v", (Hkv * Dh, D))):
            raw[p + f"self_attn.{n}_proj.weight"] = w(*shape)
            if cfg["model_type"] == "qwen2":
                raw[p + f"self_attn.{n}_proj.bias"] = w(shape[0])
        raw[p + "self_attn.o_proj.weight"] = w(D, H * Dh)
        raw[p + "mlp.gate_proj.weight"] = w(F, D)
        raw[p + "mlp.up_proj.weight"] = w(F, D)
        raw[p + "mlp.down_proj.weight"] = w(D, F)
    if lm_head and cfg["model_type"] != "gemma":
        raw["lm_head.weight"] = w(V, D)
    names = sorted(raw)
    weight_map = {}
    for i in range(shards):
        fname = (f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
                 if shards > 1 else "model.safetensors")
        part = names[i::shards]
        stnp.save_file({k: raw[k] for k in part}, str(path / fname),
                       metadata={"format": "pt"})
        weight_map.update({k: fname for k in part})
    if shards > 1:
        (path / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {"total_size": 0}, "weight_map": weight_map}))
    (path / "config.json").write_text(json.dumps(cfg))
    return raw


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (QuantizedTensor, jq.QuantizedTensor)):
        yield prefix + ".q", tree.q
        yield prefix + ".s", tree.s
    else:
        yield prefix, tree


def assert_trees_bit_equal(port_tree, jax_tree):
    """Same paths, dtypes, shapes and bytes (the JAX tree through
    ``jax.device_get``; bf16 compared as its bits)."""
    a = dict(_leaves(port_tree))
    b = dict(_leaves(jax.device_get(jax_tree)))
    assert sorted(a) == sorted(b)
    for k in a:
        want = np.asarray(b[k])
        got = tensor_to_numpy(a[k])
        assert got.shape == want.shape, k
        assert got.dtype.itemsize == want.dtype.itemsize, k
        assert str(a[k].dtype).split(".")[-1] == want.dtype.name, k
        assert got.tobytes() == np.ascontiguousarray(want).tobytes(), k


def _both_specs(path, dtype):
    js = jl.spec_from_hf_config(str(path)).replace(dtype=dtype)
    ts = tl.spec_from_hf_config(str(path)).replace(dtype=dtype)
    assert js.to_dict() == ts.to_dict()
    return js, ts


@pytest.mark.parametrize("case", [
    "llama-f32-prefixed", "llama-bf16-unprefixed", "llama-f32-to-bf16",
    "mistral-no-lm-head", "qwen2-biases", "gemma-tied-bf16",
    "llama-sharded-index"])
def test_load_checkpoint_bit_equal_to_jax(tmp_path, case):
    family = case.split("-")[0]
    kw = dict(prefix="" if "unprefixed" in case else "model.",
              lm_head="no-lm-head" not in case,
              shards=3 if "sharded" in case else 1,
              dtype=(ml_dtypes.bfloat16 if "bf16-" in case else np.float32))
    raw = write_hf_llama(tmp_path, FAMILY_CONFIGS[family], **kw)
    dtype = "bfloat16" if "bf16" in case else "float32"
    js, ts = _both_specs(tmp_path, dtype)
    want = jl.load_checkpoint(str(tmp_path), js)
    stats = {}
    got = tl.load_checkpoint(str(tmp_path), ts, device="cpu", stats=stats)
    assert_trees_bit_equal(got, want)
    # every tensor read once; an absent untied head reads the embedding
    # a second time
    emb = raw[kw["prefix"] + "embed_tokens.weight"].nbytes
    assert stats["bytes_read"] == sum(a.nbytes for a in raw.values()) + (
        emb if "no-lm-head" in case else 0)
    if "no-lm-head" in case:
        assert torch.equal(got["lm_head"], got["tok_emb"].t())
    if family == "gemma":
        assert "lm_head" not in got


def _gpt2_spec(dtype="float32"):
    return jb.ModelSpec(
        vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
        d_ff=128, max_seq_len=32, pos_emb="learned", norm="layernorm",
        mlp="gelu", use_bias=True, tie_embeddings=True, dtype=dtype)


@pytest.mark.parametrize("prefix", ["", "transformer."])
def test_gpt2_from_jax_writer_bit_equal(tmp_path, prefix):
    """JAX ``save_checkpoint_gpt2`` into the port's loader (and the
    ``transformer.``-prefixed naming of HF's own files), against the JAX
    loader on the same file, fp32 and cast to bf16."""
    js = _gpt2_spec()
    jp = jb.init_params(js, jax.random.key(3))
    jl.save_checkpoint_gpt2(str(tmp_path), jp, js)
    if prefix:
        f = tmp_path / "model.safetensors"
        raw = stnp.load_file(str(f))
        stnp.save_file({prefix + k: v for k, v in raw.items()}, str(f))
    for dtype in ("float32", "bfloat16"):
        want = jl.load_checkpoint(str(tmp_path), js.replace(dtype=dtype))
        ts = ModelSpec(**{**js.to_dict(), "dtype": dtype}).validate()
        got = tl.load_checkpoint(str(tmp_path), ts, device="cpu")
        assert_trees_bit_equal(got, want)


def test_gpt2_writer_into_jax_loader(tmp_path):
    """The port's ``save_checkpoint_gpt2`` read back by the JAX loader:
    the tree it wrote, bit for bit."""
    js = _gpt2_spec()
    ts = ModelSpec(**js.to_dict()).validate()
    tp = params_from_numpy(jax.device_get(
        jb.init_params(js, jax.random.key(4))), ts, "cpu")
    tl.save_checkpoint_gpt2(str(tmp_path), tp, ts)
    assert_trees_bit_equal(tp, jl.load_checkpoint(str(tmp_path), js))
    assert_trees_bit_equal(tl.load_checkpoint(str(tmp_path), ts,
                                              device="cpu"),
                           jl.load_checkpoint(str(tmp_path), js))


def test_missing_layer_tensor_raises(tmp_path):
    raw = write_hf_llama(tmp_path, FAMILY_CONFIGS["llama"])
    del raw["model.layers.1.mlp.up_proj.weight"]
    stnp.save_file(raw, str(tmp_path / "model.safetensors"))
    ts = tl.spec_from_hf_config(str(tmp_path))
    with pytest.raises(KeyError, match="layers.1.mlp.up_proj"):
        tl.load_checkpoint(str(tmp_path), ts, device="cpu")


# ------------------------------------------- an engine from an HF directory

ENGINE_META = {"continuous": True, "page_size": 16, "num_pages": 32,
               "decode_steps_per_call": 4, "prefill_buckets": [16, 32]}


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int4"])
def test_engine_from_hf_dir_emits_the_jax_engines_tokens(tmp_path, mode):
    """``engine_from_config(ModelConfig(path=<HF dir>, continuous=1))``
    against the JAX factory on the same directory (XLA attention): fp32
    tokens equal; bf16 and int4 (``quantized=1,weight_bits=4``, fp32
    activations) held teacher-forced to the JAX reference's logits on the
    JAX loader's tree, as the JAX engine's own tokens are."""
    write_hf_llama(tmp_path, FAMILY_CONFIGS["llama"], seed=5)
    dtype = "bfloat16" if mode == "bfloat16" else "float32"
    quant = mode == "int4"
    md = dict(ENGINE_META, **({"weight_bits": 4} if quant else {}))
    common = dict(name="m", architecture="llama", path=str(tmp_path),
                  dtype=dtype, max_seq_len=64, max_batch_size=4,
                  quantized=quant)
    jeng = jmodels.engine_from_config(JModel(
        **common, metadata=dict(md, attention_impl="xla")))
    teng = tmodels.engine_from_config(ModelConfig(
        **common, metadata=dict(md, attention_impl="pallas-decode")),
        device="cpu")
    assert teng.load_info["source"] == "hf"
    rs = np.random.RandomState(6)
    prompts = [rs.randint(1, 300, size=n).tolist() for n in (5, 17, 30)]
    want = jeng.generate([JReq(prompt=p, max_new_tokens=8) for p in prompts])
    got = teng.generate([GenerationRequest(prompt=p, max_new_tokens=8)
                         for p in prompts])
    js = jl.spec_from_hf_config(str(tmp_path)).replace(dtype=dtype,
                                                       max_seq_len=64)
    jp = jl.load_checkpoint(str(tmp_path), js)
    if quant:
        jp = jq.quantize_params(js, jp, bits=4)
    eps = 5e-2 if dtype == "bfloat16" else 5e-3
    for p, w, g in zip(prompts, want, got):
        assert len(g.tokens) == len(w.tokens) == 8
        if mode == "float32":
            assert g.tokens == w.tokens
        assert_greedy_parity(js, jp, p, g.tokens, eps=eps, min_matched=2,
                             label=f"port {mode}")
        assert_greedy_parity(js, jp, p, w.tokens, eps=eps, min_matched=2,
                             label=f"jax {mode}")
