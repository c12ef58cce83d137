"""fp8 (e4m3 and e5m2) KV pools in the port (CPU) against the JAX package:
the counterpart of ``tests/test_fp8_kv.py``. Every case runs over both
pool dtypes, ``float8_e4m3fn`` and ``float8_e5m2`` (ids ``e4m3``,
``e5m2``).

- The cast: ``ops/attention.py:astype_kv`` is bit-equal to JAX's
  ``astype`` into either dtype on all 65,536 bf16 patterns and on 1e6
  seeded fp32 values with ±inf and NaN (e4m3: overflow past 464 to NaN,
  where torch's own cast saturates to ±448; e5m2: ±inf from 61,440, as
  torch, and JAX's NaN bytes, 0x7E with the sign from fp32 and 0x7F from
  any bf16 NaN, where torch writes 0x7F/0xFF), e5m2's subnormals and its
  largest values included.
- The plain versions of the four kernels that take fp8 pools, on the same
  fp8 bytes (from a numpy seed) as ``paged_attention_xla``,
  ``flash_decode_attention_xla`` (with the fw variant's one-hot side write)
  and ``ragged_attention_xla``: fp32 q within 1e-5, bf16 q within 2e-2 (the
  bf16 tolerance of the other files), written pool bytes and side windows
  byte-equal, fresh K/V past 464 (past 61,440 for e5m2) included, and the
  rows that see a NaN or an infinite key NaN or ±inf in both.
- The engine: greedy tokens equal to the JAX ``ContinuousEngine`` with
  the fp8 ``kv_dtype`` on each path, against the JAX engine that
  rounds where the port's path does (the window scheme, fw and deferred
  admission against JAX's ``pallas_interpret`` engine, whose side window
  stays in the compute dtype; the inline decode, int4 weights and
  Mistral past its window against its XLA engine), with the window and
  mixed-step chains also teacher-forced through the JAX
  ``assert_greedy_parity``. Logprobs within 1e-3: the same fp32 value a
  few ulps apart in two frameworks can round to neighbouring e4m3 values
  (6% apart; e5m2's 12.5-25%), which moves a logprob by more than fp32
  noise. The ragged
  mixed step rounds its fresh K/V before attending, which no JAX engine
  runs off the TPU: its tokens are held to the JAX XLA engine (whose dense
  decode rounds each step too), its logprobs within 1e-2, and its layer
  step to the JAX ``forward_mixed_step(attn_impl="xla")``.
- ``hbm_bytes`` half of bf16's, one-byte pools, ``get_stats`` keys equal to
  JAX's; the worker loads ``kv_dtype`` from metadata and serves the JAX
  engine's tokens.
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
from distributed_inference_engine_tpu.engine.paged_kv import (
    PagedKVCache as JPagedKVCache,
)
from distributed_inference_engine_tpu.engine.types import (
    GenerationRequest as JReq,
)
from distributed_inference_engine_tpu.models import base as jb
from distributed_inference_engine_tpu.models.llama import llama_spec as jspec
from distributed_inference_engine_tpu.models.mistral import (
    mistral_spec as jmspec,
)
from distributed_inference_engine_tpu.ops import quant as jq
from distributed_inference_engine_tpu.ops.flash_decode import (
    flash_decode_attention_xla,
)
from distributed_inference_engine_tpu.ops.paged_attention import (
    paged_attention_xla as j_paged,
)
from distributed_inference_engine_tpu.ops.ragged_attention import (
    ragged_attention_xla,
)
from distributed_inference_engine_tpu.utils.parity import (
    assert_greedy_parity,
)
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
from distributed_inference_engine_tpu_torch.engine.paged_kv import (
    PagedKVCache,
)
from distributed_inference_engine_tpu_torch.engine.types import (
    GenerationRequest,
)
from distributed_inference_engine_tpu_torch.models import (
    base as tb,
    engine_from_config,
)
from distributed_inference_engine_tpu_torch.models.llama import (
    llama_spec as tspec,
)
from distributed_inference_engine_tpu_torch.models.mistral import (
    mistral_spec as tmspec,
)
from distributed_inference_engine_tpu_torch.ops import _cuda
from distributed_inference_engine_tpu_torch.ops.attention import (
    E5M2,
    astype_kv,
)
from distributed_inference_engine_tpu_torch.ops.flash_decode import (
    flash_decode_attention,
    flash_decode_attention_fw,
)
from distributed_inference_engine_tpu_torch.ops.paged_attention import (
    paged_attention,
)
from distributed_inference_engine_tpu_torch.ops.ragged_attention import (
    ragged_attention,
    ragged_instance,
)

pytestmark = pytest.mark.torch_port

# xdist runs several workers on the host's cores: one intra-op thread a
# worker keeps OpenMP's waiting threads from starving the others
torch.set_num_threads(1)

FP8 = "float8_e4m3fn"
# the pool dtypes every case runs over, and their torch dtypes
KV8 = ["float8_e4m3fn", "float8_e5m2"]
KV8_IDS = ["e4m3", "e5m2"]
TORCH8 = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": E5M2}
# a scale of fresh K/V that overflows part of it: past 464 (e4m3: NaN
# bytes), past 61,440 (e5m2: ±inf)
PAST = {"float8_e4m3fn": 300.0, "float8_e5m2": 3e4}
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
LP_ATOL = 1e-3
kv8 = pytest.mark.parametrize("kv", KV8, ids=KV8_IDS)


def _t(a):
    return bridge.tensor_from_numpy(np.asarray(a), "cpu")


def _f32(x):
    if hasattr(x, "detach"):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bytes(x):
    """The raw bytes of a port tensor or a JAX/numpy array."""
    if hasattr(x, "detach"):
        return bridge.tensor_to_numpy(x).view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _cast(a, dtype):
    return np.asarray(jnp.asarray(a, dtype))


# ------------------------------------------------------------------ cast


def _jax_bytes(x, kv=FP8):
    return np.asarray(jnp.asarray(x).astype(kv)).view(np.uint8)


@kv8
def test_cast_matches_jax_on_every_bf16_pattern(kv):
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    jx = jnp.asarray(bits).view(jnp.bfloat16)
    tx = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    got = astype_kv(tx, TORCH8[kv]).view(torch.uint8).numpy()
    want = _jax_bytes(jx, kv)
    assert np.array_equal(got, want)
    # torch's own cast saturates e4m3's overflows and writes 0xFF for
    # e5m2's negative NaNs: the cast exists for them
    own = tx.to(TORCH8[kv]).view(torch.uint8).numpy()
    assert not np.array_equal(own, want)
    if kv != FP8:
        differ = np.nonzero(own != want)[0]
        assert (differ.min(), differ.max(), len(differ)) == (
            0xFF81, 0xFFFF, 127)
        assert set(want[differ]) == {0x7F}


# values on e5m2's edges: its largest finite value, the last value below
# the overflow, the overflow (±61,440), its subnormals, and values that
# round to them or to 0
E5M2_EDGES = [57344.0, 61439.0, 61440.0, -61440.0, 65504.0, 2.0 ** -16,
              2.0 ** -17, 3 * 2.0 ** -18, 2.0 ** -15 * 1.5, 2.0 ** -18]


@kv8
def test_cast_matches_jax_on_seeded_fp32(kv):
    rs = np.random.RandomState(0)
    scales = ([0.01, 1.0, 60.0, 400.0] if kv == FP8
              else [1e-4, 0.01, 1.0, 400.0, 3e4, 6e4])
    x = (rs.randn(1_000_000) * rs.choice(scales, 1_000_000)).astype(
        np.float32)
    edges = [np.inf, -np.inf, np.nan, -np.nan] + (
        [464.0, -464.0, 464.00003, 448.0] if kv == FP8 else E5M2_EDGES)
    x[:len(edges)] = edges
    got = astype_kv(torch.from_numpy(x), TORCH8[kv])
    assert np.array_equal(got.view(torch.uint8).numpy(), _jax_bytes(x, kv))
    limit = 464 if kv == FP8 else 61440
    assert (np.abs(x) >= limit).sum() > 1000          # overflows were drawn


@kv8
def test_cast_matches_jax_on_specials_from_both_dtypes(kv):
    """±inf and NaN of both signs (and NaN payloads), from fp32 and from
    bf16: JAX's bytes; over e5m2 they differ from torch's own cast."""
    f32 = np.array([0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
                    0x7F800001, 0xFFFFFFFF], np.uint32).view(np.float32)
    bf = np.array([0x7F80, 0xFF80, 0x7FC0, 0xFFC0, 0x7F81, 0xFFFF],
                  np.uint16)
    tf = torch.from_numpy(f32.copy())
    tb_ = torch.from_numpy(bf.view(np.int16).copy()).view(torch.bfloat16)
    for x, want in ((tf, _jax_bytes(f32, kv)),
                    (tb_, _jax_bytes(jnp.asarray(bf).view(jnp.bfloat16),
                                     kv))):
        got = astype_kv(x, TORCH8[kv]).view(torch.uint8).numpy()
        assert np.array_equal(got, want), (x.dtype, got, want)
        if kv != FP8:
            assert not np.array_equal(
                x.to(TORCH8[kv]).view(torch.uint8).numpy(), want)


@kv8
def test_bridge_carries_fp8_bit_for_bit(kv):
    a = _cast(np.random.RandomState(1).randn(3, 5) * PAST[kv], kv)
    t = _t(a)
    assert t.dtype == TORCH8[kv]
    assert np.array_equal(bridge.tensor_to_numpy(t), a.view(np.uint8))
    back = bridge.tensor_from_numpy(bridge.tensor_to_numpy(t).view(a.dtype),
                                    "cpu")
    assert torch.equal(back.view(torch.uint8), t.view(torch.uint8))


@kv8
def test_kernel_dtype_codes(kv):
    dt = TORCH8[kv]
    code = _cuda.FP8 if kv == FP8 else _cuda.E5M2
    assert _cuda.dtype_code(dt, pool=True) == code
    with pytest.raises(TypeError):
        _cuda.dtype_code(dt)                      # never a q/out dtype
    assert ragged_instance(torch.bfloat16, dt) == "mma"
    assert ragged_instance(torch.float32, dt) == "simt"
    suffix = "fp8" if kv == FP8 else "e5m2"
    assert _cuda.pool_instance("k", dt) == ("k", f"k.{suffix}")
    assert _cuda.pool_instance("k", torch.bfloat16) == ("k",)
    assert tb.kv_torch_dtype(kv) == dt
    EngineConfig(kv_dtype=kv).check_supported()


# ------------------------------------------------- the kernels' plain versions

P, MP, W, DH = 16, 4, 4, 32
PREFIX = np.array([0, 1, P - 1, P, 2 * P + 7, MP * P], np.int32)
N_SIDE = np.array([0, 1, 2, W, 3, W], np.int32)


def _pools(rs, rows, hkv, kv, scale=2.0):
    kp = _cast(rs.randn(rows, P, hkv * DH) * scale, kv)
    vp = _cast(rs.randn(rows, P, hkv * DH) * scale, kv)
    return kp, vp


def _specials_match(got, want, exact):
    """NaN and ±inf in ``got`` where ``want`` has them, and every other
    value within bf16's tolerance. ``exact`` (fp32): element by element,
    NaN, +inf and -inf each where JAX has them. Otherwise (bf16) by
    (query, head) row: every row JAX makes non-finite is non-finite here,
    and every row finite here matches JAX's. torch's CPU einsums over bf16
    (``ops/attention.py``'s Q·Kᵀ and P·V, strided batched products) are
    not IEEE-faithful with ±inf: they return NaN for a whole row where one
    of its inputs is infinite (a score where XLA gives -inf, an output row
    where it gives one inf), which the same products through ``torch.mm``
    do not; so bf16 holds the rows that see a special value, fp32 the
    elements."""
    got, want = _f32(got), _f32(want)
    assert not np.isfinite(want).all() and np.isfinite(want).any()
    if exact:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
    else:
        fin = np.isfinite(got).all(-1)
        assert not (fin & ~np.isfinite(want).all(-1)).any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=2e-2)


def _infinite_keys(kp, vp, at):
    """Write +inf / -inf into a few live K and V entries (e5m2's overflow;
    ``at``: (row, position, dim) triples)."""
    for i, (row, pos, d) in enumerate(at):
        sign = -1.0 if i % 2 else 1.0
        (kp if i % 3 else vp)[row, pos, d] = sign * np.inf


@kv8
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_jax_on_fp8_pools(dtype, window, kv):
    rs = np.random.RandomState(2)
    b, h, hkv, n, layers = len(PREFIX), 8, 2, 24, 2
    q = _cast(rs.randn(b, h, DH), dtype)
    kp, vp = _pools(rs, layers * n, hkv, kv)
    table = np.stack([rs.permutation(n)[:MP] for _ in range(b)]).astype(
        np.int32)
    lens = np.maximum(PREFIX, 1).astype(np.int32)
    for layer in range(layers):
        out, m, l = paged_attention(
            _t(q), _t(kp), _t(vp), _t(table), _t(lens), n_kv_heads=hkv,
            window=window, with_stats=True, layer=layer,
            n_pages_per_layer=n)
        sl = slice(layer * n, (layer + 1) * n)
        jo, jm, jl = j_paged(*(jnp.asarray(a) for a in (
            q, kp[sl], vp[sl], table, lens)), n_kv_heads=hkv,
            window=window, with_stats=True)
        np.testing.assert_allclose(_f32(out), _f32(jo), rtol=0,
                                   atol=ATOL[dtype])
        np.testing.assert_allclose(_f32(m), _f32(jm), rtol=0,
                                   atol=ATOL[dtype])
        np.testing.assert_allclose(_f32(l), _f32(jl), rtol=1e-5,
                                   atol=ATOL[dtype])


def _fd_case(seed, dtype, kv, h=8, hkv=2, layers=2):
    rs = np.random.RandomState(seed)
    b = len(PREFIX)
    n = b * MP
    kp, vp = _pools(rs, layers * n, hkv, kv)
    return dict(
        q=_cast(rs.randn(b, h, DH), dtype), kp=kp, vp=vp, n=n, hkv=hkv,
        table=np.stack([rs.permutation(n)[:MP] for _ in range(b)]).astype(
            np.int32),
        sk=_cast(rs.randn(b, W, hkv, DH) * 2, dtype),
        sv=_cast(rs.randn(b, W, hkv, DH) * 2, dtype),
        fk=_cast(rs.randn(b, 1, hkv, DH) * 300, dtype),   # past 464 too
        fv=_cast(rs.randn(b, 1, hkv, DH) * 300, dtype))


def _jax_fd(c, layer, sk, sv, n_side):
    n = c["n"]
    sl = slice(layer * n, (layer + 1) * n)
    return flash_decode_attention_xla(
        *(jnp.asarray(a) for a in (c["q"], c["kp"][sl], c["vp"][sl],
                                   c["table"], PREFIX, sk, sv, n_side)),
        n_kv_heads=c["hkv"])


@kv8
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_jax_on_fp8_pools(dtype, kv):
    c = _fd_case(3, dtype, kv)
    for layer in (0, 1):
        out = flash_decode_attention(
            _t(c["q"]), _t(c["kp"]), _t(c["vp"]), _t(c["table"]),
            _t(PREFIX), _t(c["sk"]), _t(c["sv"]), _t(N_SIDE),
            n_kv_heads=c["hkv"], layer=layer, n_pages_per_layer=c["n"])
        assert out.dtype == _t(c["q"]).dtype
        np.testing.assert_allclose(
            _f32(out), _f32(_jax_fd(c, layer, c["sk"], c["sv"], N_SIDE)),
            rtol=0, atol=ATOL[dtype])


@kv8
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_fw_plain_matches_jax_on_fp8_pools(dtype, kv):
    """The writeback variant: the fresh row (values past 464 included)
    lands in the side window in q's dtype, byte-equal to the JAX one-hot
    write, and the output matches the JAX composition over it."""
    c = _fd_case(4, dtype, kv)
    b = len(PREFIX)
    side_idx = np.array([0, 1, 2, 3, 3, W], np.int32)   # the last drops
    active = np.array([1, 1, 0, 1, 1, 1], np.int32)
    sk, sv = _t(c["sk"]), _t(c["sv"])
    out, sk, sv = flash_decode_attention_fw(
        _t(c["q"]), _t(c["kp"]), _t(c["vp"]), _t(c["table"]), _t(PREFIX),
        sk, sv, _t(c["fk"]), _t(c["fv"]), _t(side_idx), _t(active),
        n_kv_heads=c["hkv"], layer=1, n_pages_per_layer=c["n"])
    onehot = ((np.arange(W)[None] == side_idx[:, None])
              & (active[:, None] > 0))[:, :, None, None]
    jsk = jnp.where(onehot, jnp.asarray(c["fk"]).reshape(b, 1, c["hkv"], DH),
                    jnp.asarray(c["sk"]))
    jsv = jnp.where(onehot, jnp.asarray(c["fv"]).reshape(b, 1, c["hkv"], DH),
                    jnp.asarray(c["sv"]))
    assert np.array_equal(_bytes(sk), _bytes(jsk))
    assert np.array_equal(_bytes(sv), _bytes(jsv))
    want = _jax_fd(c, 1, jsk, jsv, side_idx + active)
    np.testing.assert_allclose(_f32(out), _f32(want), rtol=0,
                               atol=ATOL[dtype] * 300)


def _ragged_case(seed, dtype, fresh_scale, kv, h=8, hkv=2, layers=2):
    rs = np.random.RandomState(seed)
    q_lens = np.array([1, 1, 0, 5, 9, 1], np.int32)
    ctx = np.array([0, 17, 3, 16, 21, 40], np.int32)
    r, qmax, mp = len(q_lens), int(q_lens.max()), 4
    n = r * mp
    kp, vp = _pools(rs, layers * n, hkv, kv)
    return dict(q=_cast(rs.randn(r, qmax, h, DH), dtype), kp=kp, vp=vp,
                table=np.stack([rs.permutation(n)[:mp]
                                for _ in range(r)]).astype(np.int32),
                ctx=ctx, q_lens=q_lens, n=n, hkv=hkv,
                fk=_cast(rs.randn(r, qmax, hkv, DH) * fresh_scale, dtype),
                fv=_cast(rs.randn(r, qmax, hkv, DH) * fresh_scale, dtype))


def _ragged_block_rows(c, kv, pools, jo):
    """``ragged_attention_xla``'s output ``jo`` with the TPU kernel's rule
    (``_ragged_block``) on the (row, query, head) rows whose visible keys
    all score -inf: there the probabilities are 0, so each output element
    is 0, or NaN where a key the plain version multiplies (the row's whole
    gathered table and its fresh rows) has a non-finite V in that dim (0 x
    inf); ``ragged_attention_xla`` averages the masked keys' V instead.
    ``pools``: layer 1's K/V pools before the launch."""
    want = np.array(_f32(jo), np.float32)
    q = _f32(c["q"]).astype(np.float64)
    kp, vp = (_f32(x).astype(np.float64) for x in pools)
    fk = _f32(jnp.asarray(c["fk"]).astype(kv)).astype(np.float64)
    fv = _f32(jnp.asarray(c["fv"]).astype(kv)).astype(np.float64)
    hkv = c["hkv"]
    r, qmax, h, dh = q.shape
    g = h // hkv
    with np.errstate(invalid="ignore"):
        for b in range(r):
            kc = kp[c["table"][b]].reshape(-1, hkv, dh)
            vc = vp[c["table"][b]].reshape(-1, hkv, dh)
            ctx = int(c["ctx"][b])
            for i in range(int(c["q_lens"][b])):
                for hh in range(h):
                    kvh = hh // g
                    k = np.concatenate([kc[:ctx, kvh], fk[b, :i + 1, kvh]])
                    if not (k @ q[b, i, hh] == -np.inf).all():
                        continue
                    v = np.concatenate([vc[:, kvh], fv[b, :, kvh]])
                    want[b, i, hh] = np.where(
                        np.isfinite(v).all(0), 0.0, np.nan)
    return want


@kv8
@pytest.mark.parametrize("past", [False, True], ids=["2.0", "past limit"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_plain_matches_jax_on_fp8_pools(dtype, past, kv):
    """The fresh K/V is rounded with the JAX cast, attended as stored and
    written back byte-equal to ``ragged_attention_xla``'s pools; past the
    limit (scale 300 for e4m3, 3e4 for e5m2) part of it overflows to NaN
    bytes (e5m2: ±inf), and the outputs of the rows that see one are NaN
    (or ±inf) in both; a row whose visible keys all score -inf follows the
    TPU kernel's rule (``_ragged_block_rows``), not the XLA reference's."""
    fresh_scale = PAST[kv] if past else 2.0
    c = _ragged_case(5, dtype, fresh_scale, kv)
    layer, n = 1, c["n"]
    kp, vp = _t(c["kp"]), _t(c["vp"])
    out, kp, vp = ragged_attention(
        _t(c["q"]), kp, vp, _t(c["table"]), _t(c["ctx"]), _t(c["q_lens"]),
        _t(c["fk"]), _t(c["fv"]), n_kv_heads=c["hkv"], layer=layer,
        n_pages_per_layer=n)
    sl = slice(layer * n, (layer + 1) * n)
    jo, jkp, jvp = ragged_attention_xla(
        *(jnp.asarray(a) for a in (c["q"], c["kp"][sl], c["vp"][sl],
                                   c["table"], c["ctx"], c["q_lens"],
                                   c["fk"], c["fv"])), n_kv_heads=c["hkv"])
    assert np.array_equal(_bytes(kp[sl]), _bytes(jkp))
    assert np.array_equal(_bytes(vp[sl]), _bytes(jvp))
    assert np.array_equal(_bytes(kp[:n]), c["kp"][:n].view(np.uint8))
    if kv == FP8 or not past:
        np.testing.assert_allclose(_f32(out), _f32(jo), rtol=0,
                                   atol=ATOL[dtype])
    else:
        _specials_match(out, _ragged_block_rows(
            c, kv, (c["kp"][sl], c["vp"][sl]), jo),
            exact=dtype == "float32")
    if past:
        special = np.isnan if kv == FP8 else np.isinf
        assert special(_f32(jkp)).any()
        assert not np.isfinite(_f32(jo)).all()


@kv8
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["paged", "flash_decode", "ragged"])
def test_plain_versions_over_infinite_keys_match_jax(kernel, dtype, kv):
    """±inf K and V entries in live keys (e5m2's overflow; for e4m3, whose
    cast has no inf, the NaN bytes a cast of ±inf gives): the three plain
    versions give NaN and ±inf where the JAX XLA functions do (by element
    in fp32, by row in bf16: ``_specials_match``), and every other value
    within bf16's tolerance."""
    c = _ragged_case(12, dtype, 2.0, kv)
    rs = np.random.RandomState(13)
    n, hkv = c["n"], c["hkv"]
    kp32, vp32 = _f32(c["kp"]).copy(), _f32(c["vp"]).copy()
    at = [(int(c["table"][i, 0]) + n, int(rs.randint(min(c["ctx"][i], P))),
           int(rs.randint(hkv * DH))) for i in range(len(c["ctx"]))
          if c["ctx"][i] > 0]
    _infinite_keys(kp32, vp32, at)
    kp, vp = _cast(kp32, kv), _cast(vp32, kv)
    lens = np.minimum(np.maximum(c["ctx"], 1), MP * P).astype(np.int32)
    q1 = np.ascontiguousarray(c["q"][:, 0])
    sl = slice(n, 2 * n)

    def j(*a):
        return (jnp.asarray(x) for x in a)

    if kernel == "paged":
        out = paged_attention(_t(q1), _t(kp), _t(vp), _t(c["table"]),
                              _t(lens), n_kv_heads=hkv, layer=1,
                              n_pages_per_layer=n)
        want = j_paged(*j(q1, kp[sl], vp[sl], c["table"], lens),
                       n_kv_heads=hkv)
    elif kernel == "flash_decode":
        b = len(lens)
        sk = _cast(rs.randn(b, W, hkv, DH), dtype)
        sv = _cast(rs.randn(b, W, hkv, DH), dtype)
        ns = np.minimum(np.arange(b), W).astype(np.int32)
        out = flash_decode_attention(
            _t(q1), _t(kp), _t(vp), _t(c["table"]), _t(lens), _t(sk),
            _t(sv), _t(ns), n_kv_heads=hkv, layer=1, n_pages_per_layer=n)
        want = flash_decode_attention_xla(
            *j(q1, kp[sl], vp[sl], c["table"], lens, sk, sv, ns),
            n_kv_heads=hkv)
    else:
        out, _, _ = ragged_attention(
            _t(c["q"]), _t(kp), _t(vp), _t(c["table"]), _t(c["ctx"]),
            _t(c["q_lens"]), _t(c["fk"]), _t(c["fv"]), n_kv_heads=hkv,
            layer=1, n_pages_per_layer=n)
        want, _, _ = ragged_attention_xla(
            *j(c["q"], kp[sl], vp[sl], c["table"], c["ctx"], c["q_lens"],
               c["fk"], c["fv"]), n_kv_heads=hkv)
    _specials_match(out, want, exact=dtype == "float32")


@kv8
def test_mixed_step_matches_jax_on_fp8_pools(kv):
    """The port's ragged mixed step against the JAX ``forward_mixed_step``
    on its XLA path (the same rounding point), llama-tiny fp32: hidden
    states within 1e-4 and the pools' written rows within one e4m3 step."""
    js = jspec("llama-tiny", dtype="float32")
    ts = tspec("llama-tiny", dtype="float32")
    jp = jb.init_params(js, jax.random.key(0))
    tp = bridge.params_from_numpy(jax.device_get(jp), ts, "cpu")
    rs = np.random.RandomState(7)
    L, n, p, mp = js.n_layers, 24, 16, 4
    fused = js.n_kv_heads * js.head_dim
    kp = _cast(rs.randn(L, n, p, fused), kv)
    vp = _cast(rs.randn(L, n, p, fused), kv)
    q_lens = np.array([1, 0, 7, 12], np.int32)
    ctx = np.array([20, 0, 9, 0], np.int32)
    table = np.stack([rs.permutation(n)[:mp] for _ in range(4)]).astype(
        np.int32)
    tokens = rs.randint(1, 1024, size=(4, 12)).astype(np.int32)
    jh, jkp, jvp = jb.forward_mixed_step(
        js, jp, *(jnp.asarray(a) for a in (tokens, ctx, q_lens, kp, vp,
                                           table)), attn_impl="xla")
    tkp, tvp = _t(kp), _t(vp)
    th, tkp, tvp = tb.forward_mixed_step(
        ts, tp, _t(tokens), _t(ctx), _t(q_lens), tkp, tvp, _t(table))
    live = q_lens > 0
    np.testing.assert_allclose(_f32(th)[live], _f32(jh)[live], rtol=0,
                               atol=1e-4)
    for got, want in ((tkp, jkp), (tvp, jvp)):
        g, w = _f32(got), _f32(want)
        np.testing.assert_allclose(g, w, rtol=0.07, atol=1e-3)
        assert (g == w).mean() > 0.999


# ---------------------------------------------------------------- engines

BASE_KW = dict(max_slots=4, max_seq_len=128, prefill_buckets=[16, 64],
               page_size=16, num_pages=48, decode_steps_per_call=4)


def _engine_kw(kv):
    return dict(BASE_KW, kv_dtype=kv)


@pytest.fixture(scope="module")
def weights():
    js = jspec("llama-tiny", dtype="float32")
    ts = tspec("llama-tiny", dtype="float32")
    jp = jb.init_params(js, jax.random.key(0))
    return js, ts, jp, bridge.params_from_numpy(jax.device_get(jp), ts,
                                                "cpu")


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


def _waves():
    """Staggered waves with a prefix hit (through the suffix prefill)."""
    rs = np.random.RandomState(0)
    shared = rs.randint(1, 1024, size=40).tolist()

    def req(i, n, m=8):
        return dict(prompt=rs.randint(1, 1024, size=n).tolist(),
                    max_new_tokens=m, request_id=f"r{i}")

    return [[req(0, 9), req(1, 45), dict(prompt=shared + [7, 8, 9],
                                         max_new_tokens=8, request_id="p0")],
            [req(2, 12, 5), dict(prompt=shared + [11, 12], max_new_tokens=9,
                                 request_id="p1")],
            [req(3, 20, 12)]]


def _staggered(engine, req_cls):
    """Two requests, one step, three more: the later ones are admitted
    under decode pressure, so deferred (the JAX default, as the port's)."""
    rs = np.random.RandomState(9)
    reqs = [req_cls(prompt=rs.randint(1, 1024, size=n).tolist(),
                    max_new_tokens=m, request_id=f"h{i}")
            for i, (n, m) in enumerate(((9, 12), (30, 7), (45, 10),
                                        (12, 5), (20, 14)))]
    for r in reqs[:2]:
        engine.submit(r)
    engine.step()
    for r in reqs[2:]:
        engine.submit(r)
    return {r.request_id: r for r in engine.run_until_idle()}


def _same(got, want, n, lp_atol=LP_ATOL):
    assert sorted(got) == sorted(want) and len(got) == n
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason, rid
        np.testing.assert_allclose(got[rid].logprobs, want[rid].logprobs,
                                   rtol=0, atol=lp_atol)


def _teacher_forced(spec, params, prompts, results):
    """Every chain through the JAX ``assert_greedy_parity``, its tie band
    widened to the fp8 pools' logit noise (unrounded fp32 reference)."""
    for rid, res in results.items():
        if len(res.tokens) >= 3:
            assert_greedy_parity(spec, params, prompts[rid], res.tokens,
                                 eps=2e-2, min_matched=1,
                                 label=f"fp8 {rid}")


def _prompts(waves):
    return {kw["request_id"]: kw["prompt"] for wave in waves for kw in wave}


@pytest.fixture(scope="module", params=KV8, ids=KV8_IDS)
def jax_window(weights, request):
    """The JAX window scheme on fp8 pools of each dtype (side window in the
    compute dtype, paged prefix through the paged kernel's interpreter):
    the waves, then a staggered wave admitted deferred."""
    js, _, jp, _ = weights
    kv = request.param
    je = JEngine(js, params=jp, config=JCfg(attention_impl="pallas_interpret",
                                            **_engine_kw(kv)))
    assert str(je.kv.k_pages.dtype) == kv
    waves = _drive(je, JReq, _waves())
    deferred0 = je.get_metrics()["deferred_admissions"]
    staggered = _staggered(je, JReq)
    assert je.get_metrics()["deferred_admissions"] - deferred0 == 3
    assert je.get_metrics()["prefix_hit_admissions"] >= 1
    return kv, waves, staggered


@pytest.mark.parametrize("impl", ["auto", "pallas-decode-fw"])
def test_window_decode_matches_jax_engine(weights, jax_window, impl):
    """The window scheme through flash-decode and its writeback form
    (plain versions here), with a prefix hit through the suffix prefill,
    then deferred admission (the default engine)."""
    js, ts, jp, tp = weights
    kv, jwaves, jstaggered = jax_window
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(
        attention_impl=impl, **_engine_kw(kv)), device="cpu")
    assert te.kv.k_pages.dtype == TORCH8[kv]
    got = _drive(te, GenerationRequest, _waves())
    _same(got, jwaves, 6)
    assert te.kv.k_pages.element_size() == 1
    assert te.get_metrics()["prefix_hit_admissions"] >= 1
    _teacher_forced(js, jp, _prompts(_waves()), got)
    if impl == "auto":
        deferred0 = te.get_metrics()["deferred_admissions"]
        staggered = _staggered(te, GenerationRequest)
        _same(staggered, jstaggered, 5)
        assert te.get_metrics()["deferred_admissions"] - deferred0 == 3


@kv8
def test_inline_decode_matches_jax_engine(weights, kv):
    js, ts, jp, tp = weights
    je = JEngine(js, params=jp, config=JCfg(
        attention_impl="xla", decode_mode="inline", **_engine_kw(kv)))
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(
        decode_mode="inline", **_engine_kw(kv)), device="cpu")
    got = _drive(te, GenerationRequest, _waves())
    _same(got, _drive(je, JReq, _waves()), 6)
    assert te.get_metrics()["decode_mode"] == "inline"


def _chunk_waves():
    """Chunked prompts (16-token chunks), a 45-token owner of a 2-page
    prefix, then a prefix hit on it whose tail exceeds the chunk."""
    rs = np.random.RandomState(6)
    shared = rs.randint(1, 1024, size=32).tolist()
    first = [dict(prompt=rs.randint(1, 1024, size=28).tolist(),
                  max_new_tokens=8, request_id="long"),
             dict(prompt=[5, 9, 13], max_new_tokens=8, request_id="short"),
             dict(prompt=shared + rs.randint(1, 1024, size=13).tolist(),
                  max_new_tokens=6, request_id="owner")]
    second = [dict(prompt=rs.randint(1, 1024, size=37).tolist(),
                   max_new_tokens=7, request_id="w0")]
    third = [dict(prompt=shared + rs.randint(1, 1024, size=40).tolist(),
                  max_new_tokens=8, request_id="hit")]
    return [first, second, third]


@kv8
def test_chunked_prefill_in_the_mixed_step_matches_jax_engine(weights, kv):
    """Chunked prefill in the ragged mixed step, a prefix hit resuming
    chunked: the JAX XLA engine's tokens (its split path; logprobs within
    1e-2, the rounding points differing), every chain teacher-forced.
    Over e5m2 the logprobs are held within 3e-2: they differed by up to
    0.0120 (measured on this case), since the two rounding points can
    land a value on neighbouring e5m2 values, 12.5-25% apart against
    e4m3's 6%."""
    js, ts, jp, tp = weights
    kw = dict(_engine_kw(kv), prefill_chunk=16)
    je = JEngine(js, params=jp, config=JCfg(attention_impl="xla", **kw))
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(
        attention_impl="pallas-ragged", **kw), device="cpu")
    got = _drive(te, GenerationRequest, _chunk_waves(), steps=3)
    _same(got, _drive(je, JReq, _chunk_waves(), steps=3), 5,
          1e-2 if kv == FP8 else 3e-2)
    m = te.get_metrics()
    assert m["chunked_admissions"] >= 2 and m["prefix_hit_admissions"] >= 1
    assert m["mixed_steps"] > 0
    _teacher_forced(js, jp, _prompts(_chunk_waves()), got)


@kv8
def test_mistral_past_its_window_matches_jax_engine(kv):
    """mistral-tiny (window 64) decodes inline on fp8 pools past its
    window, through a chunked prompt and a prefix hit."""
    js = jmspec("mistral-tiny", dtype="float32")
    ts = tmspec("mistral-tiny", dtype="float32")
    jp = jb.init_params(js, jax.random.key(0))
    tp = bridge.params_from_numpy(jax.device_get(jp), ts, "cpu")
    kw = dict(max_slots=4, max_seq_len=256, prefill_buckets=[64, 128],
              page_size=16, num_pages=72, decode_steps_per_call=4,
              prefill_chunk=64, kv_dtype=kv)
    rs = np.random.RandomState(11)
    shared = rs.randint(1, 1024, size=64).tolist()
    waves = [[dict(prompt=rs.randint(1, 1024, size=90).tolist(),
                   max_new_tokens=30, request_id="long"),
              dict(prompt=shared + [3, 4], max_new_tokens=20,
                   request_id="owner")],
             [dict(prompt=shared + rs.randint(1, 1024, size=70).tolist(),
                   max_new_tokens=12, request_id="hit")]]
    je = JEngine(js, params=jp, config=JCfg(attention_impl="xla", **kw))
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(**kw),
                          device="cpu")
    got = _drive(te, GenerationRequest, waves, steps=3)
    _same(got, _drive(je, JReq, waves, steps=3), 3)
    m = te.get_metrics()
    assert m["decode_mode"] == "inline" and m["prefix_hit_admissions"] >= 1
    assert len(waves[0][0]["prompt"]) + 30 > js.sliding_window


@kv8
def test_int4_weights_with_fp8_pools_match_jax_engine(kv):
    """int4 weights (fused q|k|v and gate|up) over fp8 pools, through the
    inline decode in both engines."""
    js = jspec("llama-tiny", dtype="float32")
    ts = tspec("llama-tiny", dtype="float32")
    jp = jq.random_quantized_params(js, jax.random.key(1), bits=4)
    tp = bridge.params_from_numpy(jax.device_get(jp), ts, "cpu")
    kw = dict(_engine_kw(kv), decode_mode="inline")
    je = JEngine(js, params=jp, config=JCfg(attention_impl="xla", **kw))
    te = ContinuousEngine(ts, params=tp, config=EngineConfig(**kw),
                          device="cpu")
    assert "w_qkv" in te.params["blocks"]
    _same(_drive(te, GenerationRequest, _waves()),
          _drive(je, JReq, _waves()), 6)


@kv8
def test_hbm_bytes_half_of_bf16_and_stats_keys_match_jax(weights, kv):
    js, ts, _, _ = weights
    kw = dict(max_slots=2, page_size=16, num_pages=24, max_seq_len=128)
    bf16 = PagedKVCache(ts, device="cpu", dtype="bfloat16", **kw)
    fp8 = PagedKVCache(ts, device="cpu", dtype=kv, **kw)
    assert fp8.k_pages.element_size() == fp8.v_pages.element_size() == 1
    assert fp8.k_rows.dtype == TORCH8[kv]
    assert fp8.get_stats()["hbm_bytes"] * 2 == bf16.get_stats()["hbm_bytes"]
    jfp8 = JPagedKVCache(js, dtype=kv, **kw)
    assert fp8.get_stats()["hbm_bytes"] == jfp8.get_stats()["hbm_bytes"]
    assert set(fp8.get_stats()) == set(jfp8.get_stats())
    assert set(bf16.get_stats()) == set(JPagedKVCache(
        js, dtype="bfloat16", **kw).get_stats())


@kv8
def test_worker_serves_fp8_pools_from_metadata(weights, kv):
    """``load_model`` with ``kv_dtype`` in its metadata builds fp8 pools
    and serves the JAX engine's tokens on the same (seeded) weights."""
    js, ts, _, _ = weights
    md = {"size": "llama-tiny", "continuous": "1", "seed": "3",
          "page_size": "16", "num_pages": "48",
          "prefill_buckets": "[16, 64]", "kv_dtype": kv,
          "attention_impl": "pallas-decode"}
    cfg = ModelConfig(name="f8", architecture="llama", dtype="float32",
                      max_seq_len=128, max_batch_size=4, metadata=md)
    ref = engine_from_config(cfg, device="cpu")
    assert ref.kv.k_pages.dtype == TORCH8[kv]
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, 1024, size=n).tolist() for n in (7, 30, 50)]
    jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(ref.params))
    want = JEngine(js, params=jp, config=JCfg(
        attention_impl="pallas_interpret", **_engine_kw(kv))).generate(
        [JReq(prompt=p, max_new_tokens=7) for p in prompts])

    async def serve():
        server = WorkerServer(ServerConfig(worker_id="f0", port=0),
                              device="cpu")
        server.load_model(cfg)
        host, port = await server.start()
        client = JClient(host, port, timeout=60.0)
        try:
            return await asyncio.gather(*[
                client.generate("f8", [JReq(prompt=p, max_new_tokens=7,
                                            request_id=f"q{i}")])
                for i, p in enumerate(prompts)])
        finally:
            await client.close()
            await server.stop()

    outs = asyncio.run(serve())
    for o, w in zip(outs, want):
        assert o[0].tokens == w.tokens
        assert o[0].finish_reason == w.finish_reason == "length"
