"""The port's CUDA kernels against their plain PyTorch versions, on the
card (run there with ``python -m pytest --noconftest -q
tests/test_torch_cuda.py``, since ``tests/conftest.py`` imports JAX; skipped
without a card). Small shapes; chip_smoke.py checks the Llama-3-8B and Mistral ones.
Tolerances: fp32 atol 1e-4, bf16 (and fp32 over bf16 pools) atol = rtol =
2e-2, e4m3 and e5m2 pools q's tolerance (they widen exactly; values past
464, and past 61,440 for e5m2, in the ragged kernel's fresh K/V included,
written bytes equal; over e5m2's infinities NaN and inf where the plain
version has them); written
pages and side rows equal; paged attention's m and l
within 1e-4 of the plain version's on the inputs widened to fp32, also
with a slot's keys split over many blocks. The int4 matmul is held per output
column to max|out - ref32| / max|ref32| <= 1e-2 (bf16) and 1e-4 (fp32) at
8 rows and more, ref32 being the plain version on the same inputs widened
to fp32, and at every row count to the same bound relative to the column's
largest sum |x w| s, at every Llama-3-8B projection shape; each call
also counts one launch of the instance ``int4_instance`` names.

The engine's CUDA graphs (llama-tiny and mistral-tiny, bf16 and fp32, random
weights from a seed): on every decode scheme and the mixed step, graph
replays emit the eager bodies' tokens and logprobs exactly (the same kernels
on the same inputs), count the same launches, and write the same pages;
sampled replays advance the generator and reproduce under a seed; two
engines of different shapes replaying in turn on one stream each emit their
own eager tokens (flash-decode's shared split scratch).

The host paths on the card: graph replays under deferred admission,
``defer_sync`` and sub-chunk streaming emit the eager hook's tokens and
logprobs and count its launches; a packed read's event turns ready without
a host synchronisation; a served run after ``warmup()`` captures no
graph."""

import gc

import pytest
import torch

from distributed_inference_engine_tpu_torch.config import EngineConfig
from distributed_inference_engine_tpu_torch.engine.continuous import (
    ContinuousEngine,
)
from distributed_inference_engine_tpu_torch.engine.types import (
    GenerationRequest,
)
from distributed_inference_engine_tpu_torch.models.base import (
    init_params,
    random_quantized_params,
)
from distributed_inference_engine_tpu_torch.models.base import layer_view
from distributed_inference_engine_tpu_torch.models.llama import (
    llama_spec,
    mixtral_spec,
)
from distributed_inference_engine_tpu_torch.models.mistral import (
    mistral_spec,
)
from distributed_inference_engine_tpu_torch.ops import _cuda
from distributed_inference_engine_tpu_torch.ops.attention import (
    astype_kv,
    raw_view,
)
from distributed_inference_engine_tpu_torch.ops import flash_decode as fd
from distributed_inference_engine_tpu_torch.ops import fused_decode as fdec
from distributed_inference_engine_tpu_torch.ops import int4_matmul as i4
from distributed_inference_engine_tpu_torch.ops import moe
from distributed_inference_engine_tpu_torch.ops import quant as tq
from distributed_inference_engine_tpu_torch.ops import paged_attention as pa
from distributed_inference_engine_tpu_torch.ops import ragged_attention as ra

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
FP8 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
# the fp8 pool dtypes and the suffix their instances count under
FP8S = {FP8: "fp8", E5M2: "e5m2"}
FP8_IDS = ["e4m3", "e5m2"]


def _tol_dtype(dtype, kv_dtype):
    """The tolerance of a (q, pool) pair: q's, where the pool is q's dtype
    or fp8 (exact in both), else bf16's."""
    return dtype if kv_dtype == dtype or kv_dtype in FP8S else torch.bfloat16


def _same_bytes(a, b):
    return torch.equal(raw_view(a), raw_view(b))


def _randn_like(t):
    """``torch.randn_like``, which has no fp8 kernel: fp8 draws fp32 and
    rounds."""
    if t.dtype not in FP8S:
        return torch.randn_like(t)
    return torch.randn(t.shape, device=t.device).to(t.dtype)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    _cuda.lib()                      # builds with nvcc on first use
    return torch.device("cuda")


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,dh", [(8, 4, 32), (8, 2, 64), (32, 8, 128)])
def test_flash_decode_kernel(card, dtype, h, hkv, dh):
    g = torch.Generator(device=card).manual_seed(0)
    b, p, mp, w, n = 5, 16, 4, 4, 40
    q = torch.randn((b, h, dh), generator=g, device=card).to(dtype)
    kp = torch.randn((2 * n, p, hkv * dh), generator=g,
                     device=card).to(dtype)
    vp = torch.randn_like(kp)
    table = torch.randint(0, n, (b, mp), generator=g, device=card,
                          dtype=torch.int32)
    plen = torch.tensor([0, 1, 15, 16, 64], dtype=torch.int32, device=card)
    nside = torch.tensor([0, 4, 1, 2, 3], dtype=torch.int32, device=card)
    sk = torch.randn((b, w, hkv, dh), generator=g, device=card).to(dtype)
    sv = torch.randn_like(sk)
    args = (q, kp, vp, table, plen, sk, sv, nside)
    kw = dict(n_kv_heads=hkv, layer=1, n_pages_per_layer=n)
    before = _cuda.LAUNCHES["flash_decode"]
    out = fd.flash_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_decode"] == before + 1
    _close(out, fd.flash_decode_attention_plain(*args, **kw), dtype)
    assert float(out[0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d,n", [(1, 256, 384), (5, 256, 688),
                                   (40, 688, 256)])
def test_fused_decode_kernels(card, dtype, b, d, n):
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn((b, d), generator=g, device=card).to(dtype)
    gain = torch.randn((d,), generator=g, device=card).to(dtype)
    w = (0.05 * torch.randn((d, n), generator=g, device=card)).to(dtype)
    res = torch.randn((b, n), generator=g, device=card).to(dtype)
    for plus_one in (False, True):
        out = fdec.norm_matmul(x, gain, w, eps=1e-5, plus_one=plus_one)
        torch.cuda.synchronize()
        _close(out, fdec.norm_matmul_plain(x, gain, w, eps=1e-5,
                                           plus_one=plus_one), dtype)
    inst = "matmul_residual." + fdec.gemv_instance(dtype)
    before = _cuda.LAUNCHES[inst]
    out = fdec.matmul_residual(x, w, res)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[inst] == before + 1
    _close(out, fdec.matmul_residual_plain(x, w, res), dtype)


# matmul_residual at the decode batches (B 1-40: one, two and four 8-token
# tiles, then two 32-token tiles), the Llama-3-8B contractions (wo 4096,
# w_down 14336) and a small one, N 4096 and two N off the 128-column tile:
# 1000 (rows of whole 16-byte pieces: bf16 weights by TMA, the last tile
# past N zero-filled) and 1002 (they are not: 4-byte copies)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [688, 4096, 14336])
@pytest.mark.parametrize("n", [4096, 1000, 1002])
def test_matmul_residual_shapes(card, dtype, d, n):
    g = torch.Generator(device=card).manual_seed(11)
    w = (0.02 * torch.randn((d, n), generator=g, device=card)).to(dtype)
    inst = "matmul_residual." + fdec.gemv_instance(dtype)
    for b in (1, 2, 7, 8, 9, 16, 32, 40):
        x = torch.randn((b, d), generator=g, device=card).to(dtype)
        res = torch.randn((b, n), generator=g, device=card).to(dtype)
        before = _cuda.LAUNCHES[inst]
        out = fdec.matmul_residual(x, w, res)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES[inst] == before + 1, (b, inst)
        _close(out, fdec.matmul_residual_plain(x, w, res), dtype)


@pytest.fixture
def fp32_sums():
    """The plain versions' bf16 matmuls summed in fp32 throughout, as the
    kernels sum: cuBLAS may otherwise reduce split-K partials in bf16
    (PyTorch's default), which moves an output near 0 by more than the
    bf16 tolerance at K 14336."""
    m = torch.backends.cuda.matmul
    before = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    yield
    m.allow_bf16_reduced_precision_reduction = before


# norm_matmul on the same core at the same shapes and batches, plus_one off
# and on (one launch each, counted by instance)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [688, 4096, 14336])
@pytest.mark.parametrize("n", [4096, 1000, 1002])
def test_norm_matmul_shapes(card, fp32_sums, dtype, d, n):
    g = torch.Generator(device=card).manual_seed(12)
    w = (0.02 * torch.randn((d, n), generator=g, device=card)).to(dtype)
    gain = (1.0 + 0.1 * torch.randn((d,), generator=g, device=card)
            ).to(dtype)
    inst = "norm_matmul." + fdec.gemv_instance(dtype)
    for b in (1, 2, 7, 8, 9, 16, 32, 40):
        x = torch.randn((b, d), generator=g, device=card).to(dtype)
        for plus_one in (False, True):
            before = _cuda.LAUNCHES[inst]
            out = fdec.norm_matmul(x, gain, w, eps=1e-5, plus_one=plus_one)
            torch.cuda.synchronize()
            assert _cuda.LAUNCHES[inst] == before + 1, (b, inst)
            _close(out, fdec.norm_matmul_plain(x, gain, w, eps=1e-5,
                                               plus_one=plus_one), dtype)


@pytest.mark.parametrize("b", [1, 8, 40])
def test_norm_matmul_rounds_h_first(card, b):
    """bf16: x all ones (so 1 / rms is exactly 1 at eps 0), gain[0] =
    3 * 2^-9 with plus_one, so (x rinv) g = 1 + 3 * 2^-9, which rounds to
    h = 1 + 2^-7 in bf16; w's rows 0 and 1 are 1 and -1. Rounding h before
    the product gives h0 - h1 = 2^-7; the unrounded 3 * 2^-9 is another
    bf16 value."""
    d, n = 4096, 4096
    x = torch.ones((b, d), dtype=torch.bfloat16, device=card)
    gain = torch.zeros((d,), dtype=torch.bfloat16, device=card)
    gain[0] = 3 * 2.0 ** -9
    w = torch.zeros((d, n), dtype=torch.bfloat16, device=card)
    w[0] = 1.0
    w[1] = -1.0
    out = fdec.norm_matmul(x, gain, w, eps=0.0, plus_one=True)
    torch.cuda.synchronize()
    assert bool((out == 2.0 ** -7).all()), out.unique()
    assert torch.equal(out, fdec.norm_matmul_plain(x, gain, w, eps=0.0,
                                                   plus_one=True))


@pytest.mark.parametrize("b", [1, 8, 40])
def test_matmul_residual_rounds_the_product_first(card, b):
    """bf16: x @ w = 1 + 2^-8 exactly (a tie that rounds to 1.0), res =
    256. Rounding the product first gives 257, a tie that rounds to 256;
    adding before rounding would give 257.0039..., which rounds to 258."""
    d, n = 4096, 4096
    x = torch.zeros((b, d), dtype=torch.bfloat16, device=card)
    x[:, :2] = 1.0
    w = torch.zeros((d, n), dtype=torch.bfloat16, device=card)
    w[0] = 1.0
    w[1] = 2.0 ** -8
    res = torch.full((b, n), 256.0, dtype=torch.bfloat16, device=card)
    out = fdec.matmul_residual(x, w, res)
    torch.cuda.synchronize()
    assert bool((out == 256.0).all()), out.unique()
    assert torch.equal(out, fdec.matmul_residual_plain(x, w, res))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,dh", [(8, 4, 32), (8, 2, 64), (32, 8, 128)])
def test_flash_decode_fw_kernel(card, dtype, h, hkv, dh):
    """The writeback variant: output and the side rows written (active
    slots with side_idx < W only; slot 3 is active at side_idx = W)."""
    g = torch.Generator(device=card).manual_seed(3)
    b, p, mp, w, n = 6, 16, 4, 4, 40
    q = torch.randn((b, h, dh), generator=g, device=card).to(dtype)
    kp = torch.randn((2 * n, p, hkv * dh), generator=g,
                     device=card).to(dtype)
    vp = torch.randn_like(kp)
    table = torch.randint(0, n, (b, mp), generator=g, device=card,
                          dtype=torch.int32)
    plen = torch.tensor([0, 1, 15, 16, 64, 0], dtype=torch.int32,
                        device=card)
    sidx = torch.tensor([0, 2, 1, 4, 3, 0], dtype=torch.int32, device=card)
    active = torch.tensor([1, 1, 0, 1, 1, 0], dtype=torch.int32,
                          device=card)
    sk = torch.randn((b, w, hkv, dh), generator=g, device=card).to(dtype)
    sv = torch.randn_like(sk)
    fk = torch.randn((b, 1, hkv, dh), generator=g, device=card).to(dtype)
    fv = torch.randn_like(fk)
    kw = dict(n_kv_heads=hkv, layer=1, n_pages_per_layer=n)
    sk2, sv2 = sk.clone(), sv.clone()
    before = _cuda.LAUNCHES["flash_decode_fw"]
    out, _, _ = fd.flash_decode_attention_fw(
        q, kp, vp, table, plen, sk, sv, fk, fv, sidx, active, **kw)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_decode_fw"] == before + 1
    ref, _, _ = fd.flash_decode_attention_fw_plain(
        q, kp, vp, table, plen, sk2, sv2, fk, fv, sidx, active, **kw)
    _close(out, ref, dtype)
    assert torch.equal(sk, sk2) and torch.equal(sv, sv2)
    assert float(out[5].abs().max()) == 0.0    # inactive, nothing before


# flash-decode per output row: max|out - ref32| / max|ref32|, ref32 the
# plain version on the same values widened to fp32
FD_ROW_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _fd_split_case(card, dtype, kv_dtype, h, hkv, dh, p, mp, prefix, fw,
                   seed):
    """Both flash-decode kernels on the split grid against their plain
    versions: outputs within TOL and, per row, within FD_ROW_REL of the
    plain version in fp32; rows with no key exactly 0; the fw side rows
    equal the plain version's: each active slot's column side_idx < W
    holds its fresh row, every other row keeps its bits."""
    g = torch.Generator(device=card).manual_seed(seed)
    b, w = len(prefix), 8
    n = b * mp + 3
    q = torch.randn((b, h, dh), generator=g, device=card).to(dtype)
    kp = torch.randn((2 * n, p, hkv * dh), generator=g,
                     device=card).to(kv_dtype)
    vp = _randn_like(kp)
    table = torch.randperm(n, generator=g, device=card)[: b * mp].reshape(
        b, mp).to(torch.int32)
    plen = torch.tensor(prefix, dtype=torch.int32, device=card)
    i32 = dict(dtype=torch.int32, device=card)
    sk = torch.randn((b, w, hkv, dh), generator=g, device=card).to(dtype)
    sv = torch.randn_like(sk)
    kw = dict(n_kv_heads=hkv, layer=1, n_pages_per_layer=n)
    name = "flash_decode_fw" if fw else "flash_decode"
    inst = f"{name}.{FP8S.get(kv_dtype, 'fp8')}"
    before = _cuda.LAUNCHES[name], _cuda.LAUNCHES[inst]
    if fw:
        # side columns over 0..W (W: the fresh row is dropped), one in
        # three slots inactive
        sidx = torch.tensor([(3 * i) % (w + 1) for i in range(b)], **i32)
        active = torch.tensor([int(i % 3 != 2) for i in range(b)], **i32)
        fk = torch.randn((b, 1, hkv, dh), generator=g,
                         device=card).to(dtype)
        fv = torch.randn_like(fk)
        sk_k, sv_k = sk.clone(), sv.clone()
        out, _, _ = fd.flash_decode_attention_fw(
            q, kp, vp, table, plen, sk_k, sv_k, fk, fv, sidx, active, **kw)
        torch.cuda.synchronize()
        sk_p, sv_p = sk.clone(), sv.clone()
        ref, _, _ = fd.flash_decode_attention_fw_plain(
            q, kp, vp, table, plen, sk_p, sv_p, fk, fv, sidx, active, **kw)
        ref32, _, _ = fd.flash_decode_attention_fw_plain(
            q.float(), kp.float(), vp.float(), table, plen, sk.float(),
            sv.float(), fk.float(), fv.float(), sidx, active, **kw)
        assert torch.equal(sk_k, sk_p) and torch.equal(sv_k, sv_p)
        wrote = torch.zeros((b, w), dtype=torch.bool, device=card)
        for i in range(b):
            if active[i] and sidx[i] < w:
                wrote[i, sidx[i]] = True
                assert torch.equal(sk_k[i, sidx[i]], fk[i, 0])
                assert torch.equal(sv_k[i, sidx[i]], fv[i, 0])
        assert torch.equal(sk_k[~wrote], sk[~wrote])
        assert torch.equal(sv_k[~wrote], sv[~wrote])
        n_keys = plen + torch.clamp(sidx, 0, w) + (active > 0) * (sidx < w)
    else:
        nside = torch.tensor([(5 * i) % (w + 1) for i in range(b)], **i32)
        nside[0] = 0
        args = (q, kp, vp, table, plen, sk, sv, nside)
        out = fd.flash_decode_attention(*args, **kw)
        torch.cuda.synchronize()
        ref = fd.flash_decode_attention_plain(*args, **kw)
        ref32 = fd.flash_decode_attention_plain(
            *(t.float() if t.is_floating_point() else t for t in args),
            **kw)
        n_keys = plen + nside
    assert (_cuda.LAUNCHES[name], _cuda.LAUNCHES[inst]) == (
        before[0] + 1, before[1] + (kv_dtype in FP8S))
    _close(out, ref, _tol_dtype(dtype, kv_dtype))
    live = n_keys > 0
    row_err = (out.float() - ref32).abs().amax(-1)[live]
    row_ref = ref32.abs().amax(-1)[live]
    assert float((row_err / row_ref).max()) <= FD_ROW_REL[
        _tol_dtype(dtype, kv_dtype)]
    if (~live).any():
        assert float(out[~live].abs().max()) == 0.0


# lengths on the edges of the 256-key runs of the Llama-3-8B decode grid
# (8 runs at MP 16, P 128), and one slot with 2,040 keys alone
FD_EDGES = [0, 1, 255, 256, 257, 1023, 2047, 2048]


@pytest.mark.parametrize("fw", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("prefix", [FD_EDGES, [2040]],
                         ids=["split edges", "one long"])
def test_flash_decode_split_llama3_8b(card, fw, dtype, prefix):
    n_split, chunk = fd.flash_decode_split(len(prefix), 8, 128, 16, card)
    assert n_split * chunk >= 16 * 128 and n_split > 1
    _fd_split_case(card, dtype, dtype, 32, 8, 128, 128, 16, prefix, fw,
                   seed=20 + fw)


@pytest.mark.parametrize("fw", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_split_head_dim_256(card, fw, dtype):
    """Dh 256 (the largest head the wrappers take) on a grid of several
    runs, pages of 16."""
    _fd_split_case(card, dtype, dtype, 8, 2, 256, 16, 64,
                   [0, 17, 255, 256, 700, 1024], fw, seed=30 + fw)


@pytest.mark.parametrize("fw", [False, True])
@pytest.mark.parametrize("dtype,kv_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("h,hkv,dh", [(8, 8, 32), (16, 4, 64),
                                      (32, 8, 128)])
def test_flash_decode_mixed_dtypes(card, fw, dtype, kv_dtype, h, hkv, dh):
    """The two mixed (q, pool) dtype pairs (on the CUDA cores)."""
    _fd_split_case(card, dtype, kv_dtype, h, hkv, dh, 16, 40,
                   [0, 1, 300, 513, 640], fw, seed=40 + fw)


@pytest.mark.parametrize("fw", [False, True])
@pytest.mark.parametrize("h,hkv,dh", [(8, 8, 32), (8, 4, 64), (16, 2, 128),
                                      (32, 8, 128)])
def test_flash_decode_bf16_tensor_cores(card, fw, h, hkv, dh):
    """bf16 (on the tensor cores) at every G of the wrappers, pages of 16,
    a split grid of several runs."""
    _fd_split_case(card, torch.bfloat16, torch.bfloat16, h, hkv, dh, 16, 40,
                   [3, 0, 16, 255, 640], fw, seed=50 + fw)


# query-head groups past the 1, 2, 4 and 8-row instances: G 3, 5, 6, 7
# (Qwen2-7B's widths), 12, 16 and 24 (sub-groups of 8, or at Dh 128 on the
# tensor cores of 16)
ANY_GROUP = [(6, 2, 64), (10, 2, 64), (12, 2, 128), (28, 4, 128),
             (24, 2, 64), (32, 2, 128), (24, 1, 32)]
POOL_PAIRS = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
              (torch.bfloat16, FP8), (torch.float32, FP8),
              (torch.bfloat16, E5M2), (torch.float32, E5M2)]


@pytest.mark.parametrize("fw", [False, True])
@pytest.mark.parametrize("dtype,kv_dtype", POOL_PAIRS)
@pytest.mark.parametrize("h,hkv,dh", ANY_GROUP)
def test_flash_decode_any_group(card, fw, dtype, kv_dtype, h, hkv, dh):
    """Both flash-decode kernels at query-head groups that are not one of
    their instances, bf16 on the tensor cores, fp32, and fp8 pools, pages
    of 16, a split grid of several runs: the dead rows of a sub-group are
    never stored (every output row checked), fw's side write once."""
    _fd_split_case(card, dtype, kv_dtype, h, hkv, dh, 16, 40,
                   [3, 0, 16, 255, 640], fw, seed=160 + fw + h)


@pytest.mark.parametrize("fw", [False, True])
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, FP8, E5M2],
                         ids=["bf16", "e4m3", "e5m2"])
@pytest.mark.parametrize("g", [9, 10, 11, 12, 13, 14, 15, 16, 24])
def test_flash_decode_16_row_instance(card, fw, kv_dtype, g):
    """Both flash-decode kernels at G 9-16 and 24, bf16 q over bf16, e4m3
    and e5m2 pools at Dh 128: one 16-row sub-group a KV head (two at G
    24, the second's rows past G dead), counted under ``.rows16``, held
    to the plain versions as ``_fd_split_case`` holds them; fw's fresh row
    written once."""
    name = "flash_decode_fw" if fw else "flash_decode"
    assert fd.decode_subgroup(g, 128, torch.bfloat16, kv_dtype) == (
        16, -(-g // 16))
    before = _cuda.LAUNCHES[f"{name}.rows16"]
    _fd_split_case(card, torch.bfloat16, kv_dtype, 2 * g, 2, 128, 16, 40,
                   [3, 0, 16, 255, 640], fw, seed=300 + g + fw)
    assert _cuda.LAUNCHES[f"{name}.rows16"] == before + 1


@pytest.mark.parametrize("kv8", list(FP8S), ids=FP8_IDS)
@pytest.mark.parametrize("fw", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,hkv,dh", [(8, 8, 32), (16, 8, 64), (16, 4, 128),
                                      (32, 4, 128), (16, 2, 256)])
def test_flash_decode_fp8_pools(card, fw, dtype, h, hkv, dh, kv8):
    """e4m3 and e5m2 pools (the fp8 and e5m2 instances): bf16 q on the
    tensor cores (the pages widened in registers), fp32 q on the CUDA
    cores, at G 1-8 and Dh 32-256, pages of 16, a split grid of several
    runs; the side window and fw's side write in q's dtype."""
    _fd_split_case(card, dtype, kv8, h, hkv, dh, 16, 40,
                   [3, 0, 16, 255, 640], fw, seed=60 + fw)


@pytest.mark.parametrize("dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("h,hkv,dh", [(8, 4, 32), (8, 2, 64), (32, 8, 128),
                                      (4, 4, 32), (12, 4, 32), (14, 2, 64),
                                      (28, 4, 128), (96, 1, 32)])
def test_ragged_attention_kernel(card, dtype, kv_dtype, h, hkv, dh):
    """Rows of q_len 0 (one on another row's live pages), 1 and chunks
    straddling pages, against the plain version: outputs, and the pools
    equal everywhere (the written positions included)."""
    g = torch.Generator(device=card).manual_seed(4)
    rows = [(0, 37), (15, 1), (16, 1), (10, 9), (0, 0), (39, 12), (20, 0)]
    r, p, mp, n = len(rows), 16, 6, 50
    qmax = max(q for _, q in rows)
    ctx = torch.tensor([c for c, _ in rows], dtype=torch.int32, device=card)
    ql = torch.tensor([q for _, q in rows], dtype=torch.int32, device=card)
    table = torch.randperm(n, generator=g, device=card)[: r * mp].reshape(
        r, mp).to(torch.int32)
    table[4] = table[3]
    q = torch.randn((r, qmax, h, dh), generator=g, device=card).to(dtype)
    fk = torch.randn((r, qmax, hkv, dh), generator=g, device=card).to(dtype)
    fv = torch.randn_like(fk)
    kp = torch.randn((2 * n, p, hkv * dh), generator=g,
                     device=card).to(kv_dtype)
    vp = torch.randn_like(kp)
    kp2, vp2 = kp.clone(), vp.clone()
    kw = dict(n_kv_heads=hkv, layer=1, n_pages_per_layer=n)
    inst = "ragged_attention." + ra.ragged_instance(dtype, kv_dtype)
    before = _cuda.LAUNCHES["ragged_attention"], _cuda.LAUNCHES[inst]
    out, _, _ = ra.ragged_attention(q, kp, vp, table, ctx, ql, fk, fv, **kw)
    torch.cuda.synchronize()
    assert (_cuda.LAUNCHES["ragged_attention"], _cuda.LAUNCHES[inst]) == (
        before[0] + 1, before[1] + 1)
    ref, _, _ = ra.ragged_attention_plain(q, kp2, vp2, table, ctx, ql, fk,
                                          fv, **kw)
    _close(out, ref, _tol_dtype(dtype, kv_dtype))
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    for i, (_, qi) in enumerate(rows):
        assert float(out[i, qi:].abs().max() if qi < qmax else 0) == 0.0


# the tensor-core instance's rows (ctx_len, q_len), pages of 16: an inert
# row aimed at row 1's live pages, decode rows with the context on a tile
# boundary (64), on a page boundary (16), empty and ragged, a 256-query
# chunk from ctx 0 beside them, chunks straddling pages (37 + 100, 64 +
# 33) and an inert row with a context
RAGGED_MMA_ROWS = [(0, 0), (64, 1), (16, 1), (0, 1), (127, 1), (0, 256),
                   (37, 100), (64, 33), (300, 0)]


def _ragged_mma_case(card, rows, h, hkv, dh, p, mp, seed):
    """bf16 over bf16 pools (the mma instance): each live (row, query,
    head) vector within 1e-2 of the plain version on the same values
    widened to fp32 (max|out - ref32| / max|ref32|), the rest within the
    bf16 tolerance of the bf16 plain version, dead rows exactly 0, and the
    pools bit-equal to the plain version's after the writeback (so an
    inert row's pages, another row's live ones, are untouched)."""
    g = torch.Generator(device=card).manual_seed(seed)
    r = len(rows)
    n = r * mp + 8
    qmax = max(q for _, q in rows)
    i32 = dict(dtype=torch.int32, device=card)
    ctx = torch.tensor([c for c, _ in rows], **i32)
    ql = torch.tensor([q for _, q in rows], **i32)
    table = torch.randperm(n, generator=g, device=card)[: r * mp].reshape(
        r, mp).to(torch.int32)
    table[0] = table[1]
    bf = torch.bfloat16
    q = torch.randn((r, qmax, h, dh), generator=g, device=card).to(bf)
    fk = torch.randn((r, qmax, hkv, dh), generator=g, device=card).to(bf)
    fv = torch.randn((r, qmax, hkv, dh), generator=g, device=card).to(bf)
    kp = torch.randn((2 * n, p, hkv * dh), generator=g, device=card).to(bf)
    vp = torch.randn_like(kp)
    kp2, vp2 = kp.clone(), vp.clone()
    kp32, vp32 = kp.float(), vp.float()
    kw = dict(n_kv_heads=hkv, layer=1, n_pages_per_layer=n)
    assert ra.ragged_instance(bf, bf) == "mma"
    before = _cuda.LAUNCHES["ragged_attention.mma"]
    out, _, _ = ra.ragged_attention(q, kp, vp, table, ctx, ql, fk, fv, **kw)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["ragged_attention.mma"] == before + 1
    ref, _, _ = ra.ragged_attention_plain(q, kp2, vp2, table, ctx, ql, fk,
                                          fv, **kw)
    ref32, _, _ = ra.ragged_attention_plain(
        q.float(), kp32, vp32, table, ctx, ql, fk.float(), fv.float(), **kw)
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    valid = torch.arange(qmax, device=card)[None, :] < ql[:, None]
    assert float(out[~valid].abs().max()) == 0.0
    row_err = (out.float() - ref32).abs().amax(-1)[valid]
    row_ref = ref32.abs().amax(-1)[valid]
    assert float((row_err / row_ref).max()) <= 1e-2
    _close(out, ref, bf)


# the tensor-core instance's rows (ctx_len, q_len), pages of 16: an inert
# row aimed at row 1's live pages, decode rows with the context on a tile
# boundary (64), on a page boundary (16), empty and ragged, a 256-query
# chunk from ctx 0 beside them, chunks straddling pages (37 + 100, 64 +
# 33) and an inert row with a context
RAGGED_MMA_ROWS = [(0, 0), (64, 1), (16, 1), (0, 1), (127, 1), (0, 256),
                   (37, 100), (64, 33), (300, 0)]


@pytest.mark.parametrize("dh", [32, 64, 128, 256])
@pytest.mark.parametrize("h,hkv", [(8, 8), (8, 4), (16, 4), (16, 2)])
def test_ragged_attention_tensor_cores(card, h, hkv, dh):
    """The mma instance at G 1, 2, 4 and 8 and every head width (see
    _ragged_mma_case)."""
    _ragged_mma_case(card, RAGGED_MMA_ROWS, h, hkv, dh, 16, 24,
                     seed=40 + dh + h + hkv)


def _fresh_kv(shape, g, card, dtype, kv8, scale):
    """Fresh K or V of ``shape`` in ``dtype``: normal draws; over e4m3
    scaled by ``scale`` (300 and up: part of it overflows to NaN bytes);
    over e5m2 with ``scale`` > 1 one value in 500 set to +-70,000 instead
    (past 61,440: +-inf), the rest left unscaled. Values near e5m2's top
    would make the scores tens of thousands, where fp32 rounding alone
    moves a softmax by percents: the kernel and the plain version would
    then differ by the summation order, not by a fault."""
    x = torch.randn(shape, generator=g, device=card)
    if kv8 != E5M2:
        return (x * scale).to(dtype)
    if scale > 1:
        pick = torch.rand(shape, generator=g, device=card) < 2e-3
        x = torch.where(pick, torch.sign(x) * 7e4, x)
    return x.to(dtype)


def _same_specials(out, ref):
    """NaN where the plain version is NaN, and +-inf where it is +-inf."""
    out, ref = out.float(), ref.float()
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    inf = torch.isinf(ref)
    assert torch.equal(torch.isinf(out), inf)
    assert torch.equal(out[inf], ref[inf])


def _minus_inf_rows(q, kp, table, ctx, ql, fk, kv8, hkv, layer, n):
    """The (row, query, head) vectors of a ragged call whose every visible
    key scores -inf (an infinite e5m2 key entry against q's sign), as a
    [R, Qmax, H] mask: scores in fp32 over the pages (the visible context
    keys lie below ``ctx``, which the call's writeback leaves as they were)
    and the fresh keys rounded as they are stored."""
    r, qmax, h, dh = q.shape
    pages = raw_view(kp)[layer * n + table.long()]
    k_ctx = pages.view(kv8).reshape(r, -1, hkv, dh).float()
    k = torch.cat([k_ctx, astype_kv(fk, kv8).float()], 1)
    s = torch.einsum("bikgd,bjkd->bkgij",
                     q.float().reshape(r, qmax, hkv, h // hkv, dh), k)
    tc = k_ctx.shape[1]
    j = torch.arange(tc + qmax, device=q.device)[None, None, :]
    i = torch.arange(qmax, device=q.device)[None, :, None]
    vis = torch.where(j < tc, j < ctx.long()[:, None, None],
                      (j - tc <= i) & (j - tc < ql.long()[:, None, None]))
    vis = vis[:, None, None]                          # [R, 1, 1, Qmax, T]
    dead = ((s == float("-inf")) | ~vis).all(-1) & vis.any(-1)
    return dead.permute(0, 3, 1, 2).reshape(r, qmax, h)


def _ragged_specials(out, ref, dead):
    """The ragged kernel over infinite fresh keys, held to the plain
    version, which follows the TPU kernel's rule (``_ragged_block``) as
    the CUDA kernel does: outside the ``dead`` vectors
    (``_minus_inf_rows``) +-inf where the plain version has them, NaN only
    where it has NaN, finite values where it is finite; on the dead
    vectors, whose visible keys all score -inf, every probability is 0:
    both give exactly 0, NaN only in a dim where a key they multiply has
    an infinite V (0 x inf). One case stays outside this contract: a
    masked key whose V is infinite. The plain version (as both JAX
    implementations) multiplies every masked key's V by its probability
    0, so such a key makes a query's dim NaN; the kernel multiplies the
    masked keys of the tiles it visits alone, so where the plain version
    is NaN the kernel may be NaN, +-inf or finite, and on a dead vector
    0 or NaN."""
    keep = ~dead[..., None].expand_as(out)
    o, r = out.float()[keep], ref.float()[keep]
    assert not (torch.isnan(o) & ~torch.isnan(r)).any()
    inf = torch.isinf(r)
    assert torch.equal(o[inf], r[inf])
    assert bool(torch.isfinite(o[torch.isfinite(r)]).all())
    o, r = out.float()[~keep], ref.float()[~keep]
    assert bool(((r == 0) | torch.isnan(r)).all())
    assert bool(((o == 0) | torch.isnan(o)).all())
    assert not (torch.isnan(o) & ~torch.isnan(r)).any()
    assert bool((o[r == 0] == 0).all())


@pytest.mark.parametrize("kv8", list(FP8S), ids=FP8_IDS)
@pytest.mark.parametrize("past", [False, True], ids=["in range", "past limit"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,hkv,dh", [(8, 8, 32), (8, 4, 64), (16, 4, 128),
                                      (16, 2, 128), (16, 2, 256),
                                      (28, 4, 128), (12, 2, 64)])
def test_ragged_attention_fp8_pools(card, dtype, h, hkv, dh, past, kv8):
    """e4m3 and e5m2 pools (the fp8 instances: bf16 q on the tensor cores,
    fp32 q on the CUDA cores) over the tensor-core instance's rows, G 1-8
    and Dh 32-256: the pools byte-equal to the plain version's after the
    writeback (the fresh K/V rounded with JAX's cast; past the limit part
    of it overflows to NaN bytes, or e5m2's +-inf), outputs within q's
    tolerance where the plain version's are finite (over e5m2 NaN and
    +-inf where it has them), dead rows exactly 0."""
    fresh_scale = 300.0 if past else 1.0
    g = torch.Generator(device=card).manual_seed(90 + dh + h)
    rows, p, mp = RAGGED_MMA_ROWS, 16, 24
    r, qmax = len(rows), max(q for _, q in RAGGED_MMA_ROWS)
    n = r * mp + 8
    i32 = dict(dtype=torch.int32, device=card)
    ctx = torch.tensor([c for c, _ in rows], **i32)
    ql = torch.tensor([q for _, q in rows], **i32)
    table = torch.randperm(n, generator=g, device=card)[: r * mp].reshape(
        r, mp).to(torch.int32)
    table[0] = table[1]
    q = torch.randn((r, qmax, h, dh), generator=g, device=card).to(dtype)
    fk = _fresh_kv((r, qmax, hkv, dh), g, card, dtype, kv8, fresh_scale)
    fv = _fresh_kv((r, qmax, hkv, dh), g, card, dtype, kv8, fresh_scale)
    kp = torch.randn((2 * n, p, hkv * dh), generator=g, device=card).to(kv8)
    vp = torch.randn((2 * n, p, hkv * dh), generator=g, device=card).to(kv8)
    kp2, vp2 = kp.clone(), vp.clone()
    kw = dict(n_kv_heads=hkv, layer=1, n_pages_per_layer=n)
    inst = "ragged_attention." + ra.ragged_instance(dtype, kv8)
    assert inst.endswith("mma" if dtype == torch.bfloat16 else "simt")
    names = ("ragged_attention", f"ragged_attention.{FP8S[kv8]}", inst)
    before = [_cuda.LAUNCHES[k] for k in names]
    out, _, _ = ra.ragged_attention(q, kp, vp, table, ctx, ql, fk, fv, **kw)
    torch.cuda.synchronize()
    assert [_cuda.LAUNCHES[k] for k in names] == [c + 1 for c in before]
    ref, _, _ = ra.ragged_attention_plain(q, kp2, vp2, table, ctx, ql, fk,
                                          fv, **kw)
    assert _same_bytes(kp, kp2) and _same_bytes(vp, vp2)
    assert bool(raw_view(kp).any())
    valid = torch.arange(qmax, device=card)[None, :] < ql[:, None]
    assert float(out[~valid].float().abs().max()) == 0.0
    finite = torch.isfinite(ref.float())
    if past:
        special = torch.isinf if kv8 == E5M2 else torch.isnan
        assert bool(special(kp.float()).any())
        if kv8 == E5M2:
            assert bool((~finite).any()) and bool(finite.any())
            dead = _minus_inf_rows(q, kp, table, ctx, ql, fk, kv8,
                                   hkv, 1, n)
            _ragged_specials(out, ref, dead)
            finite &= ~dead[..., None]
    else:
        assert bool(finite.all())
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float()[finite], ref.float()[finite],
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("h,hkv,dh", [(12, 4, 64), (10, 2, 128),
                                      (12, 2, 128), (28, 4, 128),
                                      (14, 2, 64), (24, 2, 32), (32, 2, 256),
                                      (96, 1, 32)])
def test_ragged_attention_any_group(card, h, hkv, dh):
    """The mma instance at query-head groups that do not divide its 128
    rows (G 3, 5, 6, 7 (Qwen2), 12, 16: floor(128 / G) queries a tile, the
    rows past them dead) and above 64 (G 96: two sub-groups of 64 rows,
    the second half dead), see _ragged_mma_case."""
    _ragged_mma_case(card, RAGGED_MMA_ROWS, h, hkv, dh, 16, 24,
                     seed=140 + dh + h + hkv)


def test_ragged_attention_tensor_cores_many_pairs(card):
    """More (row, query tile) pairs than the kernel ranks on the card (40
    rows x 16 tiles of 16 queries at G 8): the blocks walk the plain
    round-robin order instead; long decode contexts (to 1,000 keys)."""
    rows = [(0, 0)] + [(25 * i, 1) for i in range(1, 38)] + [(0, 256),
                                                               (500, 77)]
    _ragged_mma_case(card, rows, 16, 2, 128, 16, 64, seed=77)


def _paged_plan(card, b, h, hkv, dh, p, mp, window, dtype, kv_dtype,
                mma=None):
    """The wrapper's launch plan at these shapes (``mma`` given: that
    route's)."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    max_keys = min(mp * p, window) if window else mp * p
    return pa.paged_plan(b, h, hkv, dh, max_keys, sms, dtype, kv_dtype,
                         mma=mma)


def _paged_case(card, dtype, kv_dtype, h, hkv, dh, p, mp, lens, window,
                seed, mma=None):
    """Per-layer and stacked (layer 1) pools: out and the flash stats
    against the plain version (stats on the inputs widened to fp32), each
    call one launch of its route and pool instance; ``mma`` given: that
    route (``paged_attention_launch``) rather than the wrapper's rule."""
    g = torch.Generator(device=card).manual_seed(seed)
    b = len(lens)
    n = b * mp + 4
    q = torch.randn((b, h, dh), generator=g, device=card).to(dtype)
    kp = torch.randn((2 * n, p, hkv * dh), generator=g,
                     device=card).to(kv_dtype)
    vp = _randn_like(kp)
    table = torch.randperm(n, generator=g, device=card)[: b * mp].reshape(
        b, mp).to(torch.int32)
    lengths = torch.tensor(lens, dtype=torch.int32, device=card)
    plan = _paged_plan(card, b, h, hkv, dh, p, mp, window, dtype, kv_dtype,
                      mma)
    route = f"paged_attention.{'mma' if plan.mma else 'simt'}"
    inst = f"paged_attention.{FP8S.get(kv_dtype, 'fp8')}"
    for kw in (dict(), dict(layer=1, n_pages_per_layer=n)):
        pools = (kp[:n], vp[:n]) if not kw else (kp, vp)
        before = (_cuda.LAUNCHES["paged_attention"],
                  _cuda.LAUNCHES[inst],
                  _cuda.LAUNCHES[route])
        call_kw = dict(n_kv_heads=hkv, window=window, with_stats=True, **kw)
        if mma is None:
            out, m, l = pa.paged_attention(q, *pools, table, lengths,
                                           **call_kw)
        else:
            out, m, l = pa.paged_attention_launch(q, *pools, table, lengths,
                                                  plan, **call_kw)
        torch.cuda.synchronize()
        assert (_cuda.LAUNCHES["paged_attention"],
                _cuda.LAUNCHES[inst],
                _cuda.LAUNCHES[route]) == (
            before[0] + 1, before[1] + (kv_dtype in FP8S), before[2] + 1)
        ref = pa.paged_attention_xla(q, *pools, table, lengths,
                                     n_kv_heads=hkv, window=window, **kw)
        _close(out, ref, _tol_dtype(dtype, kv_dtype))
        # the stats against the plain version on the same values widened
        # to fp32 (the bf16 plain version rounds its scores to bf16; the
        # kernel keeps them in fp32)
        _, rm, rl = pa.paged_attention_xla(
            q.float(), *(t.float() for t in pools), table, lengths,
            n_kv_heads=hkv, window=window, with_stats=True, **kw)
        live = rl > 0
        torch.testing.assert_close(m[live], rm[live], atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)
        empty = lengths == 0
        assert float(out[empty].abs().max() if empty.any() else 0) == 0.0
        assert float(l[empty].abs().max() if empty.any() else 0) == 0.0
        assert bool((m[empty] <= -1e29).all())


@pytest.mark.parametrize("window", [0, 16, 40])
@pytest.mark.parametrize("dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("h,hkv,dh", [(8, 8, 32), (8, 4, 64), (32, 8, 128),
                                      (16, 2, 128)])
def test_paged_attention_kernel(card, dtype, kv_dtype, window, h, hkv, dh):
    """Lengths 0 (an empty slot), around page edges and windows, a full
    table; per-layer and stacked (layer 1) pools, out and the flash stats
    against the plain version."""
    _paged_case(card, dtype, kv_dtype, h, hkv, dh, 16, 6,
                [0, 1, 15, 16, 17, 40, 41, 56, 57, 96], window, seed=5)


@pytest.mark.parametrize("kv8", list(FP8S), ids=FP8_IDS)
@pytest.mark.parametrize("window", [0, 16, 40])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,hkv,dh", [(8, 8, 32), (16, 8, 64), (16, 4, 128),
                                      (16, 2, 128)])
def test_paged_attention_fp8_pools(card, dtype, window, h, hkv, dh, kv8):
    """e4m3 and e5m2 pools (the fp8 instances: the tensor cores for bf16
    q, 8 values a lane on the CUDA cores for fp32) at G 1-8 and Dh 32-128
    with and without the sliding window: out and the flash stats against
    the plain version, as the other pairs."""
    _paged_case(card, dtype, kv8, h, hkv, dh, 16, 6,
                [0, 1, 15, 16, 17, 40, 41, 56, 57, 96], window, seed=6)


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("dtype,kv_dtype", POOL_PAIRS)
@pytest.mark.parametrize("h,hkv,dh", ANY_GROUP)
def test_paged_attention_any_group(card, dtype, kv_dtype, window, h, hkv,
                                   dh):
    """Query-head groups that are not one of the instances (sub-groups of
    8 above 8, dead rows past G), with and without the window, in every
    pool dtype: out and the flash stats against the plain version."""
    _paged_case(card, dtype, kv_dtype, h, hkv, dh, 16, 6,
                [0, 1, 15, 16, 17, 40, 41, 56, 57, 96], window, seed=7 + h)


@pytest.mark.parametrize("window", [0, 16, 40])
@pytest.mark.parametrize("dtype,kv_dtype", POOL_PAIRS + [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("h,hkv", [(16, 16), (8, 1), (14, 2), (4, 2)])
def test_paged_attention_head_dim_256(card, dtype, kv_dtype, window, h,
                                      hkv):
    """Dh 256 (Gemma: 16 heads over 16 KV heads, Gemma-2B's 8 over 1, and
    G 7 and 2) in every pool dtype, with and without the window: out and
    the flash stats against the plain version."""
    _paged_case(card, dtype, kv_dtype, h, hkv, 256, 16, 6,
                [0, 1, 15, 16, 17, 40, 41, 56, 57, 96], window, seed=8 + h)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [0, 4096, 1000])
@pytest.mark.parametrize("slots", ["one long", "split edges"])
def test_paged_attention_split_kv(card, dtype, window, slots):
    """A slot's keys cut over many blocks at the Mistral widths (H 32, Hkv
    8, Dh 128, pages of 128, 48 a slot): B = 1 with a 6,000-key slot, and 8
    slots with lengths on the split edges, one key either side of them, a
    window whose first key falls mid-run (window 1000) and the empty
    slot."""
    p, mp, hkv = 128, 48, 8
    max_keys = min(mp * p, window) if window else mp * p
    if slots == "one long":
        lens = [6000]
    else:
        sms = torch.cuda.get_device_properties(card).multi_processor_count
        n_split, chunk = pa.paged_split(8, hkv, max_keys, sms)
        assert n_split > 1 and n_split * chunk >= max_keys
        lens = [0, 1, chunk, chunk + 1, 2 * chunk - 1, 3 * chunk,
                min(mp * p, (window or 4096) + chunk), 6000]
    _paged_case(card, dtype, dtype, 32, hkv, 128, p, mp, lens, window,
                seed=len(lens) + window)


# the tensor-core route's edges: G 9, 15 and 16 (one 16-row block a KV
# head, rows past G dead), 17, 24, 32 and 96 (sub-groups of 16)
MMA_GROUPS = [(9, 1, 128), (15, 1, 64), (16, 1, 128), (17, 1, 64),
              (24, 1, 128), (64, 2, 64), (96, 1, 32)]
BF16_POOLS = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, FP8),
              (torch.bfloat16, E5M2)]


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("dtype,kv_dtype", BF16_POOLS)
@pytest.mark.parametrize("h,hkv,dh", MMA_GROUPS)
def test_paged_attention_tensor_core_groups(card, dtype, kv_dtype, window,
                                            h, hkv, dh):
    """bf16 q over bf16 and e4m3 pools on the tensor cores at the 16-row
    instance's edges, with and without the window: out and the flash
    stats of every row against the plain version."""
    plan = _paged_plan(card, 10, h, hkv, dh, 16, 6, window, dtype, kv_dtype)
    assert plan.mma and plan.rows == 16
    assert plan.n_sub == -(-(h // hkv) // 16)
    _paged_case(card, dtype, kv_dtype, h, hkv, dh, 16, 6,
                [0, 1, 15, 16, 17, 40, 41, 56, 57, 96], window, seed=9 + h)


PAGED_PAIRS = POOL_PAIRS + [(torch.float32, torch.bfloat16),
                            (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("dtype,kv_dtype", PAGED_PAIRS)
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
@pytest.mark.parametrize("h,hkv", [(12, 2), (16, 1)])
def test_paged_attention_every_width(card, dtype, kv_dtype, window, dh, h,
                                     hkv):
    """Every head width in every pool pair, the mixed pairs included, at G
    6 (the 8-row tile, two dead rows; a sub-group of 8 on the CUDA cores)
    and G 16 (the full 16-row tile; two sub-groups of 8)."""
    _paged_case(card, dtype, kv_dtype, h, hkv, dh, 16, 6,
                [0, 1, 15, 16, 17, 40, 41, 56, 57, 96], window,
                seed=11 + dh + h)


@pytest.mark.parametrize("dtype,kv_dtype", PAGED_PAIRS)
@pytest.mark.parametrize("h,hkv,dh", [(28, 4, 128), (16, 1, 256),
                                      (64, 4, 64)])
def test_paged_attention_window_mid_tile(card, dtype, kv_dtype, h, hkv, dh):
    """A window whose first key falls mid-page (pages of 16) and mid-tile
    (tiles of 16 to 64 keys) for every slot, the runs of a split grid
    starting there: len - window = 23, 50, 137, 201 and 2,101."""
    window = 1000
    lens = [1023, 1050, 1137, 1201, 3101, 0]
    plan = _paged_plan(card, len(lens), h, hkv, dh, 16, 200, window, dtype,
                       kv_dtype)
    assert plan.n_split > 1 and plan.n_split * plan.chunk >= window
    _paged_case(card, dtype, kv_dtype, h, hkv, dh, 16, 200, lens, window,
                seed=12 + h)


@pytest.mark.parametrize("dtype,kv_dtype", BF16_POOLS)
@pytest.mark.parametrize("window", [0, 4096, 1000])
@pytest.mark.parametrize("h,hkv,dh", [(28, 4, 128), (64, 4, 128),
                                      (8, 1, 256)])
@pytest.mark.parametrize("slots", ["one run", "split edges"])
def test_paged_attention_tensor_core_split(card, dtype, kv_dtype, window, h,
                                           hkv, dh, slots):
    """The tensor-core route's split grid at Qwen2-7B's G 7, G 16 and
    Gemma-2B's 8 over 1 at Dh 256 (pages of 128, 48 a slot): 8 slots with
    lengths on the run edges and one key either side, a window whose first
    key falls mid-run, the empty slot; and one run a slot (64 slots of
    short tables: no merge)."""
    p = 128
    if slots == "one run":
        mp, lens = 2, [0, 1, 100, 127, 128, 129, 200, 256] * 8
    else:
        mp = 48
        plan = _paged_plan(card, 8, h, hkv, dh, p, mp, window, dtype,
                           kv_dtype)
        chunk = plan.chunk
        assert plan.n_split > 1
        lens = [0, 1, chunk, chunk + 1, 2 * chunk - 1, 3 * chunk,
                min(mp * p, (window or 4096) + chunk), 6000]
    plan = _paged_plan(card, len(lens), h, hkv, dh, p, mp, window, dtype,
                       kv_dtype)
    assert plan.mma and (plan.n_split == 1) == (slots == "one run")
    _paged_case(card, dtype, kv_dtype, h, hkv, dh, p, mp, lens, window,
                seed=13 + h + window)


@pytest.mark.parametrize("mma", [True, False])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("dtype,kv_dtype", BF16_POOLS)
@pytest.mark.parametrize("h,hkv,dh", [(8, 8, 128), (8, 4, 128), (8, 2, 128),
                                      (4, 4, 256), (4, 2, 256),
                                      (4, 1, 256)])
def test_paged_attention_both_routes(card, mma, window, dtype, kv_dtype, h,
                                     hkv, dh):
    """bf16 q at G 1, 2 and 4 (Dh 128 and 256) on both routes, the
    wrapper's rule and the other: each against the plain version."""
    _paged_case(card, dtype, kv_dtype, h, hkv, dh, 16, 6,
                [0, 1, 15, 16, 17, 40, 41, 56, 57, 96], window,
                seed=14 + h + dh, mma=mma)


def test_paged_attention_graph_replay(card):
    """The tensor-core route (G 7, split grid, stats, fp8 and bf16 pools)
    captured in a CUDA graph replays bit-equal to an eager call, and a
    replay over new lengths and q equals an eager call on them."""
    g = torch.Generator(device=card).manual_seed(15)
    b, h, hkv, dh, p, mp, window = 8, 28, 4, 128, 128, 48, 4096
    n = b * mp
    i32 = dict(dtype=torch.int32, device=card)
    for kv_dtype in (torch.bfloat16, FP8, E5M2):
        q = torch.randn((b, h, dh), generator=g, device=card).to(
            torch.bfloat16)
        kp = torch.randn((n, p, hkv * dh), generator=g,
                         device=card).to(kv_dtype)
        vp = _randn_like(kp)
        table = torch.randperm(n, generator=g, device=card).reshape(
            b, mp).to(torch.int32)
        lens = torch.tensor([0, 1, 127, 1500, 4097, 4224, 4225, 6000], **i32)
        kw = dict(n_kv_heads=hkv, window=window, with_stats=True)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):  # the capture stream's scratch
            pa.paged_attention(q, kp, vp, table, lens, **kw)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            got = pa.paged_attention(q, kp, vp, table, lens, **kw)
        for new in (False, True):
            if new:
                q.copy_(torch.randn(q.shape, generator=g, device=card))
                lens.copy_(torch.tensor([6000, 0, 4097, 33, 1, 4096, 129,
                                         5000], **i32))
            graph.replay()
            want = pa.paged_attention(q, kp, vp, table, lens, **kw)
            torch.cuda.synchronize()
            for a, w in zip(got, want):
                assert torch.equal(a, w), kv_dtype


# ----------------------------------------- e4m3 and e5m2 tiles (PERF.md)
#
# The fp8 path of flash-decode, its fw form and paged attention's
# tensor-core route reads its K and V fragments from fp8 tiles and widens
# them in registers; the ragged tensor-core instance widens its fp8 tiles
# in place in shared memory: every e4m3 and e5m2 byte through them, keys
# on and around the tiles' edges (64 keys, 32 at Dh 256), NaN bytes (and
# e5m2's infinities), graph replays.


def _all_bytes(n_rows, width, shift=0, dtype=FP8):
    """n_rows rows of ``dtype`` holding every byte value (e4m3: 0x7F and
    0xFF are NaN; e5m2: 0x7C and 0xFC are +-inf, 0x7D-0x7F and 0xFD-0xFF
    NaN), each row's bytes rolled by its index (plus ``shift``)."""
    base = torch.arange(256, dtype=torch.uint8).repeat(-(-width // 256))
    rows = [torch.roll(base[:width], i + shift) for i in range(n_rows)]
    return torch.stack(rows).view(dtype)


def _widened_equal(got, want):
    """got (bf16) equals want (fp8 widened exactly) value for value: NaN
    where the byte is NaN, every other value equal, +-inf included (-0
    reads as 0: the sum of one weighted key starts from +0)."""
    want = want.to(torch.bfloat16)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.parametrize("kv8", list(FP8S), ids=FP8_IDS)
@pytest.mark.parametrize("kernel", ["flash_decode", "flash_decode_fw",
                                    "paged_attention"])
@pytest.mark.parametrize("hkv,dh", [(2, 128), (1, 256), (4, 64)])
def test_fp8_one_key_gives_every_widened_byte(card, kernel, hkv, dh, kv8):
    """A slot whose one key's V row holds every e4m3 (or e5m2) byte: the
    softmax weight is exactly 1, so each output row is that V row widened
    to bf16, value for value, NaN where the byte is NaN and +-inf where it
    is +-inf (G 4, bf16 q, the tensor cores; a split grid of several runs,
    all but the first empty)."""
    g = torch.Generator(device=card).manual_seed(70 + dh)
    b, p, mp, h = 4, 16, 24, 4 * hkv
    n = b * mp
    i32 = dict(dtype=torch.int32, device=card)
    q = torch.randn((b, h, dh), generator=g, device=card).to(torch.bfloat16)
    kp = torch.randn((n, p, hkv * dh), generator=g, device=card).to(kv8)
    vp = torch.randn((n, p, hkv * dh), generator=g, device=card).to(kv8)
    table = torch.randperm(n, generator=g, device=card).reshape(b, mp).to(
        torch.int32)
    rows = _all_bytes(b, hkv * dh, dtype=kv8).to(card)
    for i in range(b):
        raw_view(vp)[table[i, 0], 0] = raw_view(rows[i])   # slot i's key 0
    ones = torch.ones(b, **i32)
    if kernel == "paged_attention":
        out = pa.paged_attention(q, kp, vp, table, ones, n_kv_heads=hkv)
    else:
        w = 8
        sk = torch.randn((b, w, hkv, dh), generator=g, device=card).to(
            torch.bfloat16)
        sv = torch.randn_like(sk)
        zeros = torch.zeros(b, **i32)
        if kernel == "flash_decode":
            out = fd.flash_decode_attention(q, kp, vp, table, ones, sk, sv,
                                            zeros, n_kv_heads=hkv)
        else:
            out, _, _ = fd.flash_decode_attention_fw(
                q, kp, vp, table, ones, sk, sv, sk[:, :1].contiguous(),
                sv[:, :1].contiguous(), zeros, zeros, n_kv_heads=hkv)
    torch.cuda.synchronize()
    want = rows.to(torch.bfloat16).reshape(b, hkv, 1, dh).expand(
        b, hkv, h // hkv, dh)
    _widened_equal(out, want.reshape(b, h, dh))


@pytest.mark.parametrize("kv8", list(FP8S), ids=FP8_IDS)
@pytest.mark.parametrize("dh", [128, 256, 64])
def test_ragged_attention_fp8_one_key_gives_every_widened_byte(card, dh,
                                                               kv8):
    """The ragged fp8 instances' staging paths with one weighted key
    (decode rows, and rows of 9 queries at G 4): rows over one context key
    whose V row holds every e4m3 (e5m2) byte (its K all 448 against q of
    ones, the fresh keys' K and V zero, so they weigh exp(-thousands) = 0),
    and rows with no context whose first fresh V holds every such value in
    bf16 (rounded back exactly; query 0 sees that key alone): each such
    output row is that V row widened, NaN where the byte is NaN, +-inf
    where it is +-inf."""
    hkv, b, p, mp = 256 // dh, 4, 16, 8
    h = 4 * hkv
    g = torch.Generator(device=card).manual_seed(80 + dh)
    rows = ([(1, 1)] * b + [(0, 1)] * b + [(1, 9)] * b + [(0, 9)] * b)
    r = len(rows)
    n = r * mp
    i32 = dict(dtype=torch.int32, device=card)
    ctx = torch.tensor([c for c, _ in rows], **i32)
    ql = torch.tensor([q for _, q in rows], **i32)
    table = torch.randperm(n, generator=g, device=card).reshape(r, mp).to(
        torch.int32)
    q = torch.ones((r, 9, h, dh), dtype=torch.bfloat16, device=card)
    kp = torch.randn((n, p, hkv * dh), generator=g, device=card).to(kv8)
    vp = torch.randn((n, p, hkv * dh), generator=g, device=card).to(kv8)
    want = _all_bytes(r, hkv * dh, dtype=kv8).to(card)
    fk = torch.zeros((r, 9, hkv, dh), dtype=torch.bfloat16, device=card)
    fv = torch.zeros_like(fk)
    k448 = raw_view(torch.full((hkv * dh,), 448.0).to(kv8)).to(card)
    for i, (c, _) in enumerate(rows):
        if c:
            raw_view(kp)[table[i, 0], 0] = k448
            raw_view(vp)[table[i, 0], 0] = raw_view(want[i])
        else:
            fk[i, 0] = torch.randn((hkv, dh), generator=g, device=card).to(
                torch.bfloat16)
            fv[i, 0] = want[i].to(torch.bfloat16).reshape(hkv, dh)
    inst = f"ragged_attention.{FP8S[kv8]}"
    before = _cuda.LAUNCHES[inst]
    out, _, _ = ra.ragged_attention(q, kp, vp, table, ctx, ql, fk, fv,
                                    n_kv_heads=hkv)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[inst] == before + 1
    rows_bf = want.to(torch.bfloat16).reshape(r, hkv, 1, dh).expand(
        r, hkv, h // hkv, dh).reshape(r, h, dh)
    for i, (c, n_q) in enumerate(rows):
        # context rows: every query; fresh rows: query 0 alone
        for qi in range(n_q if c else 1):
            _widened_equal(out[i, qi], rows_bf[i])


def _fp8_edges(card, dh, p, mp, hkv):
    """Twelve prefix lengths: one below, on and one above the e4m3 tile's
    keys and twice them, a page's keys, and the split grid's run at twelve
    slots."""
    keys = fd.fp8_tile_keys(dh)
    _, chunk = fd.flash_decode_split(12, hkv, p, mp, card)
    return [k + d for k in (keys, 2 * keys, p, chunk) for d in (-1, 0, 1)]


@pytest.mark.parametrize("kv8", list(FP8S), ids=FP8_IDS)
@pytest.mark.parametrize("fw", [False, True])
@pytest.mark.parametrize("h,hkv,dh", [(32, 8, 128), (28, 4, 128),
                                      (8, 1, 256), (16, 4, 64)])
def test_flash_decode_fp8_tile_edges(card, fw, h, hkv, dh, kv8):
    """fp8 pools, bf16 q: prefix lengths on and around the fp8 tile's
    keys, the pages (16) and the split grid's runs (see _fd_split_case)."""
    lens = _fp8_edges(card, dh, 16, 40, hkv)
    _fd_split_case(card, torch.bfloat16, kv8, h, hkv, dh, 16, 40, lens, fw,
                   seed=170 + fw + dh)


@pytest.mark.parametrize("kv8", list(FP8S), ids=FP8_IDS)
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("h,hkv,dh", [(32, 8, 128), (28, 4, 128),
                                      (8, 1, 256), (64, 4, 128)])
def test_paged_attention_fp8_tile_edges(card, window, h, hkv, dh, kv8):
    """The tensor-core route over fp8 pools at lengths on and around the
    fp8 tile's keys and the pages (see _paged_case)."""
    keys = fd.fp8_tile_keys(dh)
    lens = sorted({k + d for k in (keys, 2 * keys, 16, 96)
                   for d in (-1, 0, 1)})
    _paged_case(card, torch.bfloat16, kv8, h, hkv, dh, 16, 12, lens, window,
                seed=180 + dh + h)


def _nan_bytes(pool, pages, key, kh, dh, dims, byte=0x7F):
    """Set dims ``dims`` of KV head kh of key ``key`` (in pages ``pages``
    of 16) to ``byte`` (the NaN byte 0x7F; e5m2's +-inf 0x7C, 0xFC)."""
    raw = raw_view(pool)
    row = raw[pages[key // 16], key % 16]
    for d in dims:
        row[kh * dh + d] = byte


# the bytes set in live keys: NaN (0x7F: e4m3's overflow, an e5m2 NaN) in
# either pool; e5m2's +inf and -inf (JAX's overflow) in K and V
SPECIAL_BYTES = [(FP8, (0x7F, 0x7F)), (E5M2, (0x7F, 0x7F)),
                 (E5M2, (0x7C, 0xFC))]


@pytest.mark.parametrize("kv8,bytes_", SPECIAL_BYTES,
                         ids=["e4m3 nan", "e5m2 nan", "e5m2 inf"])
@pytest.mark.parametrize("kernel", ["flash_decode", "flash_decode_fw",
                                    "paged_attention", "ragged_attention"])
@pytest.mark.parametrize("h,hkv,dh", [(32, 8, 128), (8, 1, 256)])
def test_fp8_nan_bytes_in_live_keys(card, kernel, h, hkv, dh, kv8, bytes_):
    """NaN bytes (0x7F, e4m3's overflow) and e5m2's +-inf (its overflow) in
    live keys match the plain version: a NaN in a K row makes its KV head's
    rows NaN, a NaN in a V row that dim of them; an infinite K entry makes
    a row's score +-inf (+inf: NaN rows; -inf: the key weighs 0, and 0 x an
    infinite V is NaN), an infinite V entry that dim +-inf: NaN and +-inf
    where the plain version has them, every other output within q's
    tolerance."""
    g = torch.Generator(device=card).manual_seed(190 + dh)
    b, p, mp = 6, 16, 24
    n = b * mp + 4
    i32 = dict(dtype=torch.int32, device=card)
    lens = [5, 70, 200, 63, 333, 17]
    q = torch.randn((b, h, dh), generator=g, device=card).to(torch.bfloat16)
    kp = torch.randn((n, p, hkv * dh), generator=g, device=card).to(kv8)
    vp = torch.randn((n, p, hkv * dh), generator=g, device=card).to(kv8)
    table = torch.randperm(n, generator=g, device=card)[: b * mp].reshape(
        b, mp).to(torch.int32)
    pos, neg = bytes_
    _nan_bytes(kp, table[1], 66, 0, dh, [3], pos)      # K: slot 1, head 0
    _nan_bytes(vp, table[2], 150, hkv - 1, dh, [0], pos)      # V: slot 2
    _nan_bytes(vp, table[2], 150, hkv - 1, dh, [dh - 1], neg)
    _nan_bytes(kp, table[4], 331, hkv - 1, dh, [dh // 2], neg)  # slot 4
    plen = torch.tensor(lens, **i32)
    w = 8
    sk = torch.randn((b, w, hkv, dh), generator=g, device=card).to(
        torch.bfloat16)
    sv = torch.randn_like(sk)
    nside = torch.tensor([3, 0, 8, 1, 5, 2], **i32)
    if kernel == "flash_decode":
        args = (q, kp, vp, table, plen, sk, sv, nside)
        out = fd.flash_decode_attention(*args, n_kv_heads=hkv)
        ref = fd.flash_decode_attention_plain(*args, n_kv_heads=hkv)
    elif kernel == "flash_decode_fw":
        fk = torch.randn((b, 1, hkv, dh), generator=g, device=card).to(
            torch.bfloat16)
        fv = torch.randn_like(fk)
        active = torch.ones(b, **i32)
        out, _, _ = fd.flash_decode_attention_fw(
            q, kp, vp, table, plen, sk.clone(), sv.clone(), fk, fv, nside,
            active, n_kv_heads=hkv)
        ref, _, _ = fd.flash_decode_attention_fw_plain(
            q, kp, vp, table, plen, sk.clone(), sv.clone(), fk, fv, nside,
            active, n_kv_heads=hkv)
    elif kernel == "paged_attention":
        out = pa.paged_attention(q, kp, vp, table, plen, n_kv_heads=hkv)
        ref = pa.paged_attention_xla(q, kp, vp, table, plen, n_kv_heads=hkv)
    else:
        # decode rows over the same contexts: the fresh key at position
        # len (its K/V in range), written after the context
        ctx = plen
        ql = torch.ones(b, **i32)
        fk = torch.randn((b, 1, hkv, dh), generator=g, device=card).to(
            torch.bfloat16)
        fv = torch.randn_like(fk)
        kp2, vp2 = kp.clone(), vp.clone()
        out, _, _ = ra.ragged_attention(q[:, None], kp, vp, table, ctx, ql,
                                        fk, fv, n_kv_heads=hkv)
        ref, _, _ = ra.ragged_attention_plain(q[:, None], kp2, vp2, table,
                                              ctx, ql, fk, fv,
                                              n_kv_heads=hkv)
        assert _same_bytes(kp, kp2) and _same_bytes(vp, vp2)
        out, ref = out[:, 0], ref[:, 0]
    torch.cuda.synchronize()
    finite = torch.isfinite(ref)
    assert bool((~finite).any()) and bool(finite.any())
    _same_specials(out, ref)
    _close(out[finite], ref[finite], torch.bfloat16)


@pytest.mark.parametrize("kv8", list(FP8S), ids=FP8_IDS)
@pytest.mark.parametrize("h,hkv,dh", [(32, 8, 128), (16, 2, 256),
                                      (28, 4, 128)])
def test_ragged_attention_fp8_tile_edges_past_464(card, h, hkv, dh, kv8):
    """The ragged fp8 instances with contexts and chunks on and around
    their key tiles (64 keys, 32 at Dh 256) and the fresh K/V scaled past
    the type's limit (464; e5m2 61,440): the pools byte-equal to the plain
    version's after the writeback (NaN bytes, e5m2's +-inf, where JAX's
    cast overflows), outputs within q's tolerance where the plain
    version's are finite, NaN and +-inf where it has them, dead rows
    exactly 0."""
    keys = 64 if dh <= 128 else 32
    rows = [(keys - 1, 1), (keys, 1), (keys + 1, 1), (2 * keys, 1),
            (keys + 3, 8), (0, 5), (0, keys + 2), (keys - 1, keys), (3, 0),
            (keys + 5, 40)]
    g = torch.Generator(device=card).manual_seed(200 + dh)
    p, mp = 16, 2 * (-(-3 * keys // 16))
    r, qmax = len(rows), max(q for _, q in rows)
    n = r * mp + 8
    i32 = dict(dtype=torch.int32, device=card)
    ctx = torch.tensor([c for c, _ in rows], **i32)
    ql = torch.tensor([q for _, q in rows], **i32)
    table = torch.randperm(n, generator=g, device=card)[: r * mp].reshape(
        r, mp).to(torch.int32)
    bf = torch.bfloat16
    q = torch.randn((r, qmax, h, dh), generator=g, device=card).to(bf)
    fk = _fresh_kv((r, qmax, hkv, dh), g, card, bf, kv8, 600.0)
    fv = _fresh_kv((r, qmax, hkv, dh), g, card, bf, kv8, 600.0)
    kp = torch.randn((2 * n, p, hkv * dh), generator=g, device=card).to(kv8)
    vp = torch.randn((2 * n, p, hkv * dh), generator=g, device=card).to(kv8)
    kp2, vp2 = kp.clone(), vp.clone()
    kw = dict(n_kv_heads=hkv, layer=1, n_pages_per_layer=n)
    out, _, _ = ra.ragged_attention(q, kp, vp, table, ctx, ql, fk, fv, **kw)
    torch.cuda.synchronize()
    ref, _, _ = ra.ragged_attention_plain(q, kp2, vp2, table, ctx, ql, fk,
                                          fv, **kw)
    assert _same_bytes(kp, kp2) and _same_bytes(vp, vp2)
    assert bool((~torch.isfinite(kp.float())).any())
    valid = torch.arange(qmax, device=card)[None, :] < ql[:, None]
    assert float(out[~valid].float().abs().max()) == 0.0
    finite = torch.isfinite(ref.float())
    if kv8 == FP8:
        assert torch.equal(torch.isnan(out.float()), ~finite)
    else:
        dead = _minus_inf_rows(q, kp, table, ctx, ql, fk, kv8, hkv,
                               1, n)
        _ragged_specials(out, ref, dead)
        finite &= ~dead[..., None]
    torch.testing.assert_close(out.float()[finite], ref.float()[finite],
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("kv8", list(FP8S), ids=FP8_IDS)
def test_fp8_kernels_graph_replay(card, kv8):
    """Flash-decode, its fw form and ragged attention over e4m3 and e5m2
    pools, each captured in a CUDA graph: a replay is bit-equal to an eager
    call on the same inputs (fw's side write and ragged's writeback too),
    and so is a replay after new lengths are written in place."""
    g = torch.Generator(device=card).manual_seed(210)
    b, h, hkv, dh, p, mp, w = 8, 32, 8, 128, 16, 40, 8
    n = b * mp
    i32 = dict(dtype=torch.int32, device=card)
    bf = torch.bfloat16
    q = torch.randn((b, h, dh), generator=g, device=card).to(bf)
    kp = torch.randn((n, p, hkv * dh), generator=g, device=card).to(kv8)
    vp = torch.randn((n, p, hkv * dh), generator=g, device=card).to(kv8)
    table = torch.randperm(n, generator=g, device=card).reshape(b, mp).to(
        torch.int32)
    sk = torch.randn((b, w, hkv, dh), generator=g, device=card).to(bf)
    sv = torch.randn_like(sk)
    fk = torch.randn((b, 1, hkv, dh), generator=g, device=card).to(bf)
    fv = torch.randn_like(fk)
    lens = torch.tensor([0, 1, 63, 64, 65, 300, 511, 600], **i32)
    nside = torch.tensor([0, 3, 8, 1, 2, 8, 5, 0], **i32)
    active = torch.tensor([1, 1, 0, 1, 1, 1, 1, 1], **i32)
    new_lens = torch.tensor([639, 0, 129, 7, 64, 32, 1, 500], **i32)
    sk_g, sv_g = sk.clone(), sv.clone()
    kp_g, vp_g = kp.clone(), vp.clone()
    calls = {
        "flash_decode": lambda sk_, sv_, kp_, vp_: fd.flash_decode_attention(
            q, kp_, vp_, table, lens, sk_, sv_, nside, n_kv_heads=hkv),
        "flash_decode_fw": lambda sk_, sv_, kp_, vp_:
            fd.flash_decode_attention_fw(
                q, kp_, vp_, table, lens, sk_, sv_, fk, fv, nside, active,
                n_kv_heads=hkv)[0],
        "ragged_attention": lambda sk_, sv_, kp_, vp_: ra.ragged_attention(
            q[:, None], kp_, vp_, table, lens, active, fk, fv,
            n_kv_heads=hkv)[0],
    }
    for name, call in calls.items():
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):  # the capture stream's scratch
            call(sk_g, sv_g, kp_g, vp_g)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            got = call(sk_g, sv_g, kp_g, vp_g)
        for new in (False, True):
            if new:
                lens.copy_(new_lens)
            graph.replay()
            sk_e, sv_e = sk.clone(), sv.clone()
            kp_e, vp_e = kp.clone(), vp.clone()
            want = call(sk_e, sv_e, kp_e, vp_e)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, new)
            if name == "flash_decode_fw":
                assert torch.equal(sk_g, sk_e) and torch.equal(sv_g, sv_e)
                sk_g.copy_(sk)
                sv_g.copy_(sv)
            if name == "ragged_attention":
                assert _same_bytes(kp_g, kp_e) and _same_bytes(vp_g, vp_e)
                kp_g.copy_(kp)
                vp_g.copy_(vp)
        lens.copy_(torch.tensor([0, 1, 63, 64, 65, 300, 511, 600], **i32))


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.zeros((2, 8), device=card)
    with pytest.raises(ValueError):
        fdec.norm_matmul(x, torch.zeros(8, device=card),
                         torch.zeros((8, 5), device=card))
    with pytest.raises(ValueError):
        fdec.matmul_residual(x, torch.zeros((8, 6), device=card,
                                            dtype=torch.bfloat16),
                             torch.zeros((2, 6), device=card))
    pool = torch.zeros((4, 16, 64), device=card)
    i32 = dict(dtype=torch.int32, device=card)
    with pytest.raises(ValueError):          # int64 lengths
        ra.ragged_attention(torch.zeros((1, 2, 2, 32), device=card), pool,
                            pool, torch.zeros((1, 2), **i32),
                            torch.zeros((1,), device=card,
                                        dtype=torch.int64),
                            torch.ones((1,), **i32),
                            torch.zeros((1, 2, 2, 32), device=card),
                            torch.zeros((1, 2, 2, 32), device=card),
                            n_kv_heads=2)
    q = torch.zeros((1, 2, 32), device=card)
    args = (torch.zeros((1, 2), **i32), torch.ones((1,), **i32))
    for bad in (dict(q=torch.zeros((1, 2, 96), device=card)),   # Dh 96
                dict(q=torch.zeros((1, 3, 32), device=card)),   # H % Hkv
                dict(pool=pool.half()),                          # fp16 pool
                dict(layer=2, n_pages_per_layer=4)):             # past pool
        kw = {k: v for k, v in bad.items() if k not in ("q", "pool")}
        kp = bad.get("pool", pool)
        with pytest.raises((ValueError, TypeError)):
            pa.paged_attention(bad.get("q", q), kp, kp, *args,
                               n_kv_heads=2, **kw)


def _int4_case(card, dtype, m, k2, n, seed, expect=None, x_offset=0,
               p_offset=0):
    """``expect``: the instance the call must take (else the one
    ``int4_instance`` names); ``x_offset`` / ``p_offset``: x / the payload
    starts that many elements into its buffer (off the 16-byte alignment
    unless a multiple of 16 bytes)."""
    g = torch.Generator(device=card).manual_seed(seed)
    buf = torch.randn((m * 2 * k2 + x_offset,), generator=g,
                      device=card).to(dtype)
    x = buf[x_offset:].view(m, 2 * k2)
    packed = torch.randint(-128, 128, (k2 * n + p_offset,), generator=g,
                           device=card, dtype=torch.int8)[p_offset:].view(
                               k2, n)
    scale = 0.01 * torch.rand((n,), generator=g, device=card) + 1e-3
    inst = i4.int4_instance(m, k2, n, dtype, x.data_ptr() % 16 == 0
                            and packed.data_ptr() % 16 == 0)
    assert expect is None or inst == expect, (inst, expect)
    before = _cuda.LAUNCHES["int4_matmul"]
    before_inst = _cuda.LAUNCHES[f"int4_matmul.{inst}"]
    out = i4.int4_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["int4_matmul"] == before + 1
    assert _cuda.LAUNCHES[f"int4_matmul.{inst}"] == before_inst + 1
    assert out.dtype == dtype and out.shape == (m, n)
    ref32 = i4.int4_matmul_plain(x.float(), packed, scale)
    # the magnitude of each entry's sum, sum_k |x w| s: a column of one or
    # a few rows can sum thousands of random terms to near 0, where the
    # fp32 summation order alone moves the relative error
    lo, hi = i4.unpack_int4(packed)
    xf = x.float().abs()
    mag = (xf[:, :k2] @ lo.abs().float() + xf[:, k2:] @ hi.abs().float()
           ) * scale
    err = (out.float() - ref32).abs()
    rel = float((err.amax(0) / ref32.abs().amax(0).clamp_min(1e-30)).max())
    rel_mag = float((err.amax(0) / mag.amax(0).clamp_min(1e-30)).max())
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    print(f"int4_matmul {dtype} M={m} K/2={k2} N={n}: column max_rel_err "
          f"{rel:.3e} (of max|ref|), {rel_mag:.3e} (of max sum|x w| s); tol "
          f"{tol}")
    assert torch.isfinite(out).all() and rel_mag <= tol
    if m >= 8:
        assert rel <= tol


# Llama-3-8B: fused q|k|v, o, fused gate|up, down (bf16), the padded LM head
# (fp32 activations)
@pytest.mark.parametrize("k2,n,dtype", [
    (2048, 6144, torch.bfloat16), (2048, 4096, torch.bfloat16),
    (2048, 28672, torch.bfloat16), (7168, 4096, torch.bfloat16),
    (2048, 129024, torch.float32)])
@pytest.mark.parametrize("m", [1, 8, 10, 2560])
def test_int4_matmul_llama3_8b_shapes(card, m, k2, n, dtype):
    _int4_case(card, dtype, m, k2, n, seed=m + n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k2,n", [(37, 200, 1000), (3, 100, 1040),
                                    (129, 64, 130), (17, 2048, 1040),
                                    (16, 36, 24), (300, 1000, 4100)])
def test_int4_matmul_ragged_edges(card, dtype, m, k2, n):
    """Odd M, N off the tiles (and off the vector widths), K/2 off the
    tiles: every edge is bounds-checked."""
    _int4_case(card, dtype, m, k2, n, seed=m * k2)


# the GEMV instance (M <= 16: one and two 8-token tiles) at the Llama-3-8B
# products (the head with fp32 x) and off every tile: N off the 16-byte
# TMA stride (24, 1000, 4100) or not (1040), K/2 off the 64-row stage and
# off the 16-byte x pieces (36, 100, 1002), and the copy routes by
# alignment: x off 16 bytes (element loads), the payload off 16 bytes
# (byte loads instead of TMA)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k2,n,x_offset,p_offset", [
    (2048, 6144, 0, 0), (2048, 4096, 0, 0), (2048, 28672, 0, 0),
    (7168, 4096, 0, 0), (2048, 129024, 0, 0), (36, 24, 0, 0),
    (100, 1040, 0, 0), (1002, 1000, 0, 0), (200, 4100, 0, 0),
    (2048, 4096, 1, 0), (2048, 4096, 0, 16), (2048, 4096, 0, 8)])
@pytest.mark.parametrize("m", [1, 5, 8, 9, 16])
def test_int4_gemv_instance(card, dtype, m, k2, n, x_offset, p_offset):
    _int4_case(card, dtype, m, k2, n, seed=m + k2 + n, expect="gemv",
               x_offset=x_offset, p_offset=p_offset)


# Mixtral-8x7B's experts: gate/up [K/2 2048, N 14336], down [7168, 4096], at
# the decode slots (the GEMV) and an admission's or mixed step's rows
@pytest.mark.parametrize("k2,n", [(2048, 14336), (7168, 4096)])
@pytest.mark.parametrize("m", [8, 2048])
def test_int4_matmul_mixtral_expert_shapes(card, m, k2, n):
    _int4_case(card, torch.bfloat16, m, k2, n, seed=m + n,
               expect="gemv" if m <= 16 else "wgmma")


@pytest.mark.parametrize("m", [8, 64])
def test_int4_expert_views_take_the_kernel(card, m):
    """``matmul_any`` on the views of a stacked int4 expert payload ``[L,
    E, K/2, N]``: every (layer, expert) view starts on 16 bytes and takes the
    instance of its row count (the GEMV, or wgmma by TMA), each launch
    counted, each product equal to the plain version's on the view."""
    g = torch.Generator(device=card).manual_seed(m)
    L, E, k2, n = 2, 3, 512, 1024
    qt = tq.QuantizedTensor(
        q=torch.randint(-128, 128, (L, E, k2, n), generator=g, device=card,
                        dtype=torch.int8),
        s=0.01 * torch.rand((L, E, 1, n), generator=g, device=card) + 1e-3,
        bits=4, pack_axis=-2)
    x = torch.randn((m, 2 * k2), generator=g, device=card).bfloat16()
    inst = "gemv" if m <= 16 else "wgmma"
    for layer in range(L):
        for e in range(E):
            view = qt[layer][e]
            assert view.q.data_ptr() % 16 == 0 and view.q.is_contiguous()
            before = _cuda.LAUNCHES[f"int4_matmul.{inst}"]
            out = tq.matmul_any(x, view)
            torch.cuda.synchronize()
            assert _cuda.LAUNCHES[f"int4_matmul.{inst}"] == before + 1
            ref = i4.int4_matmul_plain(x.cpu(), view.q.cpu(),
                                       view.s[0].cpu())
            _close(out.cpu(), ref, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [0, 8, 4])
def test_moe_mlp_on_the_card_equals_its_cpu_form(card, dtype, bits):
    """``moe_mlp`` over ``mixtral-tiny``'s layer 0 (plain, int8 or int4
    experts) on the card against the same call on the CPU (the int4
    matmul's plain version there), at the mixed step's row count and a
    decode chunk's: within the dtype's tolerance, the routing equal."""
    name = "float32" if dtype == torch.float32 else "bfloat16"
    spec = mixtral_spec("mixtral-tiny", dtype=name)
    g = torch.Generator(device=card).manual_seed(bits)
    params = (random_quantized_params(spec, g, bits=bits) if bits
              else init_params(spec, g))
    blk = layer_view(params, 0)
    cpu_blk = {k: (tq.QuantizedTensor(q=v.q.cpu(), s=v.s.cpu(),
                                      bits=v.bits, pack_axis=v.pack_axis)
                   if isinstance(v, tq.QuantizedTensor) else v.cpu())
               for k, v in blk.items()}
    for rows in (8, 40):
        x = torch.randn((1, rows, spec.d_model), generator=g,
                        device=card).to(dtype)
        before = _cuda.LAUNCHES["int4_matmul"]
        out = moe.moe_mlp(spec, blk, x)
        torch.cuda.synchronize()
        if bits == 4:        # gate, up and down per expert
            assert _cuda.LAUNCHES["int4_matmul"] == before + 3 * 4
        want = moe.moe_mlp(spec, cpu_blk, x.cpu())
        _close(out.cpu(), want, dtype)
        _, _, idx = moe.route(blk["w_router"], x[0], 2)
        _, _, idx_cpu = moe.route(cpu_blk["w_router"], x[0].cpu(), 2)
        assert torch.equal(idx.cpu(), idx_cpu)


# K/2 = 1000 is not a multiple of the wgmma instance's 64-row k-tile
@pytest.mark.parametrize("k2,n", [(2048, 4096), (1000, 1040)])
@pytest.mark.parametrize("m", [17, 63, 64, 65, 129, 512, 2560])
def test_int4_matmul_wgmma_instance(card, m, k2, n):
    """bf16 above 16 rows at TMA-addressable shapes: the wgmma instance,
    every token tile ``wgmma_tile`` picks (64, 128, 256) and the edges of
    each."""
    _int4_case(card, torch.bfloat16, m, k2, n, seed=m + k2, expect="wgmma")


@pytest.mark.parametrize("m,k2,n,x_offset", [(37, 2000, 4100, 0),
                                             (40, 2048, 4096, 1)])
def test_int4_matmul_untileable_takes_wmma(card, m, k2, n, x_offset):
    """N off the 16-byte TMA stride, or x off 16-byte alignment: the wmma
    instance, chosen by shape and alignment before the launch."""
    _int4_case(card, torch.bfloat16, m, k2, n, seed=m, expect="wmma",
               x_offset=x_offset)


def test_int4_matmul_refuses_what_the_kernel_does_not_take(card):
    x = torch.zeros((4, 64), device=card, dtype=torch.bfloat16)
    s = torch.ones((16,), device=card)
    with pytest.raises(ValueError):                   # K != 2 * K/2
        i4.int4_matmul(x, torch.zeros((16, 16), device=card,
                                      dtype=torch.int8), s)
    with pytest.raises(ValueError):                   # payload not int8
        i4.int4_matmul(x, torch.zeros((32, 16), device=card,
                                      dtype=torch.int32), s)
    with pytest.raises(ValueError):                   # scale not fp32
        i4.int4_matmul(x, torch.zeros((32, 16), device=card,
                                      dtype=torch.int8), s.half())


# ------------------------------------------------------------ CUDA graphs

GRAPH_KW = dict(max_slots=4, max_seq_len=128, prefill_buckets=[16, 64],
                page_size=16, num_pages=48, decode_steps_per_call=4)
# (label, spec, engine config, int4 weights): every decode scheme and the
# mixed step
GRAPH_PATHS = [
    ("window", "llama", dict(attention_impl="pallas-decode"), False),
    ("fused", "llama", dict(attention_impl="pallas-decode",
                            decode_fused=True), False),
    ("fw", "llama", dict(attention_impl="pallas-decode-fw"), False),
    ("pallas", "llama", dict(attention_impl="pallas"), False),
    ("inline", "llama", dict(decode_mode="inline"), False),
    ("int4", "llama", dict(attention_impl="pallas-ragged",
                           prefill_chunk=16), True),
    ("mixed", "llama", dict(attention_impl="pallas-ragged",
                            prefill_chunk=16), False),
    ("mistral", "mistral", dict(attention_impl="pallas",
                                prefill_chunk=32), False),
    # e4m3 pools: flash-decode and fw, the paged kernel inline and past
    # Mistral's window, the ragged mixed step
    ("window fp8", "llama", dict(attention_impl="pallas-decode",
                                 kv_dtype="float8_e4m3fn"), False),
    ("fw fp8", "llama", dict(attention_impl="pallas-decode-fw",
                             kv_dtype="float8_e4m3fn"), False),
    ("inline fp8", "llama", dict(decode_mode="inline",
                                 kv_dtype="float8_e4m3fn"), False),
    ("mixed fp8", "llama", dict(attention_impl="pallas-ragged",
                                prefill_chunk=16,
                                kv_dtype="float8_e4m3fn"), False),
    ("mistral fp8", "mistral", dict(attention_impl="pallas",
                                    prefill_chunk=32,
                                    kv_dtype="float8_e4m3fn"), False),
    # the same over e5m2 pools
    ("window e5m2", "llama", dict(attention_impl="pallas-decode",
                                  kv_dtype="float8_e5m2"), False),
    ("fw e5m2", "llama", dict(attention_impl="pallas-decode-fw",
                              kv_dtype="float8_e5m2"), False),
    ("inline e5m2", "llama", dict(decode_mode="inline",
                                  kv_dtype="float8_e5m2"), False),
    ("mixed e5m2", "llama", dict(attention_impl="pallas-ragged",
                                 prefill_chunk=16,
                                 kv_dtype="float8_e5m2"), False),
    ("mistral e5m2", "mistral", dict(attention_impl="pallas",
                                     prefill_chunk=32,
                                     kv_dtype="float8_e5m2"), False),
    # Mixtral (mixtral-tiny): the router, its sort and the experts inside
    # the decode chunk's and the mixed step's graphs
    ("mixtral window", "mixtral", dict(attention_impl="pallas-decode"),
     False),
    ("mixtral mixed int4", "mixtral", dict(attention_impl="pallas-ragged",
                                           prefill_chunk=16), True),
]


def _tiny_weights(card, family, dtype, int4=False, seed=0):
    spec = {"llama": llama_spec, "mistral": mistral_spec,
            "mixtral": mixtral_spec}[family](f"{family}-tiny", dtype=dtype)
    g = torch.Generator(device=card).manual_seed(seed)
    params = (random_quantized_params(spec, g, bits=4) if int4
              else init_params(spec, g))
    return spec, params


def _graph_prompts(seed=0):
    import numpy as np
    rs = np.random.RandomState(seed)
    # past mistral-tiny's 64-token window, and over the chunk of 16
    return [rs.randint(1, 1000, size=n).tolist() for n in (5, 23, 40, 70)]


def _graph_run(spec, params, card, cfg, eager, seed=0, **req):
    eng = ContinuousEngine(spec, params=params, seed=seed,
                           config=EngineConfig(**dict(GRAPH_KW, **cfg)),
                           device=card)
    eng._eager = eager
    with _cuda.recording_launches() as launches:
        out = eng.generate([GenerationRequest(
            prompt=p, max_new_tokens=13, request_id=f"g{i}", **req)
            for i, p in enumerate(_graph_prompts())])
        torch.cuda.synchronize()
    return out, launches, eng


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("label,family,cfg,int4", GRAPH_PATHS,
                         ids=[p[0] for p in GRAPH_PATHS])
def test_graph_replays_match_eager(card, label, family, cfg, int4, dtype):
    spec, params = _tiny_weights(card, family, dtype, int4)
    want, eager_launches, eng_e = _graph_run(spec, params, card, cfg, True)
    got, graph_launches, eng_g = _graph_run(spec, params, card, cfg, False)
    assert [r.tokens for r in got] == [r.tokens for r in want], label
    assert [r.logprobs for r in got] == [r.logprobs for r in want], label
    assert graph_launches == eager_launches, (graph_launches,
                                              eager_launches)
    m, me = eng_g.get_metrics(), eng_e.get_metrics()
    assert me["cuda_graphs"] == 0 and m["cuda_graphs"] >= 1
    assert m["decode_programs"] == me["decode_programs"] >= 1
    if cfg.get("prefill_chunk") and family != "mistral":
        assert m["mixed_steps"] == me["mixed_steps"] > 0
    assert _same_bytes(eng_g.kv.k_pages, eng_e.kv.k_pages)
    assert _same_bytes(eng_g.kv.v_pages, eng_e.kv.v_pages)
    assert sum(graph_launches.values()) > 0
    if cfg.get("kv_dtype"):
        suffix = FP8S[getattr(torch, cfg["kv_dtype"])]
        assert eng_g.kv.k_pages.element_size() == 1
        assert any(k.endswith(f".{suffix}") for k in graph_launches)


def test_capture_is_not_broken_by_a_collection(card):
    """A graph that only a reference cycle still holds (an engine dropped
    without a collection) is not torn down inside a later capture:
    ``capture_graph`` keeps the cyclic collector off while the stream
    captures (a graph's teardown is not permitted during a capture and
    would invalidate it) and turns it back on after. The body allocates
    past the collector's first threshold, where a collection would run."""
    stream = _cuda.capture_stream(card)
    pool = torch.cuda.graph_pool_handle()
    x = torch.arange(4096, dtype=torch.float32, device=card)
    seen = []

    def body():
        seen.append(gc.isenabled())
        junk = [[i] for i in range(5000)]
        return x + len(junk)

    _cuda.warm_up(body, stream)
    gc.collect()
    old = _cuda.capture_graph(lambda: x * 3, pool=pool, stream=stream)
    cycle = [old]
    cycle.append(cycle)
    del old, cycle                       # unreachable but for the cycle
    graph = _cuda.capture_graph(body, pool=pool, stream=stream)
    assert seen == [True, False] and gc.isenabled()
    out = graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, x + 5000)
    gc.collect()


def test_replay_packed_equals_eager_body(card):
    """One engine, one state: the eager body's packed output and pages,
    then (state, pages and generator put back) the replay's: equal."""
    spec, params = _tiny_weights(card, "llama", "bfloat16")
    eng = ContinuousEngine(spec, params=params, config=EngineConfig(
        attention_impl="pallas-decode", **GRAPH_KW), device=card)
    for i, p in enumerate(_graph_prompts()):
        eng.submit(GenerationRequest(prompt=p, max_new_tokens=40,
                                     temperature=0.9, request_id=f"p{i}"))
    eng.step()
    eng.step()
    n = GRAPH_KW["decode_steps_per_call"]
    for slot in eng._slots:
        eng.kv.ensure_capacity(slot, int(eng._lengths_host[slot]) + n)
    caps = eng._cap_list()
    state = [t.clone() for t in eng._state()]
    pages = (eng.kv.k_pages.clone(), eng.kv.v_pages.clone())
    gen = eng._gen.get_state()
    outs = []
    for eager in (True, False, False):
        for t, v in zip(eng._state(), state):
            t.copy_(v)
        eng.kv.k_pages.copy_(pages[0])
        eng.kv.v_pages.copy_(pages[1])
        eng._gen.set_state(gen)
        eng._eager = eager
        packed = eng._decode_chunk(n, caps, 0.0).packed.cpu()
        outs.append((packed, eng.kv.k_pages.clone(), eng.kv.v_pages.clone(),
                     [t.clone() for t in eng._state()]))
    assert eng.get_metrics()["cuda_graphs"] >= 1
    for packed, kp, vp, st in outs[1:]:
        assert torch.equal(packed, outs[0][0])
        assert torch.equal(kp, outs[0][1]) and torch.equal(vp, outs[0][2])
        assert all(torch.equal(a, b) for a, b in zip(st, outs[0][3]))
    eng.abort_all()


def test_sampled_replays_advance_and_reproduce(card):
    """Sampled decoding through graphs: the generator's offset advances on
    every replay, two engines from one seed agree, and so does the eager
    run from that seed (the graph draws the eager uniforms); another seed
    samples other chains."""
    spec, params = _tiny_weights(card, "llama", "bfloat16")
    cfg = dict(attention_impl="pallas-decode")
    req = dict(temperature=1.3, top_p=0.95)
    a, _, eng = _graph_run(spec, params, card, cfg, False, seed=3, **req)
    b, _, _ = _graph_run(spec, params, card, cfg, False, seed=3, **req)
    e, _, _ = _graph_run(spec, params, card, cfg, True, seed=3, **req)
    c, _, _ = _graph_run(spec, params, card, cfg, False, seed=4, **req)
    toks = [r.tokens for r in a]
    assert toks == [r.tokens for r in b] == [r.tokens for r in e]
    assert toks != [r.tokens for r in c]
    assert all(len(set(t)) > 3 for t in toks)
    key = next(k for k in eng._graphs if k[0] == "decode" and k[4])
    before = eng._gen.get_offset()
    eng._graphs[key].replay()
    torch.cuda.synchronize()
    assert eng._gen.get_offset() > before


def test_two_engines_replay_in_turn(card):
    """Two engines of different shapes (4 and 8 slots, so flash-decode's
    shared scratch grows between their captures) step in turn on one
    stream: each emits the tokens of its own eager run."""
    spec, params = _tiny_weights(card, "llama", "bfloat16")
    spec2, params2 = _tiny_weights(card, "llama", "bfloat16", seed=1)
    cfg2 = dict(GRAPH_KW, max_slots=8, max_seq_len=256)
    want = [_graph_run(spec, params, card, {}, True)[0],
            _graph_run(spec2, params2, card, cfg2, True)[0]]
    engines = [ContinuousEngine(spec, params=params, config=EngineConfig(
                   **GRAPH_KW), device=card),
               ContinuousEngine(spec2, params=params2, config=EngineConfig(
                   **cfg2), device=card)]
    for eng in engines:
        for i, p in enumerate(_graph_prompts()):
            eng.submit(GenerationRequest(prompt=p, max_new_tokens=13,
                                         request_id=f"g{i}"))
    got = [{}, {}]
    while any(e.n_live or e.n_waiting for e in engines):
        for k, eng in enumerate(engines):
            eng.step()
            got[k].update({r.request_id: r for r in eng.drain_finished()})
    for k in range(2):
        assert [got[k][f"g{i}"].tokens for i in range(4)] == \
            [r.tokens for r in want[k]], k
        assert engines[k].get_metrics()["cuda_graphs"] >= 1


# ------------------------------------------------------------ host paths

HOST_PATHS = [
    ("deferred", {}),
    ("defer_sync", dict(defer_sync=True)),
    ("streaming", dict(stream_chunk_steps=2)),
    ("defer_sync streaming", dict(defer_sync=True, stream_chunk_steps=1)),
]
# fully backed, as defer_sync needs: 4 slots x 8 pages of 16
HOST_KW = dict(GRAPH_KW, num_pages=32)


def _host_run(spec, params, card, cfg, eager, label):
    """Two requests, one step, two more (admitted under decode pressure:
    deferred), a stream callback on each when ``cfg`` streams; returns
    (results in request order, launches, frames, engine)."""
    eng = ContinuousEngine(spec, params=params, seed=0, device=card,
                           config=EngineConfig(**dict(HOST_KW, **cfg)))
    eng._eager = eager
    frames = {}
    reqs = [GenerationRequest(prompt=p, max_new_tokens=13,
                              request_id=f"{label}{i}")
            for i, p in enumerate(_graph_prompts())]
    with _cuda.recording_launches() as launches:
        for i, r in enumerate(reqs):
            if i == 2:
                eng.step()
            if cfg.get("stream_chunk_steps"):
                frames[r.request_id] = []
                eng.submit(r, on_tokens=frames[r.request_id].extend)
            else:
                eng.submit(r)
        out = {r.request_id: r for r in eng.run_until_idle()}
        torch.cuda.synchronize()
    return [out[r.request_id] for r in reqs], launches, frames, eng


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("impl", ["pallas-decode", "pallas-ragged"])
@pytest.mark.parametrize("label,cfg", HOST_PATHS,
                         ids=[p[0] for p in HOST_PATHS])
def test_host_paths_replay_like_eager(card, label, cfg, impl, dtype):
    """Deferred admission, defer_sync and sub-chunk streaming on the
    window scheme and the ragged mixed step (chunked prefill): graph
    replays emit the eager hook's tokens and logprobs bit for bit and
    count its launches; streams equal their results."""
    spec, params = _tiny_weights(card, "llama", dtype)
    cfg = dict(cfg, attention_impl=impl)
    if impl == "pallas-ragged":
        cfg["prefill_chunk"] = 16
    want, e_launches, _, eng_e = _host_run(spec, params, card, cfg, True,
                                           "h")
    got, g_launches, frames, eng_g = _host_run(spec, params, card, cfg,
                                               False, "h")
    assert [r.tokens for r in got] == [r.tokens for r in want], label
    assert [r.logprobs for r in got] == [r.logprobs for r in want], label
    assert g_launches == e_launches and sum(g_launches.values()) > 0
    m = eng_g.get_metrics()
    # the ragged engine's later prompts prefill in chunks: no deferral
    assert m["deferred_admissions"] == eng_e.get_metrics()[
        "deferred_admissions"] == (2 if impl == "pallas-decode" else 0)
    assert m["cuda_graphs"] >= 1
    for r in got:
        assert len(r.tokens) == 13
        if frames:
            assert frames[r.request_id] == r.tokens
    if cfg.get("defer_sync"):
        assert m["stream_ring_pushes"] >= 1
    if cfg.get("stream_chunk_steps"):
        assert m["stream_clamped_chunks"] >= 1


def test_host_read_turns_ready_without_a_sync(card):
    """A packed read queued behind a long kernel is not ready at once;
    polling ``ready()`` (an event query, no host synchronisation) turns
    true once the copy has run, and the bytes are the tensor's."""
    import time

    src = torch.zeros(4096, dtype=torch.int32, device=card)
    torch.cuda._sleep(200_000_000)              # ~0.1 s of device time
    src.add_(7)
    read = _cuda.HostRead(src)
    assert not read.ready()
    t0 = time.perf_counter()
    while not read.ready():
        assert time.perf_counter() - t0 < 30
    assert read.host.is_pinned()
    assert (read.numpy() == 7).all()


def test_served_run_after_warmup_captures_nothing(card):
    """``warmup()`` runs every key a served run reaches (the decode chunk;
    on a ragged engine the mixed buckets): the run afterwards captures no
    graph, and emits the tokens of an engine without the warmup."""
    spec, params = _tiny_weights(card, "llama", "bfloat16")
    cfg = dict(attention_impl="pallas-ragged", prefill_chunk=16)
    want, _, _, _ = _host_run(spec, params, card, cfg, False, "w")
    eng = ContinuousEngine(spec, params=params, seed=0, device=card,
                           config=EngineConfig(**dict(HOST_KW, **cfg)))
    assert eng.warmup() > 0
    graphs = dict(eng._graphs)
    assert graphs and eng.n_live == 0
    assert eng.kv.get_stats()["live_slots"] == 0
    reqs = [GenerationRequest(prompt=p, max_new_tokens=13,
                              request_id=f"w{i}")
            for i, p in enumerate(_graph_prompts())]
    for i, r in enumerate(reqs):
        if i == 2:
            eng.step()
        eng.submit(r)
    out = {r.request_id: r for r in eng.run_until_idle()}
    assert [out[r.request_id].tokens for r in reqs] == \
        [r.tokens for r in want]
    assert eng._graphs.keys() == graphs.keys()


# ------------------------------------------------------- the worker's fleet


def _worker(card, factories, **server):
    """A port worker on the card whose engine factory picks by name."""
    from distributed_inference_engine_tpu_torch.cluster.worker import (
        WorkerServer)
    from distributed_inference_engine_tpu_torch.config import ServerConfig

    return WorkerServer(ServerConfig(worker_id="cw", port=0, **server),
                        engine_factory=lambda cfg: factories[cfg.name](),
                        device=card)


def _tiny_factory(card, cfg, int4=False):
    spec, params = _tiny_weights(card, "llama", "bfloat16", int4)
    return lambda: ContinuousEngine(
        spec, params=params, seed=0, device=card,
        config=EngineConfig(**dict(GRAPH_KW, **cfg)))


def _model(name):
    from distributed_inference_engine_tpu_torch.config import ModelConfig

    return ModelConfig(name=name, architecture="llama",
                       metadata={"warmup": 1})


STAGE_CFG = dict(attention_impl="pallas-ragged", prefill_chunk=16)


def test_staging_beside_a_serving_pump(card):
    """A model staged (its load-time warm-up capturing its graphs on the
    side thread) while another model's pump replays its graphs: every
    served request gets the tokens of the same model served alone, the
    serving engine captures nothing, the swap's probe is accepted, and the
    staged engine's graphs record the launches of the same engine warmed
    up alone (none of the server's)."""
    import asyncio

    from distributed_inference_engine_tpu_torch.cluster.model_manager import (
        GOLDEN_PROMPT, run_probe)
    from distributed_inference_engine_tpu_torch.cluster.worker import (
        WorkerClient)

    serve = _tiny_factory(card, dict(attention_impl="pallas-decode"))
    staged = _tiny_factory(card, STAGE_CFG, int4=True)
    alone = staged()
    alone.warmup()
    probe = run_probe(alone, list(GOLDEN_PROMPT), 8)
    want = serve().generate([GenerationRequest(
        prompt=p, max_new_tokens=13) for p in _graph_prompts()])
    worker = _worker(card, {"a": serve, "b": staged})
    worker.load_model(_model("a"))
    graphs_a = dict(worker.engines["a"]._graphs)

    async def drive():
        host, port = await worker.start()
        client = WorkerClient(host, port, timeout=300.0)
        try:
            await client.stage_model(_model("b"))
            swap = asyncio.ensure_future(client.swap_model("b", probe=probe))
            waves = 0
            while not swap.done() or waves < 2:
                outs = await asyncio.gather(*[client.generate("a", [
                    GenerationRequest(prompt=p, max_new_tokens=13)])
                    for p in _graph_prompts()])
                assert [o[0].tokens for o in outs] == \
                    [r.tokens for r in want]
                waves += 1
            return await swap, waves
        finally:
            await client.close()
            await worker.stop()

    receipt, waves = asyncio.run(drive())
    assert receipt["swapped"] == "b" and receipt["overlap_steps"] > 0
    assert worker.engines["a"]._graphs.keys() == graphs_a.keys()
    got = worker.engines["b"]._graphs
    assert got.keys() == alone._graphs.keys() and got
    for key, graph in got.items():
        assert graph.launches == alone._graphs[key].launches, key


def test_unload_gives_the_memory_back(card):
    """``unload_model`` joins the pump and drops the engine's graphs,
    pools, KV pages and weights: the process's reserved and allocated
    device memory return to their readings before the load (the split
    scratch and cuBLAS's workspaces, kept for the process, within 128
    MiB), and a reload serves the same tokens."""
    import asyncio
    import gc

    from distributed_inference_engine_tpu_torch.cluster.worker import (
        WorkerClient)

    big = dict(attention_impl="pallas-decode", num_pages=16384)
    factory = _tiny_factory(card, big)
    want = factory().generate([GenerationRequest(
        prompt=p, max_new_tokens=13) for p in _graph_prompts()])
    gc.collect()
    torch.cuda.empty_cache()
    base = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    worker = _worker(card, {"a": factory})

    async def drive():
        host, port = await worker.start()
        client = WorkerClient(host, port, timeout=300.0)
        try:
            await client.load_model(_model("a"))
            loaded = torch.cuda.memory_reserved()
            outs = await client.generate("a", [GenerationRequest(
                prompt=p, max_new_tokens=13) for p in _graph_prompts()])
            assert [o.tokens for o in outs] == [r.tokens for r in want]
            assert await client.unload_model("a") is True
            after = (torch.cuda.memory_allocated(),
                     torch.cuda.memory_reserved())
            await client.load_model(_model("a"))
            again = await client.generate("a", [GenerationRequest(
                prompt=p, max_new_tokens=13) for p in _graph_prompts()])
            assert [o.tokens for o in again] == [r.tokens for r in want]
            return loaded, after
        finally:
            await client.close()
            await worker.stop()

    loaded, after = asyncio.run(drive())
    slack = 128 << 20
    assert loaded - base[1] > 256 << 20, (loaded, base)
    assert after[0] - base[0] <= slack, (after, base)
    assert after[1] - base[1] <= slack, (after, base)


def _cuda_tensors():
    """The live CUDA tensors the garbage collector sees, by id."""
    import gc

    gc.collect()
    found = {}
    for obj in gc.get_objects():
        try:
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                found[id(obj)] = (tuple(obj.shape), obj.dtype,
                                  obj.untyped_storage().nbytes())
        except Exception:       # objects that refuse inspection
            continue
    return found


def test_unload_frees_every_tensor_the_load_made(card):
    """A model whose weights are made at load time, loaded through the
    worker's model manager (with its load-time warm-up: graphs captured),
    served (the kernels' split scratch taken) and unloaded, twice. The
    first cycle may leave what the process keeps for later models (the
    split scratch of the capture stream and of the serving stream,
    cuBLAS's workspace for the pump's thread); after the second,
    ``torch.cuda.memory_allocated()`` is exactly its reading before that
    load. Prints both cycles' allocated and reserved bytes."""
    import asyncio

    from distributed_inference_engine_tpu_torch.cluster.worker import (
        WorkerClient)

    spec = llama_spec("llama-tiny", dtype="bfloat16")
    cfg = EngineConfig(**dict(GRAPH_KW, attention_impl="pallas-ragged",
                              prefill_chunk=16))

    def factory():
        g = torch.Generator(device=card).manual_seed(0)
        return ContinuousEngine(spec, params=init_params(spec, g), seed=0,
                                config=cfg, device=card)

    worker = _worker(card, {"a": factory})

    def reading():
        torch.cuda.synchronize()
        tensors = _cuda_tensors()
        return (torch.cuda.memory_allocated(), torch.cuda.memory_reserved(),
                tensors)

    async def cycle(client):
        before = reading()
        await client.load_model(_model("a"))
        loaded = reading()
        outs = await client.generate("a", [GenerationRequest(
            prompt=p, max_new_tokens=13) for p in _graph_prompts()])
        assert all(len(o.tokens) == 13 for o in outs)
        assert await client.unload_model("a") is True
        return before, loaded, reading()

    async def drive():
        host, port = await worker.start()
        client = WorkerClient(host, port, timeout=300.0)
        try:
            return [await cycle(client) for _ in range(2)]
        finally:
            await client.close()
            await worker.stop()

    cycles = asyncio.run(drive())
    for i, (before, loaded, after) in enumerate(cycles):
        print(f"[unload] cycle {i}: allocated {before[0]} -> loaded "
              f"{loaded[0]} -> unloaded {after[0]} (left {after[0] - before[0]}"
              f" bytes); reserved {before[1]} -> {loaded[1]} -> {after[1]}; "
              f"CUDA tensors the collector sees: {len(before[2])} -> "
              f"{len(after[2])}")
    before, loaded, after = cycles[1]
    left = {k: v for k, v in after[2].items() if k not in before[2]}
    assert loaded[0] > before[0]
    assert after[0] == before[0], (after[0] - before[0], left)


def test_profile_names_the_kernels(card, tmp_path):
    """``profile start``/``stop`` around an int4 ragged model's requests:
    the Chrome trace holds the ragged tensor-core and int4 kernels
    (launched from the pump's thread, inside graph replays too), and the
    step timeline's window."""
    import asyncio
    import json

    from distributed_inference_engine_tpu_torch.cluster.worker import (
        WorkerClient)

    worker = _worker(card, {"b": _tiny_factory(card, STAGE_CFG, int4=True)})
    worker.load_model(_model("b"))

    async def drive():
        host, port = await worker.start()
        client = WorkerClient(host, port, timeout=300.0)
        try:
            await client.profile("start", trace_dir=str(tmp_path))
            await asyncio.gather(*[client.generate("b", [GenerationRequest(
                prompt=p, max_new_tokens=13)]) for p in _graph_prompts()])
            return await client.profile("stop")
        finally:
            await client.close()
            await worker.stop()

    stop = asyncio.run(drive())
    with open(stop["trace_file"]) as f:
        trace = json.load(f)
    names = [e.get("name", "") for e in trace["traceEvents"]
             if e.get("cat") == "kernel"]
    assert any("ragged_mma_kernel" in n for n in names), set(names)
    assert any("int4_" in n for n in names), set(names)
    assert stop["timelines"]["b"]


# ------------------------------------------- checkpoints and artifacts

# HF Llama naming of the port's block weights (nn.Linear: [out, in])
_HF_BLOCKS = {"ln1_scale": "input_layernorm",
              "ln2_scale": "post_attention_layernorm",
              "wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
              "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
              "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
              "w_down": "mlp.down_proj"}


def _write_hf_tiny(path, file_dtype):
    """llama-tiny drawn in fp32 from a seed, written in HF Llama naming in
    ``file_dtype`` by the port's own writer (the card's machine has no
    ``safetensors`` package), with its ``config.json``."""
    import json

    from distributed_inference_engine_tpu_torch.utils.safetensors_io import (
        save_file)

    spec = llama_spec("llama-tiny", dtype="float32")
    p = init_params(spec, torch.Generator().manual_seed(3))
    raw = {"model.embed_tokens.weight": p["tok_emb"],
           "model.norm.weight": p["lnf_scale"] + 0.01 * torch.randn(
               spec.d_model, generator=torch.Generator().manual_seed(4)),
           "lm_head.weight": p["lm_head"].t()}
    for layer in range(spec.n_layers):
        for ours, theirs in _HF_BLOCKS.items():
            t = p["blocks"][ours][layer]
            raw[f"model.layers.{layer}.{theirs}.weight"] = (
                t.t() if t.dim() == 2 else t)
    save_file({k: v.to(file_dtype) for k, v in raw.items()},
              str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": spec.vocab_size,
        "hidden_size": spec.d_model, "num_hidden_layers": spec.n_layers,
        "num_attention_heads": spec.n_heads,
        "num_key_value_heads": spec.n_kv_heads,
        "intermediate_size": spec.d_ff, "max_position_embeddings": 512,
        "rope_theta": spec.rope_theta, "rms_norm_eps": spec.norm_eps}))


def _leaf_bytes(tree):
    from distributed_inference_engine_tpu_torch.utils.checkpoint import (
        tree_leaves)

    return {k: (v.dtype, tuple(v.shape), v.device.type,
                v.detach().cpu().reshape(-1).view(torch.uint8))
            for k, v in tree_leaves(tree)}


@pytest.mark.parametrize("file_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32-file", "bf16-file"])
@pytest.mark.parametrize("spec_dtype", ["float32", "bfloat16"])
def test_checkpoint_copied_on_the_card_equals_a_host_load(
        card, tmp_path, file_dtype, spec_dtype):
    """``load_checkpoint`` to the card (each layer's tensor moved in the
    file's dtype, then transposed and cast into its slice there) gives
    the bits of the same load on the host."""
    from distributed_inference_engine_tpu_torch.models.loader import (
        load_checkpoint, spec_from_hf_config)

    _write_hf_tiny(tmp_path, file_dtype)
    spec = spec_from_hf_config(str(tmp_path)).replace(dtype=spec_dtype)
    host = _leaf_bytes(load_checkpoint(str(tmp_path), spec, device="cpu"))
    dev = _leaf_bytes(load_checkpoint(str(tmp_path), spec, device=card))
    assert sorted(host) == sorted(dev)
    for k, (dt, shape, where, b) in dev.items():
        assert where == "cuda" and (dt, shape) == host[k][:2], k
        assert torch.equal(b, host[k][3]), k


def test_artifact_restored_on_the_card_equals_the_saved_tree(card,
                                                             tmp_path):
    """A prepared int4 tree (q|k|v and gate|up fused) saved from the card
    restores to the card bit for bit, its checksum the saved one, and the
    same as a restore to the host."""
    from distributed_inference_engine_tpu_torch.engine.artifact import (
        load_artifact, save_artifact, tree_checksum)
    from distributed_inference_engine_tpu_torch.ops.quant import (
        prepare_params)

    spec = llama_spec("llama-tiny", max_seq_len=64)
    params = prepare_params(random_quantized_params(
        spec, torch.Generator(device=card).manual_seed(0), bits=4))
    path = save_artifact(str(tmp_path / "art"), spec, params)
    _, restored, manifest = load_artifact(path, device=card)
    _, on_host, _ = load_artifact(path, device="cpu")
    assert manifest["checksum"] == tree_checksum(params) == \
        tree_checksum(on_host)
    want, got = _leaf_bytes(params), _leaf_bytes(restored)
    assert sorted(want) == sorted(got) and "blocks.w_qkv.q" in got
    for k, (dt, shape, where, b) in got.items():
        assert where == "cuda" and (dt, shape) == want[k][:2], k
        assert torch.equal(b, want[k][3]), k


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int4"])
def test_factory_cold_start_on_the_card(card, tmp_path, quant):
    """The factory on the card from an HF directory with ``artifact=``:
    the slow path writes the artifact, the second build cold-starts from
    it (golden probe replayed through the graphs), and both emit the same
    greedy tokens."""
    from distributed_inference_engine_tpu_torch.config import ModelConfig
    from distributed_inference_engine_tpu_torch.models import (
        engine_from_config)

    _write_hf_tiny(tmp_path, torch.bfloat16)
    md = {"continuous": "1", "attention_impl": "pallas-ragged",
          "prefill_chunk": "32", "page_size": "16", "num_pages": "64",
          "artifact": str(tmp_path / "art")}
    if quant:
        md["weight_bits"] = "4"
    cfg = ModelConfig(name="m", architecture="llama", path=str(tmp_path),
                      max_seq_len=256, max_batch_size=4, quantized=quant,
                      metadata=md)
    slow = engine_from_config(cfg, device=card)
    fast = engine_from_config(cfg, device=card)
    assert slow.artifact_manifest is None
    assert fast.artifact_manifest is not None
    assert fast.load_info["source"] == "artifact"
    reqs = [GenerationRequest(prompt=p, max_new_tokens=13)
            for p in _graph_prompts()]
    assert [r.tokens for r in fast.generate(reqs)] == \
        [r.tokens for r in slow.generate(reqs)]


# ------------------------------------- static engine and speculation (A8, A12)

# the verify step's lattice (ctx_len, q_len): rows of 1 + 4 queries over
# contexts of 0 to 1,000, a plain q=1 decode row, two inert rows
VERIFY_ROWS = [(0, 5), (1, 5), (127, 5), (128, 5), (500, 5), (1000, 5),
               (63, 1), (0, 0), (300, 0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,hkv,dh", [(8, 2, 64), (32, 8, 128)])
def test_ragged_attention_verify_lattice(card, dtype, h, hkv, dh):
    """Ragged attention at the async verify step's lattice (bf16 on its
    tensor cores, fp32 on the CUDA cores) against the plain version: the
    outputs, and the pools equal after the writeback."""
    g = torch.Generator(device=card).manual_seed(20)
    rows = VERIFY_ROWS
    r, p = len(rows), 16
    mp = -(-max(c + q for c, q in rows) // p)
    n = r * mp + 4
    qmax = max(q for _, q in rows)
    i32 = dict(dtype=torch.int32, device=card)
    ctx = torch.tensor([c for c, _ in rows], **i32)
    ql = torch.tensor([q for _, q in rows], **i32)
    table = torch.randperm(n, generator=g, device=card)[: r * mp].reshape(
        r, mp).to(torch.int32)
    q = torch.randn((r, qmax, h, dh), generator=g, device=card).to(dtype)
    fk = torch.randn((r, qmax, hkv, dh), generator=g, device=card).to(dtype)
    fv = torch.randn_like(fk)
    kp = torch.randn((2 * n, p, hkv * dh), generator=g,
                     device=card).to(dtype)
    vp = torch.randn_like(kp)
    kp2, vp2 = kp.clone(), vp.clone()
    kw = dict(n_kv_heads=hkv, layer=1, n_pages_per_layer=n)
    inst = "ragged_attention." + ra.ragged_instance(dtype, dtype)
    before = _cuda.LAUNCHES[inst]
    out, _, _ = ra.ragged_attention(q, kp, vp, table, ctx, ql, fk, fv, **kw)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[inst] == before + 1
    ref, _, _ = ra.ragged_attention_plain(q, kp2, vp2, table, ctx, ql, fk,
                                          fv, **kw)
    _close(out, ref, dtype)
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)


# Llama-3-8B's four products at the speculative verify window's rows, M =
# 8 slots x (k + 1 = 5): q|k|v, o, gate|up, down (bf16: the wgmma
# instance), and the LM head (fp32 activations)
@pytest.mark.parametrize("k2,n,dtype,inst", [
    (2048, 6144, torch.bfloat16, "wgmma"),
    (2048, 4096, torch.bfloat16, "wgmma"),
    (2048, 28672, torch.bfloat16, "wgmma"),
    (7168, 4096, torch.bfloat16, "wgmma"),
    (2048, 129024, torch.float32, "simt")])
def test_int4_matmul_verify_rows(card, k2, n, dtype, inst):
    _int4_case(card, dtype, 40, k2, n, seed=40 + n, expect=inst)


def _spec_async_run(spec, params, card, eager, temp=0.0, seed=0):
    cfg = EngineConfig(**dict(GRAPH_KW, spec_async=True,
                              spec_draft_model="layers:1",
                              spec_bubble_floor_s=0.0,
                              attention_impl="pallas-ragged",
                              prefill_chunk=16))
    eng = ContinuousEngine(spec, params=params, seed=seed, config=cfg,
                           device=card)
    eng._eager = eager
    streamed = {}
    with _cuda.recording_launches() as launches:
        for i, p in enumerate(_graph_prompts()):
            eng.submit(GenerationRequest(prompt=p, max_new_tokens=17,
                                         temperature=temp,
                                         request_id=f"v{i}"),
                       on_tokens=lambda t, i=i: streamed.setdefault(
                           i, []).extend(t))
        out = eng.run_until_idle()
        torch.cuda.synchronize()
    return sorted((r.request_id, r.tokens, r.logprobs) for r in out), \
        streamed, launches, eng


@pytest.mark.parametrize("temp", [0.0, 0.9], ids=["greedy", "sampled"])
@pytest.mark.parametrize("dtype,int4", [("bfloat16", False),
                                        ("float32", False),
                                        ("bfloat16", True)],
                         ids=["bf16", "fp32", "int4"])
def test_spec_async_verify_replays_match_eager(card, dtype, int4, temp):
    """Async speculation on the card: the verify step and the draft rounds
    as graph replays emit the eager bodies' tokens and logprobs, stream
    the same tokens, count the same launches (the ragged kernel at the
    verify lattice among them) and write the same pages; verify steps
    ran, and with a sampled run the speculator's generator reproduces."""
    spec, params = _tiny_weights(card, "llama", dtype, int4)
    want, ws, wl, eng_e = _spec_async_run(spec, params, card, True, temp)
    got, gs, gl, eng_g = _spec_async_run(spec, params, card, False, temp)
    assert got == want and gs == ws
    assert gl == wl
    m, me = eng_g.get_metrics(), eng_e.get_metrics()
    assert m["spec_async_verify_steps"] == me["spec_async_verify_steps"] > 0
    assert m["spec_async_draft_rounds"] == me["spec_async_draft_rounds"]
    assert me["cuda_graphs"] == 0 and m["cuda_graphs"] >= 2
    assert any(k.startswith("verify") for k in m["graph_capture_s"])
    assert any(k.startswith("draft") for k in m["graph_capture_s"])
    assert gl["ragged_attention"] > 0
    assert _same_bytes(eng_g.kv.k_pages, eng_e.kv.k_pages)
    assert _same_bytes(eng_g.kv.v_pages, eng_e.kv.v_pages)


@pytest.mark.parametrize("int4", [False, True], ids=["bf16", "int4"])
def test_static_and_speculative_engines_on_the_card(card, int4):
    """The static engine and the speculative one (a truncated self-draft,
    k 4) on the card: every greedy chain held teacher-forced to the plain
    forward (a random int4 llama-tiny's logits are nearly flat, so its
    steps may all be ties, each within the band); an int4 speculative
    engine's verify window takes the wgmma instance (M = 8 x 5)."""
    from distributed_inference_engine_tpu_torch.engine.engine import Engine
    from distributed_inference_engine_tpu_torch.engine.speculative import (
        SpeculativeEngine, truncated_draft)
    from distributed_inference_engine_tpu_torch.utils.parity import (
        assert_greedy_parity)

    spec, params = _tiny_weights(card, "llama", "bfloat16", int4)
    cfg = EngineConfig(max_slots=8, max_seq_len=128,
                       prefill_buckets=[16, 64])
    prompts = _graph_prompts() * 2
    reqs = [GenerationRequest(prompt=p, max_new_tokens=12) for p in prompts]
    static = Engine(spec, params=params, config=cfg, device=card)
    ds, dp = truncated_draft(spec, static.params, 2)
    se = SpeculativeEngine(spec, ds, params=static.params, draft_params=dp,
                           config=cfg, speculate_k=4, device=card)
    with _cuda.recording_launches() as launches:
        outs = [static.generate(reqs), se.generate(reqs)]
        torch.cuda.synchronize()
    for out in outs:
        for r, p in zip(out, prompts):
            assert len(r.tokens) == 12
            # a prompt past the largest prefill bucket keeps its tail
            assert_greedy_parity(spec, static.params, p[-64:], r.tokens,
                                 eps=5e-2, min_matched=0 if int4 else 2)
    assert se.get_metrics()["rounds"] > 0
    if int4:
        assert launches["int4_matmul.wgmma"] > 0
