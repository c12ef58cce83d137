// Shared helpers for the port's hand-written Hopper kernels: float
// conversion for the storage types (fp32, bf16, and e4m3 or e5m2 for KV
// pools, with JAX's rounding into them), vectorised row loads,
// cp.async and TMA copies, tensor-core fragments, split-softmax merges and
// cluster reductions. Every kernel accumulates in fp32 whatever its
// storage type.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace die {

// dtype codes shared with the Python wrappers (ops/_cuda.py); kFP8 (e4m3)
// and kE5M2 are a KV pool's only
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kFP8 = 2;
constexpr int kE5M2 = 3;

using fp8 = __nv_fp8_e4m3;
using e5m2 = __nv_fp8_e5m2;

template <typename T>
constexpr bool kIsFp8 = sizeof(T) == 1;
template <typename T>
constexpr bool kIsE5m2 = std::is_same<T, e5m2>::value;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// e4m3 widens exactly (to fp16 on the hardware path, then fp32)
__device__ __forceinline__ float to_f(fp8 x) { return static_cast<float>(x); }
// e5m2 is the top byte of an f16: exact, infinities and NaN included
__device__ __forceinline__ float to_f(e5m2 x) {
  return __half2float(__ushort_as_half(
      static_cast<unsigned short>(static_cast<unsigned short>(x.__x) << 8)));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like astype()
}

// Two floats into an 8-bit pool type as JAX's astype rounds them
// (ops/attention.py astype_kv), lo in the low byte. The card's conversion
// (cvt.rn.satfinite, one instruction for the pair) rounds to nearest even
// and saturates to the largest finite value; the rare values past it are
// patched. e4m3: JAX's answer up to 464, and NaN (0x7F with x's sign) past
// it, for +-inf and for NaN. e5m2: JAX's answer below 61,440, +-inf (0x7C
// with x's sign) from it, and for an fp32 NaN 0x7E with x's sign. (The
// library's non-saturating conversion gives the e4m3 bytes on a software
// path of dozens of instructions a value.)
__device__ __forceinline__ uint32_t fp8_nan_byte(float x) {
  return 0x7Fu | (signbit(x) ? 0x80u : 0u);
}
__device__ __forceinline__ uint32_t e5m2_over_byte(float x) {
  return (isnan(x) ? 0x7Eu : 0x7Cu) | (signbit(x) ? 0x80u : 0u);
}
template <typename T8>
__device__ __forceinline__ uint32_t f32x2_to_f8x2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t f32x2_to_f8x2<fp8>(float lo, float hi) {
  uint32_t v = __nv_cvt_float2_to_fp8x2(make_float2(lo, hi), __NV_SATFINITE,
                                        __NV_E4M3);
  if (!(fabsf(lo) <= 464.f && fabsf(hi) <= 464.f)) {   // rare: overflow
    if (!(fabsf(lo) <= 464.f)) v = (v & 0xff00u) | fp8_nan_byte(lo);
    if (!(fabsf(hi) <= 464.f)) v = (v & 0x00ffu) | (fp8_nan_byte(hi) << 8);
  }
  return v;
}
template <>
__device__ __forceinline__ uint32_t f32x2_to_f8x2<e5m2>(float lo, float hi) {
  uint32_t v = __nv_cvt_float2_to_fp8x2(make_float2(lo, hi), __NV_SATFINITE,
                                        __NV_E5M2);
  if (!(fabsf(lo) < 61440.f && fabsf(hi) < 61440.f)) {   // rare: overflow
    if (!(fabsf(lo) < 61440.f)) v = (v & 0xff00u) | e5m2_over_byte(lo);
    if (!(fabsf(hi) < 61440.f)) v = (v & 0x00ffu) | (e5m2_over_byte(hi) << 8);
  }
  return v;
}
template <>
__device__ __forceinline__ fp8 from_f<fp8>(float x) {
  fp8 r;
  r.__x = static_cast<__nv_fp8_storage_t>(f32x2_to_f8x2<fp8>(x, 0.f) & 0xffu);
  return r;
}
template <>
__device__ __forceinline__ e5m2 from_f<e5m2>(float x) {
  e5m2 r;
  r.__x =
      static_cast<__nv_fp8_storage_t>(f32x2_to_f8x2<e5m2>(x, 0.f) & 0xffu);
  return r;
}

// Elements a lane loads at once from a row of T: 16 bytes, but 8 fp8
// values (8 bytes), so that an fp8 row spreads over as many lanes as a bf16
// one and a lane holds as many fp32 values.
template <typename T>
constexpr int kVecOf = kIsFp8<T> ? 8 : 16 / static_cast<int>(sizeof(T));

// Two 8-bit values (lo in the low byte) widened to two f16 in one 32-bit
// register, lo in the low half, exactly. e4m3: one conversion (every e4m3
// value, subnormals included, is an f16 normal or zero). e5m2: one byte
// permute, each byte over a zero low byte (an e5m2 value is an f16's top
// byte; +-inf and NaN come through as f16 +-inf and NaN). The fp8 paths'
// P V takes V in f16 (common.cuh v_frags).
template <typename T8>
__device__ __forceinline__ uint32_t f8x2_to_f16x2(unsigned short v) {
  if constexpr (kIsE5m2<T8>) {
    return __byte_perm(static_cast<uint32_t>(v), 0u, 0x1404);
  } else {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(v, __NV_E4M3);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

// Two 8-bit values widened to two bf16 in one 32-bit register, lo in the
// low half: exact. Each f16 of f8x2_to_f16x2 widens to an fp32 whose low
// 16 bits are zero (at most 4 significant bits, e5m2's range inside
// bf16's), so its high half IS the bf16, and one byte permute packs the two
// high halves. No rounding conversion into bf16 is left. NaN bytes give f16
// NaN, an fp32 NaN, and a bf16 whose exponent is all ones with a non-zero
// mantissa: NaN; e5m2's infinities stay infinite.
template <typename T8>
__device__ __forceinline__ uint32_t f8x2_to_bf16x2(unsigned short v) {
  const uint32_t h = f8x2_to_f16x2<T8>(v);
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  return __byte_perm(__float_as_uint(f.x), __float_as_uint(f.y), 0x7632);
}

// The two 8-bit pairs of a 32-bit word: bytes 0-1 and bytes 2-3.
template <typename T8>
__device__ __forceinline__ uint32_t f8_lo_to_bf16x2(uint32_t w) {
  return f8x2_to_bf16x2<T8>(static_cast<unsigned short>(w & 0xffffu));
}
template <typename T8>
__device__ __forceinline__ uint32_t f8_hi_to_bf16x2(uint32_t w) {
  return f8x2_to_bf16x2<T8>(static_cast<unsigned short>(w >> 16));
}

// Eight 8-bit values (8 bytes) widened to eight bf16 (16 bytes), exact.
template <typename T8>
__device__ __forceinline__ uint4 f8x8_to_bf16x8(uint2 v) {
  return make_uint4(f8_lo_to_bf16x2<T8>(v.x), f8_hi_to_bf16x2<T8>(v.x),
                    f8_lo_to_bf16x2<T8>(v.y), f8_hi_to_bf16x2<T8>(v.y));
}

// Eight 8-bit values (8 bytes) widened to eight f16 (16 bytes), exact.
template <typename T8>
__device__ __forceinline__ uint4 f8x8_to_f16x8(uint2 v) {
  return make_uint4(
      f8x2_to_f16x2<T8>(static_cast<unsigned short>(v.x & 0xffffu)),
      f8x2_to_f16x2<T8>(static_cast<unsigned short>(v.x >> 16)),
      f8x2_to_f16x2<T8>(static_cast<unsigned short>(v.y & 0xffffu)),
      f8x2_to_f16x2<T8>(static_cast<unsigned short>(v.y >> 16)));
}

// Eight bf16 values rounded to the 8-bit type (from_f's rounding) and
// packed into 8 bytes; a bf16 widens to fp32 by a shift. One test for the
// eight finds a magnitude past the type's limit (or inf, NaN): a half h of
// a bf16 pair is past L iff (h & 0x7FFF) + (0x8000 - L) reaches bit 15,
// L = 0x43E8 (464) for e4m3 and 0x4770 (61,440) for e5m2. Then e4m3 takes
// f32x2_to_f8x2's NaN bytes; e5m2 takes +-inf (0x7C with the sign), and
// for a bf16 NaN of either sign 0x7F, as JAX casts bf16 (not fp32's 0x7E).
template <typename T8>
__device__ __forceinline__ uint2 bf16x8_to_f8x8(uint4 v) {
  constexpr uint32_t kBias = kIsE5m2<T8> ? 0x38903890u : 0x3c173c17u;
  constexpr __nv_fp8_interpretation_t kFmt =
      kIsE5m2<T8> ? __NV_E5M2 : __NV_E4M3;
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t over = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) over |= (w[i] & 0x7fff7fffu) + kBias;
  uint32_t p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p[i] = __nv_cvt_float2_to_fp8x2(
        make_float2(__uint_as_float(w[i] << 16),
                    __uint_as_float(w[i] & 0xffff0000u)),
        __NV_SATFINITE, kFmt);
  if (over & 0x80008000u) {   // rare: overflow, inf or NaN
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kIsE5m2<T8>) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t h = (w[i] >> (16 * j)) & 0xffffu;
          const uint32_t mag = h & 0x7fffu;
          if (mag + 0x3890u >= 0x8000u) {
            const uint32_t b =
                mag > 0x7f80u ? 0x7Fu : (0x7Cu | ((h >> 8) & 0x80u));
            p[i] = (p[i] & ~(0xffu << (8 * j))) | (b << (8 * j));
          }
        }
      } else {
        p[i] = f32x2_to_f8x2<T8>(__uint_as_float(w[i] << 16),
                                 __uint_as_float(w[i] & 0xffff0000u));
      }
    }
  }
  return make_uint2(p[0] | (p[1] << 16), p[2] | (p[3] << 16));
}

// x rounded through storage type T and widened back (T's rounding, as a
// PyTorch .to(T).float() round trip).
template <typename T>
__device__ __forceinline__ float through(float x) {
  return to_f(from_f<T>(x));
}

// One global load: through the read-only (non-coherent) cache, or a plain
// load where the kernel also writes the buffer it reads (the ragged and fw
// kernels write their pools / side rows in place, at addresses they never
// read).
template <bool kReadOnly, typename V>
__device__ __forceinline__ V ld(const V* p) {
  if constexpr (kReadOnly) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// Load E contiguous elements starting at p (aligned to E * sizeof(T), or
// to 16 bytes when the run is longer) and widen them to fp32. One 4-, 8-
// or 16-byte load per lane keeps a warp's row read in full sectors.
template <typename T, int E, bool kReadOnly = true>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[E]) {
  constexpr int kBytes = E * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      uint4 raw = ld<kReadOnly>(reinterpret_cast<const uint4*>(p) + c);
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kPer; ++e) out[c * kPer + e] = to_f(t[e]);
    }
  } else if constexpr (kBytes == 8) {
    uint2 raw = ld<kReadOnly>(reinterpret_cast<const uint2*>(p));
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_f(t[e]);
  } else if constexpr (kBytes == 4) {
    unsigned int raw =
        ld<kReadOnly>(reinterpret_cast<const unsigned int*>(p));
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_f(t[e]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_f(p[e]);
  }
}

// E contiguous fp32 values from shared memory (aligned to 4 * E bytes
// when E is 2 or a multiple of 4).
template <int E>
__device__ __forceinline__ void lds_row(const float* p, float (&out)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int c = 0; c < E / 4; ++c) {
      const float4 v = reinterpret_cast<const float4*>(p)[c];
      out[4 * c] = v.x;
      out[4 * c + 1] = v.y;
      out[4 * c + 2] = v.z;
      out[4 * c + 3] = v.w;
    }
  } else if constexpr (E == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = p[e];
  }
}

// A row of E elements kept as raw 32-bit words until it is used, so that
// several rows can be in flight per thread for few registers.
template <typename T, int E>
struct RawRow {
  static constexpr int kBytes = E * static_cast<int>(sizeof(T));
  static constexpr int kWords = (kBytes + 3) / 4;
  unsigned int w[kWords];

  __device__ __forceinline__ void load(const T* __restrict__ p) {
    if constexpr (kBytes % 16 == 0) {
#pragma unroll
      for (int c = 0; c < kBytes / 16; ++c) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + c);
        w[4 * c] = v.x;
        w[4 * c + 1] = v.y;
        w[4 * c + 2] = v.z;
        w[4 * c + 3] = v.w;
      }
    } else if constexpr (kBytes == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x;
      w[1] = v.y;
    } else if constexpr (kBytes == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      static_assert(kBytes == 2, "rows are 2, 4, 8 or 16k bytes");
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }

  __device__ __forceinline__ void widen(float (&out)[E]) const {
    const T* t = reinterpret_cast<const T*>(w);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_f(t[e]);
  }
};

// 2^x in one MUFU instruction (ex2.approx, denormals flushed to 0: an
// online softmax's weights below 2^-126 are 0 either way).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// ------------------------------------------------ flash partials (split KV)
//
// A partial softmax state over a subset of the keys: m, the max of the
// scaled scores (-1e30 when the subset is empty), l = sum exp(s - m), and
// acc = sum exp(s - m) v, not yet divided by l. Two states over disjoint
// key sets merge exactly; an empty state (l = 0, acc = 0) has weight 0.

// Merge another state (mo, lo, acco) into (m, l, acc).
template <int N>
__device__ __forceinline__ void merge_state(float& m, float& l,
                                            float (&acc)[N], float mo,
                                            float lo, const float (&acco)[N]) {
  const float mx = fmaxf(m, mo);
  const float a = expf(m - mx);
  const float c = expf(mo - mx);
  l = l * a + lo * c;
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = acc[e] * a + acco[e] * c;
  m = mx;
}

// The query rows a block of the decode attention kernels (flash-decode and
// paged attention) holds for a query-head group of g heads: the least of
// 1, 2, 4, 8 that holds g, 8 above 8; a KV head's g heads then take
// ceil(g / rows) blocks. With wide (flash-decode's tensor cores at Dh 128)
// 16 above 8: the warp pairs' 16-row instance, so that G 9-16 read each
// K/V tile once. ops/paged_attention.py subgroup and ops/flash_decode.py
// decode_subgroup are the same rule on the host.
inline int subgroup_rows(int g, bool wide = false) {
  return g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : g <= 8 || !wide ? 8 : 16;
}

// Workspace of the split-KV attention kernels: for each output row r (a
// (slot, query head) pair) and split s, m at m[r * n_split + s], l at
// l[r * n_split + s], and the unnormalised acc at acc[(r * n_split + s) * dh
// + d]. One fp32 buffer of rows * n_split * (dh + 2) values.
struct SplitPartials {
  float* m;
  float* l;
  float* acc;
  int n_split;
  int dh;

  __device__ __host__ SplitPartials(float* ws, long long rows, int n_split_,
                                    int dh_)
      : m(ws + rows * n_split_ * dh_),
        l(ws + rows * n_split_ * dh_ + rows * n_split_),
        acc(ws),
        n_split(n_split_),
        dh(dh_) {}
};

// The merge rule of one row's n_split partials, (m_s, l_s) at ms[s] and
// ls[s]: m and l of the softmax over the union of the splits' keys, as one
// pass would give them, and weight(m_s) = exp(m_s - m) / l, the weight of
// split s's unnormalised acc in the normalised output (the apply step is
// out[d] = sum_s weight(m_s) acc_s[d]). An empty split (m_s = -1e30, l_s
// = 0, acc_s = 0) adds nothing; a row with no key at all gives exactly 0.
// Both split-KV kernels merge with it: paged attention's merge kernel and
// flash-decode's last block.
struct SplitMerge {
  float m;
  float l;
  float inv_l;

  __device__ __forceinline__ SplitMerge(const float* ms, const float* ls,
                                        int n_split) {
    m = -1e30f;
    for (int s = 0; s < n_split; ++s) m = fmaxf(m, ms[s]);
    l = 0.f;
    for (int s = 0; s < n_split; ++s) l += ls[s] * expf(ms[s] - m);
    inv_l = 1.f / fmaxf(l, 1e-30f);
  }

  __device__ __forceinline__ float weight(float m_s) const {
    return expf(m_s - m) * inv_l;
  }
};

// ------------------------------------- asynchronous copies, tensor cores
//
// cp.async stages 16 bytes from global into shared memory without a
// register round trip (Ampere and later); with `valid` false it writes 16
// zero bytes and reads nothing (src must still be a global address).

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The same for 4 bytes (src and dst aligned to 4), through L1.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8. With .trans each matrix arrives transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores: a 16x16 bf16 (row major), b 16x8 bf16
// (column major), d 16x8 fp32, in the mma.sync fragment layouts.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An 8x8 b16 matrix held as mma fragments (lane i: row i / 4, columns
// 2 (i % 4) and + 1) transposed across the warp, in the same layout.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// d += a . b on the tensor cores in f16 (the e4m3 paths' P V: e4m3 is
// exact in f16, P in [0, 1] keeps 3 more bits than in bf16).
__device__ __forceinline__ void mma_f16_16816(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to f16 in one 32-bit register, lo in the low
// half.
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two fp32 values rounded to bf16 in one 32-bit register, lo in the low
// half (the element with the smaller column index of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------- e4m3 fragments in registers
//
// The tensor-core instances of flash-decode, its fw form and paged
// attention over e4m3 pools (flash_decode.cuh fp8_block) read their K and
// V mma fragments straight from the
// staged e4m3 tiles as 32-bit words of four consecutive head dims, and
// widen them in registers: ldmatrix moves 16-bit elements only. A K word
// feeds a lane's k pairs (2t, 2t + 1) and (2t + 8, 2t + 9) of one K-step
// (t = lane % 4), so a K-step's k index runs over the head dims in the
// order kdim gives, and Q is read in the same order (a sum over Dh does not
// depend on its order). A V word gives four dims of one key; a pair of
// keys in one dim column is gathered from two key rows by one byte
// permute, so the output's dims come in vdim's order, undone where the
// output is written. ops/flash_decode.py fp8_fragment_dims mirrors both
// orders on the host.

// The first of the four consecutive head dims that lane quad t reads for
// K-step kk (k pairs 2t, 2t + 1 and 2t + 8, 2t + 9). A lane's dims of four
// consecutive K-steps are 16 contiguous dims (one 16-byte e4m3 load); at
// Dh 128 and 256 the pieces of lanes t and t + 1 are two apart, so that the
// loads of two key rows at the e4m3 stride hit different banks.
template <int DH>
__host__ __device__ constexpr int kdim(int kk, int t) {
  return DH == 32   ? 8 * t + 4 * kk
         : DH == 64 ? 16 * t + 4 * kk
                    : 16 * (2 * t + ((kk >> 2) & 1) + 8 * (kk >> 3)) +
                          4 * (kk & 3);
}

// The first of the four consecutive head dims of V word q (0 .. DH/32 - 1)
// that lane row g (lane / 4) reads: flash-decode's O^T takes them as dim
// rows g, g + 8 of m-tiles 2q and 2q + 1. At Dh >= 128 a lane's four words
// of a 128-dim block are one 16-byte load.
template <int DH>
__host__ __device__ constexpr int vdim(int g, int q) {
  return DH == 32   ? 4 * g
         : DH == 64 ? 8 * g + 4 * q
                    : 128 * (q >> 2) + 16 * g + 4 * (q & 3);
}

// A lane's part of one K row for K-step group c (kSteps K-steps: four, two
// at Dh 32): dims kdim(kk, t) .. + 3 of each K-step kk of the group, as
// e4m3 words (one a step) or bf16 pairs (two a step), one 8- to 32-byte
// contiguous load. Also Q^T's B operand (bf16, from global memory).
template <typename T, int DH>
struct KGroup {
  static constexpr int kSteps = DH == 32 ? 2 : 4;
  static constexpr int kGroups = DH / 16 / kSteps;
  static constexpr int kWords = kSteps * (kIsFp8<T> ? 1 : 2);
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const char* row, int c, int t) {
    const char* p = row + static_cast<int>(sizeof(T)) *
                              kdim<DH>(kSteps * c, t);
    if constexpr (kWords == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    } else {
#pragma unroll
      for (int h = 0; h < kWords / 4; ++h) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[h];
        w[4 * h] = v.x; w[4 * h + 1] = v.y; w[4 * h + 2] = v.z;
        w[4 * h + 3] = v.w;
      }
    }
  }

  // step u's pairs as bf16: k 2t, 2t + 1 (lo) and 2t + 8, 2t + 9 (hi)
  __device__ __forceinline__ uint32_t lo(int u) const {
    if constexpr (kIsFp8<T>) return f8_lo_to_bf16x2<T>(w[u]);
    else return w[2 * u];
  }
  __device__ __forceinline__ uint32_t hi(int u) const {
    if constexpr (kIsFp8<T>) return f8_hi_to_bf16x2<T>(w[u]);
    else return w[2 * u + 1];
  }
};

// A lane's V words of one key row for word group c: dims vdim(g, q) .. + 3
// of each word q of the group (kQs of them: four, fewer below Dh 128),
// e4m3 (one 32-bit word each) or bf16 (two), one contiguous load.
template <typename T, int DH>
struct VGroup {
  static constexpr int kQs = DH >= 128 ? 4 : DH / 32;
  static constexpr int kGroups = DH / 32 / kQs;
  static constexpr int kWords = kQs * (kIsFp8<T> ? 1 : 2);
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const char* row, int c, int g) {
    const char* p = row + static_cast<int>(sizeof(T)) * vdim<DH>(g, kQs * c);
    if constexpr (kWords == 1) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else if constexpr (kWords == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    } else {
#pragma unroll
      for (int h = 0; h < kWords / 4; ++h) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[h];
        w[4 * h] = v.x; w[4 * h + 1] = v.y; w[4 * h + 2] = v.z;
        w[4 * h + 3] = v.w;
      }
    }
  }
};

// The pairs (key 2t, key 2t + 1) and (2t + 8, 2t + 9) of the four dims of
// word q of a group, from the V words of key rows 2t (va), 2t + 1 (vb), 2t
// + 8 (vc) and 2t + 9 (vd): a0[0] dim d, a0[1] dim d + 1 over keys 2t,
// 2t + 1, a0[2], a0[3] the same over keys 2t + 8, 2t + 9; a1 dims d + 2
// and d + 3 (d = vdim(g, q)). e4m3 words give f16 pairs (one conversion
// a pair), bf16 words bf16 pairs. Flash-decode's O^T takes a0 and a1 as the A
// fragments of m-tiles 2q and 2q + 1 (dim rows g, g + 8).
template <typename T, int DH>
__device__ __forceinline__ void v_frags(const VGroup<T, DH>& va,
                                        const VGroup<T, DH>& vb,
                                        const VGroup<T, DH>& vc,
                                        const VGroup<T, DH>& vd, int q,
                                        uint32_t (&a0)[4], uint32_t (&a1)[4]) {
  if constexpr (kIsFp8<T>) {
    // bytes (va_d, vb_d) of dims d, d + 1 | d + 2, d + 3, then widened to
    // f16
    const uint32_t ab01 = __byte_perm(va.w[q], vb.w[q], 0x5140);
    const uint32_t ab23 = __byte_perm(va.w[q], vb.w[q], 0x7362);
    const uint32_t cd01 = __byte_perm(vc.w[q], vd.w[q], 0x5140);
    const uint32_t cd23 = __byte_perm(vc.w[q], vd.w[q], 0x7362);
    a0[0] = f8x2_to_f16x2<T>(static_cast<unsigned short>(ab01 & 0xffffu));
    a0[1] = f8x2_to_f16x2<T>(static_cast<unsigned short>(ab01 >> 16));
    a0[2] = f8x2_to_f16x2<T>(static_cast<unsigned short>(cd01 & 0xffffu));
    a0[3] = f8x2_to_f16x2<T>(static_cast<unsigned short>(cd01 >> 16));
    a1[0] = f8x2_to_f16x2<T>(static_cast<unsigned short>(ab23 & 0xffffu));
    a1[1] = f8x2_to_f16x2<T>(static_cast<unsigned short>(ab23 >> 16));
    a1[2] = f8x2_to_f16x2<T>(static_cast<unsigned short>(cd23 & 0xffffu));
    a1[3] = f8x2_to_f16x2<T>(static_cast<unsigned short>(cd23 >> 16));
  } else {
    // bf16 halves (va_d, vb_d): dim d from the low halves, d + 1 high
    const int i = 2 * q;
    a0[0] = __byte_perm(va.w[i], vb.w[i], 0x5410);
    a0[1] = __byte_perm(va.w[i], vb.w[i], 0x7632);
    a0[2] = __byte_perm(vc.w[i], vd.w[i], 0x5410);
    a0[3] = __byte_perm(vc.w[i], vd.w[i], 0x7632);
    a1[0] = __byte_perm(va.w[i + 1], vb.w[i + 1], 0x5410);
    a1[1] = __byte_perm(va.w[i + 1], vb.w[i + 1], 0x7632);
    a1[2] = __byte_perm(vc.w[i + 1], vd.w[i + 1], 0x5410);
    a1[3] = __byte_perm(vc.w[i + 1], vd.w[i + 1], 0x7632);
  }
}

// ------------------------------------- TMA copies tracked by mbarriers
//
// A tile copy of the Tensor Memory Accelerator lands in shared memory and
// reports its bytes to an mbarrier; consumers wait on the barrier's phase.
// The int4 wgmma instance and matmul_residual's bf16 instance use them.

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`; a
// wait that has not ended after ~2^34 cycles (seconds) is a fault, and
// traps rather than hold the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: the library links only the
// runtime, so it is fetched from the driver once through the runtime
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// ------------------------------------------------ thread-block clusters

constexpr int kMaxCluster = 8;   // the portable cluster size

// Element i of the sum of the cluster's per-block fp32 partials, each
// block's at `part` in its own shared memory (distributed shared memory),
// added in rank order; a cluster of at most kMaxCluster blocks. The loads
// are all issued before the adds, so the remote latency is paid once.
// Every block must have written its partial and passed a cluster barrier
// before any block reads, and must not exit before the others have read it
// (a second barrier).
__device__ __forceinline__ float cluster_sum(float* part, int i) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int n = static_cast<int>(cl.num_blocks());
  float v[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    v[q] = q < n ? cl.map_shared_rank(part, q)[i] : 0.f;
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) s += v[q];
  return s;
}

// The split-K reduce of a cluster GEMV, run by every thread of every block
// once each block's fp32 partial [rows][kCols] sits at `part` in its own
// shared memory: after a cluster barrier, block `rank` of ks sums the
// cluster's partials of its kCols / ks columns in rank order (cluster_sum)
// and hands epi(row, column, sum) each of them; a closing barrier keeps
// every block, and so its partial, alive until all have read.
template <int kCols, int kThreads, typename Epi>
__device__ __forceinline__ void cluster_reduce(float* part, int rows,
                                               Epi epi) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();   // every partial of the cluster written
  const int ks = static_cast<int>(cl.num_blocks());
  const int per = kCols / ks;
  const int c0 = static_cast<int>(cl.block_rank()) * per;
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int row = i / per;
    const int c = c0 + (i - row * per);
    epi(row, c, cluster_sum(part, row * kCols + c));
  }
  cl.sync();   // no block leaves while its partial is read
}

// One launch of Kernel with `args`: `grid` blocks of `threads`, clusters
// of ks blocks along x, `smem` bytes of dynamic shared memory (the kernel's
// limit raised on its first launch; one card). Returns the launch's error.
template <auto Kernel, typename... Args>
cudaError_t launch_cluster(dim3 grid, int threads, int ks, int smem,
                           cudaStream_t st, Args... args) {
  static bool attr_set = false;  // per kernel
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, Kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace die
