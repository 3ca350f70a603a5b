// In-kernel prime-field library for the BN254-width fields (256-bit R).
//
// CUDA counterpart of TileFp (myzkp_tpu/fields/tile_ops.py:28-182): add, sub,
// neg, Montgomery multiply, select and the conditional subtract of p, as
// __device__ functions that every kernel of the port is built from.  It is not
// a kernel itself.
//
// Layout.  At the tensor interface an element is 16 little-endian 16-bit limbs,
// one int32 per limb, limb k of element i at base[k * stride + i] (limb planes,
// so a warp reading one limb of 32 neighbouring elements reads 128 contiguous
// bytes).  Inside a thread an element is repacked into 8 little-endian 32-bit
// words.  R = 2^256 in both layouts, so Montgomery form is unchanged by the
// repack.
//
// Carries.  The TPU kernels keep 16-bit limbs and lazy uint32 columns (bound
// 4L * 2^16, tile_ops.py:12-14).  With 32-bit words that bound no longer holds,
// so every carry here is a true carry chain through 64-bit accumulators.
//
// Every result is canonical (< p), so it equals the reference's result limb
// for limb whatever order the partial products are summed in.
#pragma once

#include <cstdint>

namespace myzkp {

constexpr int kLimbs = 16;  // 16-bit limbs at the tensor interface
constexpr int kWords = 8;   // 32-bit words inside a thread

// Field constants, passed to each kernel by value (they land in the constant
// bank).  The host builds them from the FieldSpec (_ext.field_consts).
struct FieldConsts {
  uint32_t p[kWords];
  uint32_t one[kWords];  // R mod p: Montgomery form of 1
  uint32_t n0;           // -p^{-1} mod 2^32
};

struct Fe {
  uint32_t w[kWords];
};

__device__ __forceinline__ Fe load_planes(const int32_t* __restrict__ base,
                                          int64_t stride, int64_t i) {
  Fe r;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint32_t lo = static_cast<uint32_t>(base[(2 * k) * stride + i]);
    uint32_t hi = static_cast<uint32_t>(base[(2 * k + 1) * stride + i]);
    r.w[k] = lo | (hi << 16);
  }
  return r;
}

__device__ __forceinline__ void store_planes(int32_t* __restrict__ base,
                                             int64_t stride, int64_t i,
                                             const Fe& a) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    base[(2 * k) * stride + i] = static_cast<int32_t>(a.w[k] & 0xFFFFu);
    base[(2 * k + 1) * stride + i] = static_cast<int32_t>(a.w[k] >> 16);
  }
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int k = 0; k < kWords; ++k) r.w[k] = 0;
  return r;
}

__device__ __forceinline__ Fe fe_one(const FieldConsts& c) {
  Fe r;
#pragma unroll
  for (int k = 0; k < kWords; ++k) r.w[k] = c.one[k];
  return r;
}

__device__ __forceinline__ Fe fe_select(bool m, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int k = 0; k < kWords; ++k) r.w[k] = m ? a.w[k] : b.w[k];
  return r;
}

// a - p if (top != 0 or a >= p) else a; a < 2p.
__device__ __forceinline__ Fe fe_cond_sub_p(const Fe& a, uint32_t top,
                                            const FieldConsts& c) {
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint64_t t = static_cast<uint64_t>(a.w[k]) - c.p[k] - borrow;
    d.w[k] = static_cast<uint32_t>(t);
    borrow = static_cast<uint32_t>(t >> 63);
  }
  return fe_select(top != 0 || borrow == 0, d, a);
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b,
                                     const FieldConsts& c) {
  Fe s;
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint64_t t = static_cast<uint64_t>(a.w[k]) + b.w[k] + carry;
    s.w[k] = static_cast<uint32_t>(t);
    carry = t >> 32;
  }
  return fe_cond_sub_p(s, static_cast<uint32_t>(carry), c);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b,
                                     const FieldConsts& c) {
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint64_t t = static_cast<uint64_t>(a.w[k]) - b.w[k] - borrow;
    d.w[k] = static_cast<uint32_t>(t);
    borrow = static_cast<uint32_t>(t >> 63);
  }
  Fe s;
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint64_t t = static_cast<uint64_t>(d.w[k]) + c.p[k] + carry;
    s.w[k] = static_cast<uint32_t>(t);
    carry = t >> 32;
  }
  return fe_select(borrow != 0, s, d);
}

__device__ __forceinline__ Fe fe_neg(const Fe& a, const FieldConsts& c) {
  return fe_sub(fe_zero(), a, c);
}

// Montgomery product a * b * 2^-256 mod p, coarsely integrated operand
// scanning (CIOS) over 32-bit words with 64-bit accumulators.  Inputs < p
// give t < 2p before the final conditional subtract.
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b,
                                     const FieldConsts& c) {
  uint32_t t[kWords + 2];
#pragma unroll
  for (int k = 0; k < kWords + 2; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      uint64_t s = static_cast<uint64_t>(t[j]) +
                   static_cast<uint64_t>(a.w[j]) * b.w[i] + carry;
      t[j] = static_cast<uint32_t>(s);
      carry = s >> 32;
    }
    uint64_t s = static_cast<uint64_t>(t[kWords]) + carry;
    t[kWords] = static_cast<uint32_t>(s);
    t[kWords + 1] = static_cast<uint32_t>(s >> 32);

    uint32_t m = t[0] * c.n0;
    s = static_cast<uint64_t>(t[0]) + static_cast<uint64_t>(m) * c.p[0];
    carry = s >> 32;
#pragma unroll
    for (int j = 1; j < kWords; ++j) {
      s = static_cast<uint64_t>(t[j]) + static_cast<uint64_t>(m) * c.p[j] +
          carry;
      t[j - 1] = static_cast<uint32_t>(s);
      carry = s >> 32;
    }
    s = static_cast<uint64_t>(t[kWords]) + carry;
    t[kWords - 1] = static_cast<uint32_t>(s);
    t[kWords] = t[kWords + 1] + static_cast<uint32_t>(s >> 32);
  }
  Fe r;
#pragma unroll
  for (int k = 0; k < kWords; ++k) r.w[k] = t[k];
  return fe_cond_sub_p(r, t[kWords], c);
}

__device__ __forceinline__ Fe fe_sqr(const Fe& a, const FieldConsts& c) {
  return fe_mul(a, a, c);
}

}  // namespace myzkp
