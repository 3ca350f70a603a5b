// In-kernel prime-field library: BN254's fields (256-bit R), M128 (128-bit R)
// and M64 (64-bit R).
//
// CUDA counterpart of TileFp (myzkp_tpu/fields/tile_ops.py:28-182): add, sub,
// neg, Montgomery multiply, select and the conditional subtract of p, as
// __device__ functions that every kernel of the port is built from.  It is not
// a kernel itself.
//
// Layout.  At the tensor interface an element is 2N little-endian 16-bit limbs,
// one int32 per limb, limb k of element i at base[k * stride + i] (limb planes,
// so a warp reading one limb of 32 neighbouring elements reads 128 contiguous
// bytes).  Inside a thread an element is repacked into N little-endian 32-bit
// words: N = 8 for BN254 (L = 16 limbs, R = 2^256), N = 4 for M128 (L = 8,
// R = 2^128), N = 2 for M64 (L = 4, R = 2^64).  R is the same in both
// layouts, so Montgomery form is unchanged by the repack.  The types and the
// carry-chain helpers (FeN<N>, FieldConstsN<N>, load_planes / store_planes,
// fe_add_cc, fe_sub_cc, fe_mul_cc, fe_mul_sel) take the word count as a
// template parameter; Fe and FieldConsts name the eight-word instances, which
// the curve kernels use.
//
// Carries.  The TPU kernels keep 16-bit limbs and lazy uint32 columns (bound
// 4L * 2^16, tile_ops.py:12-14).  With 32-bit words that bound no longer holds,
// so every carry here is a true carry chain: through 64-bit accumulators in
// fe_add / fe_sub / fe_mul_u<U> (K2-K10, eight words), and on the PTX carry
// flag in fe_add_cc / fe_sub_cc / fe_mul_cc (K1, K5, K6 and K10), half the
// instructions.
//
// Every result is canonical (< p), so it equals the reference's result limb
// for limb whatever order the partial products are summed in.
#pragma once

#include <cstdint>

namespace myzkp {

constexpr int kLimbs = 16;  // 16-bit limbs at the tensor interface (BN254)
constexpr int kWords = 8;   // 32-bit words inside a thread (BN254)

// Field constants, passed to each kernel by value (they land in the constant
// bank).  The host builds them from the FieldSpec (_ext.field_consts).
template <int N>
struct FieldConstsN {
  uint32_t p[N];
  uint32_t one[N];  // R mod p: Montgomery form of 1
  uint32_t n0;      // -p^{-1} mod 2^32
};

template <int N>
struct FeN {
  uint32_t w[N];
};

using FieldConsts = FieldConstsN<kWords>;
using Fe = FeN<kWords>;

template <int N = kWords>
__device__ __forceinline__ FeN<N> load_planes(const int32_t* __restrict__ base,
                                              int64_t stride, int64_t i) {
  FeN<N> r;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint32_t lo = static_cast<uint32_t>(base[(2 * k) * stride + i]);
    uint32_t hi = static_cast<uint32_t>(base[(2 * k + 1) * stride + i]);
    r.w[k] = lo | (hi << 16);
  }
  return r;
}

template <int N>
__device__ __forceinline__ void store_planes(int32_t* __restrict__ base,
                                             int64_t stride, int64_t i,
                                             const FeN<N>& a) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    base[(2 * k) * stride + i] = static_cast<int32_t>(a.w[k] & 0xFFFFu);
    base[(2 * k + 1) * stride + i] = static_cast<int32_t>(a.w[k] >> 16);
  }
}

template <int N = kWords>
__device__ __forceinline__ FeN<N> fe_zero() {
  FeN<N> r;
#pragma unroll
  for (int k = 0; k < N; ++k) r.w[k] = 0;
  return r;
}

template <int N>
__device__ __forceinline__ FeN<N> fe_one(const FieldConstsN<N>& c) {
  FeN<N> r;
#pragma unroll
  for (int k = 0; k < N; ++k) r.w[k] = c.one[k];
  return r;
}

template <int N>
__device__ __forceinline__ FeN<N> fe_select(bool m, const FeN<N>& a, const FeN<N>& b) {
  FeN<N> r;
#pragma unroll
  for (int k = 0; k < N; ++k) r.w[k] = m ? a.w[k] : b.w[k];
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

// One row of CIOS: t += a * bi, then one reduction step (t += m p, shift a
// word).  t has kWords + 2 words.
__device__ __forceinline__ void mont_row(uint32_t (&t)[kWords + 2], const Fe& a,
                                         uint32_t bi, const FieldConsts& c) {
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    uint64_t s = static_cast<uint64_t>(t[j]) +
                 static_cast<uint64_t>(a.w[j]) * bi + carry;
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

// Montgomery product a * b * 2^-256 mod p, coarsely integrated operand
// scanning (CIOS) over 32-bit words with 64-bit accumulators.  Inputs < p
// give t < 2p before the final conditional subtract.
//
// U rows of the eight are unrolled in the code: U = kWords is straight-line
// code (about 600 SASS instructions a product); a smaller U runs a loop of
// kWords / U trips over b's words, rotated U a trip so that every index stays
// static (registers, no local memory).  A kernel that inlines many products
// may run faster at a smaller U, in less code for the same arithmetic: K2's
// 14 products (about 9,000 SASS instructions at U = 8) ran 1.5x faster at
// U = 4, likely limited by instruction fetch (not measured: no ncu).
template <int U>
__device__ __forceinline__ Fe fe_mul_u(const Fe& a, const Fe& b,
                                       const FieldConsts& c) {
  static_assert(U >= 1 && kWords % U == 0, "U must divide the word count");
  uint32_t t[kWords + 2];
#pragma unroll
  for (int k = 0; k < kWords + 2; ++k) t[k] = 0;
  if constexpr (U == kWords) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) mont_row(t, a, b.w[i], c);
  } else {
    Fe bw = b;
#pragma unroll 1
    for (int i = 0; i < kWords; i += U) {
#pragma unroll
      for (int u = 0; u < U; ++u) mont_row(t, a, bw.w[u], c);
      Fe r;
#pragma unroll
      for (int k = 0; k < kWords; ++k) r.w[k] = bw.w[(k + U) % kWords];
      bw = r;
    }
  }
  Fe r;
#pragma unroll
  for (int k = 0; k < kWords; ++k) r.w[k] = t[k];
  return fe_cond_sub_p(r, t[kWords], c);
}

__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b,
                                     const FieldConsts& c) {
  return fe_mul_u<kWords>(a, b, c);
}

// ---------------------------------------------------------------------------
// Carry-chain arithmetic (K1 and K6).  Each helper is one PTX instruction;
// the carry flag (CC.CF) links the helpers of a chain, so a chain is written
// as consecutive calls with nothing between them that the flag must survive.
// The asm is volatile, so the front end keeps the calls in order; ptxas
// renames the flag onto SASS carry predicates, which lets two independent
// chains interleave.  A host rehearsal (g++, MYZKP_HOST_REHEARSAL defined)
// gets the same instructions with the flag emulated in a thread-local.
// ---------------------------------------------------------------------------
namespace cc {

#if defined(__CUDA_ARCH__) || !defined(MYZKP_HOST_REHEARSAL)
#define MYZKP_CC3(name, op)                                                  \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b,          \
                                           uint32_t c) {                    \
    uint32_t d;                                                              \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c)); \
    return d;                                                                \
  }
#define MYZKP_CC2(name, op)                                          \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) { \
    uint32_t d;                                                      \
    asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));     \
    return d;                                                        \
  }
MYZKP_CC3(mad_lo_cc, "mad.lo.cc.u32")
MYZKP_CC3(madc_lo_cc, "madc.lo.cc.u32")
MYZKP_CC3(madc_hi_cc, "madc.hi.cc.u32")
MYZKP_CC3(madc_hi, "madc.hi.u32")
MYZKP_CC3(mad_hi_cc, "mad.hi.cc.u32")
MYZKP_CC2(add_cc, "add.cc.u32")
MYZKP_CC2(addc_cc, "addc.cc.u32")
MYZKP_CC2(addc, "addc.u32")
MYZKP_CC2(sub_cc, "sub.cc.u32")
MYZKP_CC2(subc_cc, "subc.cc.u32")
MYZKP_CC2(subc, "subc.u32")
#undef MYZKP_CC3
#undef MYZKP_CC2
#else
inline thread_local uint32_t flag;  // CC.CF: carry, or borrow after sub
inline uint32_t put(uint64_t s) {
  flag = static_cast<uint32_t>(s >> 32) & 1;
  return static_cast<uint32_t>(s);
}
inline uint64_t lo(uint32_t a, uint32_t b) { return static_cast<uint32_t>(uint64_t{a} * b); }
inline uint64_t hi(uint32_t a, uint32_t b) { return (uint64_t{a} * b) >> 32; }
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) { return put(lo(a, b) + c); }
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) { return put(lo(a, b) + c + flag); }
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) { return put(hi(a, b) + c + flag); }
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  return static_cast<uint32_t>(hi(a, b) + c + flag);
}
inline uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) { return put(hi(a, b) + c); }
inline uint32_t add_cc(uint32_t a, uint32_t b) { return put(uint64_t{a} + b); }
inline uint32_t addc_cc(uint32_t a, uint32_t b) { return put(uint64_t{a} + b + flag); }
inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + flag; }
inline uint32_t sub_cc(uint32_t a, uint32_t b) { return put(uint64_t{a} - b); }
inline uint32_t subc_cc(uint32_t a, uint32_t b) { return put(uint64_t{a} - b - flag); }
inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - flag; }
#endif

}  // namespace cc

// a + b mod p and a - b mod p on carry chains (canonical in and out).  The
// sum keeps its carry word (top), so it holds for p up to 2^(32N) - 1: for
// M128, a + b reaches 2^129 - 2.
template <int N>
__device__ __forceinline__ FeN<N> fe_add_cc(const FeN<N>& a, const FeN<N>& b,
                                            const FieldConstsN<N>& c) {
  FeN<N> s, d;
  s.w[0] = cc::add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) s.w[k] = cc::addc_cc(a.w[k], b.w[k]);
  const uint32_t top = cc::addc(0, 0);
  d.w[0] = cc::sub_cc(s.w[0], c.p[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) d.w[k] = cc::subc_cc(s.w[k], c.p[k]);
  // top - borrow: all ones exactly when s < p (then s is the sum)
  const bool keep = cc::subc(top, 0) == 0xFFFFFFFFu;
  return fe_select(keep, s, d);
}

template <int N>
__device__ __forceinline__ FeN<N> fe_sub_cc(const FeN<N>& a, const FeN<N>& b,
                                            const FieldConstsN<N>& c) {
  FeN<N> d, r;
  d.w[0] = cc::sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) d.w[k] = cc::subc_cc(a.w[k], b.w[k]);
  const uint32_t mask = cc::subc(0, 0);  // all ones where a < b
  r.w[0] = cc::add_cc(d.w[0], c.p[0] & mask);
#pragma unroll
  for (int k = 1; k < N; ++k) r.w[k] = cc::addc_cc(d.w[k], c.p[k] & mask);
  return r;
}

// Montgomery product a * b * 2^-256 mod p on carry chains: CIOS over eight
// 32-bit words, each row a * b_i + m * p added as 32-bit multiply-adds
// (mad.lo / madc.hi: 264 a product, the count the bounds use) with no
// 64-bit accumulators, in about 290 instructions against fe_mul_u<8>'s 600.
//
// The running sum T is kept in two accumulators, so that a row is two
// independent chains: ev holds the products a_j b_i and a_j m of even j, as
// (lo, hi) word pairs at positions 0..7, and od those of odd j at positions
// 1..8 (od[k] at position k + 1).  A row ends with ev[0] = 0 and T divided
// by 2^32, which shifts the frame by one word: the next row's ev is this
// row's od, its od is this row's ev moved down two words (folded into the
// next row's multiply-adds as their addends), and ev[1], which now lands at
// position 0, is added into the next ev[0] with its carry feeding the od
// chain.  The words above position 8 are zero: T < 2p throughout, and each
// accumulator is at most T, so for p < 2^255 (both BN254 fields;
// _ext.field_consts checks it) od's chains never carry out and ev's carry
// out is one word, top.  The result is reduced to canonical.
__device__ __forceinline__ void mont_redc_row(uint32_t (&ev)[kWords],
                                              uint32_t (&od)[kWords],
                                              uint32_t& top,
                                              const FieldConsts& c) {
  const uint32_t m = ev[0] * c.n0;
  ev[0] = cc::mad_lo_cc(m, c.p[0], ev[0]);
  ev[1] = cc::madc_hi_cc(m, c.p[0], ev[1]);
#pragma unroll
  for (int j = 2; j < kWords; j += 2) {
    ev[j] = cc::madc_lo_cc(m, c.p[j], ev[j]);
    ev[j + 1] = cc::madc_hi_cc(m, c.p[j], ev[j + 1]);
  }
  top = cc::addc(top, 0);
  od[0] = cc::mad_lo_cc(m, c.p[1], od[0]);
  od[1] = cc::madc_hi_cc(m, c.p[1], od[1]);
#pragma unroll
  for (int j = 3; j < kWords - 1; j += 2) {
    od[j - 1] = cc::madc_lo_cc(m, c.p[j], od[j - 1]);
    od[j] = cc::madc_hi_cc(m, c.p[j], od[j]);
  }
  od[kWords - 2] = cc::madc_lo_cc(m, c.p[kWords - 1], od[kWords - 2]);
  od[kWords - 1] = cc::madc_hi(m, c.p[kWords - 1], od[kWords - 1]);
}

// Row i > 0: the frame moves down a word (ev <- od, od <- ev two words
// down, ev[1] into ev[0]) while a * b_i is added.
__device__ __forceinline__ void mont_mul_row(uint32_t (&ev)[kWords],
                                             uint32_t (&od)[kWords],
                                             uint32_t& top, const Fe& a,
                                             uint32_t bi) {
  uint32_t nev[kWords], nod[kWords];
  // od chain: the new frame's positions 1..8, fed by ev[1]'s carry
  const uint32_t ev0 = cc::add_cc(od[0], ev[1]);
#pragma unroll
  for (int j = 1; j < kWords - 1; j += 2) {
    nod[j - 1] = cc::madc_lo_cc(a.w[j], bi, ev[j + 1]);
    nod[j] = cc::madc_hi_cc(a.w[j], bi, ev[j + 2]);
  }
  nod[kWords - 2] = cc::madc_lo_cc(a.w[kWords - 1], bi, top);
  nod[kWords - 1] = cc::madc_hi(a.w[kWords - 1], bi, 0);
  // ev chain: positions 0..7, its carry out to top
  nev[0] = cc::mad_lo_cc(a.w[0], bi, ev0);
  nev[1] = cc::madc_hi_cc(a.w[0], bi, od[1]);
#pragma unroll
  for (int j = 2; j < kWords; j += 2) {
    nev[j] = cc::madc_lo_cc(a.w[j], bi, od[j]);
    nev[j + 1] = cc::madc_hi_cc(a.w[j], bi, od[j + 1]);
  }
  top = cc::addc(0, 0);
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    ev[k] = nev[k];
    od[k] = nod[k];
  }
}

__device__ __forceinline__ Fe fe_mul_cc_spare(const Fe& a, const Fe& b,
                                              const FieldConsts& c) {
  uint32_t ev[kWords], od[kWords], top = 0;
  const uint32_t b0 = b.w[0];
#pragma unroll
  for (int j = 0; j < kWords; j += 2) {
    ev[j] = a.w[j] * b0;
    ev[j + 1] = __umulhi(a.w[j], b0);
    od[j] = a.w[j + 1] * b0;
    od[j + 1] = __umulhi(a.w[j + 1], b0);
  }
  mont_redc_row(ev, od, top, c);
#pragma unroll
  for (int i = 1; i < kWords; ++i) {
    mont_mul_row(ev, od, top, a, b.w[i]);
    mont_redc_row(ev, od, top, c);
  }
  // T = (ev[1..7], top) + od, both at positions 0..7
  Fe r, d;
  r.w[0] = cc::add_cc(od[0], ev[1]);
#pragma unroll
  for (int k = 1; k < kWords - 1; ++k) r.w[k] = cc::addc_cc(od[k], ev[k + 1]);
  r.w[kWords - 1] = cc::addc_cc(od[kWords - 1], top);
  const uint32_t hi = cc::addc(0, 0);
  d.w[0] = cc::sub_cc(r.w[0], c.p[0]);
#pragma unroll
  for (int k = 1; k < kWords; ++k) d.w[k] = cc::subc_cc(r.w[k], c.p[k]);
  const bool keep = cc::subc(hi, 0) == 0xFFFFFFFFu;
  return fe_select(keep, r, d);
}

// t += a * bi over t[0..N+1]: the products of even j in one chain and of
// odd j in another, each product's low and high halves side by side
// (positions j and j + 1), as fe_mul_cc_spare adds them, so that ptxas fuses
// each pair into one IMAD.WIDE.U32(.X).  With the low halves in one chain
// and the high halves in another, ptxas left IMAD, IMAD.HI and carry adds:
// on the H100, K1's chain over 2^20 M128 elements took 1.35 ms against
// 1.00, K6's top leaf 0.0534 against 0.0479 (unroll_sweep.py pow / leaf8,
// PERF.md).
template <int N>
__device__ __forceinline__ void wide_row(uint32_t (&t)[N + 2], const FeN<N>& a, uint32_t bi) {
  t[0] = cc::mad_lo_cc(a.w[0], bi, t[0]);
  t[1] = cc::madc_hi_cc(a.w[0], bi, t[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    t[j] = cc::madc_lo_cc(a.w[j], bi, t[j]);
    t[j + 1] = cc::madc_hi_cc(a.w[j], bi, t[j + 1]);
  }
  t[N] = cc::addc_cc(t[N], 0);
  t[N + 1] = cc::addc(t[N + 1], 0);
  t[1] = cc::mad_lo_cc(a.w[1], bi, t[1]);
  t[2] = cc::madc_hi_cc(a.w[1], bi, t[2]);
#pragma unroll
  for (int j = 3; j < N; j += 2) {
    t[j] = cc::madc_lo_cc(a.w[j], bi, t[j]);
    t[j + 1] = cc::madc_hi_cc(a.w[j], bi, t[j + 1]);
  }
  t[N + 1] = cc::addc(t[N + 1], 0);
}

// Montgomery product a * b * 2^(-32N) mod p on carry chains for p with no
// spare bit (M128: p > 2^127 = R / 2; M64: p > 2^63).  There T < 2p can pass
// R, so the even / odd accumulators above, which hold N words each, do not
// apply.  CIOS with the running sum T in N + 2 words t[0..N+1]: a row adds
// a * b_i (wide_row: two chains), then m p with m = t_0 n0 (two more), and
// shifts down a word.  Inputs below p keep T < 2p after each row, so T
// fits in N words and one bit (t[N]), and before the shift in N + 1 words
// and one bit (t[N+1]); the chains' carries run into t[N] and t[N+1] and
// never past them.  The result is T - p where t[N] is set or T >= p.  4 N +
// 7 PTX instructions a row: about 100 a product at N = 4, 30 at N = 2.
template <int N>
__device__ __forceinline__ FeN<N> fe_mul_cc_wide(const FeN<N>& a, const FeN<N>& b,
                                                 const FieldConstsN<N>& c) {
  static_assert(N % 2 == 0, "an even word count");
  uint32_t t[N + 2];
#pragma unroll
  for (int k = 0; k < N + 2; ++k) t[k] = 0;
  FeN<N> p;
#pragma unroll
  for (int k = 0; k < N; ++k) p.w[k] = c.p[k];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    wide_row(t, a, b.w[i]);
    wide_row(t, p, t[0] * c.n0);  // t[0] becomes 0
#pragma unroll
    for (int k = 0; k <= N; ++k) t[k] = t[k + 1];
    t[N + 1] = 0;
  }
  FeN<N> r, d;
#pragma unroll
  for (int k = 0; k < N; ++k) r.w[k] = t[k];
  d.w[0] = cc::sub_cc(r.w[0], c.p[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) d.w[k] = cc::subc_cc(r.w[k], c.p[k]);
  const bool keep = cc::subc(t[N], 0) == 0xFFFFFFFFu;  // t[N] = 0 and T < p
  return fe_select(keep, r, d);
}

// The carry-chain product at N words: the even / odd accumulators at eight
// words (BN254's fields, p < 2^255: _ext.field_consts checks it), the wide
// CIOS at four (M128, p > 2^127) and two (M64, p > 2^63).
template <int N>
__device__ __forceinline__ FeN<N> fe_mul_cc(const FeN<N>& a, const FeN<N>& b,
                                            const FieldConstsN<N>& c) {
  if constexpr (N == kWords) {
    return fe_mul_cc_spare(a, b, c);
  } else {
    return fe_mul_cc_wide(a, b, c);
  }
}

// The product a kernel is built on, by a -D constant: 0 the carry-chain
// product above, U = 1, 2, 4, 8 fe_mul_u<U>.  fe_mul_u exists at eight words
// only: the four- and two-word instances run the carry chains at any MUL.
template <int MUL, int N>
__device__ __forceinline__ FeN<N> fe_mul_sel(const FeN<N>& a, const FeN<N>& b,
                                             const FieldConstsN<N>& c) {
  if constexpr (MUL == 0 || N != kWords) {
    return fe_mul_cc(a, b, c);
  } else {
    return fe_mul_u<MUL>(a, b, c);
  }
}

__device__ __forceinline__ Fe fe_sqr(const Fe& a, const FieldConsts& c) {
  return fe_mul(a, a, c);
}

}  // namespace myzkp
