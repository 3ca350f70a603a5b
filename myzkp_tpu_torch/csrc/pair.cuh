// The group law on a lane pair: one point held by two lanes of a warp, lane k
// of a half-warp and lane k + 16.  The split is on the half-warp, so each
// half-warp reads and writes 16 consecutive points of a limb plane.  The two
// lanes run the same instructions on different operands, chosen by the
// lane's half with selects and no branch, and trade values through
// __shfl_xor_sync(..., 16).
//
// G2 (Fe2pU): the lane of half 0 holds c0 and the lane of half 1 holds c1 of
// every F_q2 value.  Add and sub are component-wise and need no exchange.  A
// product (a0 + a1 u)(b0 + b1 u) trades the partner's a and b (16 words) and
// takes two F_q products a lane: a0 b0 - a1 b1 on the c0 lane, a1 b0 + a0 b1
// on the c1 lane.  That is 4 F_q products per F_q2 product against
// Karatsuba's 3 (fq2.cuh), two deep against three, on half the state a
// thread.  A square is one F_q product a lane, one deep against two.
// group.cuh's padd and pdbl run over it unchanged.
//
// Every lane of the warp must reach every exchange: the shuffles take the
// full mask, so a kernel built on these computes on clamped indices past the
// end of its batch and masks only the stores.  Results are canonical, so they
// equal the one-thread formulas bit for bit.
#pragma once

#include "group.cuh"

namespace myzkp {

// 1 on the lane of half 1, 0 on the lane of half 0.
__device__ __forceinline__ int pair_half() { return (threadIdx.x >> 4) & 1; }

// The point of this thread's lane pair: lanes k and k + 16 of a warp share
// point 16 * (the warp's index in the grid) + k.
__device__ __forceinline__ int64_t pair_index() {
  return (static_cast<int64_t>(blockIdx.x) * blockDim.x + (threadIdx.x & ~31u)) / 2 +
         (threadIdx.x & 15);
}

// The partner lane's a.
__device__ __forceinline__ Fe pair_swap(const Fe& a) {
  Fe r;
#pragma unroll
  for (int k = 0; k < kWords; ++k) r.w[k] = __shfl_xor_sync(0xffffffffu, a.w[k], 16);
  return r;
}

// Rows of the Montgomery product unrolled in K7's and the G2 level's code
// (field.cuh's fe_mul_u): a G2 add inlines 28 products a lane, which fully
// unrolled are about 18,000 SASS instructions and ran 25% slower than at 2.
// A build may set it with -DMYZKP_PAIR2_UNROLL=U (unroll_sweep.py).  K8 sets
// its own (curve2.cu's MYZKP_K8_UNROLL).
#ifndef MYZKP_PAIR2_UNROLL
#define MYZKP_PAIR2_UNROLL 2
#endif
constexpr int kPair2Unroll = MYZKP_PAIR2_UNROLL;

// One component of an F_q2 element; the partner lane holds the other.  Its
// products unroll U of the Montgomery product's 8 rows (fe_mul_sel<U>), or
// with U = 0 run on the carry chains (fe_mul_cc).
template <int U>
struct Fe2pU {
  Fe v;
};
using Fe2p = Fe2pU<kPair2Unroll>;

template <int U>
__device__ __forceinline__ Fe2pU<U> add(const Fe2pU<U>& a, const Fe2pU<U>& b,
                                        const FieldConsts& c) {
  return Fe2pU<U>{fe_add(a.v, b.v, c)};
}

template <int U>
__device__ __forceinline__ Fe2pU<U> sub(const Fe2pU<U>& a, const Fe2pU<U>& b,
                                        const FieldConsts& c) {
  return Fe2pU<U>{fe_sub(a.v, b.v, c)};
}

// c0 lane (holds a0, b0): a0 b0 - a1 b1; c1 lane (holds a1, b1): a1 b0 + a0 b1.
template <int U>
__device__ __forceinline__ Fe2pU<U> mul(const Fe2pU<U>& a, const Fe2pU<U>& b,
                                        const FieldConsts& c) {
  const Fe ap = pair_swap(a.v), bp = pair_swap(b.v);
  const bool hi = pair_half() != 0;
  const Fe m1 = fe_mul_sel<U>(a.v, fe_select(hi, bp, b.v), c);  // a0 b0 | a1 b0
  const Fe m2 = fe_mul_sel<U>(ap, fe_select(hi, b.v, bp), c);   // a1 b1 | a0 b1
  return Fe2pU<U>{fe_select(hi, fe_add(m1, m2, c), fe_sub(m1, m2, c))};
}

// c0 lane (holds a0): (a0 + a1)(a0 - a1) = a0^2 - a1^2; c1 lane (holds a1):
// 2 a1 a0.  One F_q product a lane; canonical, so equal to fq2.cuh's fe2_sqr.
template <int U>
__device__ __forceinline__ Fe2pU<U> sqr(const Fe2pU<U>& a, const FieldConsts& c) {
  const Fe ap = pair_swap(a.v);
  const bool hi = pair_half() != 0;
  const Fe m = fe_mul_sel<U>(fe_select(hi, a.v, fe_add(a.v, ap, c)),
                             fe_select(hi, ap, fe_sub(a.v, ap, c)), c);
  return Fe2pU<U>{fe_select(hi, fe_add(m, m, c), m)};
}

// m ? a : b word by word.
template <int U>
__device__ __forceinline__ Point<Fe2pU<U>> pt_select(bool m, const Point<Fe2pU<U>>& a,
                                                    const Point<Fe2pU<U>>& b) {
  return Point<Fe2pU<U>>{{fe_select(m, a.x.v, b.x.v)}, {fe_select(m, a.y.v, b.y.v)},
                         {fe_select(m, a.z.v, b.z.v)}};
}

// This lane's component of the F_q2 one, (R mod q, 0).
__device__ __forceinline__ Fe pair_one(const FieldConsts& c) {
  return fe_select(pair_half() != 0, fe_zero(), fe_one(c));
}

// This lane's component of the point at infinity (0, 1, 0).
__device__ __forceinline__ Point<Fe2p> pt2p_infinity(const FieldConsts& c) {
  return Point<Fe2p>{{fe_zero()}, {pair_one(c)}, {fe_zero()}};
}

}  // namespace myzkp
