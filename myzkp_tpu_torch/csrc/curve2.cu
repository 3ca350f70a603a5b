// K7: G2 complete add over F_q2, with an optional select mask (Q where h is
// set, else P + Q).  K8: a chain of n >= 1 G2 complete doublings, 2^n P, in
// one launch, with the optional output of every step.  K10: G2 mixed add
// P + (qx, qy, 1), with an optional select mask ((qx, qy, 1) where h is set).
// The G2 lane-merge level: one level of the lane merge's segmented
// Hillis-Steele scan (msm._seg_scan_hs) in one launch, on K7's body.
//
// Replace curve_pallas.padd2_fused / padd2_sel_fused (kernel
// _make_padd2_kernel, myzkp_tpu/curves/curve_pallas.py:484, :534, :542),
// curve_pallas.pdbl2_fused (_make_pdbl2_kernel :515, :550) and
// curve_pallas.padd_mixed2_sel_fused / padd_mixed2_fused (kernel
// _make_padd_mixed2_kernel :257, :289, :300); the level replaces the rolls,
// selects and padd2 launch of one level of myzkp_tpu/curves/msm.py:335-357.
//
// Bound on the H100: integer multiply throughput, with register pressure and
// latency as the limits at the lane merge's 32,768 lanes.  A complete add is
// 14 F_q2 products (12 of the formula, 2 by b3) and about 40 F_q adds/subs,
// against 12 point coordinate reads and 6 writes of 64 bytes each per F_q
// component.
//
// K7 and the level run one point on a lane pair (pair.cuh): each lane
// holds one component of every coordinate, so a thread carries a G1 point's
// state instead of a G2 point's (one thread per point took 255 registers and
// spilled 256 bytes), there are twice the warps, and an F_q2 product is two
// F_q products deep (four in all, 56 a complete add, against Karatsuba's 42
// three deep).  The 28 products a lane unroll 2 of their 8 rows in the code
// (pair.cuh's kPair2Unroll): fully unrolled they were about 18,000 SASS
// instructions and ran 25% slower.  Lanes past the end of the batch and
// lanes that the mask or a flag keeps compute on clamped inputs and store
// nothing or the kept point, since every lane of a warp must reach every
// shuffle.  A level skips the add only where a whole warp's points are
// flagged (a warp-uniform branch).
//
// K8 runs on the lane pair too, for the widths the prover gives it: 1 to 16
// points (Horner's and the window sums' chains of c doublings, the G2
// ladder's 255 bases), one warp, where a one-thread double was a chain of 25
// dependent products in 194 registers.  On the pair a double is 16 products
// a lane deep (7 F_q2 products of 2, 2 squares of 1), and one launch runs
// the whole chain: the point stays in registers, the step loop is rolled (its
// body fetched once) and each product unrolls MYZKP_K8_UNROLL rows.  Its
// bound at those widths is latency, not the multiply rate; its outputs are
// write-only.
//
// K10 runs on the lane pair too (it ran one thread a point, with the whole
// formula in 255 registers and a 232-byte stack): group.cuh's padd_mixed over
// this lane's components, qx and qy loaded as this lane's component, 13 F_q2
// products of two F_q products each, two deep.  Every lane computes, on
// clamped indices past the end, and the mask acts only at the store: where h
// is set the lane stores (qx, qy, one), the one (R mod q, 0) split over the
// pair.  The products run on the carry chains of fe_mul_cc
// (MYZKP_K10_UNROLL = 0; U > 0 unrolls U rows of fe_mul_u<U>).  b3 (the
// pair 3 * B2, not 9) is read as this lane's component from two (16,)
// tensors; the outputs are write-only.  The mixed add holds P and an affine
// Q, 10 F_q elements against the complete add's 12.
#include <cuda_runtime.h>

#include "pair.cuh"

using myzkp::Fe2p;
using myzkp::FieldConsts;
using Pt2p = myzkp::Point<Fe2p>;

namespace {

// A G2 point batch at the C interface: x0, x1, y0, y1, z0, z1 limb planes,
// each (16, n) int32.
struct In6 {
  const int32_t* v[6];
};
struct Out6 {
  int32_t* v[6];
};
// An affine G2 point batch: qx0, qx1, qy0, qy1.
struct In4 {
  const int32_t* v[4];
};

// This lane's component (pair_half) of each coordinate of point i.
template <class E = Fe2p>
__device__ __forceinline__ myzkp::Point<E> load_point2p(const In6& a, int half,
                                                        int64_t n, int64_t i) {
  return myzkp::Point<E>{{myzkp::load_planes(half ? a.v[1] : a.v[0], n, i)},
                         {myzkp::load_planes(half ? a.v[3] : a.v[2], n, i)},
                         {myzkp::load_planes(half ? a.v[5] : a.v[4], n, i)}};
}

template <class E>
__device__ __forceinline__ void store_point2p(const Out6& o, int half,
                                              int64_t n, int64_t i,
                                              const myzkp::Point<E>& p) {
  myzkp::store_planes(half ? o.v[1] : o.v[0], n, i, p.x.v);
  myzkp::store_planes(half ? o.v[3] : o.v[2], n, i, p.y.v);
  myzkp::store_planes(half ? o.v[5] : o.v[4], n, i, p.z.v);
}

// One point on a lane pair: 64 points a block of 128 threads, 16 a warp.
constexpr int kPairThreads = 128;
constexpr int kPairPoints = kPairThreads / 2;

__global__ void __launch_bounds__(kPairThreads)
    padd2_kernel(In6 p, In6 q, const bool* __restrict__ h,
                 const int32_t* __restrict__ b3c0,
                 const int32_t* __restrict__ b3c1, Out6 o, int64_t n,
                 FieldConsts c) {
  const int half = myzkp::pair_half();
  const int64_t i = myzkp::pair_index();
  const int64_t ic = i < n ? i : n - 1;  // every lane reaches the shuffles
  const Pt2p qv = load_point2p(q, half, n, ic);
  const Pt2p pv = load_point2p(p, half, n, ic);
  const Fe2p b3{myzkp::load_planes(half ? b3c1 : b3c0, 1, 0)};
  const Pt2p r = myzkp::padd(pv, qv, b3, c);
  if (i < n) {
    const bool keep_q = h != nullptr && h[i];
    store_point2p(o, half, n, i, myzkp::pt_select(keep_q, qv, r));
  }
}

// One level of the segmented Hillis-Steele scan over rows of B lanes (the
// batch is (rows, B), point i at lane i % B), at distance d:
//   out[i]    = flags[i] ? x[i] : (lane >= d ? x[i - d] : O) + x[i]
//   oflags[i] = flags[i] | (lane >= d & flags[i - d])
// x and out are different buffers: a level reads lane i - d as it was.
__global__ void __launch_bounds__(kPairThreads)
    padd2_seg_level_kernel(In6 x, const bool* __restrict__ flags,
                           const int32_t* __restrict__ b3c0,
                           const int32_t* __restrict__ b3c1, Out6 o,
                           bool* __restrict__ oflags, int64_t n, int64_t B,
                           int64_t d, FieldConsts c) {
  const int half = myzkp::pair_half();
  const int64_t i = myzkp::pair_index();
  const bool live = i < n;
  const int64_t ic = live ? i : n - 1;
  const bool valid = ic % B >= d;
  const bool f = flags[ic];
  if (live && half == 0) oflags[i] = f || (valid && flags[ic - d]);
  const Pt2p qv = load_point2p(x, half, n, ic);
  if (__all_sync(0xffffffffu, f || !live)) {  // the whole warp keeps x
    if (live) store_point2p(o, half, n, i, qv);
    return;
  }
  const Pt2p pv = myzkp::pt_select(valid, load_point2p(x, half, n, valid ? ic - d : ic),
                                   myzkp::pt2p_infinity(c));
  const Fe2p b3{myzkp::load_planes(half ? b3c1 : b3c0, 1, 0)};
  const Pt2p r = myzkp::padd(pv, qv, b3, c);
  if (live) store_point2p(o, half, n, i, myzkp::pt_select(f, qv, r));
}

unsigned pair_blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kPairPoints - 1) / kPairPoints);
}

// Rows of the Montgomery product unrolled in K8's step loop.  The prover runs
// K8 on 1 to 16 points (one warp), where a double's latency is the whole
// cost: on an H100 80GB HBM3 at 700 W a double took 15.1 us at U = 4, 15.7
// at U = 2, 18.6 at U = 1 and 31 at U = 8 (11,408 SASS instructions against
// 8,120; unroll_sweep.py, PERF.md).  A build may set it with
// -DMYZKP_K8_UNROLL=U.
#ifndef MYZKP_K8_UNROLL
#define MYZKP_K8_UNROLL 4
#endif
using Fe2pK8 = myzkp::Fe2pU<MYZKP_K8_UNROLL>;

// The planes of step k of a steps output: (steps, 16, n) planes a coordinate.
__device__ __forceinline__ Out6 step_of(const Out6& s, int64_t offset) {
  Out6 r;
#pragma unroll
  for (int j = 0; j < 6; ++j) r.v[j] = s.v[j] + offset;
  return r;
}

// steps doublings of each point on a lane pair: the point stays in registers
// and the step loop is not unrolled.  out (if o.v[0] is not null) gets
// 2^steps P; the steps output (if s.v[0] is not null) gets step k,
// 2^(k+1) P, at offset k * 16 n.  A warp whose points all lie past the end
// leaves at once (a warp-uniform exit); the other lanes past the end compute
// on the last point and store nothing.
__global__ void __launch_bounds__(kPairThreads)
    pdbl2_kernel(In6 p, const int32_t* __restrict__ b3c0,
                 const int32_t* __restrict__ b3c1, Out6 o, Out6 s, int64_t n,
                 int steps, FieldConsts c) {
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                         (threadIdx.x & ~31u)) / 2;
  if (first >= n) return;
  const int half = myzkp::pair_half();
  const int64_t i = myzkp::pair_index();
  const bool live = i < n;
  myzkp::Point<Fe2pK8> v = load_point2p<Fe2pK8>(p, half, n, live ? i : n - 1);
  const Fe2pK8 b3{myzkp::load_planes(half ? b3c1 : b3c0, 1, 0)};
  const int64_t block = myzkp::kLimbs * n;
#pragma unroll 1
  for (int k = 0; k < steps; ++k) {
    v = myzkp::pdbl(v, b3, c);
    if (live && s.v[0] != nullptr) store_point2p(step_of(s, k * block), half, n, i, v);
  }
  if (live && o.v[0] != nullptr) store_point2p(o, half, n, i, v);
}

// Rows of the Montgomery product unrolled in K10's products, 0 meaning the
// carry chains of fe_mul_cc.  On an H100 80GB HBM3 at 700 W, 32,768 lanes
// with the mask on 1 in 32 took 0.0570 ms at U = 0 (194 registers), 0.0882
// at 1, 0.0809 at 2 (128 registers), 0.1028 at 4 and 0.1048 at 8
// (unroll_sweep.py mixed, PERF.md).  A build may set it with
// -DMYZKP_K10_UNROLL=U.
#ifndef MYZKP_K10_UNROLL
#define MYZKP_K10_UNROLL 0
#endif
using Fe2pK10 = myzkp::Fe2pU<MYZKP_K10_UNROLL>;

__global__ void __launch_bounds__(kPairThreads)
    padd_mixed2_kernel(In6 p, In4 q, const bool* __restrict__ h,
                       const int32_t* __restrict__ b3c0,
                       const int32_t* __restrict__ b3c1, Out6 o, int64_t n,
                       FieldConsts c) {
  using E = Fe2pK10;
  const int half = myzkp::pair_half();
  const int64_t i = myzkp::pair_index();
  const int64_t ic = i < n ? i : n - 1;  // every lane reaches the shuffles
  const E qx{myzkp::load_planes(half ? q.v[1] : q.v[0], n, ic)};
  const E qy{myzkp::load_planes(half ? q.v[3] : q.v[2], n, ic)};
  const myzkp::Point<E> pv = load_point2p<E>(p, half, n, ic);
  const E b3{myzkp::load_planes(half ? b3c1 : b3c0, 1, 0)};
  const myzkp::Point<E> r = myzkp::padd_mixed(pv, qx, qy, b3, c);
  if (i < n) {
    const bool keep_q = h != nullptr && h[i];
    const myzkp::Point<E> qp{qx, qy, {myzkp::pair_one(c)}};
    store_point2p(o, half, n, i, myzkp::pt_select(keep_q, qp, r));
  }
}

}  // namespace

// p, q, out: six (16, n) planes each (x0, x1, y0, y1, z0, z1); h may be null:
// plain P + Q.
extern "C" int myzkp_padd2(const int32_t* p0, const int32_t* p1,
                           const int32_t* p2, const int32_t* p3,
                           const int32_t* p4, const int32_t* p5,
                           const int32_t* q0, const int32_t* q1,
                           const int32_t* q2, const int32_t* q3,
                           const int32_t* q4, const int32_t* q5, const bool* h,
                           const int32_t* b3c0, const int32_t* b3c1,
                           int32_t* o0, int32_t* o1, int32_t* o2, int32_t* o3,
                           int32_t* o4, int32_t* o5, int64_t n,
                           const FieldConsts* consts, void* stream) {
  In6 p{{p0, p1, p2, p3, p4, p5}};
  In6 q{{q0, q1, q2, q3, q4, q5}};
  Out6 o{{o0, o1, o2, o3, o4, o5}};
  padd2_kernel<<<pair_blocks_for(n), kPairThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(p, q, h, b3c0, b3c1, o,
                                                      n, *consts);
  return static_cast<int>(cudaGetLastError());
}

// steps >= 1 doublings: out <- 2^steps P; the steps output, six
// (steps, 16, n) planes, <- 2P, 4P, ..., 2^steps P.  Either may be null (all
// six of its pointers).
extern "C" int myzkp_pdbl2(const int32_t* p0, const int32_t* p1,
                           const int32_t* p2, const int32_t* p3,
                           const int32_t* p4, const int32_t* p5,
                           const int32_t* b3c0, const int32_t* b3c1,
                           int32_t* o0, int32_t* o1, int32_t* o2, int32_t* o3,
                           int32_t* o4, int32_t* o5, int32_t* s0, int32_t* s1,
                           int32_t* s2, int32_t* s3, int32_t* s4, int32_t* s5,
                           int64_t n, int steps, const FieldConsts* consts,
                           void* stream) {
  if (steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  In6 p{{p0, p1, p2, p3, p4, p5}};
  Out6 o{{o0, o1, o2, o3, o4, o5}};
  Out6 s{{s0, s1, s2, s3, s4, s5}};
  pdbl2_kernel<<<pair_blocks_for(n), kPairThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(p, b3c0, b3c1, o, s, n,
                                                      steps, *consts);
  return static_cast<int>(cudaGetLastError());
}

// p, out: six (16, n) planes each (x0, x1, y0, y1, z0, z1); q: four (qx0,
// qx1, qy0, qy1); h may be null: plain P + (qx, qy, 1).
extern "C" int myzkp_padd_mixed2(const int32_t* p0, const int32_t* p1,
                                 const int32_t* p2, const int32_t* p3,
                                 const int32_t* p4, const int32_t* p5,
                                 const int32_t* q0, const int32_t* q1,
                                 const int32_t* q2, const int32_t* q3,
                                 const bool* h, const int32_t* b3c0,
                                 const int32_t* b3c1, int32_t* o0,
                                 int32_t* o1, int32_t* o2, int32_t* o3,
                                 int32_t* o4, int32_t* o5, int64_t n,
                                 const FieldConsts* consts, void* stream) {
  In6 p{{p0, p1, p2, p3, p4, p5}};
  In4 q{{q0, q1, q2, q3}};
  Out6 o{{o0, o1, o2, o3, o4, o5}};
  padd_mixed2_kernel<<<pair_blocks_for(n), kPairThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p, q, h, b3c0,
                                                            b3c1, o, n,
                                                            *consts);
  return static_cast<int>(cudaGetLastError());
}

// x, out: six (16, n) planes each (x0, x1, y0, y1, z0, z1) of a (rows, B)
// batch, n = rows * B; flags, oflags: (rows, B) bool; 1 <= d < B.  x and out,
// flags and oflags must not overlap.
extern "C" int myzkp_padd2_seg_level(
    const int32_t* x0, const int32_t* x1, const int32_t* x2,
    const int32_t* x3, const int32_t* x4, const int32_t* x5,
    const bool* flags, const int32_t* b3c0, const int32_t* b3c1, int32_t* o0,
    int32_t* o1, int32_t* o2, int32_t* o3, int32_t* o4, int32_t* o5,
    bool* oflags, int64_t n, int64_t B, int64_t d, const FieldConsts* consts,
    void* stream) {
  In6 x{{x0, x1, x2, x3, x4, x5}};
  Out6 o{{o0, o1, o2, o3, o4, o5}};
  padd2_seg_level_kernel<<<pair_blocks_for(n), kPairThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, flags, b3c0, b3c1, o, oflags, n, B, d, *consts);
  return static_cast<int>(cudaGetLastError());
}
