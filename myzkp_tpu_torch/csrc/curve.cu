// K2: G1 complete add, with an optional select mask (Q where h is set, else
// P + Q).  K3: a chain of n >= 1 G1 complete doublings, 2^n P, in one launch,
// with the optional output of every step.  K9: G1 mixed add P + (qx, qy, 1),
// with an optional select mask ((qx, qy, 1) where h is set).  The G1
// lane-merge level: one level of the lane merge's segmented Hillis-Steele scan
// (msm._seg_scan_hs) in one launch, on K2's one-thread body.
//
// Replace curve_pallas.padd_fused / padd_sel_fused (kernel
// _make_padd_kernel, myzkp_tpu/curves/curve_pallas.py:183, :322, :330),
// curve_pallas.pdbl_fused (_make_pdbl_kernel :307, :340) and
// curve_pallas.padd_mixed_fused / padd_mixed_sel_fused (kernel
// _make_padd_mixed_kernel :214, :239, :247); the level replaces the rolls,
// selects and padd launch of one level of myzkp_tpu/curves/msm.py:335-357.
//
// Bound on the H100: integer multiply throughput.  A complete add is 14
// Montgomery products (~3,700 32x32->64-bit multiply-adds) and 17 adds/subs
// against 6 point reads and 3 point writes of 192 bytes each.  b3 is read
// once per thread from a (16,) tensor instead of the full tile the TPU
// broadcast it to (curve_pallas.py:146-151).
//
// K2 runs one thread a point at every width, computes every lane and applies
// the mask at the store: no divergent early exit.  Its cost is the code: the
// 14 products fully unrolled are about 9,000 SASS instructions, which ran at
// 1.7x K9's time for 1.1x its instructions, so its body unrolls 4 of each
// product's 8 rows (kUnroll, field.cuh's fe_mul_u).  K9 (the mixed add reads
// 5 coordinates instead of 6 and does 13 products) runs on the carry chains
// (group.cuh's FeC: fe_mul_cc, about 290 instructions a product against
// fe_mul_u<8>'s 600), one thread a point with the whole formula in
// registers (K10's lane pair and K3's lane quad ran slower: PERF.md, row 9).
// Where its mask is set it writes (qx, qy, R mod q) without reading P.
//
// K3: the prover calls it on 1 to 16 points (Horner's and the window sums'
// chains of c doublings, the ladders' 255 bases), one warp on one SM, where
// a double's 9 dependent products are the whole cost: the bound is latency
// and the host's cost of a launch, not the card's multiply rate.  So one
// launch runs the whole chain with the point in registers and the step loop
// rolled (its body fetched once), and each point runs on a lane quad: the
// four independent products of each of RCB16 Algorithm 9's two product
// rounds go one to a lane, 3 products deep a double against 9 on one
// thread.  The outputs are write-only.
#include <cuda_runtime.h>

#include "group.cuh"

using myzkp::Fe;
using myzkp::FieldConsts;
using myzkp::Pt;

namespace {

// Rows of the Montgomery product unrolled in the code of K2 and of the G1
// level (field.cuh's fe_mul_u): fully unrolled, K2's 14 products are about
// 9,000 SASS instructions and ran 1.5x slower at 4M points.  A build may set
// it with -DMYZKP_K2_UNROLL=U (unroll_sweep.py).
#ifndef MYZKP_K2_UNROLL
#define MYZKP_K2_UNROLL 4
#endif
constexpr int kUnroll = MYZKP_K2_UNROLL;

// Rows of the Montgomery product unrolled in K3's step loop.  The prover runs
// K3 on 1 to 16 points, one or two warps, where a double's latency is the
// whole cost: on an H100 80GB HBM3 at 700 W a double on a lane quad took
// 2.9 us at U = 8 against 3.4 at U = 4, and one thread a point 6.7-10.0 us
// (unroll_sweep.py, PERF.md).  A build may set it with -DMYZKP_K3_UNROLL=U.
#ifndef MYZKP_K3_UNROLL
#define MYZKP_K3_UNROLL 8
#endif
constexpr int kK3Unroll = MYZKP_K3_UNROLL;

__device__ __forceinline__ Pt load_point(const int32_t* x, const int32_t* y,
                                         const int32_t* z, int64_t n,
                                         int64_t i) {
  return Pt{myzkp::load_planes(x, n, i), myzkp::load_planes(y, n, i),
            myzkp::load_planes(z, n, i)};
}

__device__ __forceinline__ void store_point(int32_t* x, int32_t* y,
                                            int32_t* z, int64_t n, int64_t i,
                                            const Pt& p) {
  myzkp::store_planes(x, n, i, p.x);
  myzkp::store_planes(y, n, i, p.y);
  myzkp::store_planes(z, n, i, p.z);
}

__global__ void __launch_bounds__(128)
    padd_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
                const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
                const bool* __restrict__ h, const int32_t* __restrict__ b3,
                int32_t* __restrict__ x3, int32_t* __restrict__ y3,
                int32_t* __restrict__ z3, int64_t n, FieldConsts c) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Pt q = load_point(x2, y2, z2, n, i);
  const Pt p = load_point(x1, y1, z1, n, i);
  const Pt r = myzkp::padd_u<kUnroll>(p, q, myzkp::load_planes(b3, 1, 0), c);
  store_point(x3, y3, z3, n, i, myzkp::pt_select(h != nullptr && h[i], q, r));
}

// One level of the segmented Hillis-Steele scan over rows of B lanes (the
// batch is (rows, B), point i at lane i % B), at distance d:
//   out[i]    = flags[i] ? x[i] : (lane >= d ? x[i - d] : O) + x[i]
//   oflags[i] = flags[i] | (lane >= d & flags[i - d])
// x and out are different buffers: a level reads lane i - d as it was.
__global__ void __launch_bounds__(128)
    padd_seg_level_kernel(const int32_t* __restrict__ x,
                          const int32_t* __restrict__ y,
                          const int32_t* __restrict__ z,
                          const bool* __restrict__ flags,
                          const int32_t* __restrict__ b3,
                          int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                          int32_t* __restrict__ oz, bool* __restrict__ oflags,
                          int64_t n, int64_t B, int64_t d, FieldConsts c) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool valid = i % B >= d;
  const bool f = flags[i];
  oflags[i] = f || (valid && flags[i - d]);
  Pt q = load_point(x, y, z, n, i);
  if (f) {
    store_point(ox, oy, oz, n, i, q);
    return;
  }
  Pt p = myzkp::pt_select(valid, load_point(x, y, z, n, valid ? i - d : i),
                          myzkp::pt_infinity(c));
  store_point(ox, oy, oz, n, i,
              myzkp::padd_u<kUnroll>(p, q, myzkp::load_planes(b3, 1, 0), c));
}

// A lane quad: lanes k, k + 8, k + 16 and k + 24 of a warp hold point
// 8 * (the warp's index in the grid) + k, each the whole point; lane k + 8 r
// computes product r of each of RCB16 Algorithm 9's two rounds of four
// independent products, and the quad trades them through shuffles, so a
// double is 3 products deep (the middle one, b3 Z^2, on every lane).
__device__ __forceinline__ Fe quad_bcast(const Fe& m, int r) {
  Fe out;
  const int src = static_cast<int>(threadIdx.x & 7) + 8 * r;
#pragma unroll
  for (int k = 0; k < myzkp::kWords; ++k) out.w[k] = __shfl_sync(0xffffffffu, m.w[k], src);
  return out;
}

template <int U>
__device__ __forceinline__ Pt pdbl_quad(const Pt& p, const Fe& b3, const FieldConsts& c) {
  using myzkp::fe_add;
  using myzkp::fe_select;
  const int r = (threadIdx.x >> 3) & 3;
  // Y Y | Y Z | Z Z | X Y
  Fe m = myzkp::fe_mul_u<U>(fe_select(r == 3, p.x, fe_select(r == 2, p.z, p.y)),
                            fe_select(r == 0 || r == 3, p.y, p.z), c);
  const Fe t0 = quad_bcast(m, 0), t1 = quad_bcast(m, 1), xy = quad_bcast(m, 3);
  Fe z3 = fe_add(t0, t0, c);
  z3 = fe_add(z3, z3, c);
  z3 = fe_add(z3, z3, c);
  const Fe t2 = myzkp::fe_mul_u<U>(b3, quad_bcast(m, 2), c);
  const Fe y3 = fe_add(t0, t2, c);
  const Fe t0b = myzkp::fe_sub(t0, fe_add(fe_add(t2, t2, c), t2, c), c);
  // t2 Z3 | t1 Z3 | t0' Y3 | t0' X Y
  m = myzkp::fe_mul_u<U>(fe_select(r == 0, t2, fe_select(r == 1, t1, t0b)),
                         fe_select(r <= 1, z3, fe_select(r == 2, y3, xy)), c);
  const Fe x3 = quad_bcast(m, 0), x3b = quad_bcast(m, 3);
  return Pt{fe_add(x3b, x3b, c), fe_add(x3, quad_bcast(m, 2), c), quad_bcast(m, 1)};
}

// steps doublings of each point on a lane quad (32 points a block of 128
// threads): the point stays in registers and the step loop is not unrolled,
// so its body is fetched once and runs steps times.  out (if not null) gets
// 2^steps P; the steps output (if not null) gets step k, 2^(k+1) P, at
// sx + k * 16 n: (steps, 16, n) planes.  A warp whose points all lie past
// the end leaves at once; the other lanes past the end compute on the last
// point, and lane k of each quad stores.
__global__ void __launch_bounds__(128)
    pdbl_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                const int32_t* __restrict__ z, const int32_t* __restrict__ b3,
                int32_t* __restrict__ x3, int32_t* __restrict__ y3,
                int32_t* __restrict__ z3, int32_t* __restrict__ sx,
                int32_t* __restrict__ sy, int32_t* __restrict__ sz, int64_t n,
                int steps, FieldConsts c) {
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                         (threadIdx.x & ~31u)) / 4;
  if (first >= n) return;
  const int64_t i = first + (threadIdx.x & 7);
  const bool store = i < n && (threadIdx.x & 24) == 0;
  Pt p = load_point(x, y, z, n, i < n ? i : n - 1);
  const Fe b3v = myzkp::load_planes(b3, 1, 0);
  const int64_t block = myzkp::kLimbs * n;
#pragma unroll 1
  for (int k = 0; k < steps; ++k) {
    p = pdbl_quad<kK3Unroll>(p, b3v, c);
    if (store && sx != nullptr)
      store_point(sx + k * block, sy + k * block, sz + k * block, n, i, p);
  }
  if (store && x3 != nullptr) store_point(x3, y3, z3, n, i, p);
}

// K9: one thread a point, group.cuh's padd_mixed over FeC.  Where the mask
// is set the output is (qx, qy, R mod q), and P is not read.
__global__ void __launch_bounds__(128)
    padd_mixed_kernel(const int32_t* __restrict__ x1,
                      const int32_t* __restrict__ y1,
                      const int32_t* __restrict__ z1,
                      const int32_t* __restrict__ qx,
                      const int32_t* __restrict__ qy,
                      const bool* __restrict__ h,
                      const int32_t* __restrict__ b3, int32_t* __restrict__ x3,
                      int32_t* __restrict__ y3, int32_t* __restrict__ z3,
                      int64_t n, FieldConsts c) {
  using myzkp::FeC;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe qxv = myzkp::load_planes(qx, n, i);
  const Fe qyv = myzkp::load_planes(qy, n, i);
  if (h != nullptr && h[i]) {
    store_point(x3, y3, z3, n, i, Pt{qxv, qyv, myzkp::fe_one(c)});
    return;
  }
  const Pt p = load_point(x1, y1, z1, n, i);
  const FeC b3v{myzkp::load_planes(b3, 1, 0)};
  const myzkp::Point<FeC> out =
      myzkp::padd_mixed(myzkp::Point<FeC>{{p.x}, {p.y}, {p.z}}, FeC{qxv}, FeC{qyv}, b3v, c);
  store_point(x3, y3, z3, n, i, Pt{out.x.v, out.y.v, out.z.v});
}

constexpr int kThreads = 128;

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// h may be null: plain P + Q.
extern "C" int myzkp_padd(const int32_t* x1, const int32_t* y1,
                          const int32_t* z1, const int32_t* x2,
                          const int32_t* y2, const int32_t* z2, const bool* h,
                          const int32_t* b3, int32_t* x3, int32_t* y3,
                          int32_t* z3, int64_t n, const FieldConsts* consts,
                          void* stream) {
  padd_kernel<<<blocks_for(n), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      x1, y1, z1, x2, y2, z2, h, b3, x3, y3, z3, n, *consts);
  return static_cast<int>(cudaGetLastError());
}

// steps >= 1 doublings: out <- 2^steps P; the steps output, (steps, 16, n)
// planes a coordinate, <- 2P, 4P, ..., 2^steps P.  Either may be null.
extern "C" int myzkp_pdbl(const int32_t* x, const int32_t* y,
                          const int32_t* z, const int32_t* b3, int32_t* x3,
                          int32_t* y3, int32_t* z3, int32_t* sx, int32_t* sy,
                          int32_t* sz, int64_t n, int steps,
                          const FieldConsts* consts, void* stream) {
  if (steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  pdbl_kernel<<<blocks_for(4 * n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, z, b3, x3, y3, z3, sx, sy, sz, n, steps, *consts);
  return static_cast<int>(cudaGetLastError());
}

// h may be null: plain P + (qx, qy, 1).
extern "C" int myzkp_padd_mixed(const int32_t* x1, const int32_t* y1,
                                const int32_t* z1, const int32_t* qx,
                                const int32_t* qy, const bool* h,
                                const int32_t* b3, int32_t* x3, int32_t* y3,
                                int32_t* z3, int64_t n,
                                const FieldConsts* consts, void* stream) {
  padd_mixed_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x1, y1, z1, qx, qy, h, b3, x3, y3, z3, n, *consts);
  return static_cast<int>(cudaGetLastError());
}

// x, out: (16, n) planes of a (rows, B) batch, n = rows * B; flags, oflags:
// (rows, B) bool; 1 <= d < B.  x and out, flags and oflags must not overlap.
extern "C" int myzkp_padd_seg_level(const int32_t* x, const int32_t* y,
                                    const int32_t* z, const bool* flags,
                                    const int32_t* b3, int32_t* ox,
                                    int32_t* oy, int32_t* oz, bool* oflags,
                                    int64_t n, int64_t B, int64_t d,
                                    const FieldConsts* consts, void* stream) {
  padd_seg_level_kernel<<<blocks_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, y, z, flags, b3, ox, oy, oz, oflags, n, B, d, *consts);
  return static_cast<int>(cudaGetLastError());
}
