// K2: G1 complete add, with an optional select mask (Q where h is set, else
// P + Q).  K3: G1 complete double.  K9: G1 mixed add P + (qx, qy, 1), with an
// optional select mask ((qx, qy, 1) where h is set).
//
// Replace curve_pallas.padd_fused / padd_sel_fused (kernel
// _make_padd_kernel, myzkp_tpu/curves/curve_pallas.py:183, :322, :330),
// curve_pallas.pdbl_fused (_make_pdbl_kernel :307, :340) and
// curve_pallas.padd_mixed_fused / padd_mixed_sel_fused (kernel
// _make_padd_mixed_kernel :214, :239, :247).
//
// Bound on the H100: integer multiply throughput, with register pressure as
// the limit on occupancy.  A complete add is 12 Montgomery products and 17
// adds/subs (~1,600 32x32->64-bit multiply-adds) against 6 point reads and 3
// point writes of 192 bytes each.  Design: one thread per point, the whole
// formula in registers (group.cuh) and only the three output coordinates
// written; b3 is read once per thread from a (16,) tensor instead of the full
// tile the TPU broadcast it to (curve_pallas.py:146-151).  The mixed add
// reads 5 coordinates instead of 6 and does 13 products instead of 14; where
// its mask is set it writes (qx, qy, R mod q) without reading P.
#include <cuda_runtime.h>

#include "group.cuh"

using myzkp::Fe;
using myzkp::FieldConsts;
using myzkp::Pt;

namespace {

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
  Pt q = load_point(x2, y2, z2, n, i);
  if (h != nullptr && h[i]) {
    store_point(x3, y3, z3, n, i, q);
    return;
  }
  Pt p = load_point(x1, y1, z1, n, i);
  Fe b3v = myzkp::load_planes(b3, 1, 0);
  store_point(x3, y3, z3, n, i, myzkp::padd(p, q, b3v, c));
}

__global__ void __launch_bounds__(128)
    pdbl_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                const int32_t* __restrict__ z, const int32_t* __restrict__ b3,
                int32_t* __restrict__ x3, int32_t* __restrict__ y3,
                int32_t* __restrict__ z3, int64_t n, FieldConsts c) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt p = load_point(x, y, z, n, i);
  Fe b3v = myzkp::load_planes(b3, 1, 0);
  store_point(x3, y3, z3, n, i, myzkp::pdbl(p, b3v, c));
}

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
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe qxv = myzkp::load_planes(qx, n, i);
  Fe qyv = myzkp::load_planes(qy, n, i);
  if (h != nullptr && h[i]) {
    store_point(x3, y3, z3, n, i, Pt{qxv, qyv, myzkp::fe_one(c)});
    return;
  }
  Pt p = load_point(x1, y1, z1, n, i);
  Fe b3v = myzkp::load_planes(b3, 1, 0);
  store_point(x3, y3, z3, n, i, myzkp::padd_mixed(p, qxv, qyv, b3v, c));
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

extern "C" int myzkp_pdbl(const int32_t* x, const int32_t* y,
                          const int32_t* z, const int32_t* b3, int32_t* x3,
                          int32_t* y3, int32_t* z3, int64_t n,
                          const FieldConsts* consts, void* stream) {
  pdbl_kernel<<<blocks_for(n), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(x, y, z, b3, x3, y3, z3,
                                                     n, *consts);
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
