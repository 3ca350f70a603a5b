// K7: G2 complete add over F_q2, with an optional select mask (Q where h is
// set, else P + Q).  K8: G2 complete double.  K10: G2 mixed add
// P + (qx, qy, 1), with an optional select mask ((qx, qy, 1) where h is set).
//
// Replace curve_pallas.padd2_fused / padd2_sel_fused (kernel
// _make_padd2_kernel, myzkp_tpu/curves/curve_pallas.py:484, :534, :542),
// curve_pallas.pdbl2_fused (_make_pdbl2_kernel :515, :550) and
// curve_pallas.padd_mixed2_sel_fused / padd_mixed2_fused (kernel
// _make_padd_mixed2_kernel :257, :289, :300).
//
// Bound on the H100: integer multiply throughput, with register pressure as
// the limit on occupancy.  A complete add is 14 F_q2 products (12 of the
// formula, 2 by b3), 42 Montgomery products with Karatsuba, and about 40 F_q
// adds/subs, against 12 point coordinate reads and 6 writes of 64 bytes each
// per F_q component.  A G2 point is twice a G1 point's state, so the whole
// formula in registers (group.cuh, one thread per point) may spill; 64 threads
// a block keep the per-block register demand small.  Only the six output
// planes are written, and they are write-only; b3 (the pair 3 * B2, not 9) is
// read once per thread from two (16,) tensors.  The mixed add holds P and an
// affine Q, 10 F_q elements against the complete add's 12, and does 13 F_q2
// products (39 Montgomery products); where its mask is set it writes
// (qx, qy, (R mod q, 0)) without reading P.
#include <cuda_runtime.h>

#include "group.cuh"

using myzkp::Fe2;
using myzkp::FieldConsts;
using myzkp::Pt2;

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

__device__ __forceinline__ Fe2 load_fe2(const int32_t* c0, const int32_t* c1,
                                        int64_t n, int64_t i) {
  return Fe2{myzkp::load_planes(c0, n, i), myzkp::load_planes(c1, n, i)};
}

__device__ __forceinline__ Pt2 load_point2(const In6& a, int64_t n, int64_t i) {
  return Pt2{load_fe2(a.v[0], a.v[1], n, i), load_fe2(a.v[2], a.v[3], n, i),
             load_fe2(a.v[4], a.v[5], n, i)};
}

__device__ __forceinline__ void store_point2(const Out6& o, int64_t n,
                                             int64_t i, const Pt2& p) {
  myzkp::store_planes(o.v[0], n, i, p.x.c0);
  myzkp::store_planes(o.v[1], n, i, p.x.c1);
  myzkp::store_planes(o.v[2], n, i, p.y.c0);
  myzkp::store_planes(o.v[3], n, i, p.y.c1);
  myzkp::store_planes(o.v[4], n, i, p.z.c0);
  myzkp::store_planes(o.v[5], n, i, p.z.c1);
}

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
    padd2_kernel(In6 p, In6 q, const bool* __restrict__ h,
                 const int32_t* __restrict__ b3c0,
                 const int32_t* __restrict__ b3c1, Out6 o, int64_t n,
                 FieldConsts c) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt2 qv = load_point2(q, n, i);
  if (h != nullptr && h[i]) {
    store_point2(o, n, i, qv);
    return;
  }
  Pt2 pv = load_point2(p, n, i);
  Fe2 b3 = load_fe2(b3c0, b3c1, 1, 0);
  store_point2(o, n, i, myzkp::padd(pv, qv, b3, c));
}

__global__ void __launch_bounds__(kThreads)
    pdbl2_kernel(In6 p, const int32_t* __restrict__ b3c0,
                 const int32_t* __restrict__ b3c1, Out6 o, int64_t n,
                 FieldConsts c) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt2 pv = load_point2(p, n, i);
  Fe2 b3 = load_fe2(b3c0, b3c1, 1, 0);
  store_point2(o, n, i, myzkp::pdbl(pv, b3, c));
}

__global__ void __launch_bounds__(kThreads)
    padd_mixed2_kernel(In6 p, In4 q, const bool* __restrict__ h,
                       const int32_t* __restrict__ b3c0,
                       const int32_t* __restrict__ b3c1, Out6 o, int64_t n,
                       FieldConsts c) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe2 qx = load_fe2(q.v[0], q.v[1], n, i);
  Fe2 qy = load_fe2(q.v[2], q.v[3], n, i);
  if (h != nullptr && h[i]) {
    store_point2(o, n, i, Pt2{qx, qy, Fe2{myzkp::fe_one(c), myzkp::fe_zero()}});
    return;
  }
  Pt2 pv = load_point2(p, n, i);
  Fe2 b3 = load_fe2(b3c0, b3c1, 1, 0);
  store_point2(o, n, i, myzkp::padd_mixed(pv, qx, qy, b3, c));
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
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
  padd2_kernel<<<blocks_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(p, q, h, b3c0, b3c1, o,
                                                      n, *consts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int myzkp_pdbl2(const int32_t* p0, const int32_t* p1,
                           const int32_t* p2, const int32_t* p3,
                           const int32_t* p4, const int32_t* p5,
                           const int32_t* b3c0, const int32_t* b3c1,
                           int32_t* o0, int32_t* o1, int32_t* o2, int32_t* o3,
                           int32_t* o4, int32_t* o5, int64_t n,
                           const FieldConsts* consts, void* stream) {
  In6 p{{p0, p1, p2, p3, p4, p5}};
  Out6 o{{o0, o1, o2, o3, o4, o5}};
  pdbl2_kernel<<<blocks_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(p, b3c0, b3c1, o, n,
                                                      *consts);
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
  padd_mixed2_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p, q, h, b3c0,
                                                            b3c1, o, n,
                                                            *consts);
  return static_cast<int>(cudaGetLastError());
}
