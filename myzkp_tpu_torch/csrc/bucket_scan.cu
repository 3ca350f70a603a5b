// K4 and its G2 instance: Pippenger's segmented bucket scan over the point
// table read by index in step-major order, with the segment flushes written
// by the kernel into the bucket table.
//
// Replace curve_pallas.bucket_scan_rows (myzkp_tpu/curves/curve_pallas.py:425,
// kernel _make_bucket_scan_kernel :365) for G1, and for G2 the K-step
// lax.scan of padd2_sel_fused in myzkp_tpu/curves/msm.py:215-280
// (curve_pallas.py:542).  The reference had no G2 rows kernel because a TPU
// tile held 3-leaf G1 rows only.  Here one template over the element type (Fe
// for G1, Fe2 for G2) on group.cuh's padd serves both, with one C entry point
// per instance: myzkp_bucket_scan_rows (G1) and myzkp_bucket_scan_rows2 (G2).
// The reference gathered the rows in step-major order into a copy first
// (jnp.take, myzkp_tpu/curves/msm.py:309); reading the table by index here
// is the MSM's part of probe 14 (tools/exp_gather_pallas.py:33), fused into
// the scan as its docstring planned, so no gathered copy is made.
//
// Contract.  A row holds C used 16-bit limbs, one per int32: C = 48 for G1
// (x | y | z) and 96 for G2 (x0 | x1 | y0 | y1 | z0 | z1), in W = 64 or 128
// int32 (C rounded up to a multiple of 64, the rest unused).
//   table   (Nt, W) int32: the point table, one point a row;
//   idx     (K * N,) int32: row k*N + l is lane l's table row at step k.
//           Indices may repeat (both windows of a group read each point);
//           they must lie in [0, Nt), which the kernel does not check (the
//           caller builds them from an iota);
//   tag     (K * N,) int32: bit 0 negates the point's y, bit 1 marks a
//           segment head;
//   tgt     (K * N,) int32: the row of buckets that receives lane l's
//           accumulator before step k, or -1.  The caller gives -1 at every
//           step 0 and wherever no segment ends; the real targets are unique
//           and below S (the caller builds them so; the kernel does not check);
//   buckets (S, W) int32: the caller's bucket table, written in place at the
//           real targets (columns 0..C-1) and never read;
//   acc     (C, N) int32 out: each lane's accumulator after step K-1, as limb
//           planes.
// Per step: if tgt >= 0, write the accumulator to buckets[tgt]; then
// acc <- Q = table[idx] on a segment head, else acc <- acc + Q, Q's y negated
// if bit 0 is set.
//
// Bound on the H100: the integer multiplies of the complete adds, one per step
// that is not a segment head: 14 Montgomery products for G1 and 42 for G2
// (14 F_q2 products of 3 each).  At the MSM's shape (K = 64, N = 32,768, 3% of
// the steps heads) that is 0.44 ms for G1 and 1.33 ms for G2, against 0.13 ms
// and 0.26 ms for the bytes the function must move: the used limbs of each
// step's row, its index, tag and target, the real flushes (3% of the steps)
// and acc.
//
// Design.  One thread owns one lane and loops over the K steps itself, in
// place of the TPU's sequential grid axis; its accumulator stays in registers
// for the whole scan, and every output is write-only (the reference's r4 fault
// was an accumulator read back from a pipelined output block,
// curve_pallas.py:374-382).  Flushes go straight to their bucket rows: no
// stream of K * N pre-add accumulators is written, and no caller scatters one.
// Each lane stages its rows in shared memory with cp.async, double-buffered,
// so that step k+1's row is in flight while step k adds; only the C used
// limbs are copied, straight from the table row its index names.  A lane
// loads its index two steps ahead, so the address of step k+1's copy is in a
// register when the copy is issued and the index load's latency hides under
// an add like the row's.  A lane's staged row starts every C + 4 words, an odd
// number of 16-byte units, so the 8 lanes of one 16-byte shared-memory phase
// fall on 32 distinct banks.  Before its add a lane packs its staged limbs
// into 32-bit words in place and negates y there, and the formula reads Q
// from shared memory where it needs it (its first six products) rather than
// holding it in registers; b3 sits in shared memory too.  That leaves the G2
// instance's registers to the accumulator and the formula's temporaries: it
// still reaches 255 with a 120-byte stack frame (132 B of spill stores; 80
// and 92 B when it read a gathered copy in order, with no index), against
// K7's 256 B with P, Q and b3 in registers (the G1 instance: 144, no spill).  A lane needs 2 (C + 4) words
// of shared memory, so a block is 64 lanes for G1 and 32 for G2: 26 KB and
// 25 KB, under the 48 KB of static shared memory.  What is left between the
// kernel and its bound is latency: 32,768 lanes give about 8 warps an SM for
// the dependent carry chains of the products.  A smaller K would widen the
// scan but deepen the lane merge; K stays the reference's 64.
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "group.cuh"

using myzkp::cp_async16;
using myzkp::cp_async_commit;
using myzkp::cp_async_wait;
using myzkp::Fe;
using myzkp::Fe2;
using myzkp::FieldConsts;
using myzkp::Point;

namespace {

// 32-bit words of one element (8 for Fe, 16 for Fe2) and of one point.
template <class E>
constexpr int kElemWords = static_cast<int>(sizeof(E) / 4);
template <class E>
constexpr int kPointWords = 3 * kElemWords<E>;
// C, the used limbs of a row; W, the row's width in the tensor; the stride
// of a lane's staged row in shared memory, in words.
template <class E>
constexpr int kUsed = 2 * kPointWords<E>;
template <class E>
constexpr int kRowLimbs = (kUsed<E> + 63) / 64 * 64;
template <class E>
constexpr int kSlot = kUsed<E> + 4;
template <class E>
constexpr int kThreads = sizeof(E) == sizeof(Fe) ? 64 : 32;

static_assert(kSlot<Fe> / 4 % 2 == 1 && kSlot<Fe2> / 4 % 2 == 1,
              "a staged row must start an odd number of 16-byte units apart");
static_assert(2 * kThreads<Fe> * kSlot<Fe> * 4 <= 48 * 1024 &&
                  2 * kThreads<Fe2> * kSlot<Fe2> * 4 <= 48 * 1024,
              "two staged rows a lane must fit static shared memory");

// The C used limbs of a global row into a lane's shared slot, as one group.
template <class E>
__device__ __forceinline__ void stage_row(uint32_t* dst, const int32_t* row) {
#pragma unroll
  for (int j = 0; j < kUsed<E> / 4; ++j) cp_async16(dst + 4 * j, row + 4 * j);
  cp_async_commit();
}

// ---- elements in shared memory (packed words) and in rows (limbs) ---------

__device__ __forceinline__ void lds(const uint32_t* s, Fe& a) {
  const uint4* v = reinterpret_cast<const uint4*>(s);
  const uint4 lo = v[0], hi = v[1];
  a.w[0] = lo.x, a.w[1] = lo.y, a.w[2] = lo.z, a.w[3] = lo.w;
  a.w[4] = hi.x, a.w[5] = hi.y, a.w[6] = hi.z, a.w[7] = hi.w;
}
__device__ __forceinline__ void lds(const uint32_t* s, Fe2& a) {
  lds(s, a.c0);
  lds(s + 8, a.c1);
}

__device__ __forceinline__ void sts(uint32_t* s, const Fe& a) {
  uint4* v = reinterpret_cast<uint4*>(s);
  v[0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
  v[1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
}
__device__ __forceinline__ void sts(uint32_t* s, const Fe2& a) {
  sts(s, a.c0);
  sts(s + 8, a.c1);
}

template <class E>
__device__ __forceinline__ E load_elem(const uint32_t* s) {
  E a;
  lds(s, a);
  return a;
}

// A point staged in shared memory as packed words x | y | z; padd reads its
// coordinates through these where the formula needs them (group.cuh).
template <class E>
struct StagedPoint {
  const uint32_t* w;
};
template <class E>
__device__ __forceinline__ E x_of(const StagedPoint<E>& q) {
  return load_elem<E>(q.w);
}
template <class E>
__device__ __forceinline__ E y_of(const StagedPoint<E>& q) {
  return load_elem<E>(q.w + kElemWords<E>);
}
template <class E>
__device__ __forceinline__ E z_of(const StagedPoint<E>& q) {
  return load_elem<E>(q.w + 2 * kElemWords<E>);
}

// A staged row's C limbs -> C / 2 packed words (word j = limb 2j | limb
// 2j+1 << 16), in place: the words of vector m are written after limbs 8m ..
// 8m + 7 are read, and no later vector reads them.  Then y is negated in
// place if neg is set.
template <class E>
__device__ __forceinline__ void pack_row(uint32_t* s, bool neg,
                                         const FieldConsts& c) {
  uint4* v = reinterpret_cast<uint4*>(s);
#pragma unroll
  for (int m = 0; m < kUsed<E> / 8; ++m) {
    const uint4 a = v[2 * m], b = v[2 * m + 1];
    v[m] = make_uint4(a.x | (a.y << 16), a.z | (a.w << 16), b.x | (b.y << 16),
                      b.z | (b.w << 16));
  }
  if (neg) sts(s + kElemWords<E>, myzkp::neg(load_elem<E>(s + kElemWords<E>), c));
}

// One element as 16-bit limbs into a row, four int4 per base-field element.
__device__ __forceinline__ void store_limbs(int4* row, const Fe& a) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    row[j] = make_int4(static_cast<int32_t>(a.w[2 * j] & 0xFFFFu),
                       static_cast<int32_t>(a.w[2 * j] >> 16),
                       static_cast<int32_t>(a.w[2 * j + 1] & 0xFFFFu),
                       static_cast<int32_t>(a.w[2 * j + 1] >> 16));
  }
}
__device__ __forceinline__ void store_limbs(int4* row, const Fe2& a) {
  store_limbs(row, a.c0);
  store_limbs(row + 4, a.c1);
}

template <class E>
__device__ __forceinline__ void store_point_row(int32_t* row, const Point<E>& p) {
  int4* v = reinterpret_cast<int4*>(row);
  constexpr int kVecs = kElemWords<E> / 2;  // int4 of limbs per element
  store_limbs(v, p.x);
  store_limbs(v + kVecs, p.y);
  store_limbs(v + 2 * kVecs, p.z);
}

// An element's limb planes at lane l of (16, n) planes from base on; returns
// the base of the next element's planes.
__device__ __forceinline__ int32_t* put_planes(int32_t* base, int64_t n,
                                               int64_t l, const Fe& a) {
  myzkp::store_planes(base, n, l, a);
  return base + 16 * n;
}
__device__ __forceinline__ int32_t* put_planes(int32_t* base, int64_t n,
                                               int64_t l, const Fe2& a) {
  return put_planes(put_planes(base, n, l, a.c0), n, l, a.c1);
}

__device__ __forceinline__ void load_b3(const int32_t* b0, const int32_t*,
                                        Fe& b3) {
  b3 = myzkp::load_planes(b0, 1, 0);
}
__device__ __forceinline__ void load_b3(const int32_t* b0, const int32_t* b1,
                                        Fe2& b3) {
  b3 = Fe2{myzkp::load_planes(b0, 1, 0), myzkp::load_planes(b1, 1, 0)};
}

__device__ __forceinline__ void set_infinity(Point<Fe>& p,
                                             const FieldConsts& c) {
  p = myzkp::pt_infinity(c);
}
__device__ __forceinline__ void set_infinity(Point<Fe2>& p,
                                             const FieldConsts& c) {
  const Fe z = myzkp::fe_zero();
  p = Point<Fe2>{Fe2{z, z}, Fe2{myzkp::fe_one(c), z}, Fe2{z, z}};
}

template <class E>
__global__ void __launch_bounds__(kThreads<E>)
    bucket_scan_kernel(const int32_t* __restrict__ table,
                       const int32_t* __restrict__ idx,
                       const int32_t* __restrict__ tag,
                       const int32_t* __restrict__ tgt,
                       const int32_t* __restrict__ b3c0,
                       const int32_t* __restrict__ b3c1,
                       int32_t* __restrict__ acc_out,
                       int32_t* __restrict__ buckets, int64_t n_lanes,
                       int K, FieldConsts c) {
  constexpr int W = kRowLimbs<E>;
  __shared__ __align__(16) uint32_t staged[2][kThreads<E>][kSlot<E>];
  __shared__ E b3;
  if (threadIdx.x == 0) load_b3(b3c0, b3c1, b3);
  __syncthreads();
  const int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= n_lanes) return;  // no barrier below: a lane touches its own slots only

  stage_row<E>(staged[0][threadIdx.x], table + static_cast<int64_t>(idx[l]) * W);
  int32_t t_next = tag[l], g_next = tgt[l];
  int32_t i_next = K > 1 ? idx[n_lanes + l] : 0;  // step 1's table row
  Point<E> acc;
  set_infinity(acc, c);
  for (int k = 0; k < K; ++k) {
    const int32_t t = t_next, g = g_next;
    uint32_t* q = staged[k & 1][threadIdx.x];
    if (k + 1 < K) {
      const int64_t r = static_cast<int64_t>(k + 1) * n_lanes + l;
      stage_row<E>(staged[(k + 1) & 1][threadIdx.x],
                   table + static_cast<int64_t>(i_next) * W);
      t_next = tag[r];
      g_next = tgt[r];
      if (k + 2 < K) i_next = idx[r + n_lanes];
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    pack_row<E>(q, t & 1, c);
    if (g >= 0) {
      store_point_row(buckets + static_cast<int64_t>(g) * W, acc);
    }
    const StagedPoint<E> qp{q};
    if (t & 2) {
      acc = Point<E>{x_of(qp), y_of(qp), z_of(qp)};
    } else {
      acc = myzkp::padd(acc, qp, b3, c);
    }
  }
  put_planes(put_planes(put_planes(acc_out, n_lanes, l, acc.x), n_lanes, l,
                        acc.y),
             n_lanes, l, acc.z);
}

template <class E>
int launch_scan(const int32_t* table, const int32_t* idx, const int32_t* tag,
                const int32_t* tgt, const int32_t* b3c0, const int32_t* b3c1,
                int32_t* acc, int32_t* buckets, int64_t n_lanes, int K,
                const FieldConsts* consts, void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((n_lanes + kThreads<E> - 1) / kThreads<E>);
  bucket_scan_kernel<E><<<blocks, kThreads<E>, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      table, idx, tag, tgt, b3c0, b3c1, acc, buckets, n_lanes, K, *consts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// G1: b3 one (16,) tensor; table and buckets 64 int32 wide, acc (48, N).
extern "C" int myzkp_bucket_scan_rows(const int32_t* table, const int32_t* idx,
                                      const int32_t* tag, const int32_t* tgt,
                                      const int32_t* b3, int32_t* acc,
                                      int32_t* buckets, int64_t n_lanes, int K,
                                      const FieldConsts* consts, void* stream) {
  return launch_scan<Fe>(table, idx, tag, tgt, b3, nullptr, acc, buckets,
                         n_lanes, K, consts, stream);
}

// G2: b3 the pair (c0, c1) of (16,) tensors; table and buckets 128 int32
// wide, acc (96, N).
extern "C" int myzkp_bucket_scan_rows2(const int32_t* table, const int32_t* idx,
                                       const int32_t* tag, const int32_t* tgt,
                                       const int32_t* b3c0, const int32_t* b3c1,
                                       int32_t* acc, int32_t* buckets,
                                       int64_t n_lanes, int K,
                                       const FieldConsts* consts,
                                       void* stream) {
  return launch_scan<Fe2>(table, idx, tag, tgt, b3c0, b3c1, acc, buckets,
                          n_lanes, K, consts, stream);
}
