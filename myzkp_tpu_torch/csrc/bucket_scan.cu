// K4: Pippenger's segmented bucket scan over step-major point rows.
//
// Replaces curve_pallas.bucket_scan_rows (myzkp_tpu/curves/curve_pallas.py:425,
// kernel _make_bucket_scan_kernel :365).  Same contract, except that any lane
// count N is accepted: the ragged edge is masked, with no 1024-lane multiple.
//
//   rows  (K * N, 64) int32: row k*N + l holds lane l's point at step k,
//         x | y | z limbs in columns 0..47, columns 48..63 unused;
//   tag   (K * N,) int32: bit 0 = negate the point, bit 1 = segment head;
//   acc   (3 * 16, N) int32 out: each lane's accumulator after step K-1,
//         as limb planes;
//   flush (K * N, 64) int32 out: row k*N + l is lane l's accumulator
//         before step k (step 0 included: the caller masks it out), with
//         columns 48..63 zeroed.
//
// Per step: read the row and its tag, negate y if bit 0, write the pre-add
// accumulator as the flush row, then acc <- Q on a segment head, else
// acc <- acc + Q.
//
// Bound on the H100: integer multiply throughput of the K complete adds per
// lane, as for K2.  Design: one thread owns one lane and loops over the K
// steps itself, in place of the TPU's sequential grid axis; the accumulator
// lives in registers for the whole scan, so both outputs are write-only (the
// r4 fault was an accumulator read back from a pipelined output block,
// curve_pallas.py:374-382).  Rows are read and written as 16-byte vectors.
#include <cuda_runtime.h>

#include "group.cuh"

using myzkp::Fe;
using myzkp::FieldConsts;
using myzkp::Pt;

namespace {

constexpr int kRowLanes = 64;  // int32 per row
constexpr int kThreads = 128;

// Limbs [off, off + 16) of a row: four int4 vectors, two 32-bit words each.
__device__ __forceinline__ Fe load_row_coord(const int4* row, int off) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int4 v = row[off / 4 + j];
    r.w[2 * j] = static_cast<uint32_t>(v.x) | (static_cast<uint32_t>(v.y) << 16);
    r.w[2 * j + 1] =
        static_cast<uint32_t>(v.z) | (static_cast<uint32_t>(v.w) << 16);
  }
  return r;
}

__device__ __forceinline__ void store_row_coord(int4* row, int off,
                                                const Fe& a) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int4 v;
    v.x = static_cast<int32_t>(a.w[2 * j] & 0xFFFFu);
    v.y = static_cast<int32_t>(a.w[2 * j] >> 16);
    v.z = static_cast<int32_t>(a.w[2 * j + 1] & 0xFFFFu);
    v.w = static_cast<int32_t>(a.w[2 * j + 1] >> 16);
    row[off / 4 + j] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
    bucket_scan_kernel(const int32_t* __restrict__ rows,
                       const int32_t* __restrict__ tag,
                       const int32_t* __restrict__ b3,
                       int32_t* __restrict__ acc_out,
                       int32_t* __restrict__ flush, int64_t n_lanes, int K,
                       FieldConsts c) {
  int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= n_lanes) return;
  const Fe b3v = myzkp::load_planes(b3, 1, 0);
  Pt acc = myzkp::pt_infinity(c);
  for (int k = 0; k < K; ++k) {
    const int64_t r = static_cast<int64_t>(k) * n_lanes + l;
    const int4* row = reinterpret_cast<const int4*>(rows + r * kRowLanes);
    Pt q{load_row_coord(row, 0), load_row_coord(row, 16),
         load_row_coord(row, 32)};
    const int32_t t = tag[r];
    if (t & 1) q.y = myzkp::fe_neg(q.y, c);

    int4* out = reinterpret_cast<int4*>(flush + r * kRowLanes);
    store_row_coord(out, 0, acc.x);
    store_row_coord(out, 16, acc.y);
    store_row_coord(out, 32, acc.z);
#pragma unroll
    for (int j = 12; j < kRowLanes / 4; ++j) out[j] = make_int4(0, 0, 0, 0);

    acc = (t & 2) ? q : myzkp::padd(acc, q, b3v, c);
  }
  myzkp::store_planes(acc_out, n_lanes, l, acc.x);
  myzkp::store_planes(acc_out + 16 * n_lanes, n_lanes, l, acc.y);
  myzkp::store_planes(acc_out + 32 * n_lanes, n_lanes, l, acc.z);
}

}  // namespace

extern "C" int myzkp_bucket_scan_rows(const int32_t* rows, const int32_t* tag,
                                      const int32_t* b3, int32_t* acc,
                                      int32_t* flush, int64_t n_lanes, int K,
                                      const FieldConsts* consts,
                                      void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((n_lanes + kThreads - 1) / kThreads);
  bucket_scan_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      rows, tag, b3, acc, flush, n_lanes, K, *consts);
  return static_cast<int>(cudaGetLastError());
}
