// K14 gather_planes and K16 scatter_rows: point rows <-> limb planes.
//
// K14 replaces probe 14, tools/exp_gather_pallas.py:33 gather_pallas (the
// row gather out[i] = table[idx[i]], pallas_call at :57), with probe 16's
// rows -> planes transpose (tools/exp_transpose.py:78 mk, pallas_call at :83)
// fused in; K16 is probe 16's planes -> rows direction.  The reference made
// each of these moves as XLA ops: jnp.take of rows, then a transpose
// (myzkp_tpu/curves/msm.py:190-212, 408-414; fixed_base.py:118-119).
//
// Layouts.  A point row holds C used 16-bit limbs, one per int32: C = 48 for
// G1 (x | y | z) and 96 for G2 (x0 | x1 | y0 | y1 | z0 | z1), in a row of W
// int32 (W >= C, a multiple of 4; the MSM's tables have W = 64 and 128).  A
// point batch's limb planes are its 3 or 6 coordinate tensors, (16, n) int32
// each: limb j of coordinate l of point i at leaf_l[j * n + i].
//
//   K14  gather_planes(table (Nt, W), idx (n,) int32 or int64 or none,
//        planes (C, n) out): planes[16 l + j, i] = table[idx[i], 16 l + j],
//        with idx[i] = i where idx is none.  Indices may repeat; they must lie
//        in [0, Nt), which the kernel does not check (the callers build them
//        from an iota and the digits).
//   K16  scatter_rows(leaves, tgt (n,) int32 or int64 or none, out (S, W)):
//        out[tgt[i], 16 l + j] = leaf_l[j, i] and out[tgt[i], C..W-1] = 0,
//        with tgt[i] = i where tgt is none; other rows are left as they were.
//        Targets must lie in [0, S) (not checked).  A row that two points
//        target ends up with 16-byte pieces of either, in no set order (the
//        MSM's merge repeats a target only on a dummy row that it drops).
//
// Bound on the H100: bytes.  K14 reads the C used limbs of each distinct row
// once and each index, and writes the planes: at a fixed-base chunk (8,388,608
// int32 indices into 8,192 rows) 0.49 ms for G1 and 0.97 ms for G2, where every
// index reads its row anew from memory, n (8 C + 4) B, would take twice that.
// The table of a chunk (2 or 4 MB) stays in the 50 MB L2, so the repeated
// reads cost L2 bandwidth only.  K16 reads the planes and the targets and
// writes whole rows, n (4 C + 4 W) B with no targets: at 2^20 points 0.14 ms
// for G1 and 0.28 ms for G2.
//
// Design.  A block moves a tile of R points through shared memory: R = 64 for
// G1 and 32 for G2 (kRows), so a tile is 3,072 limbs in either group and 128
// threads (kThreads) move 6 pieces of 4 limbs each.  On the rows' side the
// moves are 16-byte pieces with consecutive threads on consecutive pieces of
// one row: K14 copies each row's C used limbs with cp.async (no registers on
// the way), K16 stores whole rows, the zero columns included.  On the planes'
// side consecutive threads take consecutive points, so a warp loads or stores
// 32 neighbouring limbs of one plane row, 128 bytes.  Between the two each
// thread moves one 4-limb piece of one point: one 16-byte shared access and
// four 4-byte global ones.  A point's staged row starts every C + 4 words, an
// odd number of 16-byte units, so the 8 lanes of a 16-byte shared-memory
// phase fall on 32 distinct banks in both access patterns (the scan's kSlot,
// bucket_scan.cu).  A block loads its R indices or targets itself, once, into
// shared memory.  The tile takes 13-14 KB of shared memory, so an SM holds 16
// blocks and about 200 KB of copies in flight.
#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 128;
template <int C>
constexpr int kRows = C == 48 ? 64 : 32;
template <int C>
constexpr int kSlot = C + 4;  // a staged row's stride in shared memory, words
template <int C>
constexpr int kPieces = C / 4;  // 16-byte pieces of a row's used limbs

static_assert(kSlot<48> / 4 % 2 == 1 && kSlot<96> / 4 % 2 == 1,
              "a staged row must start an odd number of 16-byte units apart");
static_assert(kRows<48> * kPieces<48> % kThreads == 0 &&
                  kRows<96> * kPieces<96> % kThreads == 0,
              "a tile's pieces must split evenly over the block");

// The row that point i of the batch reads or writes: rows[i], or i itself
// where no index tensor is given.
template <class I>
__device__ __forceinline__ int64_t row_at(const I* __restrict__ rows, int64_t i) {
  return rows == nullptr ? i : static_cast<int64_t>(rows[i]);
}

template <int C, class I>
__global__ void __launch_bounds__(kThreads)
    gather_planes_kernel(const int32_t* __restrict__ table,
                         const I* __restrict__ idx, int32_t* __restrict__ planes,
                         int64_t n, int W) {
  constexpr int R = kRows<C>, P = kPieces<C>;
  __shared__ __align__(16) int32_t tile[R][kSlot<C>];
  __shared__ int64_t row[R];
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * R;
  const int live = static_cast<int>(n - i0 < R ? n - i0 : R);
  if (static_cast<int>(threadIdx.x) < live) {
    row[threadIdx.x] = row_at(idx, i0 + threadIdx.x);
  }
  __syncthreads();
  for (int q = threadIdx.x; q < live * P; q += kThreads) {
    const int r = q / P, p = q % P;
    myzkp::cp_async16(&tile[r][4 * p], table + row[r] * W + 4 * p);
  }
  myzkp::cp_async_commit();
  myzkp::cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int s = 0; s < R * P / kThreads; ++s) {
    const int q = threadIdx.x + s * kThreads, r = q % R, p = q / R;
    if (r < live) {
      const int4 v = *reinterpret_cast<const int4*>(&tile[r][4 * p]);
      int32_t* dst = planes + static_cast<int64_t>(4 * p) * n + i0 + r;
      dst[0] = v.x;
      dst[n] = v.y;
      dst[2 * n] = v.z;
      dst[3 * n] = v.w;
    }
  }
}

// The coordinate tensors of a point batch, by value: 3 for G1, 6 for G2.
struct Leaves {
  const int32_t* p[6];
};

// Leaf l of ls, selected without indexing the parameter array at run time
// (which would copy it to local memory).
__device__ __forceinline__ const int32_t* leaf(const Leaves& ls, int l) {
  const int32_t* out = ls.p[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) out = l == k ? ls.p[k] : out;
  return out;
}

template <int C, class I>
__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(Leaves leaves, const I* __restrict__ tgt,
                        int32_t* __restrict__ out, int64_t n, int W) {
  constexpr int R = kRows<C>, P = kPieces<C>;
  __shared__ __align__(16) int32_t tile[R][kSlot<C>];
  __shared__ int64_t row[R];
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * R;
  const int live = static_cast<int>(n - i0 < R ? n - i0 : R);
  if (static_cast<int>(threadIdx.x) < live) {
    row[threadIdx.x] = row_at(tgt, i0 + threadIdx.x);
  }
#pragma unroll
  for (int s = 0; s < R * P / kThreads; ++s) {
    const int q = threadIdx.x + s * kThreads, r = q % R, p = q / R;
    if (r < live) {
      // piece p: limbs 4 (p % 4) .. + 3 of coordinate p / 4 (16 limbs each)
      const int32_t* src =
          leaf(leaves, p / 4) + static_cast<int64_t>(4 * (p % 4)) * n + i0 + r;
      *reinterpret_cast<int4*>(&tile[r][4 * p]) =
          make_int4(src[0], src[n], src[2 * n], src[3 * n]);
    }
  }
  __syncthreads();
  const int Q = W / 4;  // 16-byte pieces of a whole output row
  for (int q = threadIdx.x; q < live * Q; q += kThreads) {
    const int r = q / Q, p = q % Q;
    const int4 v = p < P ? *reinterpret_cast<const int4*>(&tile[r][4 * p])
                         : make_int4(0, 0, 0, 0);
    *reinterpret_cast<int4*>(out + row[r] * W + 4 * p) = v;
  }
}

template <int C>
int launch_gather(const int32_t* table, const void* idx, int idx_bytes,
                  int32_t* planes, int64_t n, int W, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kRows<C> - 1) / kRows<C>);
  if (idx_bytes == 8) {
    gather_planes_kernel<C, int64_t><<<blocks, kThreads, 0, stream>>>(
        table, static_cast<const int64_t*>(idx), planes, n, W);
  } else {
    gather_planes_kernel<C, int32_t><<<blocks, kThreads, 0, stream>>>(
        table, static_cast<const int32_t*>(idx), planes, n, W);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_scatter(const Leaves& leaves, const void* tgt, int tgt_bytes,
                   int32_t* out, int64_t n, int W, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kRows<C> - 1) / kRows<C>);
  if (tgt_bytes == 8) {
    scatter_rows_kernel<C, int64_t><<<blocks, kThreads, 0, stream>>>(
        leaves, static_cast<const int64_t*>(tgt), out, n, W);
  } else {
    scatter_rows_kernel<C, int32_t><<<blocks, kThreads, 0, stream>>>(
        leaves, static_cast<const int32_t*>(tgt), out, n, W);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K14.  table (Nt, W) int32, 16-byte aligned; idx the n row indices (int32
// for idx_bytes 4, int64 for 8) or null (rows 0..n-1); planes (C, n) out;
// C = 48 (G1) or 96 (G2).  n >= 1.
extern "C" int myzkp_gather_planes(const int32_t* table, const void* idx,
                                   int idx_bytes, int32_t* planes, int64_t n,
                                   int W, int C, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (C == 48) return launch_gather<48>(table, idx, idx_bytes, planes, n, W, s);
  if (C == 96) return launch_gather<96>(table, idx, idx_bytes, planes, n, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K16.  l0..l5 the (16, n) coordinate tensors (l3..l5 null for G1, C = 48);
// tgt the n target rows (int32 for tgt_bytes 4, int64 for 8) or null (rows
// 0..n-1); out (S, W) int32, 16-byte aligned, written in place.  n >= 1.
extern "C" int myzkp_scatter_rows(const int32_t* l0, const int32_t* l1,
                                  const int32_t* l2, const int32_t* l3,
                                  const int32_t* l4, const int32_t* l5,
                                  const void* tgt, int tgt_bytes, int32_t* out,
                                  int64_t n, int W, int C, void* stream) {
  const Leaves leaves{{l0, l1, l2, l3, l4, l5}};
  const auto s = static_cast<cudaStream_t>(stream);
  if (C == 48) return launch_scatter<48>(leaves, tgt, tgt_bytes, out, n, W, s);
  if (C == 96) return launch_scatter<96>(leaves, tgt, tgt_bytes, out, n, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
