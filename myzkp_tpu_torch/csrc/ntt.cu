// K5 (butterfly) and K6 (ntt_leaf): the radix-2 Stockham NTT over limb
// planes, one stage at a time (K5) or a whole short transform at once (K6).
//
// Both are DIF Stockham stages, as ops/ntt.py's _stockham_axis runs them: the
// stage input (blocks, c = 2h, B) splits its c axis in halves u, v; the
// output (2 * blocks, h, B) holds u + v in its first `blocks` blocks and
// (u - v) * tw[j] in the others, with j < h the position inside the half.
// After log2(m) stages the result is in natural order (Stockham autosort).
// Every value is canonical, so both kernels agree with their plain versions
// (ops/ntt_kernels.py) limb for limb.
//
// K5 replaces limb_pallas.butterfly_pallas (myzkp_tpu/fields/limb_pallas.py:76,
// body _make_butterfly_kernel :54), DIF mode; DIT has no caller.  The TPU
// kernel took u, v and a twiddle broadcast to u's shape, each sliced and
// copied out by the caller.  This one reads the stage input in place and
// indexes the (16, h) twiddle row itself.
//   Bound on the H100: device memory.  A pair moves 256 bytes (u, v in; two
//   outputs; one int32 per 16-bit limb) against one Montgomery product
//   (264 32-bit multiply-adds).  Design: one thread per pair, limb-plane
//   loads and stores coalesced along B (or along j when B = 1).
//
// K6 replaces limb_pallas.ntt_leaf_pallas (myzkp_tpu/fields/limb_pallas.py:242,
// body _make_ntt_leaf_kernel :156): a full length-m NTT (2 <= m <= 128) along
// axis -2 of (16, E, m, B), natural order in and out.  The TPU kernel ran the
// last three stages in place on 8-row sublane groups and unpermuted rows
// afterwards (ntt_leaf_row_perm), a Mosaic relayout workaround; here every
// stage is the same Stockham stage and the output needs no permutation.
//   Bound on the H100: an element crosses device memory once each way (128
//   bytes) and takes part in (log2 m) / 2 Montgomery products; at m = 64 and
//   128 the products bound it (3 and 3.5 x 264 multiply-adds), below 32 the
//   bytes do.  Design: one block per (e, tile of kCols columns of B); the m x kCols
//   elements stay in shared memory (8 word planes, 256 * m bytes) for all
//   log2(m) stages, so x crosses device memory once each way.  One thread
//   per pair: a stage reads its pair into registers, waits at a barrier,
//   and writes both outputs in place, so one buffer serves every stage.
//   The ragged edge of B is masked; nothing is padded.
#include <cuda_runtime.h>

#include "field.cuh"

using myzkp::Fe;
using myzkp::FieldConsts;

namespace {

__global__ void __launch_bounds__(256)
    butterfly_kernel(const int32_t* __restrict__ x,
                     const int32_t* __restrict__ tw, int32_t* __restrict__ out,
                     int64_t R, int64_t Bk, int64_t h, int64_t B,
                     FieldConsts c) {
  const int64_t pairs = R * Bk * h * B;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const int64_t b = i % B;
  int64_t t = i / B;
  const int64_t j = t % h;
  t /= h;
  const int64_t k = t % Bk;
  const int64_t r = t / Bk;
  const int64_t plane = 2 * pairs;  // both x and out hold 2 * pairs elements
  const int64_t iu = ((r * Bk + k) * 2 * h + j) * B + b;
  const int64_t ou = ((r * 2 * Bk + k) * h + j) * B + b;
  const Fe u = myzkp::load_planes(x, plane, iu);
  const Fe v = myzkp::load_planes(x, plane, iu + h * B);
  const Fe w = myzkp::load_planes(tw, h, j);
  myzkp::store_planes(out, plane, ou, myzkp::fe_add(u, v, c));
  myzkp::store_planes(out, plane, ou + Bk * h * B,
                      myzkp::fe_mul(myzkp::fe_sub(u, v, c), w, c));
}

constexpr int kCols = 8;     // columns of B per block
constexpr int kMaxLeaf = 128;

__device__ __forceinline__ Fe smem_load(const uint32_t* sm, int n_el, int idx) {
  Fe r;
#pragma unroll
  for (int k = 0; k < myzkp::kWords; ++k) r.w[k] = sm[k * n_el + idx];
  return r;
}

__device__ __forceinline__ void smem_store(uint32_t* sm, int n_el, int idx,
                                           const Fe& a) {
#pragma unroll
  for (int k = 0; k < myzkp::kWords; ++k) sm[k * n_el + idx] = a.w[k];
}

__global__ void __launch_bounds__(kMaxLeaf / 2 * kCols)
    ntt_leaf_kernel(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ tw, int32_t* __restrict__ out,
                    int64_t tiles, int m, int64_t B, int64_t plane,
                    FieldConsts c) {
  extern __shared__ uint32_t sm[];  // word k of element (row, col) at
                                    // k * n_el + row * kCols + col
  const int n_el = m * kCols;
  const int64_t e = blockIdx.x / tiles;
  const int64_t col0 = (blockIdx.x % tiles) * kCols;
  const int64_t base = e * m * B + col0;

  for (int idx = threadIdx.x; idx < n_el; idx += blockDim.x) {
    const int row = idx / kCols, col = idx % kCols;
    const Fe v = (col0 + col < B)
                     ? myzkp::load_planes(x, plane, base + row * B + col)
                     : myzkp::fe_zero();
    smem_store(sm, n_el, idx, v);
  }
  __syncthreads();

  // thread -> (pair q, column col); the stage of half-width h pairs rows
  // (blk * 2h + i, blk * 2h + i + h) into rows (q, q + m / 2)
  const int q = threadIdx.x / kCols, col = threadIdx.x % kCols;
  for (int h = m / 2, off = 0; h >= 1; off += h, h >>= 1) {
    const int blk = q / h, i = q % h;
    const int iu = (blk * 2 * h + i) * kCols + col;
    const Fe u = smem_load(sm, n_el, iu);
    const Fe v = smem_load(sm, n_el, iu + h * kCols);
    const Fe w = myzkp::load_planes(tw, m - 1, off + i);
    const Fe su = myzkp::fe_add(u, v, c);
    const Fe sv = myzkp::fe_mul(myzkp::fe_sub(u, v, c), w, c);
    __syncthreads();
    smem_store(sm, n_el, q * kCols + col, su);
    smem_store(sm, n_el, (q + m / 2) * kCols + col, sv);
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < n_el; idx += blockDim.x) {
    const int row = idx / kCols, col = idx % kCols;
    if (col0 + col < B)
      myzkp::store_planes(out, plane, base + row * B + col,
                          smem_load(sm, n_el, idx));
  }
}

}  // namespace

// x (16, R, Bk, 2h, B) -> out (16, R, 2 Bk, h, B); tw (16, h).
extern "C" int myzkp_butterfly(const int32_t* x, const int32_t* tw,
                               int32_t* out, int64_t R, int64_t Bk, int64_t h,
                               int64_t B, const FieldConsts* consts,
                               void* stream) {
  const int threads = 256;
  const int64_t blocks = (R * Bk * h * B + threads - 1) / threads;
  butterfly_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, tw, out, R, Bk, h,
                                                          B, *consts);
  return static_cast<int>(cudaGetLastError());
}

// x (16, E, m, B) -> out (16, E, m, B); tw (16, m - 1): the stage tables of
// half-widths m/2, m/4, ..., 1, concatenated.
extern "C" int myzkp_ntt_leaf(const int32_t* x, const int32_t* tw,
                              int32_t* out, int64_t E, int m, int64_t B,
                              const FieldConsts* consts, void* stream) {
  if (m < 2 || m > kMaxLeaf || (m & (m - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (B + kCols - 1) / kCols;
  const size_t smem = sizeof(uint32_t) * myzkp::kWords * m * kCols;
  ntt_leaf_kernel<<<static_cast<unsigned>(E * tiles), m / 2 * kCols, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      x, tw, out, tiles, m, B, E * m * B, *consts);
  return static_cast<int>(cudaGetLastError());
}
