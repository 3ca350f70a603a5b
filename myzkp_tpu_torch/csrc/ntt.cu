// K5 (butterfly) and K6 (ntt_leaf): the radix-2 Stockham NTT over limb
// planes, a few stages at a time (K5) or a whole short transform at once (K6).
//
// Both run DIF Stockham stages, as ops/ntt.py's _stockham_axis runs them: the
// stage input (blocks, c = 2h, B) splits its c axis in halves u, v; the
// output (2 * blocks, h, B) holds u + v in its first `blocks` blocks and
// (u - v) * tw[j] in the others, with j < h the position inside the half.
// After log2(m) stages the result is in natural order (Stockham autosort).
// Every value is canonical, so both kernels agree with their plain versions
// (fields/ntt_kernels.py) limb for limb.
//
// K5 replaces limb_pallas.butterfly_pallas (myzkp_tpu/fields/limb_pallas.py:76,
// body _make_butterfly_kernel :54) on the NTT's path, DIF mode.  The TPU
// kernel ran one stage a launch on u, v and a twiddle broadcast to u's shape,
// each sliced and copied out by the caller; its own contract, both modes on
// elementwise triples, is K5's pair form below.  This one reads the stage input
// in place and runs `stages` (1 to log2 MYZKP_K5_RADIX) consecutive stages a
// launch in registers: after the pass's first stage the pair (t, t + E/2) of
// the E elements x[k, j + t h'] (t < E, h' = c / E) lands in blocks k and
// Bk + k at position j + t h', so the next stage pairs (t, t + E/4) inside
// each of them, and so on; the element of index t ends in block
// bitreverse_s(t) Bk + k at position j (s = log2 E).  The pass's twiddles
// are its stage rows concatenated (half-widths c/2 .. c/E), read straight
// from device memory.
//   Bound on the H100: at the paths' widths (2^13 points x 3, B = 1) the
//   work is small (3 x 2^13 elements of 64 B each way: 0.94 us; the
//   products about 2.1 us a whole transform), so latency and launches bound
//   it.  A group of E elements on one thread (E/2 products a stage) left 96
//   warps for 528 schedulers and ran each product's dependent carry chain
//   unhidden: a three-stage pass took 0.0103-0.0110 ms, a whole 2^13-point
//   transform as long as 13 one-stage launches (H100 80GB HBM3 at 700 W,
//   unroll_sweep.py ntt; PERF.md).
//   Design: the group sits on E/2 neighbouring lanes, each holding one pair
//   a stage and trading one element with lane q ^ 2^b before the stage of
//   bit b (8 shuffles), so a lane runs one product a stage and a pass has R
//   m / 2 threads whatever r; r = 8 (three stages a launch: a 2^13-point
//   transform is 5 launches, not 13); products on the carry chains of
//   fe_mul_sel<MYZKP_K5_MUL>; blocks of 64; no product where a stage row's
//   entry 0 is 1 (R mod p) at position 0, as K6 skips them (every table of
//   ops/ntt.py starts each row with 1).  Lanes past the end compute on a
//   clamped group and store nothing.  A warp's loads and stores run along
//   j (or along B), whole 32-byte sectors.
//
// K6 replaces limb_pallas.ntt_leaf_pallas (myzkp_tpu/fields/limb_pallas.py:242,
// body _make_ntt_leaf_kernel :156): a full length-m NTT (2 <= m <= 128) along
// axis -2 of (16, E, m, B), natural order in and out.  The TPU kernel ran the
// last three stages in place on 8-row sublane groups and unpermuted rows
// afterwards (ntt_leaf_row_perm), a Mosaic relayout workaround.
//   Stockham's stage s pairs the rows whose original index differs in bit
//   L - 1 - s (L = log2 m) with twiddle index j = (original index) mod 2^(L-1-s)
//   and moves its output bit to the top of the row index.  So the leaf is
//   the in-place DIF transform over the original positions, and the element
//   at in-place position P ends in row bitreverse_L(P) (after s < L stages:
//   the top s bits of P reversed, the others kept).  `stages` runs only the
//   first s (for the leaf probe); the path runs all L.
//   Bound on the H100: an element crosses device memory once each way (128
//   bytes), and the products by twiddles that are not 1: at m = 128, 321 of
//   the 448 (every stage's j = 0 has twiddle 1, the whole last stage
//   included), which bound it at 0.249 ms by operations against 0.240 ms by
//   bytes at E = 3, B = 16,384.  Every table of ops/ntt.py starts each
//   stage row with 1 (R mod p); the block checks each row once, and skips
//   the j = 0 products of the rows that do (they leave a canonical value
//   unchanged), so any table gives the plain version's result.
//   Design: one block per (e, tile of kCols columns of B: MYZKP_K6_COLS,
//   16 by default).  A thread holds r = MYZKP_K6_RADIX (8) elements of one
//   column whose positions differ in log2 r bits, and runs those bits'
//   stages in registers: at m = 128, passes over bits (6, 5, 4), (3, 2, 1),
//   then bit 0 (whose stage has no products), with two exchanges through
//   shared memory (the tile, 8 word planes of m x kCols) in between: 4
//   barriers in all, the first after the twiddle table is staged (packed
//   words, (m - 1) x 32 B).  The first pass loads from device memory and the
//   last stores to it straight from registers.  At 16 columns (119
//   registers, 256 threads, 68 KB) two blocks fit an SM, so one block's
//   loads and stores overlap the other's products; at 32 columns (128-byte
//   rows) only one fits and the memory phase runs alone (unroll_sweep.py
//   leaf, PERF.md).  A warp then spans two thread groups; after the first
//   pass the groups are taken bit-reversed, so the two differ in the top row
//   bit, above every later stage's twiddle index, and the j = 0 test is
//   uniform across the warp (smem_row keeps their rows in distinct banks;
//   in plain order the skip diverges: PERF.md).
//   The ragged edge of B is masked; nothing is padded.
//
// K5 and K6 come at two widths from one templated body each: N = 8 words
// (BN254: butterfly_kernel, ntt_leaf_kernel) and N = 4 (M128, the STARK's
// field: butterfly_l8_kernel, ntt_leaf_l8_kernel, entry points with _l8).
// At four words an element is 32 bytes each way and a product about 100
// instructions (field.cuh: fe_mul_cc_wide) against eight words' 290, so the
// K5 shuffles and registers halve; the radix and K6's columns are the same
// constants at both widths (unroll_sweep.py ntt / leaf time both; PERF.md).
#include <cuda_runtime.h>

#include "field.cuh"

using myzkp::FeN;
using myzkp::FieldConsts;
using myzkp::FieldConstsN;

namespace {

#ifndef MYZKP_K5_RADIX
#define MYZKP_K5_RADIX 8
#endif
#ifndef MYZKP_K5_MUL
#define MYZKP_K5_MUL 0
#endif

constexpr int kK5Radix = MYZKP_K5_RADIX;  // most elements a group: 2^stages
constexpr int kK5Threads = 64;
static_assert(kK5Radix == 2 || kK5Radix == 4 || kK5Radix == 8 || kK5Radix == 16 ||
                  kK5Radix == 32,
              "MYZKP_K5_RADIX is 2, 4, 8, 16 or 32");

template <int N>
__device__ __forceinline__ bool fe_is_one(const FeN<N>& a, const FieldConstsN<N>& c) {
  bool one = true;
#pragma unroll
  for (int k = 0; k < N; ++k) one &= a.w[k] == c.one[k];
  return one;
}

// Group g -> (r, k, j, b) of (R, Bk, hq, B), b fastest.
template <class I>
__device__ __forceinline__ void k5_split(I g, I B, I hq, I Bk, int64_t& r, int64_t& k,
                                         int64_t& j, int64_t& b) {
  b = static_cast<int64_t>(g % B);
  g /= B;
  j = static_cast<int64_t>(g % hq);
  g /= hq;
  k = static_cast<int64_t>(g % Bk);
  r = static_cast<int64_t>(g / Bk);
}

// log2 E stages of (R, Bk, c = E hq, B) -> (R, E Bk, hq, B) on groups of E
// elements x[r, k, j + t hq, b], t < E, each on E/2 neighbouring lanes.  tw:
// the stage rows of half-widths c/2, c/4, ..., hq.  At the stage of bit bb
// lane q holds elements e and e + 2^bb, e being q with a 0 put in at bit bb;
// before it (but the first) lanes q and q ^ 2^bb trade one element.
template <int E, int N>
__device__ __forceinline__ void butterfly_body(const int32_t* __restrict__ x,
                                               const int32_t* __restrict__ tw,
                                               int32_t* __restrict__ out, int64_t R,
                                               int64_t Bk, int64_t hq, int64_t B,
                                               const FieldConstsN<N>& c) {
  constexpr int S = __builtin_ctz(E);
  constexpr int G = E / 2;  // lanes a group
  const int64_t groups = R * Bk * hq * B;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int q = static_cast<int>(i & (G - 1));
  const bool live = i / G < groups;
  const int64_t g = live ? i / G : groups - 1;  // every lane reaches the shuffles
  int64_t r, k, j, b;
  if (groups <= 0xFFFFFFFFll)  // 32-bit divisions where they suffice
    k5_split<uint32_t>(g, B, hq, Bk, r, k, j, b);
  else
    k5_split<uint64_t>(g, B, hq, Bk, r, k, j, b);
  const int64_t plane = groups * E;  // both x and out hold E elements a group
  const int64_t ntw = hq * (E - 1);
  const int64_t step = hq * B;  // from element t of a group to t + 1
  const int64_t in = ((r * Bk + k) * E * hq + j) * B + b;
  FeN<N> lo = myzkp::load_planes<N>(x, plane, in + q * step);
  FeN<N> hi = myzkp::load_planes<N>(x, plane, in + (q + G) * step);
  int64_t off = 0;  // this stage's row of tw
#pragma unroll
  for (int bb = S - 1; bb >= 0; --bb) {
    const int half = 1 << bb;
    if (bb < S - 1) {  // of lanes q, q ^ 2^bb the one with bit bb set takes the lows
      const bool up = (q >> bb) & 1;
      const FeN<N> send = myzkp::fe_select(up, lo, hi);
      FeN<N> got;
#pragma unroll
      for (int w = 0; w < N; ++w)
        got.w[w] = __shfl_xor_sync(0xffffffffu, send.w[w], half);
      lo = myzkp::fe_select(up, got, lo);
      hi = myzkp::fe_select(up, hi, got);
    }
    const int64_t pos = j + (q & (half - 1)) * hq;
    const FeN<N> w = myzkp::load_planes<N>(tw, ntw, off + pos);
    const FeN<N> d = myzkp::fe_sub_cc(lo, hi, c);
    lo = myzkp::fe_add_cc(lo, hi, c);
    hi = pos == 0 && fe_is_one(w, c) ? d : myzkp::fe_mul_sel<MYZKP_K5_MUL>(d, w, c);
    off += half * hq;
  }
  if (!live) return;
  // lane q ends with elements 2q and 2q + 1, bound for blocks
  // bitreverse_S(2q) Bk + k and bitreverse_S(2q + 1) Bk + k
  const int64_t ob = ((r * E * Bk + k) * hq + j) * B + b;  // block k of the output
  const int q0 = static_cast<int>(__brev(static_cast<unsigned>(2 * q)) >> (32 - S));
  myzkp::store_planes(out, plane, ob + q0 * Bk * step, lo);
  myzkp::store_planes(out, plane, ob + (q0 | G) * Bk * step, hi);
}

template <int E>
__global__ void __launch_bounds__(kK5Threads)
    butterfly_kernel(const int32_t* __restrict__ x,
                     const int32_t* __restrict__ tw, int32_t* __restrict__ out,
                     int64_t R, int64_t Bk, int64_t hq, int64_t B,
                     FieldConsts c) {
  butterfly_body<E, 8>(x, tw, out, R, Bk, hq, B, c);
}

template <int E>
__global__ void __launch_bounds__(kK5Threads)
    butterfly_l8_kernel(const int32_t* __restrict__ x,
                        const int32_t* __restrict__ tw, int32_t* __restrict__ out,
                        int64_t R, int64_t Bk, int64_t hq, int64_t B,
                        FieldConstsN<4> c) {
  butterfly_body<E, 4>(x, tw, out, R, Bk, hq, B, c);
}

// The pass of `stages` stages on the instantiation of 2^stages elements,
// for stages <= log2 E.
template <int E, int N>
int launch_butterfly(const int32_t* x, const int32_t* tw, int32_t* out,
                     int64_t R, int64_t Bk, int64_t hq, int64_t B, int stages,
                     const FieldConstsN<N>& c, cudaStream_t stream) {
  if constexpr (E > 2) {
    if (stages < __builtin_ctz(E))
      return launch_butterfly<E / 2, N>(x, tw, out, R, Bk, hq, B, stages, c, stream);
  }
  const int64_t blocks = (R * Bk * hq * B * (E / 2) + kK5Threads - 1) / kK5Threads;
  if constexpr (N == myzkp::kWords)
    butterfly_kernel<E><<<static_cast<unsigned>(blocks), kK5Threads, 0, stream>>>(
        x, tw, out, R, Bk, hq, B, c);
  else
    butterfly_l8_kernel<E><<<static_cast<unsigned>(blocks), kK5Threads, 0, stream>>>(
        x, tw, out, R, Bk, hq, B, c);
  return static_cast<int>(cudaGetLastError());
}

#ifndef MYZKP_K6_RADIX
#define MYZKP_K6_RADIX 8
#endif
#ifndef MYZKP_K6_COLS
#define MYZKP_K6_COLS 16
#endif
#ifndef MYZKP_K6_MUL
#define MYZKP_K6_MUL 0
#endif

constexpr int kCols = MYZKP_K6_COLS;  // columns of B per block
constexpr int kMaxLeaf = 128;
constexpr int kRadix = MYZKP_K6_RADIX;
static_assert(kRadix == 4 || kRadix == 8, "MYZKP_K6_RADIX is 4 or 8");
static_assert(kCols == 8 || kCols == 16 || kCols == 32, "MYZKP_K6_COLS is 8, 16 or 32");
constexpr int kWarpBits = __builtin_ctz(32 / kCols);  // thread groups a warp spans: 2^this

// Threads of a block of the R-element kernel: R = kRadix serves m >= kRadix,
// a smaller R only m = R.
__host__ __device__ constexpr int leaf_threads(int R) {
  return (R == kRadix ? kMaxLeaf : R) / R * kCols;
}
static_assert(leaf_threads(kRadix) <= 1024, "too many threads a block");

template <int N>
__device__ __forceinline__ FeN<N> smem_load(const uint32_t* sm, int n_el, int idx) {
  FeN<N> r;
#pragma unroll
  for (int k = 0; k < N; ++k) r.w[k] = sm[k * n_el + idx];
  return r;
}

template <int N>
__device__ __forceinline__ void smem_store(uint32_t* sm, int n_el, int idx,
                                           const FeN<N>& a) {
#pragma unroll
  for (int k = 0; k < N; ++k) sm[k * n_el + idx] = a.w[k];
}

// Position of element e of thread group g in a pass whose element bits
// start at bit lo: g's log2(m / R) bits fill the other positions.
template <int R>
__device__ __forceinline__ int leaf_pos(int g, int e, int lo) {
  constexpr int K = __builtin_ctz(R);
  return (g & ((1 << lo) - 1)) | (e << lo) | ((g >> lo) << (lo + K));
}

// The shared-memory row of tile row `row`.  After the first pass the thread
// groups of one warp differ in the top kWarpBits (W) row bits (the groups
// are bit-reversed there); those bits are folded onto the
// low W, so the rows a warp touches fall in distinct banks.  In the first
// pass the groups of a warp differ in the low W bits, which the fold leaves
// distinct.  A bijection on [0, m).
__device__ __forceinline__ int smem_row(int row, int logm) {
  constexpr int W = kWarpBits;
  const int s = logm - W;
  if (W == 0 || s < W) return row;
  return row ^ ((row >> s) & ((1 << W) - 1));
}

template <int R, int N>
__device__ __forceinline__ void ntt_leaf_body(const int32_t* __restrict__ x,
                                              const int32_t* __restrict__ tw,
                                              int32_t* __restrict__ out, int64_t tiles,
                                              int logm, int stages, int64_t B,
                                              int64_t plane, const FieldConstsN<N>& c) {
  constexpr int K = __builtin_ctz(R);
  // word k of twiddle t at smt[k * kMaxLeaf + t]; word k of element (row,
  // col) of the tile at smx[k * n_el + row * kCols + col]
  extern __shared__ uint32_t sm[];
  uint32_t* smt = sm;
  uint32_t* smx = sm + N * kMaxLeaf;
  const int m = 1 << logm;
  const int n_el = m * kCols;
  const int64_t e = blockIdx.x / tiles;
  const int64_t col0 = (blockIdx.x % tiles) * kCols;
  const int64_t base = e * m * B + col0;
  // thread -> (group g, column col).  The first pass takes the groups in
  // order, so a warp's loads read neighbouring rows; the later passes take
  // them bit-reversed, so that the groups a warp spans (kCols < 32) differ
  // in their top bits, which lie above every later stage's twiddle index:
  // the j = 0 test is then uniform across the warp, and the last pass's
  // stores land on neighbouring rows again
  const int col = threadIdx.x % kCols, gbits = logm - K;
  const int g_rev = gbits > 0
                  ? static_cast<int>(__brev(threadIdx.x / kCols) >> (32 - gbits))
                  : static_cast<int>(threadIdx.x / kCols);
  int g = threadIdx.x / kCols;
  const bool live = col0 + col < B;

  for (int t = threadIdx.x; t < m - 1; t += blockDim.x)
    smem_store(smt, kMaxLeaf, t, myzkp::load_planes<N>(tw, m - 1, t));
  int lo = logm - K;
  FeN<N> v[R];
#pragma unroll
  for (int i = 0; i < R; ++i)
    v[i] = live ? myzkp::load_planes<N>(x, plane,
                                        base + int64_t{leaf_pos<R>(g, i, lo)} * B + col)
                : myzkp::fe_zero<N>();
  __syncthreads();
  // bit b: the stage row of half-width 2^b starts with 1, so its j = 0
  // products are skipped
  unsigned unit = 0;
  for (int b = 0; b < logm; ++b) {
    bool one = true;
#pragma unroll
    for (int k = 0; k < N; ++k)
      one &= smt[k * kMaxLeaf + m - (2 << b)] == c.one[k];
    unit |= static_cast<unsigned>(one) << b;
  }

  // bits logm - 1 .. logm - stages are the stages to run; bits >= top are done
  const int last = logm - stages;
  int top = logm;
  for (;;) {
#pragma unroll
    for (int t = K - 1; t >= 0; --t) {
      const int b = lo + t;
      if (b >= top || b < last) continue;
      const int h = 1 << b, off = m - 2 * h;  // this stage's row of tw
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (i & (1 << t)) continue;
        const int i2 = i | (1 << t);
        const int j = leaf_pos<R>(g, i, lo) & (h - 1);
        const FeN<N> u = v[i], w = v[i2];
        v[i] = myzkp::fe_add_cc(u, w, c);
        const FeN<N> d = myzkp::fe_sub_cc(u, w, c);
        v[i2] = j == 0 && (unit >> b & 1u)
                    ? d
                    : myzkp::fe_mul_sel<MYZKP_K6_MUL>(d, smem_load<N>(smt, kMaxLeaf, off + j),
                                                      c);
      }
    }
    top = lo;
    if (top <= last) break;
    // the next pass: write this pass's elements, read the next one's
    if (lo + K < logm) __syncthreads();  // every read of the last exchange done
#pragma unroll
    for (int i = 0; i < R; ++i)
      smem_store(smx, n_el, smem_row(leaf_pos<R>(g, i, lo), logm) * kCols + col, v[i]);
    __syncthreads();
    lo = max(lo - K, 0);
    g = g_rev;
#pragma unroll
    for (int i = 0; i < R; ++i)
      v[i] = smem_load<N>(smx, n_el, smem_row(leaf_pos<R>(g, i, lo), logm) * kCols + col);
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int pos = leaf_pos<R>(g, i, lo);
    const int low = pos & ((1 << last) - 1);
    const int row = static_cast<int>(__brev(static_cast<unsigned>(pos >> last)) >>
                                     (32 - stages)) << last | low;
    myzkp::store_planes(out, plane, base + int64_t{row} * B + col, v[i]);
  }
}

template <int R>
__global__ void __launch_bounds__(leaf_threads(R))
    ntt_leaf_kernel(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ tw, int32_t* __restrict__ out,
                    int64_t tiles, int logm, int stages, int64_t B,
                    int64_t plane, FieldConsts c) {
  ntt_leaf_body<R, 8>(x, tw, out, tiles, logm, stages, B, plane, c);
}

template <int R>
__global__ void __launch_bounds__(leaf_threads(R))
    ntt_leaf_l8_kernel(const int32_t* __restrict__ x,
                       const int32_t* __restrict__ tw, int32_t* __restrict__ out,
                       int64_t tiles, int logm, int stages, int64_t B,
                       int64_t plane, FieldConstsN<4> c) {
  ntt_leaf_body<R, 4>(x, tw, out, tiles, logm, stages, B, plane, c);
}

template <int R, int N>
int launch_leaf(const int32_t* x, const int32_t* tw, int32_t* out, int64_t E,
                int logm, int stages, int64_t B, const FieldConstsN<N>& c,
                cudaStream_t stream) {
  const int m = 1 << logm;
  auto smem_of = [](int rows) {
    return sizeof(uint32_t) * N * (kMaxLeaf + rows * kCols);
  };
  auto kernel = [] {
    if constexpr (N == myzkp::kWords)
      return ntt_leaf_kernel<R>;
    else
      return ntt_leaf_l8_kernel<R>;
  }();
  // granted on the current device at the instantiation's largest leaf, so
  // that launches of any m on any device and thread see the same limit
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_of(R == kRadix ? kMaxLeaf : R)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_of(m);
  const int64_t tiles = (B + kCols - 1) / kCols;
  kernel<<<static_cast<unsigned>(E * tiles), m / R * kCols, smem, stream>>>(
      x, tw, out, tiles, logm, stages, B, E * m * B, c);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int butterfly_pass(const int32_t* x, const int32_t* tw, int32_t* out, int64_t R,
                   int64_t Bk, int64_t c, int64_t B, int stages,
                   const FieldConstsN<N>& consts, void* stream) {
  if (stages < 1 || (1 << stages) > kK5Radix || c % (int64_t{1} << stages) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_butterfly<kK5Radix, N>(x, tw, out, R, Bk, c >> stages, B, stages,
                                       consts, static_cast<cudaStream_t>(stream));
}

template <int N>
int leaf(const int32_t* x, const int32_t* tw, int32_t* out, int64_t E, int m,
         int stages, int64_t B, const FieldConstsN<N>& consts, void* stream) {
  if (m < 2 || m > kMaxLeaf || (m & (m - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int logm = __builtin_ctz(static_cast<unsigned>(m));
  if (stages < 1 || stages > logm) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (m == 2) return launch_leaf<2, N>(x, tw, out, E, logm, stages, B, consts, s);
  if (kRadix == 8 && m == 4)
    return launch_leaf<4, N>(x, tw, out, E, logm, stages, B, consts, s);
  return launch_leaf<kRadix, N>(x, tw, out, E, logm, stages, B, consts, s);
}

// K5's pair form: butterfly_pallas's own contract, one radix-2 butterfly on
// elementwise triples (u, v, tw) of (2N, n) limb planes, DIF (u + v, (u - v)
// tw) or DIT (u + v tw, u - v tw), the mode a template parameter.  No path
// calls it (the NTT runs K5's Stockham passes); it is the port's counterpart
// of the TPU kernel's interface.  Bound on the H100: device memory, five
// elements of 4N int32 limbs a butterfly (three read, two written: 320 bytes
// at N = 8) against one product (264 multiply-adds at N = 8, 68 at N = 4, 18
// at N = 2).  Design: one element a thread, blocks of 256, a warp's loads
// and stores along n (whole 128-byte lines of each limb plane), the product
// on the carry chains of fe_mul_cc (fe_mul_cc_wide at N = 4 and 2) and the
// add and subtract on fe_add_cc / fe_sub_cc; every value canonical, so the
// result equals the plain version's limb for limb.
constexpr int kPairThreads = 256;

template <int N, bool DIT>
__global__ void __launch_bounds__(kPairThreads)
    butterfly_pair_kernel(const int32_t* __restrict__ u, const int32_t* __restrict__ v,
                          const int32_t* __restrict__ tw, int32_t* __restrict__ su,
                          int32_t* __restrict__ sv, int64_t n, FieldConstsN<N> c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kPairThreads + threadIdx.x;
  if (i >= n) return;
  const FeN<N> a = myzkp::load_planes<N>(u, n, i);
  const FeN<N> b = myzkp::load_planes<N>(v, n, i);
  const FeN<N> w = myzkp::load_planes<N>(tw, n, i);
  if constexpr (DIT) {
    const FeN<N> t = myzkp::fe_mul_cc(b, w, c);
    myzkp::store_planes(su, n, i, myzkp::fe_add_cc(a, t, c));
    myzkp::store_planes(sv, n, i, myzkp::fe_sub_cc(a, t, c));
  } else {
    myzkp::store_planes(su, n, i, myzkp::fe_add_cc(a, b, c));
    myzkp::store_planes(sv, n, i, myzkp::fe_mul_cc(myzkp::fe_sub_cc(a, b, c), w, c));
  }
}

template <int N>
int butterfly_pair(const int32_t* u, const int32_t* v, const int32_t* tw, int32_t* su,
                   int32_t* sv, int64_t n, int dit, const FieldConstsN<N>& consts,
                   void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto blocks = static_cast<unsigned>((n + kPairThreads - 1) / kPairThreads);
  auto s = static_cast<cudaStream_t>(stream);
  if (dit)
    butterfly_pair_kernel<N, true><<<blocks, kPairThreads, 0, s>>>(u, v, tw, su, sv, n,
                                                                   consts);
  else
    butterfly_pair_kernel<N, false><<<blocks, kPairThreads, 0, s>>>(u, v, tw, su, sv, n,
                                                                    consts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (su, sv) = (u + v, (u - v) tw) (dit = 0) or (u + v tw, u - v tw) (dit = 1)
// elementwise over (2N, n) limb planes: 2N = 16 (BN254), 8 (M128, _l8) or 4
// (M64, _l4).
extern "C" int myzkp_butterfly_pair(const int32_t* u, const int32_t* v,
                                    const int32_t* tw, int32_t* su, int32_t* sv,
                                    int64_t n, int dit, const FieldConsts* consts,
                                    void* stream) {
  return butterfly_pair(u, v, tw, su, sv, n, dit, *consts, stream);
}

extern "C" int myzkp_butterfly_pair_l8(const int32_t* u, const int32_t* v,
                                       const int32_t* tw, int32_t* su, int32_t* sv,
                                       int64_t n, int dit, const FieldConstsN<4>* consts,
                                       void* stream) {
  return butterfly_pair(u, v, tw, su, sv, n, dit, *consts, stream);
}

extern "C" int myzkp_butterfly_pair_l4(const int32_t* u, const int32_t* v,
                                       const int32_t* tw, int32_t* su, int32_t* sv,
                                       int64_t n, int dit, const FieldConstsN<2>* consts,
                                       void* stream) {
  return butterfly_pair(u, v, tw, su, sv, n, dit, *consts, stream);
}

// x (2N, R, Bk, c, B) -> out (2N, R, 2^stages Bk, c / 2^stages, B), 2N = 16
// limbs (BN254) or 8 (M128, the _l8 entry point); tw (2N, c - c / 2^stages):
// the stage rows of half-widths c/2, c/4, ..., c / 2^stages, concatenated.
// 1 <= stages <= log2 MYZKP_K5_RADIX, and 2^stages divides c.
extern "C" int myzkp_butterfly(const int32_t* x, const int32_t* tw,
                               int32_t* out, int64_t R, int64_t Bk, int64_t c,
                               int64_t B, int stages, const FieldConsts* consts,
                               void* stream) {
  return butterfly_pass(x, tw, out, R, Bk, c, B, stages, *consts, stream);
}

extern "C" int myzkp_butterfly_l8(const int32_t* x, const int32_t* tw,
                                  int32_t* out, int64_t R, int64_t Bk, int64_t c,
                                  int64_t B, int stages,
                                  const FieldConstsN<4>* consts, void* stream) {
  return butterfly_pass(x, tw, out, R, Bk, c, B, stages, *consts, stream);
}

// x (2N, E, m, B) -> out (2N, E, m, B); tw (2N, m - 1): the stage tables of
// half-widths m/2, m/4, ..., 1, concatenated.  The first `stages`
// (1 <= stages <= log2 m) Stockham stages.
extern "C" int myzkp_ntt_leaf(const int32_t* x, const int32_t* tw,
                              int32_t* out, int64_t E, int m, int stages,
                              int64_t B, const FieldConsts* consts, void* stream) {
  return leaf(x, tw, out, E, m, stages, B, *consts, stream);
}

extern "C" int myzkp_ntt_leaf_l8(const int32_t* x, const int32_t* tw,
                                 int32_t* out, int64_t E, int m, int stages,
                                 int64_t B, const FieldConstsN<4>* consts,
                                 void* stream) {
  return leaf(x, tw, out, E, m, stages, B, *consts, stream);
}
