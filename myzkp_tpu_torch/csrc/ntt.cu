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
// K5 has a design at each width.  BN254's (eight words, butterfly_kernel)
// is the one above.  M128's (four words, the STARK's field: the _l8 entry
// point, stockham_l8_kernel) replaces the same TPU kernel at the same
// contract, with passes of up to 10 stages instead of log2 MYZKP_K5_RADIX.
//   Bound on the H100: every transform of a FastStark prove below 2^14
//   points moves 2^16 or 2^17 elements (its subproduct trees: R m = 2^16 or
//   2^17), 1.25 or 2.5 us of device memory each way at 32 bytes an element,
//   against products of 68 multiply-adds (the j = 0 ones skipped) that are
//   shorter still; the 114 transforms' bound sums to 0.19 ms (chip_smoke.py).
//   What binds in practice is the integer pipes and the launch: a
//   butterfly is about 140 integer instructions (the product's ~100, the
//   add and subtract's ~40), all on 16 lanes a cycle a scheduler, about 0.3
//   us a stage of 2^16 elements on 132 SMs; and a launch costs about 4 us
//   of fixed time (a one-stage pass of 2^16 elements: 4.3-4.5 us a launch
//   in a graph, against 1.3 us for a one-int add and 3.0 us for a copy of
//   twice its bytes; PERF.md, PR 21 runs I and J).
//   BN254's body at four words ran three stages a launch in registers, so
//   a 2^13-point transform made 5 passes over device memory and 5 launches
//   of 64-thread blocks: 312 launches a prove, 1.47 ms.
//   Design: at most 10 stages a pass (the caller's split,
//   ntt_kernels.k5_l8_split), so a transform up to 2^10 points is one
//   launch and up to 2^13 two balanced ones (7 + 6); a block holds one tile
//   of whole groups (2^s elements of 8 or more neighbouring columns where
//   the tile holds them, or of whole rows), the largest that still leaves a
//   block for each of the 132 SMs (stockham_plan.cuh).  The tile
//   comes in along memory, 16-byte loads of four elements a limb plane
//   where its columns run in fours, every load issued before the first
//   store to shared memory, and is packed into four 32-bit words as it
//   lands: 16 bytes an element of shared memory, not 32.  The tile's
//   entries of every stage row (fewer than its elements) come in beside
//   it.  The stages run two a barrier: a thread takes a quad (elements t,
//   t + h, t + 2h, t + 3h) through both stages in registers, on
//   fe_mul_cc's wide carry chains (p > R/2 keeps a carry word), and the
//   16-byte slots are swizzled so that a quarter warp's quads and the last
//   step's bit-reversed reads fall in distinct bank groups (tile_slot).
//   The last step reads the tile in output order, runs the last two stages
//   in registers and stores along the output; where that leaves runs of
//   fewer than 8 positions (transforms below 2^5 points) the outputs go
//   through a second tile and out along memory.  No product at position 0
//   of a stage row whose entry there is R mod p (the entry itself is
//   checked), so any table gives the plain version's result.  Dynamic
//   shared memory, past 48 KB by cudaFuncSetAttribute (at the largest
//   tiles, kTileMax).
// K6 has a design at each width too: BN254's below (ntt_leaf_kernel, one
// tile a block, bound by its products), and M128's (ntt_leaf_l8_kernel,
// after it: a persistent grid that loads the next tile while the stages
// run, bound by device memory), with constants of their own
// (unroll_sweep.py leaf / leaf8).
#include <cuda_runtime.h>

#include <algorithm>

#include "cp_async.cuh"
#include "field.cuh"
#include "stockham_plan.cuh"

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

// BN254's pass of `stages` stages on the instantiation of 2^stages
// elements, for stages <= log2 E.
template <int E>
int launch_butterfly(const int32_t* x, const int32_t* tw, int32_t* out,
                     int64_t R, int64_t Bk, int64_t hq, int64_t B, int stages,
                     const FieldConsts& c, cudaStream_t stream) {
  if constexpr (E > 2) {
    if (stages < __builtin_ctz(E))
      return launch_butterfly<E / 2>(x, tw, out, R, Bk, hq, B, stages, c, stream);
  }
  const int64_t blocks = (R * Bk * hq * B * (E / 2) + kK5Threads - 1) / kK5Threads;
  butterfly_kernel<E><<<static_cast<unsigned>(blocks), kK5Threads, 0, stream>>>(
      x, tw, out, R, Bk, hq, B, c);
  return static_cast<int>(cudaGetLastError());
}

// K5 at four words (M128): a pass of up to myzkp_stockham::kMaxStages
// stages a launch on one tile a block in shared memory (the design in the
// header above; the tiles in stockham_plan.cuh).

// A pass's shape and tile (myzkp_stockham::Tile), by value.  Every index
// fits 32 bits: the launcher takes at most 2^31 - 1 elements a limb plane.
struct StockhamPass {
  uint32_t rows;     // R Bk: the (r, k) blocks
  uint32_t Bk;
  uint32_t inner;    // hq B: the columns jb = j B + b of a block
  uint32_t hq;
  uint32_t B;
  uint32_t plane;    // elements of a limb plane, in and out
  uint32_t ntw;      // entries of a twiddle limb plane: c - hq
  uint32_t tiles_j;  // tiles across a block's columns
  int lbk, ltj;      // log2 Bk and log2 tiles_j where they are powers of two, else -1
  int ls, lw, lq, lkq;
  int staged_out;    // the output through a second tile (myzkp_stockham::Tile)
  int vec;           // 16-byte loads (and staged stores) of 4 neighbouring elements a plane
};

// Four neighbouring elements of (2N, plane) limb planes at i (a multiple of
// 4, 16-byte aligned): one 16-byte load a plane.
template <int N>
__device__ __forceinline__ void load4_planes(const int32_t* __restrict__ base, uint32_t plane,
                                             uint32_t i, FeN<N>* v) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int4 lo = *reinterpret_cast<const int4*>(base + (2 * k) * static_cast<size_t>(plane) + i);
    const int4 hi =
        *reinterpret_cast<const int4*>(base + (2 * k + 1) * static_cast<size_t>(plane) + i);
    v[0].w[k] = static_cast<uint32_t>(lo.x) | static_cast<uint32_t>(hi.x) << 16;
    v[1].w[k] = static_cast<uint32_t>(lo.y) | static_cast<uint32_t>(hi.y) << 16;
    v[2].w[k] = static_cast<uint32_t>(lo.z) | static_cast<uint32_t>(hi.z) << 16;
    v[3].w[k] = static_cast<uint32_t>(lo.w) | static_cast<uint32_t>(hi.w) << 16;
  }
}

template <int N>
__device__ __forceinline__ void store4_planes(int32_t* __restrict__ base, uint32_t plane,
                                              uint32_t i, const FeN<N>* v) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    auto lo16 = [&](int e) { return static_cast<int32_t>(v[e].w[k] & 0xFFFFu); };
    auto hi16 = [&](int e) { return static_cast<int32_t>(v[e].w[k] >> 16); };
    *reinterpret_cast<int4*>(base + (2 * k) * static_cast<size_t>(plane) + i) =
        make_int4(lo16(0), lo16(1), lo16(2), lo16(3));
    *reinterpret_cast<int4*>(base + (2 * k + 1) * static_cast<size_t>(plane) + i) =
        make_int4(hi16(0), hi16(1), hi16(2), hi16(3));
  }
}

// x / d, by a shift where d = 2^ld (ld >= 0)
__device__ __forceinline__ uint32_t div_by(uint32_t x, uint32_t d, int ld) {
  return ld >= 0 ? x >> ld : x / d;
}

// i with a 0 put in at bit b
__device__ __forceinline__ uint32_t insert0(uint32_t i, int b) {
  return (i >> b) << (b + 1) | (i & ((1u << b) - 1));
}

// The shared-memory slot (16 bytes) of tile index i.  A quarter warp's
// eight 16-byte accesses are one wavefront when their slots differ in the
// low three bits.  The swizzle XORs those bits with 7 times bit 3 of i and
// with the 3-bit pieces of i >> 4 folded together, so that any three
// neighbouring bits of i from bit 1 up land on three independent patterns:
// the slots of eight indices that differ in those bits (a stage's pairs
// across bit lw + bb, the last stage's reads at bit-reversed t or along
// the blocks) all differ.  A bijection on any power-of-two range from 8 up.
__device__ __forceinline__ uint32_t tile_slot(uint32_t i) {
  const uint32_t z = i >> 4;
  return i ^ (((i >> 3) & 1) * 7) ^ ((z ^ (z >> 3) ^ (z >> 6)) & 7);
}

__device__ __forceinline__ uint4 fe_pack(const FeN<4>& a) {
  return make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
}

__device__ __forceinline__ FeN<4> fe_unpack(const uint4& s) {
  FeN<4> a;
  a.w[0] = s.x;
  a.w[1] = s.y;
  a.w[2] = s.z;
  a.w[3] = s.w;
  return a;
}

// (u, v) <- (u + v, (u - v) w); no product where `unit` (w = R mod p at
// position 0: the product would leave u - v as it is).
__device__ __forceinline__ void stockham_pair(FeN<4>& u, FeN<4>& v, const FeN<4>& w, bool unit,
                                              const FieldConstsN<4>& c) {
  const FeN<4> d = myzkp::fe_sub_cc(u, v, c);
  u = myzkp::fe_add_cc(u, v, c);
  if (unit)
    v = d;
  else
    v = myzkp::fe_mul_cc(d, w, c);
}

// Two stages on the four elements e[0..3] at in-place positions t, t + h,
// t + 2h, t + 3h (h = 2^(bb - 1), bit bb - 1 and bb of t clear): stage bb
// pairs (0, 2) and (1, 3) with twiddles w0, w1, stage bb - 1 pairs (0, 1)
// and (2, 3), both with w2.
__device__ __forceinline__ void stockham_quad(FeN<4> (&e)[4], const FeN<4>& w0, bool unit0,
                                              const FeN<4>& w1, const FeN<4>& w2, bool unit2,
                                              const FieldConstsN<4>& c) {
  stockham_pair(e[0], e[2], w0, unit0, c);
  stockham_pair(e[1], e[3], w1, false, c);
  stockham_pair(e[0], e[1], w2, unit2, c);
  stockham_pair(e[2], e[3], w2, unit2, c);
}

// One tile a block: tile index i = q 2^(ls + lw) + t 2^lw + jl holds
// element t of column jb0 + jl of block rk0 + q, its group's position t in
// the in-place DIF order (stage bb pairs t and t + 2^bb, twiddle position
// j + (t mod 2^bb) hq in the stage row of half-width 2^bb hq).  The tile
// comes in along memory (index order is memory order along jb, and along
// the whole tile where W = hq B), so a warp's loads take whole sectors.  A
// thread runs P pairs a stage, as P / 2 quads (two stages in registers, one
// barrier) where P is even; the last step reads the tile in output order (t
// = bitreverse(t')), runs the last one or two stages in registers and
// stores along the output.  Elements past the ragged edge (rows past R Bk,
// columns past hq B) are zeros that no product or store touches.
template <int P>
__global__ void __launch_bounds__(myzkp_stockham::kThreadsMax)
    stockham_l8_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ tw,
                       int32_t* __restrict__ out, StockhamPass a, FieldConstsN<4> c) {
  using F = FeN<4>;
  constexpr bool kQuad = P % 2 == 0;
  constexpr int G = kQuad ? P / 2 : P;  // a thread's units: four elements each, or two
  constexpr int PU = kQuad ? 2 : 1;     // pairs a unit in a one-stage step
  extern __shared__ uint4 k5_sm[];
  const int ls = a.ls, lw = a.lw, lt = a.ls + a.lw;
  const uint32_t E = 1u << ls, W = 1u << lw, T = blockDim.x;
  uint4* const xs = k5_sm;  // the tile: 2^(lt + lq) slots (tile_slot)
  uint4* const ts = k5_sm + (1u << (lt + a.lq));  // stage row bb: (2^bb - 1 + u) W + jl
  uint4* const ys = ts + ((E - 1) << lw);  // the output tile, in the output's order
  const uint32_t tr = div_by(blockIdx.x, a.tiles_j, a.ltj);
  const uint32_t rk0 = tr << a.lq, jb0 = (blockIdx.x - tr * a.tiles_j) << lw;
  const uint32_t r0 = div_by(rk0, a.Bk, a.lbk), k0 = rk0 - r0 * a.Bk;
  const uint32_t rows_left = a.rows - rk0, cols_left = a.inner - jb0;
  auto live = [&](uint32_t i) { return (i >> lt) < rows_left && (i & (W - 1)) < cols_left; };
  auto col_j = [&](uint32_t jl) { return a.B == 1 ? jb0 + jl : (jb0 + jl) / a.B; };
  auto at_zero = [&](uint32_t jl) { return jb0 + jl < a.B; };  // j = 0
  auto in_at = [&](uint32_t i) {
    const uint32_t q = i >> lt, t = (i >> lw) & (E - 1), jl = i & (W - 1);
    return ((rk0 + q) * E + t) * a.inner + jb0 + jl;
  };
  auto out_at = [&](uint32_t q, uint32_t t, uint32_t jl) {
    const uint32_t r = r0 + (q >> a.lkq), k = k0 + (q & ((1u << a.lkq) - 1));
    return ((r * E + t) * a.Bk + k) * a.inner + jb0 + jl;
  };
  auto tw_staged = [&](int bb, uint32_t u, uint32_t jl) {
    return fe_unpack(ts[((1u << bb) - 1 + u) << lw | jl]);
  };
  auto get = [&](uint32_t i) { return fe_unpack(xs[tile_slot(i)]); };
  auto put = [&](uint32_t i, const F& v) { xs[tile_slot(i)] = fe_pack(v); };

  // the tile in the order of memory (runs of W along jb, or the whole tile
  // where W = hq B), packed into four words as it lands, and every stage
  // row's entries of the tile's columns ((2^ls - 1) W: fewer than the
  // tile's 2 P T elements) beside it.  Every load is issued before the
  // first store to shared memory: an element past the edge reads element
  // 0 and is zeroed, an entry past the edge entry 0.
  const uint32_t staged = (E - 1) << lw;
  F v[2 * P], wv[2 * P];
  // with vec, thread element n is tile index 4 (tid + (n / 4) T) + n % 4:
  // runs of 4 in memory, all live or all past the edge
  auto elem = [&](int n) {
    return a.vec ? 4 * (threadIdx.x + (n / 4) * T) + n % 4 : threadIdx.x + n * T;
  };
  if constexpr (P >= 2) {
    if (a.vec) {
#pragma unroll
      for (int n = 0; n < 2 * P; n += 4) {
        if (live(elem(n))) load4_planes<4>(x, a.plane, in_at(elem(n)), &v[n]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 2 * P; ++n) {
    const uint32_t i = threadIdx.x + n * T, jl = i & (W - 1);
    if (!a.vec || P < 2) v[n] = myzkp::load_planes<4>(x, a.plane, live(i) ? in_at(i) : 0);
    wv[n] = myzkp::fe_zero<4>();
    if (i < staged && jl < cols_left) {
      const uint32_t g = (i >> lw) + 1;
      const int bb = 31 - __clz(g);  // the row of half-width 2^bb hq
      wv[n] = myzkp::load_planes<4>(
          tw, a.ntw, (E - (2u << bb)) * a.hq + col_j(jl) + (g - (1u << bb)) * a.hq);
    }
  }
#pragma unroll
  for (int n = 0; n < 2 * P; ++n) {
    const uint32_t i = threadIdx.x + n * T;
    put(elem(n), live(elem(n)) ? v[n] : myzkp::fe_zero<4>());
    if (i < staged) ts[i] = fe_pack(wv[n]);
  }
  __syncthreads();

  F e[G][4];
  uint32_t at[G];  // each quad's first tile index
  int bb = ls - 1;  // the next stage to run
  // the middle steps, on the tile: quads while two stages lie above the
  // last step's, then single stages
  const int last = kQuad && ls >= 2 ? 2 : 1;  // stages of the last step (Tile::last)
  while (bb >= last) {
    if (kQuad && bb - 1 >= last) {
      const int hi = lw + bb;
#pragma unroll
      for (int n = 0; n < G; ++n) {
        const uint32_t i0 = insert0(insert0(threadIdx.x + n * T, hi - 1), hi);
        const uint32_t h = 1u << (hi - 1), jl = i0 & (W - 1);
        const uint32_t u = (i0 >> lw) & ((1u << bb) - 1);
        at[n] = i0;
        e[n][0] = get(i0);
        e[n][1] = get(i0 + h);
        e[n][2] = get(i0 + 2 * h);
        e[n][3] = get(i0 + 3 * h);
        const F w0 = tw_staged(bb, u, jl), w1 = tw_staged(bb, u + (1u << (bb - 1)), jl);
        const F w2 = tw_staged(bb - 1, u, jl);
        const bool dead = !live(i0), zero = u == 0 && at_zero(jl);
        stockham_quad(e[n], w0, dead || (zero && fe_is_one(w0, c)), w1, w2,
                      dead || (zero && fe_is_one(w2, c)), c);
      }
#pragma unroll
      for (int n = 0; n < G; ++n) {
        const uint32_t h = 1u << (hi - 1);
#pragma unroll
        for (int d = 0; d < 4; ++d) put(at[n] + d * h, e[n][d]);
      }
      bb -= 2;
    } else {
      const int bit = lw + bb;
      // a thread's G quads' worth of elements as 2 G pairs
#pragma unroll
      for (int n = 0; n < G; ++n) {
#pragma unroll
        for (int d = 0; d < PU; ++d) {
          const uint32_t i0 = insert0(threadIdx.x + (n * PU + d) * T, bit);
          const uint32_t jl = i0 & (W - 1), u = (i0 >> lw) & ((1u << bb) - 1);
          F& lo = e[n][2 * d];
          F& hi = e[n][2 * d + 1];
          lo = get(i0);
          hi = get(i0 + (1u << bit));
          const F w = tw_staged(bb, u, jl);
          stockham_pair(lo, hi, w, !live(i0) || (u == 0 && at_zero(jl) && fe_is_one(w, c)), c);
          put(i0, lo);
          put(i0 + (1u << bit), hi);
        }
      }
      bb -= 1;
    }
    __syncthreads();
  }

  // the last step (stages last - 1 ... 0), read in the order of the output:
  // h = ((rq (E / 2^last) + t') Kq + kq) W + jl takes the in-place
  // positions t ... t + 2^last - 1, t = bitreverse(t'), bound for t' + {0,
  // E/2} (one stage) or t' + {0, E/2, E/4, 3E/4} (two); with staged_out, to
  // the output tile at ((rq E + t') Kq + kq) W + jl, then out along memory
  const int lkq = a.lkq;
  auto emit = [&](uint32_t q, uint32_t t, uint32_t jl, const F& v, bool ok) {
    if (a.staged_out) {
      const uint32_t kq = q & ((1u << lkq) - 1), rq = q >> lkq;
      ys[tile_slot(((rq * E + t) << lkq | kq) << lw | jl)] = fe_pack(v);
    } else if (ok) {
      myzkp::store_planes(out, a.plane, out_at(q, t, jl), v);
    }
  };
#pragma unroll
  for (int n = 0; n < G; ++n) {
#pragma unroll
    for (int d = 0; d < (last == 1 ? PU : 1); ++d) {
      const uint32_t hh = threadIdx.x + (n * (last == 1 ? PU : 1) + d) * T;
      const uint32_t jl = hh & (W - 1), kq = (hh >> lw) & ((1u << lkq) - 1);
      const uint32_t t2 = (hh >> (lw + lkq)) & ((E >> last) - 1);
      const uint32_t q = (hh >> (lw + lkq + ls - last)) << lkq | kq;
      const uint32_t i0 = q << lt | (__brev(t2) >> (32 - ls)) << lw | jl;
      const bool ok = live(i0);
      if (last == 2) {
        F v[4] = {get(i0), get(i0 + W), get(i0 + 2 * W), get(i0 + 3 * W)};
        const F w0 = tw_staged(1, 0, jl), w1 = tw_staged(1, 1, jl), w2 = tw_staged(0, 0, jl);
        const bool zero = at_zero(jl);
        stockham_quad(v, w0, !ok || (zero && fe_is_one(w0, c)), w1, w2,
                      !ok || (zero && fe_is_one(w2, c)), c);
        emit(q, t2, jl, v[0], ok);
        emit(q, t2 + E / 2, jl, v[1], ok);
        emit(q, t2 + E / 4, jl, v[2], ok);
        emit(q, t2 + 3 * E / 4, jl, v[3], ok);
      } else {
        F u = get(i0), v = get(i0 + W);
        const F w = tw_staged(0, 0, jl);
        stockham_pair(u, v, w, !ok || (at_zero(jl) && fe_is_one(w, c)), c);
        emit(q, t2, jl, u, ok);
        emit(q, t2 + E / 2, jl, v, ok);
      }
    }
  }
  if (a.staged_out) {  // the output tile is one run of memory from (q, t, jl) = 0
    __syncthreads();
    const uint32_t base = out_at(0, 0, 0);
    auto row_of = [&](uint32_t o) {
      return (o >> (lw + lkq + ls)) << lkq | ((o >> lw) & ((1u << lkq) - 1));
    };
    if constexpr (P >= 2) {
      if (a.vec) {
#pragma unroll
        for (int n = 0; n < 2 * P; n += 4) {
          const uint32_t o = elem(n);
          const F quad[4] = {fe_unpack(ys[tile_slot(o)]), fe_unpack(ys[tile_slot(o + 1)]),
                             fe_unpack(ys[tile_slot(o + 2)]), fe_unpack(ys[tile_slot(o + 3)])};
          if (base + o < a.plane) store4_planes<4>(out, a.plane, base + o, quad);
        }
        return;
      }
    }
#pragma unroll
    for (int n = 0; n < 2 * P; ++n) {
      const uint32_t o = threadIdx.x + n * T;
      if (row_of(o) < rows_left)
        myzkp::store_planes(out, a.plane, base + o, fe_unpack(ys[tile_slot(o)]));
    }
  }
}

// The kernel's view of a pass of `stages` stages on x (R, Bk, c, B) cut
// into tiles t.
// `aligned`: x and out lie on 16-byte boundaries, so 16-byte pieces of
// four elements a plane can be read where the tile's columns run in fours.
StockhamPass stockham_pass(int64_t R, int64_t Bk, int64_t c, int64_t B,
                           const myzkp_stockham::Tile& t, bool aligned) {
  const int64_t hq = c >> t.ls, inner = hq * B, plane = R * Bk * c * B;
  auto log2_or = [](int64_t v) {
    return myzkp_stockham::pow2(v) ? myzkp_stockham::floor_log2(v) : -1;
  };
  const int64_t W = int64_t{1} << t.lw;
  const bool vec = aligned && t.pairs >= 2 && plane % 4 == 0 &&
                   (W == inner || (W >= 4 && inner % 4 == 0));
  return {static_cast<uint32_t>(R * Bk), static_cast<uint32_t>(Bk),
          static_cast<uint32_t>(hq * B), static_cast<uint32_t>(hq),
          static_cast<uint32_t>(B),      static_cast<uint32_t>(R * Bk * c * B),
          static_cast<uint32_t>(c - hq), static_cast<uint32_t>(t.tiles_j),
          log2_or(Bk),                   log2_or(t.tiles_j),
          t.ls,                          t.lw,
          t.lq,                          t.lkq,
          t.staged_out,                  vec};
}

template <int P>
int launch_stockham_l8(const int32_t* x, const int32_t* tw, int32_t* out, const StockhamPass& a,
                       const myzkp_stockham::Tile& t, const FieldConstsN<4>& c,
                       cudaStream_t stream) {
  if (t.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stockham_l8_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, t.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  stockham_l8_kernel<P><<<static_cast<unsigned>(t.tiles), t.threads, t.smem, stream>>>(
      x, tw, out, a, c);
  return static_cast<int>(cudaGetLastError());
}

// The tiles of a four-word pass on the current card, or an error for a
// pass the kernel does not take.
int stockham_l8_tile(int64_t R, int64_t Bk, int64_t c, int64_t B, int stages,
                     myzkp_stockham::Tile* t) {
  if (R < 0 || Bk < 1 || B < 1 || stages < 1 || stages > myzkp_stockham::kMaxStages ||
      c % (int64_t{1} << stages) != 0 || R * Bk * c * B >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  *t = myzkp_stockham::plan_tile(R, Bk, c, B, stages, sms);
  return 0;
}

int butterfly_l8_pass(const int32_t* x, const int32_t* tw, int32_t* out, int64_t R, int64_t Bk,
                      int64_t c, int64_t B, int stages, const FieldConstsN<4>& consts,
                      void* stream) {
  myzkp_stockham::Tile t;
  const int err = stockham_l8_tile(R, Bk, c, B, stages, &t);
  if (err != 0) return err;
  if (t.tiles == 0)  // a pass with elements always has a tile (plan_tile)
    return R * Bk * c * B == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const StockhamPass a = stockham_pass(R, Bk, c, B, t, aligned);
  auto s = static_cast<cudaStream_t>(stream);
  switch (t.pairs) {
    case 1: return launch_stockham_l8<1>(x, tw, out, a, t, consts, s);
    case 2: return launch_stockham_l8<2>(x, tw, out, a, t, consts, s);
    case 4: return launch_stockham_l8<4>(x, tw, out, a, t, consts, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

#ifndef MYZKP_K6_L8_SMALL
#define MYZKP_K6_L8_SMALL 2
#endif

// K6 at four words (M128).  Bound: device memory, 32 B an element each way
// (the top leaf of the prove's 2^20-point transforms, (1, 128, 8192): 0.0200
// ms), against 68 multiply-adds a product.  BN254's design above, one tile a
// block in one wave, ran every block's loads, then its stages, then its
// stores in lockstep: on the H100, 30 us of memory phases alone (its first
// stage only) against 25 us for a copy of the input, then 25 us more of
// stages (0.0557 ms, 36%; unroll_sweep.py leaf8).  Design: a persistent grid of
// the blocks that fit the card (the occupancy query), each walking the
// tiles blockIdx.x, blockIdx.x + gridDim.x, ...; once a tile's raw limb
// planes are in registers, the next tile's are on their way into shared
// memory with cp.async (16-byte pieces where B and the pointer allow, else
// 4-byte) while this tile's stages run.  A block is T threads of R = 8
// elements (R = m below 8), so a tile is T R elements whatever m: C = T R /
// m columns of B (16 at m = 128 and T = 256: 64 B of each limb plane a
// row).  Shared memory: the twiddles, one tile of raw limb planes (32 B an
// element) and one exchange area of packed words (16 B an element), 98 KB
// at T = 256: two blocks an SM.  T = 256 where the leaf has at least
// MYZKP_K6_L8_SMALL such tiles an SM (the top leaves), else T = 128: the
// prove's small leaves (2^16-2^17 elements, about 10 us each, mostly
// latency) run faster on twice the blocks of half the tile.  The stages are
// BN254's (three in registers a pass, the groups bit-reversed after the
// first pass, the rows folded onto distinct banks), with C a run-time value.
constexpr int kL8Small = MYZKP_K6_L8_SMALL;

// Shared words of a block of T threads: the twiddles (4 word planes of
// kMaxLeaf), a tile of 8 int32 limb planes and an exchange area of 4 word
// planes.
__host__ __device__ constexpr int leaf_l8_smem_words(int R, int T) {
  return 4 * kMaxLeaf + 12 * T * R;
}

template <int R, int T>
__global__ void __launch_bounds__(T)
    ntt_leaf_l8_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ tw,
                       int32_t* __restrict__ out, int64_t tiles_e, int64_t tiles, int logm,
                       int stages, int64_t B, int64_t plane, int vec, FieldConstsN<4> c) {
  constexpr int N = 4, K = __builtin_ctz(R);
  constexpr int n_el = T * R;  // elements a tile
  extern __shared__ uint32_t sm[];
  uint32_t* const smt = sm;  // word k of twiddle t at smt[k * kMaxLeaf + t]
  uint32_t* const raw = sm + N * kMaxLeaf;  // limb k of (row, col) at [(k m + row) C + col]
  uint32_t* const smx = raw + 2 * N * n_el;  // word k of (row, col) at [k n_el + srow C + col]
  const int m = 1 << logm;
  const int lc = __builtin_ctz(T) + K - logm;  // log2 C
  const int C = 1 << lc;
  const int wbits = lc < 5 ? 5 - lc : 0;  // thread groups a warp spans: 2^wbits
  const int col = threadIdx.x & (C - 1), g0 = threadIdx.x >> lc, gbits = logm - K;
  const int g_rev = gbits > 0 ? static_cast<int>(__brev(g0) >> (32 - gbits)) : g0;
  auto srow = [&](int row) {
    const int s = logm - wbits;
    return wbits == 0 || s < wbits ? row : row ^ ((row >> s) & ((1 << wbits) - 1));
  };
  // the raw limb planes of tile t into raw[]: a thread's pieces in turn
  auto fetch = [&](int64_t t) {
    const int64_t col0 = (t % tiles_e) << lc;
    const int64_t base = (t / tiles_e) * m * B + col0;
    const int64_t cols = min(int64_t{C}, B - col0);
    if (vec) {  // 16-byte pieces: B and x line up
      for (int q = threadIdx.x; q < 2 * N * n_el / 4; q += T) {
        const int kr = q >> (lc - 2), c4 = (q & ((C >> 2) - 1)) << 2;
        if (c4 < cols)
          myzkp::cp_async16(raw + (kr << lc) + c4,
                            x + (kr >> logm) * plane + base + (kr & (m - 1)) * B + c4);
      }
    } else {
      for (int q = threadIdx.x; q < 2 * N * n_el; q += T) {
        const int kr = q >> lc, cc = q & (C - 1);
        if (cc < cols)
          myzkp::cp_async4(raw + q, x + (kr >> logm) * plane + base + (kr & (m - 1)) * B + cc);
      }
    }
    myzkp::cp_async_commit();
  };

  for (int t = threadIdx.x; t < m - 1; t += T)
    smem_store(smt, kMaxLeaf, t, myzkp::load_planes<N>(tw, m - 1, t));
  int64_t tile = blockIdx.x;
  if (tile < tiles) fetch(tile);
  unsigned unit = 0;
  const int last = logm - stages;
  for (; tile < tiles; tile += gridDim.x) {
    myzkp::cp_async_wait<0>();  // this thread's pieces of the tile have landed
    __syncthreads();            // and every thread's (and the twiddles)
    if (tile == blockIdx.x) {
      // bit b: the stage row of half-width 2^b starts with 1, so its j = 0
      // products are skipped
      for (int b = 0; b < logm; ++b) {
        bool one = true;
#pragma unroll
        for (int k = 0; k < N; ++k) one &= smt[k * kMaxLeaf + m - (2 << b)] == c.one[k];
        unit |= static_cast<unsigned>(one) << b;
      }
    }
    const int64_t col0 = (tile % tiles_e) << lc;
    const int64_t base = (tile / tiles_e) * m * B + col0;
    const bool live = col0 + col < B;
    int lo = logm - K, g = g0;
    FeN<N> v[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = leaf_pos<R>(g, i, lo);
#pragma unroll
      for (int k = 0; k < N; ++k)
        v[i].w[k] = raw[((2 * k * m + row) << lc) + col] |
                    (raw[(((2 * k + 1) * m + row) << lc) + col] << 16);
    }
    // every raw read done (and every exchange read of the last tile): the
    // next tile's pieces go out
    __syncthreads();
    if (tile + gridDim.x < tiles) fetch(tile + gridDim.x);
    // bits logm - 1 .. last are the stages to run; bits >= top are done
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
                      : myzkp::fe_mul_cc(d, smem_load<N>(smt, kMaxLeaf, off + j), c);
        }
      }
      top = lo;
      if (top <= last) break;
      // the next pass: write this pass's elements, read the next one's
      if (lo + K < logm) __syncthreads();  // every read of the last exchange done
#pragma unroll
      for (int i = 0; i < R; ++i)
        smem_store(smx, n_el, (srow(leaf_pos<R>(g, i, lo)) << lc) + col, v[i]);
      __syncthreads();
      lo = max(lo - K, 0);
      g = g_rev;
#pragma unroll
      for (int i = 0; i < R; ++i)
        v[i] = smem_load<N>(smx, n_el, (srow(leaf_pos<R>(g, i, lo)) << lc) + col);
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int pos = leaf_pos<R>(g, i, lo);
        const int low = pos & ((1 << last) - 1);
        const int row = static_cast<int>(__brev(static_cast<unsigned>(pos >> last)) >>
                                         (32 - stages)) << last | low;
        myzkp::store_planes(out, plane, base + int64_t{row} * B + col, v[i]);
      }
    }
  }
}

template <int R, int T>
int launch_leaf_l8_at(const int32_t* x, const int32_t* tw, int32_t* out, int64_t E, int logm,
                      int stages, int64_t B, int64_t tiles_e, int sms,
                      const FieldConstsN<4>& c, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(uint32_t) * leaf_l8_smem_words(R, T));
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(ntt_leaf_l8_kernel<R, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ntt_leaf_l8_kernel<R, T>, T,
                                                        smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = E * tiles_e;
  const int64_t blocks = std::min<int64_t>(tiles, int64_t{sms} * std::max(per_sm, 1));
  const int vec = B % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  ntt_leaf_l8_kernel<R, T><<<static_cast<unsigned>(blocks), T, smem, stream>>>(
      x, tw, out, tiles_e, tiles, logm, stages, B, E * (int64_t{1} << logm) * B, vec, c);
  return static_cast<int>(cudaGetLastError());
}

// The block size by the count of 256-thread tiles (kL8Small above).
template <int R>
int launch_leaf_l8(const int32_t* x, const int32_t* tw, int32_t* out, int64_t E, int logm,
                   int stages, int64_t B, const FieldConstsN<4>& c, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t cols = 256 * R >> logm;  // C at T = 256
  const int64_t tiles_e = (B + cols - 1) / cols;
  if (E * tiles_e >= int64_t{kL8Small} * sms)
    return launch_leaf_l8_at<R, 256>(x, tw, out, E, logm, stages, B, tiles_e, sms, c, stream);
  return launch_leaf_l8_at<R, 128>(x, tw, out, E, logm, stages, B, (B + cols / 2 - 1) / (cols / 2),
                                   sms, c, stream);
}

// BN254's instance (N = 8).
template <int R, int N>
int launch_leaf(const int32_t* x, const int32_t* tw, int32_t* out, int64_t E,
                int logm, int stages, int64_t B, const FieldConstsN<N>& c,
                cudaStream_t stream) {
  const int m = 1 << logm;
  auto smem_of = [](int rows) {
    return sizeof(uint32_t) * N * (kMaxLeaf + rows * kCols);
  };
  auto kernel = ntt_leaf_kernel<R>;
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

int butterfly_pass(const int32_t* x, const int32_t* tw, int32_t* out, int64_t R,
                   int64_t Bk, int64_t c, int64_t B, int stages,
                   const FieldConsts& consts, void* stream) {
  if (stages < 1 || (1 << stages) > kK5Radix || c % (int64_t{1} << stages) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_butterfly<kK5Radix>(x, tw, out, R, Bk, c >> stages, B, stages, consts,
                                    static_cast<cudaStream_t>(stream));
}

template <int N>
int leaf(const int32_t* x, const int32_t* tw, int32_t* out, int64_t E, int m,
         int stages, int64_t B, const FieldConstsN<N>& consts, void* stream) {
  if (m < 2 || m > kMaxLeaf || (m & (m - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int logm = __builtin_ctz(static_cast<unsigned>(m));
  if (stages < 1 || stages > logm) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if constexpr (N == myzkp::kWords) {
    if (m == 2) return launch_leaf<2, N>(x, tw, out, E, logm, stages, B, consts, s);
    if (kRadix == 8 && m == 4)
      return launch_leaf<4, N>(x, tw, out, E, logm, stages, B, consts, s);
    return launch_leaf<kRadix, N>(x, tw, out, E, logm, stages, B, consts, s);
  } else {
    if (m == 2) return launch_leaf_l8<2>(x, tw, out, E, logm, stages, B, consts, s);
    if (m == 4) return launch_leaf_l8<4>(x, tw, out, E, logm, stages, B, consts, s);
    return launch_leaf_l8<8>(x, tw, out, E, logm, stages, B, consts, s);
  }
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
// 2^stages divides c, and 1 <= stages <= log2 MYZKP_K5_RADIX (BN254) or
// myzkp_stockham::kMaxStages = 10 (M128); hq B below 2^31.
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
  return butterfly_l8_pass(x, tw, out, R, Bk, c, B, stages, *consts, stream);
}

// The four-word pass's tiles on the current card, without launching: out
// [stages, lw, lq, lkq, threads, pairs, tiles_j, tiles, smem] (stockham_plan.cuh).
extern "C" int myzkp_butterfly_l8_plan(int64_t R, int64_t Bk, int64_t c, int64_t B,
                                       int64_t stages, int64_t* out) {
  myzkp_stockham::Tile t;
  const int err = stockham_l8_tile(R, Bk, c, B, static_cast<int>(stages), &t);
  if (err != 0) return err;
  const int64_t v[] = {t.ls, t.lw, t.lq, t.lkq, t.threads, t.pairs, t.tiles_j, t.tiles, t.smem};
  std::copy(v, v + 9, out);
  return 0;
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
