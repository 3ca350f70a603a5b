// K17: polynomial long division a = q b + r over limb planes, one launch a
// batch of rows.
//
// Replaces the reference's long division (myzkp_tpu/ops/poly.py:229-261,
// _divmod_kernel: a lax.scan of na - bd steps, each one Montgomery product
// and one subtraction on a bd-wide window, jit-compiled onto the device).
// The STARK's remainder tree (ops/ntt.py _fast_evaluate_pow2) divides 2^(16-k)
// residues of 2^(k+1) coefficients by nodes of degree 2^k (k = 15 ... 0), and
// its boundary quotient 65,536 coefficients by a quadratic.  The plain
// version's step k takes pos = na - 1 - k, c = rem[pos] * inv(b[bd]), q[pos -
// bd] = c and rem[pos - bd + j] -= c b[j] for j < bd.  Field arithmetic is
// exact and every result canonical, so any order of the same sums gives the
// plain version's integers: the wrapper passes inv(b[bd]) (inv(0) = 0 gives q
// = 0 and r = a's low bd coefficients) and the kernels below reorganise the
// steps three ways, chosen by the launcher from (rows, na, bd) and the card's
// SM count and shared memory a block (div_plan.cuh's plan_division, which
// states every threshold).
//
// Bound on the H100.  The work is (na - bd) bd products a row, about 2^32 at
// M128 over a prove's 17 launches; the steps are a chain, so a row is also
// bound by its critical path.  The parent kernel paid one cluster barrier and
// two L2 round trips a step (rem lived in a global scratch), ran the top
// levels on 16 and 32 of 132 SMs and the boundary quotient on one warp:
// 478.78 ms a prove.
//
// 1. Blocks of B quotient coefficients a barrier (the tree, bd > NARROW;
//    div_block_kernel).  Once a row, u = the first B coefficients of
//    1 / rev(b): u_0 = inv, u_k = sum_{j=1..k} beta_j u_(k-j) with beta_j =
//    -inv b[bd - j] (0 past bd), on one warp.  Then a block of Bs <= B
//    coefficients is, with t_l = rem[P - l] final after the earlier blocks,
//    c_i = sum_{l <= i} u_(i-l) t_l (lanes independent, four a coefficient),
//    and every position x of [P - Bs - bd + 1, P - Bs] takes rem[x] -=
//    sum_i c_i b[x - P + i + bd]: Bs independent products a position.  One
//    row barrier a block instead of one a step.  Every block of a row solves
//    the block's c itself (B^2 / 2 products against its share of the bd B of
//    the update), so nothing but the tops crosses the row.  Both sums are
//    reduced once (WideSum): the products of u and c scaled by 2^32 are added
//    as 2N-word integers, 2 N^2 multiply-adds each, and the sum takes N + 1
//    Montgomery rounds, (N + 1) 2N multiply-adds for up to B products.
// 2. The window on chip.  rem is read from a once and written to r once; in
//    between it lives in shared memory, spread over the row's G blocks in
//    segments of 32 positions (segment g on block g mod G, on warp (g / G)
//    mod W, slot g / (G W)), so that every block and warp holds about the
//    same share of each step's window.  A warp updates 32 consecutive
//    positions: it stages the 32 + Bs - 1 coefficients of b that they need
//    in shared memory (coalesced loads) and each lane runs over the block's
//    c.  With G = 1 the tops are read from the block's own shared memory
//    after __syncthreads.  With G >= 2 the row's blocks are a cooperative
//    grid (all resident: the launcher takes the rows SMs / G at a time), the
//    tops cross it through a small global buffer and one row barrier (an
//    atomic counter a row) a block of coefficients.  On the H100 that grid
//    ran a block of coefficients in half the time of clusters of 4 and 8
//    with the tops through distributed shared memory, and in a third of a
//    cluster of 16's (PERF.md, row 17's findings).  A row longer than the
//    blocks' shared memory holds (past about 1.6M coefficients at M128,
//    0.65M at BN254, on 132 SMs) keeps its window in global scratch instead,
//    each slot read and written by its own thread (the tops, at G = 1, by
//    its block after __syncthreads).
// 3. Narrow divisors (bd <= NARROW).  The division is a linear recurrence of
//    order bd: a step is c = w_0 inv and the window w (rem at pos ... pos -
//    bd + 1) takes w_m <- w_(m+1) - w_0 gamma_m, gamma_m = inv b[bd - 1 -
//    m], one product deep.  A short one runs on one thread a row
//    (div_rows_kernel).  A long one (the boundary quotient, 65,534 steps) is
//    cut into P chunks of Lc steps, one thread each (div_chunks_kernel): each
//    runs from its own a-window (zero corrections), bd more threads run a
//    chunk from the unit windows with zero input (the responses H, the same
//    for every full chunk), one warp scans the corrections chunk to chunk
//    (delta_(k+1) = omega_k + H delta_k, omega_k the chunk's own outgoing
//    correction), and every chunk runs again from its true window and writes
//    q (the last one r).  Depth about 2 Lc + P against na - bd; Lc grows
//    past sqrt(na - bd) where omega and delta of more chunks would not fit
//    in shared memory.
//
// Every other product is myzkp::fe_mul_cc over FeN<N> (M128's wide CIOS with
// its carry word, p > R / 2; BN254's even / odd accumulators); the reduced-once
// sums keep p > R / 2 in their bounds (WideSum).  Shared memory holds an
// element as N / 4 16-byte words.  Outputs are write-only.  Measured at the
// prove's 17 shapes in PERF.md (chip_smoke.py, unroll_sweep.py div).
#include <cuda_runtime.h>

#include "div_plan.cuh"
#include "field.cuh"

using myzkp::FeN;
using myzkp::FieldConsts;
using myzkp::FieldConstsN;

namespace {

using myzkp_div::kB;
using myzkp_div::kChunkThreads;
using myzkp_div::kNarrow;
using myzkp_div::kThreads;

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

template <int N>
__device__ __forceinline__ FeN<N> mul(const FeN<N>& a, const FeN<N>& b,
                                      const FieldConstsN<N>& c) {
  return myzkp::fe_mul_cc(a, b, c);
}
template <int N>
__device__ __forceinline__ FeN<N> add(const FeN<N>& a, const FeN<N>& b,
                                      const FieldConstsN<N>& c) {
  return myzkp::fe_add_cc(a, b, c);
}
template <int N>
__device__ __forceinline__ FeN<N> sub(const FeN<N>& a, const FeN<N>& b,
                                      const FieldConstsN<N>& c) {
  return myzkp::fe_sub_cc(a, b, c);
}

// Element i of a shared-memory (or distributed shared-memory) array.
template <int N>
__device__ __forceinline__ FeN<N> sm_get(const uint4* s, int64_t i) {
  FeN<N> r;
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const uint4 v = s[i * (N / 4) + k];
    r.w[4 * k] = v.x;
    r.w[4 * k + 1] = v.y;
    r.w[4 * k + 2] = v.z;
    r.w[4 * k + 3] = v.w;
  }
  return r;
}

template <int N>
__device__ __forceinline__ void sm_put(uint4* s, int64_t i, const FeN<N>& a) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    s[i * (N / 4) + k] = make_uint4(a.w[4 * k], a.w[4 * k + 1], a.w[4 * k + 2], a.w[4 * k + 3]);
}

// The same through L2 only (__ldcg / __stcg): the grid mode's tops, which
// another block wrote.
template <int N>
__device__ __forceinline__ FeN<N> cg_get(const uint4* s, int64_t i) {
  FeN<N> r;
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const uint4 v = __ldcg(s + i * (N / 4) + k);
    r.w[4 * k] = v.x;
    r.w[4 * k + 1] = v.y;
    r.w[4 * k + 2] = v.z;
    r.w[4 * k + 3] = v.w;
  }
  return r;
}

template <int N>
__device__ __forceinline__ void cg_put(uint4* s, int64_t i, const FeN<N>& a) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    __stcg(s + i * (N / 4) + k,
           make_uint4(a.w[4 * k], a.w[4 * k + 1], a.w[4 * k + 2], a.w[4 * k + 3]));
}

template <int N>
__device__ __forceinline__ FeN<N> shfl_xor(const FeN<N>& a, int m, unsigned mask = 0xffffffffu) {
  FeN<N> r;
#pragma unroll
  for (int k = 0; k < N; ++k) r.w[k] = __shfl_xor_sync(mask, a.w[k], m);
  return r;
}

template <int N>
__device__ __forceinline__ FeN<N> shfl(const FeN<N>& a, int src) {
  FeN<N> r;
#pragma unroll
  for (int k = 0; k < N; ++k) r.w[k] = __shfl_sync(0xffffffffu, a.w[k], src);
  return r;
}

// ---------------------------------------------------------------------------
// 3. Narrow divisors: the recurrence on a window in registers.
// ---------------------------------------------------------------------------

// gamma_m = inv b[bd - 1 - m] for m < d (the product a step subtracts from
// window slot m is w_0 gamma_m).
template <int N>
__device__ __forceinline__ void narrow_gammas(FeN<N> (&gamma)[kNarrow], const int32_t* b,
                                              int64_t pb, int64_t bbase, int d,
                                              const FeN<N>& inv, const FieldConstsN<N>& c) {
#pragma unroll
  for (int m = 0; m < kNarrow; ++m)
    gamma[m] = m < d ? mul(inv, myzkp::load_planes<N>(b, pb, bbase + d - 1 - m), c)
                     : myzkp::fe_zero<N>();
}

// The window at hi: w_m = a[hi - m] (m < d), or zero.
template <int N>
__device__ __forceinline__ void narrow_window(FeN<N> (&w)[kNarrow], const int32_t* a,
                                              int64_t pa, int64_t abase, int64_t hi, int d) {
#pragma unroll
  for (int m = 0; m < kNarrow; ++m)
    w[m] = m < d ? myzkp::load_planes<N>(a, pa, abase + hi - m) : myzkp::fe_zero<N>();
}

// Steps pos = hi down to lo (lo >= d) from the window w at hi; w ends as the
// window at lo - 1.  The input a is read at pos - d (zero where a is null),
// one step ahead; q, where not null, takes c at pos - d.
template <int N>
__device__ __forceinline__ void narrow_run(FeN<N> (&w)[kNarrow], const FeN<N> (&gamma)[kNarrow],
                                           const FeN<N>& inv, int d, const int32_t* a,
                                           int64_t pa, int64_t abase, int32_t* q, int64_t pq,
                                           int64_t qbase, int64_t hi, int64_t lo,
                                           const FieldConstsN<N>& c) {
  FeN<N> next = a != nullptr && hi >= lo ? myzkp::load_planes<N>(a, pa, abase + hi - d)
                                         : myzkp::fe_zero<N>();
#pragma unroll 1
  for (int64_t pos = hi; pos >= lo; --pos) {
    const FeN<N> in = next;
    if (a != nullptr && pos > lo) next = myzkp::load_planes<N>(a, pa, abase + pos - 1 - d);
    const FeN<N> top = w[0];
    if (q != nullptr) myzkp::store_planes(q, pq, qbase + pos - d, mul(top, inv, c));
#pragma unroll
    for (int m = 0; m < kNarrow; ++m) {
      if (m < d) {
        const FeN<N> src = myzkp::fe_select(m + 1 < d, w[m + 1 < kNarrow ? m + 1 : m], in);
        w[m] = sub(src, mul(top, gamma[m], c), c);
      }
    }
  }
}

// One thread a row: the whole recurrence.
template <int N>
__device__ __forceinline__ void div_rows_body(const int32_t* __restrict__ a,
                                              const int32_t* __restrict__ b,
                                              const int32_t* __restrict__ lead,
                                              int32_t* __restrict__ q, int32_t* __restrict__ r,
                                              int64_t rows, int64_t na, int64_t bd,
                                              const FieldConstsN<N>& c) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int d = static_cast<int>(bd);
  const int64_t steps = na - bd, pa = rows * na, pb = rows * (bd + 1);
  const FeN<N> inv = myzkp::load_planes<N>(lead, rows, row);
  FeN<N> gamma[kNarrow], w[kNarrow];
  narrow_gammas(gamma, b, pb, row * (bd + 1), d, inv, c);
  narrow_window(w, a, pa, row * na, na - 1, d);
  narrow_run(w, gamma, inv, d, a, pa, row * na, q, rows * steps, row * steps, na - 1, bd, c);
#pragma unroll
  for (int m = 0; m < kNarrow; ++m)
    if (m < d) myzkp::store_planes(r, rows * bd, row * bd + d - 1 - m, w[m]);
}

// One block a row: P chunks of Lc steps (the last one shorter) and d
// response threads.  Shared memory: omega (P x d), delta (P x d), H (d x d).
template <int N>
__device__ __forceinline__ void div_chunks_body(const int32_t* __restrict__ a,
                                                const int32_t* __restrict__ b,
                                                const int32_t* __restrict__ lead,
                                                int32_t* __restrict__ q,
                                                int32_t* __restrict__ r, int64_t rows,
                                                int64_t na, int64_t bd, int Lc, int P,
                                                const FieldConstsN<N>& c) {
  extern __shared__ uint4 sm[];
  const int d = static_cast<int>(bd);
  uint4* omega = sm;
  uint4* delta = omega + static_cast<int64_t>(P) * d * (N / 4);
  uint4* H = delta + static_cast<int64_t>(P) * d * (N / 4);
  const int64_t row = blockIdx.x, steps = na - bd, pa = rows * na, pb = rows * (bd + 1);
  const int64_t abase = row * na, pq = rows * steps, qbase = row * steps;
  const int tid = threadIdx.x;
  const FeN<N> inv = myzkp::load_planes<N>(lead, rows, row);
  FeN<N> gamma[kNarrow], w[kNarrow];
  narrow_gammas(gamma, b, pb, row * (bd + 1), d, inv, c);
  const int64_t hi = na - 1 - static_cast<int64_t>(tid) * Lc;
  const int64_t lo = tid == P - 1 ? bd : hi - Lc + 1;
  if (tid < P - 1) {  // zero corrections in: the outgoing correction omega
    narrow_window(w, a, pa, abase, hi, d);
    narrow_run(w, gamma, inv, d, a, pa, abase, static_cast<int32_t*>(nullptr), pq, qbase, hi,
               lo, c);
#pragma unroll
    for (int m = 0; m < kNarrow; ++m)
      if (m < d)
        sm_put(omega, tid * d + m,
               sub(w[m], myzkp::load_planes<N>(a, pa, abase + lo - 1 - m), c));
  } else if (tid >= P && tid < P + d) {  // the response to a unit window, zero input
#pragma unroll
    for (int m = 0; m < kNarrow; ++m)
      w[m] = m == tid - P ? myzkp::fe_one(c) : myzkp::fe_zero<N>();
    narrow_run(w, gamma, inv, d, static_cast<const int32_t*>(nullptr), pa, abase,
               static_cast<int32_t*>(nullptr), pq, qbase, bd + Lc - 1, bd, c);
#pragma unroll
    for (int m = 0; m < kNarrow; ++m)
      if (m < d) sm_put(H, (tid - P) * d + m, w[m]);
  }
  __syncthreads();
  if (tid < 32) {  // delta_0 = 0; delta_(k+1)[j] = omega_k[j] + sum_m delta_k[m] H[m][j]
    FeN<N> dj = myzkp::fe_zero<N>();
    const int j = tid < d ? tid : 0;
    if (tid < d) sm_put(delta, j, dj);
#pragma unroll 1
    for (int k = 0; k + 1 < P; ++k) {
      FeN<N> acc = sm_get<N>(omega, k * d + j);
#pragma unroll
      for (int m = 0; m < kNarrow; ++m) {
        const FeN<N> dm = shfl(dj, m);
        if (m < d) acc = add(acc, mul(dm, sm_get<N>(H, m * d + j), c), c);
      }
      dj = acc;
      if (tid < d) sm_put(delta, (k + 1) * d + j, dj);
    }
  }
  __syncthreads();
  if (tid < P) {  // again from the true window: q, and r from the last chunk
    narrow_window(w, a, pa, abase, hi, d);
#pragma unroll
    for (int m = 0; m < kNarrow; ++m)
      if (m < d) w[m] = add(w[m], sm_get<N>(delta, tid * d + m), c);
    narrow_run(w, gamma, inv, d, a, pa, abase, q, pq, qbase, hi, lo, c);
    if (tid == P - 1) {
#pragma unroll
      for (int m = 0; m < kNarrow; ++m)
        if (m < d) myzkp::store_planes(r, rows * bd, row * bd + d - 1 - m, w[m]);
    }
  }
}

// ---------------------------------------------------------------------------
// 1, 2. Blocks of coefficients, the window in shared memory.
// ---------------------------------------------------------------------------

// Sums of products reduced once (the block kernel's update and solve): a
// product is the 2N-word a b added into 2N + 2 words, each row's two carry
// chains (the low and the high halves) ending in a counter word instead of
// running to the top (2 N^2 multiply-adds and 2 N adds, against about 4 N^2
// + 12 N instructions of fe_mul_cc_wide with its reduction).  A sum of up to
// 2^10 products of canonical operands stays below 2^(64 N + 10).
template <int N>
struct WideSum {
  uint32_t t[2 * N + 2];
  uint32_t carries[N + 1];  // carries into words N .. 2N
};

template <int N>
__device__ __forceinline__ void wide_zero(WideSum<N>& s) {
#pragma unroll
  for (int k = 0; k < 2 * N + 2; ++k) s.t[k] = 0;
#pragma unroll
  for (int k = 0; k <= N; ++k) s.carries[k] = 0;
}

// s += a b.
template <int N>
__device__ __forceinline__ void wide_mac(WideSum<N>& s, const FeN<N>& a, const FeN<N>& b) {
  namespace cc = myzkp::cc;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t bi = b.w[i];
    s.t[i] = cc::mad_lo_cc(a.w[0], bi, s.t[i]);
#pragma unroll
    for (int j = 1; j < N; ++j) s.t[i + j] = cc::madc_lo_cc(a.w[j], bi, s.t[i + j]);
    s.carries[i] = cc::addc(s.carries[i], 0);  // into word i + N
    s.t[i + 1] = cc::mad_hi_cc(a.w[0], bi, s.t[i + 1]);
#pragma unroll
    for (int j = 1; j < N; ++j) s.t[i + 1 + j] = cc::madc_hi_cc(a.w[j], bi, s.t[i + 1 + j]);
    s.carries[i + 1] = cc::addc(s.carries[i + 1], 0);  // into word i + N + 1
  }
}

// The sum's value mod p, times 2^(-32 (N + 1)): the counted carries added in,
// then N + 1 rounds of Montgomery reduction (t < 2^(64 N + 10) and m p <
// p 2^(32 (N + 1)), so t + m p fits the 2N + 2 words and the result, below
// 2p, takes one conditional subtraction).  Operands scaled by 2^32 (scaled
// below) make that the sum of their Montgomery products.
template <int N>
__device__ __forceinline__ FeN<N> wide_reduce(WideSum<N>& s, const FieldConstsN<N>& c) {
  namespace cc = myzkp::cc;
  uint32_t* t = s.t;
  t[N] = cc::add_cc(t[N], s.carries[0]);
#pragma unroll
  for (int k = 1; k <= N; ++k) t[N + k] = cc::addc_cc(t[N + k], s.carries[k]);
  t[2 * N + 1] = cc::addc(t[2 * N + 1], 0);
#pragma unroll
  for (int k = 0; k <= N; ++k) {
    const uint32_t m = t[k] * c.n0;
    t[k] = cc::mad_lo_cc(m, c.p[0], t[k]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[k + j] = cc::madc_lo_cc(m, c.p[j], t[k + j]);
#pragma unroll
    for (int w = k + N; w < 2 * N + 1; ++w) t[w] = cc::addc_cc(t[w], 0);
    t[2 * N + 1] = cc::addc(t[2 * N + 1], 0);
    t[k + 1] = cc::mad_hi_cc(m, c.p[0], t[k + 1]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[k + 1 + j] = cc::madc_hi_cc(m, c.p[j], t[k + 1 + j]);
#pragma unroll
    for (int w = k + N + 1; w < 2 * N + 1; ++w) t[w] = cc::addc_cc(t[w], 0);
    if (k + N + 1 <= 2 * N + 1) t[2 * N + 1] = cc::addc(t[2 * N + 1], 0);
  }
  FeN<N> r, d;
#pragma unroll
  for (int k = 0; k < N; ++k) r.w[k] = t[N + 1 + k];
  d.w[0] = cc::sub_cc(r.w[0], c.p[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) d.w[k] = cc::subc_cc(r.w[k], c.p[k]);
  const bool keep = cc::subc(t[2 * N + 1], 0) == 0xFFFFFFFFu;  // top 0 and r < p
  return myzkp::fe_select(keep, r, d);
}

// 2^32 R mod p, the factor (as a Montgomery operand) that scales by 2^32.
template <int N>
__device__ __forceinline__ FeN<N> scale_factor(const FieldConstsN<N>& c) {
  FeN<N> x = myzkp::fe_one(c);
#pragma unroll 1
  for (int k = 0; k < 32; ++k) x = add(x, x, c);
  return x;
}

// u_0 .. u_(B-1) into u (shared), on one warp: lane l sums the terms j = l +
// 1 + 32 t of u_k = sum_{j=1..k} beta_j u_(k-j), beta_j = -inv b[bd - j].
template <int N>
__device__ __forceinline__ void reciprocal_head(uint4* u, const int32_t* b, int64_t pb,
                                                int64_t bbase, int64_t bd, const FeN<N>& inv,
                                                int B, int lane, const FieldConstsN<N>& c) {
  constexpr int kT = (kB + 31) / 32;
  FeN<N> beta[kT];
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    const int j = lane + 1 + 32 * t;
    beta[t] = j < B && j <= bd
                  ? sub(myzkp::fe_zero<N>(),
                        mul(inv, myzkp::load_planes<N>(b, pb, bbase + bd - j), c), c)
                  : myzkp::fe_zero<N>();
  }
  if (lane == 0) sm_put(u, 0, inv);
  __syncwarp();
#pragma unroll 1
  for (int k = 1; k < B; ++k) {
    FeN<N> acc = myzkp::fe_zero<N>();
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int j = lane + 1 + 32 * t;
      if (j <= k) acc = add(acc, mul(beta[t], sm_get<N>(u, k - j), c), c);
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) acc = add(acc, shfl_xor(acc, m), c);
    if (lane == 0) sm_put(u, k, acc);
    __syncwarp();
  }
}

// The row barrier of the grid mode: block arrivals on the row's counter;
// barrier t of a row completes at t G arrivals.
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
#if defined(__CUDA_ARCH__)
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
#else
  return __atomic_load_n(p, __ATOMIC_ACQUIRE);
#endif
}

__device__ __forceinline__ void row_barrier(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (ld_acquire(counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The block kernel at a row's G blocks: tops (G >= 2: (rows, 2, kB) elements,
// the tops of this and the next block of coefficients), counters (G >= 2: a
// row barrier a row) and, where kGlobalWindow, window (the rows' G x S x T
// slots) in global scratch; rows of the launch row0 ... (plane strides by
// rows).
template <int N, bool kGlobalWindow>
__device__ __forceinline__ void div_block_body(const int32_t* __restrict__ a,
                                               const int32_t* __restrict__ b,
                                               const int32_t* __restrict__ lead,
                                               int32_t* __restrict__ q,
                                               int32_t* __restrict__ r, uint4* xtops,
                                               unsigned* counters, uint4* window,
                                               int64_t rows, int64_t row0, int64_t na,
                                               int64_t bd, int B, int G, int S,
                                               const FieldConstsN<N>& c) {
  extern __shared__ uint4 sm[];
  const int T = blockDim.x, W = T / 32, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t lr = blockIdx.x / G, row = row0 + lr;
  const int rank = static_cast<int>(blockIdx.x % G);
  const bool spread = G > 1;
  const int64_t steps = na - bd, pa = rows * na, pb = rows * (bd + 1);
  const int64_t abase = row * na, bbase = row * (bd + 1), pq = rows * steps, qbase = row * steps;
  constexpr int E = N / 4;  // 16-byte words an element
  uint4* rem = kGlobalWindow ? window + (lr * G + rank) * S * T * E : sm;
  uint4* u = kGlobalWindow ? sm : sm + static_cast<int64_t>(S) * T * E;
  uint4* tops = u + kB * E;
  uint4* cs = tops + kB * E;
  uint4* wb = cs + kB * E + static_cast<int64_t>(warp) * (32 + kB) * E;
  uint4* xtop = spread ? xtops + lr * 2 * kB * E : nullptr;
  unsigned* counter = spread ? counters + lr : nullptr;
  // the position of this thread's slot s; the slot of position x (G = 1)
  const auto pos_of = [&](int s) {
    return ((static_cast<int64_t>(s) * W + warp) * G + rank) * 32 + lane;
  };
  const auto home = [&](int64_t x) {
    return ((x >> 5) / W) * T + ((x >> 5) % W) * 32 + (x & 31);
  };
  const FeN<N> zero = myzkp::fe_zero<N>();
  for (int s = 0; s < S; ++s) {
    const int64_t x = pos_of(s);
    sm_put(rem, static_cast<int64_t>(s) * T + tid,
           x < na ? myzkp::load_planes<N>(a, pa, abase + x) : zero);
    if (spread && x < na && x > na - 1 - lmin(B, steps))
      cg_put(xtop, na - 1 - x, myzkp::load_planes<N>(a, pa, abase + x));
  }
  const FeN<N> inv = myzkp::load_planes<N>(lead, rows, row);
  if (warp == 0) reciprocal_head(u, b, pb, bbase, bd, inv, B, lane, c);
  __syncthreads();
  const FeN<N> scale = scale_factor(c);
  for (int k = tid; k < B; k += T) sm_put(u, k, mul(sm_get<N>(u, k), scale, c));  // 2^32 u_k
  unsigned barriers = 0;
  int parity = 0;
#pragma unroll 1
  for (int64_t P = na - 1; P >= bd; P -= B) {
    const int Bs = static_cast<int>(lmin(B, P - bd + 1));
    if (spread) {
      row_barrier(counter, ++barriers * G);
      for (int l = tid; l < Bs; l += T) sm_put(tops, l, cg_get<N>(xtop + parity * kB * E, l));
    } else {
      __syncthreads();
      for (int l = tid; l < Bs; l += T) sm_put(tops, l, sm_get<N>(rem, home(P - l)));
    }
    __syncthreads();
    // c_i = sum_{l <= i} u_(i-l) t_l: lane k of quad i sums l = k mod 4;
    // cs gets 2^32 c_i, the update's operand
    const int span = (Bs * 4 + 31) / 32 * 32;
    for (int w = tid; w < span; w += T) {
      const int i = w >> 2, k = w & 3;
      WideSum<N> sum;
      wide_zero(sum);
      if (i < Bs)
        for (int l = k; l <= i; l += 4) wide_mac(sum, sm_get<N>(u, i - l), sm_get<N>(tops, l));
      FeN<N> acc = wide_reduce(sum, c);
      acc = add(acc, shfl_xor(acc, 1), c);
      acc = add(acc, shfl_xor(acc, 2), c);
      if (i < Bs && k == 0) {
        sm_put(cs, i, mul(acc, scale, c));
        if (rank == 0) myzkp::store_planes(q, pq, qbase + P - i - bd, acc);
      }
    }
    __syncthreads();
    // rem[x] -= sum_i c_i b[x - P + i + bd] on [P - Bs - bd + 1, P - Bs]
    const int64_t lo = P - Bs - bd + 1, hi = P - Bs;
    for (int s = 0; s < S; ++s) {
      const int64_t x = pos_of(s), x0 = x - lane;
      if (x0 > hi || x0 + 31 < lo) continue;  // the whole warp
      const int64_t j0 = x0 - P + bd;
      __syncwarp();
      for (int t = lane; t < 32 + Bs - 1; t += 32) {
        const int64_t j = j0 + t;
        sm_put(wb, t, j >= 0 && j < bd ? myzkp::load_planes<N>(b, pb, bbase + j) : zero);
      }
      __syncwarp();
      WideSum<N> sum;
      wide_zero(sum);
#pragma unroll 4
      for (int i = 0; i < Bs; ++i) wide_mac(sum, sm_get<N>(cs, i), sm_get<N>(wb, lane + i));
      const FeN<N> acc = wide_reduce(sum, c);
      if (x >= lo && x <= hi) {
        const int64_t e = static_cast<int64_t>(s) * T + tid;
        sm_put(rem, e, sub(sm_get<N>(rem, e), acc, c));
      }
    }
    if (spread) {  // the next block's tops, for every block of the row
      const int64_t Pn = P - B;
      if (Pn >= bd) {
        const int Bn = static_cast<int>(lmin(B, Pn - bd + 1));
        for (int s = 0; s < S; ++s) {
          const int64_t l = Pn - pos_of(s);
          if (l >= 0 && l < Bn)
            cg_put(xtop + (parity ^ 1) * kB * E, l,
                   sm_get<N>(rem, static_cast<int64_t>(s) * T + tid));
        }
      }
      parity ^= 1;
    }
  }
  for (int s = 0; s < S; ++s) {
    const int64_t x = pos_of(s);
    if (x < bd)
      myzkp::store_planes(r, rows * bd, row * bd + x,
                          sm_get<N>(rem, static_cast<int64_t>(s) * T + tid));
  }
}

template <int N>
__global__ void __launch_bounds__(128)
    div_rows_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                    const int32_t* __restrict__ lead, int32_t* __restrict__ q,
                    int32_t* __restrict__ r, int64_t rows, int64_t na, int64_t bd,
                    FieldConstsN<N> c) {
  div_rows_body<N>(a, b, lead, q, r, rows, na, bd, c);
}

template <int N>
__global__ void __launch_bounds__(kChunkThreads)
    div_chunks_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                      const int32_t* __restrict__ lead, int32_t* __restrict__ q,
                      int32_t* __restrict__ r, int64_t rows, int64_t na, int64_t bd, int Lc,
                      int P, FieldConstsN<N> c) {
  div_chunks_body<N>(a, b, lead, q, r, rows, na, bd, Lc, P, c);
}

template <int N, bool kGlobalWindow>
__global__ void __launch_bounds__(kThreads)
    div_block_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                     const int32_t* __restrict__ lead, int32_t* __restrict__ q,
                     int32_t* __restrict__ r, uint4* xtops, unsigned* counters, uint4* window,
                     int64_t rows, int64_t row0, int64_t na, int64_t bd, int B, int G, int S,
                     FieldConstsN<N> c) {
  div_block_body<N, kGlobalWindow>(a, b, lead, q, r, xtops, counters, window, rows, row0, na,
                                   bd, B, G, S, c);
}

// (A g++ rehearsal of the kernels cuts the source here.)
cudaError_t set_smem(const void* kernel, int64_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The plan on the current device: its SM count and shared bytes a block.
cudaError_t device_plan(int64_t rows, int64_t na, int64_t bd, int64_t words,
                        myzkp_div::Plan* plan) {
  int dev = 0, sms = 0, smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return myzkp_div::plan_division(rows, na, bd, words, sms, smem, plan) ? cudaSuccess
                                                                        : cudaErrorInvalidValue;
}

// The block kernel's launches: rows plan.per at a time, the scratch (from the
// stream's pool, freed on it) shared by them in turn, the row counters zeroed
// before each.
template <int N>
cudaError_t launch_blocks(const int32_t* a, const int32_t* b, const int32_t* lead, int32_t* q,
                          int32_t* r, int64_t rows, int64_t na, int64_t bd,
                          const myzkp_div::Plan& plan, const FieldConstsN<N>& c,
                          cudaStream_t st) {
  constexpr int E = N / 4;
  const int B = static_cast<int>(plan.p1), G = static_cast<int>(plan.p2);
  const int T = static_cast<int>(plan.T), S = static_cast<int>(plan.S);
  const auto kernel = plan.global_window ? div_block_kernel<N, true> : div_block_kernel<N, false>;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), plan.smem);
  if (err != cudaSuccess) return err;
  void* scratch = nullptr;
  if (plan.scratch > 0) {
    err = cudaMallocAsync(&scratch, static_cast<size_t>(plan.scratch), st);
    if (err != cudaSuccess) return err;
  }
  uint4* xtops = static_cast<uint4*>(scratch);
  uint4* window = xtops + (G > 1 ? plan.per * 2 * kB * E : 0);
  unsigned* counters =
      reinterpret_cast<unsigned*>(window + (plan.global_window ? plan.per * G * S * T * E : 0));
  for (int64_t row0 = 0; row0 < rows && err == cudaSuccess; row0 += plan.per) {
    const int64_t n = lmin(plan.per, rows - row0);
    if (G > 1) err = cudaMemsetAsync(counters, 0, static_cast<size_t>(n) * sizeof(unsigned), st);
    if (err != cudaSuccess) break;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(n * G));
    cfg.blockDim = dim3(T);
    cfg.dynamicSmemBytes = static_cast<size_t>(plan.smem);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;  // G >= 2: the row's blocks all resident
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = G > 1 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, kernel, a, b, lead, q, r, xtops, counters, window, rows, row0,
                             na, bd, B, G, S, c);
  }
  if (scratch != nullptr) {
    const cudaError_t freed = cudaFreeAsync(scratch, st);
    if (err == cudaSuccess) err = freed;
  }
  return err;
}

template <int N>
int launch_long_division(const int32_t* a, const int32_t* b, const int32_t* lead, int32_t* q,
                         int32_t* r, int64_t rows, int64_t na, int64_t bd,
                         const FieldConstsN<N>& c, void* stream) {
  myzkp_div::Plan plan;
  cudaError_t err = device_plan(rows, na, bd, N, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan.mode == myzkp_div::kRows) {
    div_rows_kernel<N><<<static_cast<unsigned>((rows + plan.T - 1) / plan.T),
                         static_cast<unsigned>(plan.T), 0, st>>>(a, b, lead, q, r, rows, na,
                                                                 bd, c);
  } else if (plan.mode == myzkp_div::kChunks) {
    err = set_smem(reinterpret_cast<const void*>(div_chunks_kernel<N>), plan.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    div_chunks_kernel<N><<<static_cast<unsigned>(rows), static_cast<unsigned>(plan.T),
                           static_cast<size_t>(plan.smem), st>>>(
        a, b, lead, q, r, rows, na, bd, static_cast<int>(plan.p1), static_cast<int>(plan.p2), c);
  } else {
    err = launch_blocks<N>(a, b, lead, q, r, rows, na, bd, plan, c, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (2N, rows, na), b (2N, rows, bd + 1), lead (2N, rows) = inv(b[..., bd]);
// out q (2N, rows, na - bd) and r (2N, rows, bd).  2N = 16 limbs (BN254) or 8
// (M128, the _l8 entry point); 1 <= bd < na.
extern "C" int myzkp_long_division(const int32_t* a, const int32_t* b, const int32_t* lead,
                                   int32_t* q, int32_t* r, int64_t rows, int64_t na, int64_t bd,
                                   const FieldConsts* consts, void* stream) {
  return launch_long_division<8>(a, b, lead, q, r, rows, na, bd, *consts, stream);
}

extern "C" int myzkp_long_division_l8(const int32_t* a, const int32_t* b, const int32_t* lead,
                                      int32_t* q, int32_t* r, int64_t rows, int64_t na,
                                      int64_t bd, const FieldConstsN<4>* consts, void* stream) {
  return launch_long_division<4>(a, b, lead, q, r, rows, na, bd, *consts, stream);
}

// The plan K17 takes on the current device at `words` 32-bit words an
// element, into out[0 .. 8]: mode (0 a thread a row, 1 chunks, 2 blocks), p1,
// p2, T, S, rows a launch, the window in global scratch, shared and scratch
// bytes (div_plan.cuh's Plan).  Launches nothing.
extern "C" int myzkp_long_division_plan(int64_t rows, int64_t na, int64_t bd, int64_t words,
                                        int64_t* out) {
  myzkp_div::Plan p;
  const cudaError_t err = device_plan(rows, na, bd, words, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t v[9] = {p.mode, p.p1, p.p2, p.T, p.S, p.per, p.global_window, p.smem, p.scratch};
  for (int k = 0; k < 9; ++k) out[k] = v[k];
  return 0;
}
