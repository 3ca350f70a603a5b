// K1: elementwise Montgomery multiply a * b * R^-1 mod p over (2N, n) limb
// planes, and its chain: a^e for an exponent known on the host, in one launch.
// Each at three widths: N = 8 words (BN254, mont_mul_kernel /
// mont_pow_kernel), N = 4 (M128, mont_mul_l8_kernel / mont_pow_l8_kernel)
// and N = 2 (M64, mont_mul_l4_kernel / mont_pow_l4_kernel), one templated
// body each.
//
// Replaces limb_pallas.mont_mul_pallas (myzkp_tpu/fields/limb_pallas.py:286,
// kernel body _make_kernel :42), which ran the same product on (32, 128)
// VMEM tiles.  The chain replaces the reference's exponentiation (a lax.scan
// of mont_mul_pallas steps in myzkp_tpu/fields/limb.py:346-371, pow_const /
// inv), which the port had run as one K1 launch a product: 368 for a Fermat
// inversion.
//
// K1.  Bound on the H100: device memory.  An element moves 192 bytes (two
// inputs and one output of 16 int32 limbs each, twice the packed size
// because the interface keeps one 16-bit limb per int32) against 264 32-bit
// multiply-adds.  Design: one thread per element (MYZKP_K1_EPT elements a
// thread, blocks of MYZKP_K1_THREADS); thread i reads column i of every
// limb plane, so each warp's loads and stores are 128-byte coalesced, and
// the product stays in registers (field.cuh, MYZKP_K1_MUL: 0 the
// carry-chain product, U fe_mul_u<U>).  b is read with a period: element i
// reads b[i mod nb], so an operand broadcast over leading batch axes (a
// constant, a table shared by a batch) is never copied out to n elements.
// Where it repeats at most kMaxReps times (the level table against E = 3),
// a thread takes one b element and all its repeats, so b crosses device
// memory once, as the bytes bound counts it; a shorter period (a constant)
// stays in the caches, and the threads go one to an element.
//
// The chain (mont_pow), in two forms at every width; the launcher picks one
// from n and the card's SM count (pow_plan.cuh), and both give the
// canonical limbs of mont_pow_ref.  a^0 = 1 and 0^e = 0 for e > 0, as the
// reference.
//   The lane pair, for a few elements (the proofs' inversions, batch_inv's
//   one inversion).  Bound: the latency of its dependent products.  Design:
//   the LSB-first ladder acc *= base (where the bit is set), base *= base.
//   The two products of a bit are independent, so an element sits on a lane
//   pair: the base lane squares, the acc lane multiplies by the base it
//   takes from its partner with __shfl_xor_sync, and the chain is one
//   product deep a bit (254 for p - 2, against 368 for square-and-multiply
//   one product at a time).  Blocks of 64.
//   The window form, for wide batches (hash_batch's S-boxes at 2^20
//   elements).  Bound: the products, once the elements fill every
//   scheduler; the lane pair's acc lane runs a product at every bit, set or
//   not, 2 nbits an element.  Design: one thread an element, blocks of
//   MYZKP_K1_POW_THREADS; the host recodes e MSB-first into sliding windows
//   of at most w bits (_ext.exponent: the w that runs the fewest products
//   with at most kTable<N> odd powers), a window ending in a set bit, and
//   passes the schedule in the kernel's argument: for each window, the
//   squarings before it and its odd digit.  The thread builds the odd powers
//   x, x^3, ... up to the largest digit in registers (one squaring and a
//   product each), then runs the windows: squarings, then one product by a
//   power picked from the table by selects.  alpha^-1 (127 bits) takes 163
//   products (126 squarings, 33 windows, 4 powers), p - 2 at M64 83, q - 2
//   at BN254 311, against 2 nbits on the pair; the schedule is read from
//   shared memory (one copy a block), so nothing selects over exponent
//   words a bit.  The window form is deeper than the pair's ladder (a
//   window's product adds to the squarings' depth), so the pair stays the
//   latency form.
//
// At four words (M128) an element moves 96 bytes against 68 32-bit
// multiply-adds (field.cuh: fe_mul_cc_wide; 16 wide products a_j b_i and 16
// m p_j at two each, and 4 for m), so K1 stays bound by device memory.  The
// chain runs the Rescue-Prime S-box's alpha^-1 (127 bits) over hash_batch's
// 2^20 states in the window form, the Fermat inversion (128 bits) of a few
// elements on the lane pairs.
//
// At two words (M64 = 2^64 - 2^32 + 1, again above R / 2) an element moves
// 48 bytes against 18 multiply-adds (4 a_j b_i and 4 m p_j at two each, and
// 2 for m), on the same wide product: the Montgomery domain is R = 2^64 as
// in the 16-bit-limb layout, so values cross the interface unchanged.
#include <cuda_runtime.h>

#include "field.cuh"
#include "pow_plan.cuh"

#ifndef MYZKP_K1_MUL
#define MYZKP_K1_MUL 0
#endif
#ifndef MYZKP_K1_THREADS
#define MYZKP_K1_THREADS 256
#endif
#ifndef MYZKP_K1_EPT
#define MYZKP_K1_EPT 1
#endif
#ifndef MYZKP_K1_POW_THREADS
#define MYZKP_K1_POW_THREADS 128  // threads a block of the window form
#endif

using myzkp::FeN;
using myzkp::FieldConsts;
using myzkp::FieldConstsN;
using FieldConsts4 = FieldConstsN<4>;
using FieldConsts2 = FieldConstsN<2>;

constexpr int kMaxWindows = 128;  // windows of the schedule: 256 bits at w >= 2

// An exponent known on the host, in both forms' terms.  Mirrors
// _ext._Exponent.  The lane pair reads the bits: little-endian 32-bit words
// and the bit length (0 <= nbits <= 256).  The window form reads the
// schedule: `table` odd powers x^(2d + 1), d < table; windows 0 .. windows - 1,
// MSB first, step[k] = (squarings before window k) << 8 | d_k (window 0
// starts the accumulator at its power: no squarings); then `tail` squarings.
// windows = 0 is e = 0.
struct Exponent {
  uint32_t w[myzkp::kWords];
  int32_t nbits;
  int32_t table;
  int32_t windows;
  int32_t tail;
  uint16_t step[kMaxWindows];
};

namespace {

constexpr int kPowThreads = 64;

template <int N>
__device__ __forceinline__ FeN<N> mul(const FeN<N>& a, const FeN<N>& b,
                                      const FieldConstsN<N>& c) {
  return myzkp::fe_mul_sel<MYZKP_K1_MUL>(a, b, c);
}

constexpr int kMaxReps = 8;

// reps > 0: thread slot j < nb multiplies b[j] into a[j + r nb], r < reps;
// reps = 0: slot i < n multiplies a[i] by b[i mod nb].
template <int N>
__device__ __forceinline__ void mont_mul_body(const int32_t* __restrict__ a,
                                              const int32_t* __restrict__ b,
                                              int32_t* __restrict__ out, int64_t n,
                                              int64_t nb, int reps,
                                              const FieldConstsN<N>& c) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * MYZKP_K1_THREADS *
                            MYZKP_K1_EPT + threadIdx.x;
#pragma unroll
  for (int k = 0; k < MYZKP_K1_EPT; ++k) {
    const int64_t slot = first + static_cast<int64_t>(k) * MYZKP_K1_THREADS;
    if (reps > 0) {
      if (slot >= nb) return;
      const FeN<N> y = myzkp::load_planes<N>(b, nb, slot);
#pragma unroll 1
      for (int r = 0; r < reps; ++r) {
        const int64_t i = slot + r * nb;
        myzkp::store_planes(out, n, i, mul(myzkp::load_planes<N>(a, n, i), y, c));
      }
    } else {
      if (slot >= n) return;
      const int64_t j = nb == n ? slot : (nb == 1 ? 0 : slot % nb);
      const FeN<N> x = myzkp::load_planes<N>(a, n, slot);
      myzkp::store_planes(out, n, slot, mul(x, myzkp::load_planes<N>(b, nb, j), c));
    }
  }
}

__global__ void __launch_bounds__(MYZKP_K1_THREADS)
    mont_mul_kernel(const int32_t* __restrict__ a,
                    const int32_t* __restrict__ b, int32_t* __restrict__ out,
                    int64_t n, int64_t nb, int reps, FieldConsts c) {
  mont_mul_body<8>(a, b, out, n, nb, reps, c);
}

__global__ void __launch_bounds__(MYZKP_K1_THREADS)
    mont_mul_l8_kernel(const int32_t* __restrict__ a,
                       const int32_t* __restrict__ b, int32_t* __restrict__ out,
                       int64_t n, int64_t nb, int reps, FieldConsts4 c) {
  mont_mul_body<4>(a, b, out, n, nb, reps, c);
}

__global__ void __launch_bounds__(MYZKP_K1_THREADS)
    mont_mul_l4_kernel(const int32_t* __restrict__ a,
                       const int32_t* __restrict__ b, int32_t* __restrict__ out,
                       int64_t n, int64_t nb, int reps, FieldConsts2 c) {
  mont_mul_body<2>(a, b, out, n, nb, reps, c);
}

// Word k of the exponent with k a runtime index, by selects (no local memory).
__device__ __forceinline__ uint32_t exp_word(const Exponent& e, int k) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < myzkp::kWords; ++i) w = i == k ? e.w[i] : w;
  return w;
}

template <int N>
__device__ __forceinline__ FeN<N> shfl_xor(const FeN<N>& a, int lane_mask) {
  FeN<N> r;
#pragma unroll
  for (int k = 0; k < N; ++k)
    r.w[k] = __shfl_xor_sync(0xFFFFFFFFu, a.w[k], lane_mask);
  return r;
}

// Element i on lanes (2i, 2i + 1); every lane of the warp runs every step
// (tail pairs on a clamped element), so the shuffles see a full warp.
template <int N>
__device__ __forceinline__ void mont_pow_body(const int32_t* __restrict__ a,
                                              int32_t* __restrict__ out, int64_t n,
                                              const Exponent& e,
                                              const FieldConstsN<N>& c) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kPowThreads + threadIdx.x;
  const int64_t i = min(t >> 1, n - 1);
  const bool base_lane = (t & 1) != 0;
  FeN<N> x = base_lane ? myzkp::load_planes<N>(a, n, i) : myzkp::fe_one(c);
#pragma unroll 1
  for (int bit = 0; bit < e.nbits; ++bit) {
    const FeN<N> partner = shfl_xor(x, 1);
    const FeN<N> r = mul(x, base_lane ? x : partner, c);
    const bool set = (exp_word(e, bit >> 5) >> (bit & 31)) & 1u;
    x = (base_lane || set) ? r : x;
  }
  if (!base_lane && (t >> 1) < n) myzkp::store_planes(out, n, i, x);
}

__global__ void __launch_bounds__(kPowThreads)
    mont_pow_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                         int64_t n, Exponent e, FieldConsts c) {
  mont_pow_body<8>(a, out, n, e, c);
}

__global__ void __launch_bounds__(kPowThreads)
    mont_pow_l8_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                       int64_t n, Exponent e, FieldConsts4 c) {
  mont_pow_body<4>(a, out, n, e, c);
}

__global__ void __launch_bounds__(kPowThreads)
    mont_pow_l4_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                       int64_t n, Exponent e, FieldConsts2 c) {
  mont_pow_body<2>(a, out, n, e, c);
}

// The odd powers a window product picks from: 8 (w <= 4) at two and four
// words, 4 (w <= 3) at eight, where a power is eight registers.
template <int N>
constexpr int kTable = N == myzkp::kWords ? 4 : 8;

// tab[d] for a d known only at run time, by selects over the table (in
// registers: no local memory).
template <int N>
__device__ __forceinline__ FeN<N> pick(const FeN<N> (&tab)[kTable<N>], int d) {
  FeN<N> r = tab[0];
#pragma unroll
  for (int k = 1; k < kTable<N>; ++k) r = myzkp::fe_select(d == k, tab[k], r);
  return r;
}

// acc^(2^q): q squarings.
template <int N>
__device__ __forceinline__ FeN<N> squarings(FeN<N> acc, int q, const FieldConstsN<N>& c) {
#pragma unroll 1
  for (; q > 0; --q) acc = mul(acc, acc, c);
  return acc;
}

// Element i on thread i: the odd powers, then the windows of the schedule.
template <int N>
__device__ __forceinline__ void mont_pow_wide_body(const int32_t* __restrict__ a,
                                                   int32_t* __restrict__ out, int64_t n,
                                                   const Exponent& e,
                                                   const FieldConstsN<N>& c) {
  __shared__ uint16_t step[kMaxWindows];
  if (threadIdx.x == 0) {  // static indices: the argument stays in the constant bank
#pragma unroll
    for (int k = 0; k < kMaxWindows; ++k) step[k] = e.step[k];
  }
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * MYZKP_K1_POW_THREADS + threadIdx.x;
  if (i >= n) return;
  const FeN<N> x = myzkp::load_planes<N>(a, n, i);
  FeN<N> acc = myzkp::fe_one(c);
  if (e.windows > 0) {
    FeN<N> tab[kTable<N>];
#pragma unroll
    for (int d = 0; d < kTable<N>; ++d) tab[d] = x;
    if (e.table > 1) {
      const FeN<N> x2 = mul(x, x, c);
#pragma unroll
      for (int d = 1; d < kTable<N>; ++d)
        if (d < e.table) tab[d] = mul(tab[d - 1], x2, c);
    }
    acc = pick(tab, step[0] & 0xFF);
#pragma unroll 1
    for (int k = 1; k < e.windows; ++k) {
      const int s = step[k];
      acc = mul(squarings(acc, s >> 8, c), pick(tab, s & 0xFF), c);
    }
    acc = squarings(acc, e.tail, c);
  }
  myzkp::store_planes(out, n, i, acc);
}

__global__ void __launch_bounds__(MYZKP_K1_POW_THREADS)
    mont_pow_wide_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                         int64_t n, Exponent e, FieldConsts c) {
  mont_pow_wide_body<8>(a, out, n, e, c);
}

__global__ void __launch_bounds__(MYZKP_K1_POW_THREADS)
    mont_pow_wide_l8_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                            int64_t n, Exponent e, FieldConsts4 c) {
  mont_pow_wide_body<4>(a, out, n, e, c);
}

__global__ void __launch_bounds__(MYZKP_K1_POW_THREADS)
    mont_pow_wide_l4_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                            int64_t n, Exponent e, FieldConsts2 c) {
  mont_pow_wide_body<2>(a, out, n, e, c);
}

template <class Kernel, class Consts>
int launch_mont_mul(Kernel kernel, const int32_t* a, const int32_t* b, int32_t* out,
                    int64_t n, int64_t nb, const Consts& consts, void* stream) {
  if (nb < 1 || n % nb != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int reps = nb < n && n / nb <= kMaxReps ? static_cast<int>(n / nb) : 0;
  const int64_t slots = reps > 0 ? nb : n;
  const int64_t per_block = int64_t{MYZKP_K1_THREADS} * MYZKP_K1_EPT;
  const int64_t blocks = (slots + per_block - 1) / per_block;
  kernel<<<static_cast<unsigned>(blocks), MYZKP_K1_THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(a, b, out, n, nb, reps, consts);
  return static_cast<int>(cudaGetLastError());
}

// The form of n elements on the current device (pow_plan.cuh).
cudaError_t device_pow_form(int64_t n, int* form) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) *form = myzkp_pow::pow_form(n, sms);
  return err;
}

bool valid_schedule(const Exponent& e, int table_max) {
  if (e.nbits < 0 || e.nbits > 32 * myzkp::kWords) return false;
  if (e.windows < 0 || e.windows > kMaxWindows || e.tail < 0 || e.tail > 255) return false;
  if (e.table < 1 || e.table > table_max) return false;
  for (int k = 0; k < e.windows; ++k)
    if ((e.step[k] & 0xFF) >= e.table) return false;
  return true;
}

template <int N, class Pair, class Wide>
int launch_mont_pow(Pair pair, Wide wide, const int32_t* a, int32_t* out, int64_t n,
                    const Exponent* e, const FieldConstsN<N>& consts, void* stream) {
  if (n < 1 || !valid_schedule(*e, kTable<N>)) return static_cast<int>(cudaErrorInvalidValue);
  int form = 0;
  const cudaError_t err = device_pow_form(n, &form);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  if (form == myzkp_pow::kPair) {
    const auto blocks = static_cast<unsigned>((2 * n + kPowThreads - 1) / kPowThreads);
    pair<<<blocks, kPowThreads, 0, s>>>(a, out, n, *e, consts);
  } else {
    const auto blocks =
        static_cast<unsigned>((n + MYZKP_K1_POW_THREADS - 1) / MYZKP_K1_POW_THREADS);
    wide<<<blocks, MYZKP_K1_POW_THREADS, 0, s>>>(a, out, n, *e, consts);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out = a * b * R^-1 elementwise over (16, n) limb planes (BN254), (8, n)
// (M128, the _l8 entry points) or (4, n) (M64, _l4); b holds nb elements, nb
// dividing n.
extern "C" int myzkp_mont_mul(const int32_t* a, const int32_t* b,
                              int32_t* out, int64_t n, int64_t nb,
                              const FieldConsts* consts, void* stream) {
  return launch_mont_mul(mont_mul_kernel, a, b, out, n, nb, *consts, stream);
}

extern "C" int myzkp_mont_mul_l8(const int32_t* a, const int32_t* b,
                                 int32_t* out, int64_t n, int64_t nb,
                                 const FieldConsts4* consts, void* stream) {
  return launch_mont_mul(mont_mul_l8_kernel, a, b, out, n, nb, *consts, stream);
}

extern "C" int myzkp_mont_mul_l4(const int32_t* a, const int32_t* b,
                                 int32_t* out, int64_t n, int64_t nb,
                                 const FieldConsts2* consts, void* stream) {
  return launch_mont_mul(mont_mul_l4_kernel, a, b, out, n, nb, *consts, stream);
}

// out = a^e elementwise over (16, n), (8, n) or (4, n) limb planes; e's
// bits and window schedule as _ext.exponent makes them (table at most 4 at
// eight words, 8 at four and two).
extern "C" int myzkp_mont_pow(const int32_t* a, int32_t* out, int64_t n,
                              const Exponent* e, const FieldConsts* consts,
                              void* stream) {
  return launch_mont_pow<8>(mont_pow_kernel, mont_pow_wide_kernel, a, out, n, e, *consts,
                            stream);
}

extern "C" int myzkp_mont_pow_l8(const int32_t* a, int32_t* out, int64_t n,
                                 const Exponent* e, const FieldConsts4* consts,
                                 void* stream) {
  return launch_mont_pow<4>(mont_pow_l8_kernel, mont_pow_wide_l8_kernel, a, out, n, e,
                            *consts, stream);
}

extern "C" int myzkp_mont_pow_l4(const int32_t* a, int32_t* out, int64_t n,
                                 const Exponent* e, const FieldConsts2* consts,
                                 void* stream) {
  return launch_mont_pow<2>(mont_pow_l4_kernel, mont_pow_wide_l4_kernel, a, out, n, e,
                            *consts, stream);
}

// The chain's form for n elements on the current device: 0 the lane pair, 1
// the window form (pow_plan.cuh).  A query: launches nothing.
extern "C" int myzkp_mont_pow_plan(int64_t n, int32_t* form) {
  int f = 0;
  const cudaError_t err = device_pow_form(n, &f);
  *form = f;
  return static_cast<int>(err);
}

extern "C" const char* myzkp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
