// K17's launch plan (csrc/poly.cu): which of its kernels divides rows
// divisions of na coefficients by degree bd, at what shape, in how many
// launches, with how much shared memory and global scratch.  Host C++ only,
// so that g++ can build it where there is no card (tests/test_torch_poly.py
// holds it to the kernels' limits); poly.cu queries the card's SM count and
// shared memory a block and calls plan_division.
#pragma once

#include <cstdint>

// A build may set these with -D (unroll_sweep.py div).
#ifndef MYZKP_K17_B
#define MYZKP_K17_B 64  // most quotient coefficients a row barrier
#endif
#ifndef MYZKP_K17_THREADS
#define MYZKP_K17_THREADS 512  // most threads a block of the block kernel
#endif
#ifndef MYZKP_K17_NARROW
#define MYZKP_K17_NARROW 8  // bd at or below it: the recurrence kernels
#endif

namespace myzkp_div {

constexpr int kB = MYZKP_K17_B;
constexpr int kThreads = MYZKP_K17_THREADS;
constexpr int kNarrow = MYZKP_K17_NARROW;
constexpr int64_t kRowsSteps = 64;  // narrow divisions of at most this many steps: a thread a row
constexpr int kChunkThreads = 512;  // P chunks + bd response threads, one block
constexpr int64_t kMinChunk = 16;
static_assert(kB >= 1 && kB <= 1024 && kThreads % 32 == 0 && kThreads >= 32 &&
                  kThreads <= 1024,
              "K17 sizes");
static_assert(kNarrow >= 1 && kNarrow <= 32, "K17 narrow window");

enum Mode { kRows = 0, kChunks = 1, kBlock = 2 };

struct Plan {
  int mode;
  int64_t p1, p2;  // kChunks: Lc steps a chunk, P chunks; kBlock: B, G blocks a row
  int64_t T;       // threads a block
  int64_t S;       // kBlock: slots of 32 positions a warp
  int64_t per;     // rows a launch (the last launch takes the rest)
  int64_t global_window;  // kBlock: the window in global scratch, not in shared memory
  int64_t smem;           // dynamic shared bytes a block
  int64_t scratch;        // global scratch bytes a launch: the tops, the window, the counters
};

// Shared bytes of the block kernel: the window slice (unless it is in global
// scratch), u, the tops, c, and each warp's b window; of the chunk kernel:
// omega, delta and H.
inline int64_t block_smem(int64_t words, int64_t T, int64_t S, bool global_window) {
  return ((global_window ? 0 : S * T) + 3 * kB + (T / 32) * (32 + kB)) * words * 4;
}

inline int64_t chunk_smem(int64_t words, int64_t bd, int64_t P) {
  return (2 * P * bd + bd * bd) * words * 4;
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

inline int64_t isqrt_ceil(int64_t n) {  // the least s with s * s >= n
  int64_t s = 0;
  while (s * s < n) ++s;
  return s;
}

// The plan of rows divisions of na coefficients by degree bd at `words`
// 32-bit words an element, on a card of `sms` SMs with `smem_limit` shared
// bytes a block; false where none exists (bad sizes, or a build's constants
// that do not fit).
//
// - kRows: bd <= NARROW and at most 64 steps: one thread a row, blocks of 32
//   (128 past 64 rows).
// - kChunks: bd <= NARROW and more steps: one block a row, P chunks of Lc
//   steps, Lc about sqrt(na - bd), P + bd threads in one block and omega,
//   delta and H in its shared memory.
// - kBlock: B = min(B, na - bd) quotient coefficients a row barrier, a row's
//   window over G blocks of T threads (S slots of 32 positions a warp).  G
//   doubles while rows x G fits the card and each block keeps 64 positions
//   of the window, then until the slice fits a block's shared memory; past
//   the card's SMs the window lives in global scratch.  G >= 2 is a
//   cooperative grid, its rows x G blocks all resident: sms / G rows a launch.
//   T is a power of two, 32 to THREADS, near the positions a block updates a
//   step, (bd + B) / G.
inline bool plan_division(int64_t rows, int64_t na, int64_t bd, int64_t words, int64_t sms,
                          int64_t smem_limit, Plan* out) {
  if (rows < 1 || rows > 0x7FFFFFFF || bd < 1 || na <= bd || words < 1 || sms < 1)
    return false;
  const int64_t steps = na - bd;
  Plan p = {};
  p.per = rows;
  if (bd <= kNarrow && steps <= kRowsSteps) {
    p.mode = kRows;
    p.T = rows > 64 ? 128 : 32;
  } else if (bd <= kNarrow) {
    const int64_t pmax_smem = (smem_limit / (words * 4) - bd * bd) / (2 * bd);
    const int64_t pmax = pmax_smem < kChunkThreads - bd ? pmax_smem : kChunkThreads - bd;
    if (pmax < 1) return false;
    int64_t lc = isqrt_ceil(steps);
    if (lc < kMinChunk) lc = kMinChunk;
    if (lc < cdiv(steps, pmax)) lc = cdiv(steps, pmax);
    p.mode = kChunks;
    p.p1 = lc;
    p.p2 = cdiv(steps, lc);
    p.T = cdiv(p.p2 + bd, 32) * 32;
    p.smem = chunk_smem(words, bd, p.p2);
    if (lc > 0x7FFFFFFF) return false;
  } else {
    const int64_t B = steps < kB ? steps : kB;
    int64_t G = 1;
    while (G * 2 <= sms && rows * G * 2 <= sms && G * 64 <= bd + B) G *= 2;
    const int64_t segments = cdiv(na, 32);
    for (;;) {
      const int64_t active = cdiv(bd + B, G);  // positions a block updates a step
      int64_t T = 32;
      while (T < active && T < kThreads) T *= 2;
      p.T = T;
      p.S = cdiv(segments, G * (T / 32));
      if (block_smem(words, T, p.S, false) <= smem_limit) break;
      if (G * 2 > sms) {
        p.global_window = 1;
        break;
      }
      G *= 2;
    }
    p.mode = kBlock;
    p.p1 = B;
    p.p2 = G;
    p.smem = block_smem(words, p.T, p.S, p.global_window);
    if (G > 1) p.per = sms / G < rows ? sms / G : rows;
    const int64_t elem = words * 4;  // the tops (2 B a row), the window, a counter a row
    p.scratch = (G > 1 ? p.per * (2 * kB * elem + 4) : 0) +
                (p.global_window ? p.per * G * p.S * p.T * elem : 0);
    if (p.S > 0x7FFFFFFF) return false;
  }
  if (p.smem > smem_limit) return false;
  *out = p;
  return true;
}

}  // namespace myzkp_div
