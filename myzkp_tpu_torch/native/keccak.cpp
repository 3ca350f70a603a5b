// SHA3-256 and the Merkle tree's levels, on the host.
//
// The port's copy of myzkp_tpu/native/src/keccak.cpp: the same Keccak-f[1600]
// permutation and SHA3-256 padding, and the same node semantics (leaves are
// used raw, a node is SHA3-256(left || right); merkle.rs:15-25).  Two changes
// of interface, not of value: the leaf level takes the leaves' byte offsets,
// so leaves of any lengths hash in the same call, and a level of many nodes
// is split over threads (each node is independent; the bytes are the same
// whatever the split).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

const uint64_t RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808aull,
    0x8000000080008000ull, 0x000000000000808bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000aull,
    0x000000008000808bull, 0x800000000000008bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800aull, 0x800000008000000aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

inline uint64_t rotl(uint64_t x, int s) { return (x << s) | (x >> (64 - s)); }

// Keccak-f[1600]: theta, rho and pi, chi, iota; every loop over the 5 x 5
// lanes written out with constant indices, so the state stays in registers.
void keccakf(uint64_t st[25]) {
  static const int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                               27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  static const int piln[24] = {10, 7,  11, 17, 18, 3,  5,  16, 8,  21, 24, 4,
                               15, 23, 19, 13, 12, 2,  20, 14, 22, 9,  6,  1};
  for (int round = 0; round < 24; ++round) {
    uint64_t bc[5];
#pragma GCC unroll 5
    for (int i = 0; i < 5; ++i)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
#pragma GCC unroll 5
    for (int i = 0; i < 5; ++i) {
      const uint64_t t = bc[(i + 4) % 5] ^ rotl(bc[(i + 1) % 5], 1);
#pragma GCC unroll 5
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    uint64_t t = st[1];
#pragma GCC unroll 24
    for (int i = 0; i < 24; ++i) {
      const int j = piln[i];
      const uint64_t tmp = st[j];
      st[j] = rotl(t, rotc[i]);
      t = tmp;
    }
#pragma GCC unroll 5
    for (int j = 0; j < 25; j += 5) {
      uint64_t row[5];
#pragma GCC unroll 5
      for (int i = 0; i < 5; ++i) row[i] = st[j + i];
#pragma GCC unroll 5
      for (int i = 0; i < 5; ++i)
        st[j + i] = row[i] ^ ((~row[(i + 1) % 5]) & row[(i + 2) % 5]);
    }
    st[0] ^= RC[round];
  }
}

const size_t kRate = 136;  // SHA3-256's rate in bytes

void sha3_256(const uint8_t* in, size_t len, uint8_t* out) {
  uint64_t st[25];
  memset(st, 0, sizeof(st));
  while (len >= kRate) {
    for (size_t i = 0; i < kRate / 8; ++i) {
      uint64_t w;
      memcpy(&w, in + 8 * i, 8);
      st[i] ^= w;
    }
    keccakf(st);
    in += kRate;
    len -= kRate;
  }
  uint8_t buf[kRate];
  memset(buf, 0, sizeof(buf));
  memcpy(buf, in, len);
  buf[len] = 0x06;  // SHA3 domain separation
  buf[kRate - 1] |= 0x80;
  for (size_t i = 0; i < kRate / 8; ++i) {
    uint64_t w;
    memcpy(&w, buf + 8 * i, 8);
    st[i] ^= w;
  }
  keccakf(st);
  memcpy(out, st, 32);
}

// fn(i) for i in [0, n), over up to `threads` threads in contiguous ranges.
template <class F>
void parallel_for(size_t n, int threads, F fn) {
  const size_t per = 4096;  // nodes a thread at least
  size_t parts = (n + per - 1) / per;
  if (parts > static_cast<size_t>(threads)) parts = threads;
  if (parts <= 1) {
    for (size_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  const size_t chunk = (n + parts - 1) / parts;
  for (size_t t = 0; t < parts; ++t) {
    const size_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    pool.emplace_back([lo, hi, &fn] {
      for (size_t i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void myzkp_sha3_256(const uint8_t* in, size_t len, uint8_t* out32) {
  sha3_256(in, len, out32);
}

// Every interior level of the Merkle tree over n leaves (a power of two,
// n >= 2), leaf i being bytes [off[i], off[i + 1]) of `leaves`.  out receives
// the n - 1 nodes of 32 bytes, level by level (n / 2 first-level nodes, then
// n / 4, ..., the root last).  Pair i of the first level is the contiguous
// bytes [off[2i], off[2i + 2]).
void myzkp_merkle_levels(const uint8_t* leaves, const size_t* off, size_t n,
                         int threads, uint8_t* out) {
  parallel_for(n / 2, threads, [&](size_t i) {
    sha3_256(leaves + off[2 * i], off[2 * i + 2] - off[2 * i], out + 32 * i);
  });
  const uint8_t* prev = out;
  uint8_t* cur = out + 32 * (n / 2);
  for (size_t m = n / 4; m >= 1; m /= 2) {
    parallel_for(m, threads, [&](size_t i) { sha3_256(prev + 64 * i, 64, cur + 32 * i); });
    prev = cur;
    cur += 32 * m;
  }
}
}
