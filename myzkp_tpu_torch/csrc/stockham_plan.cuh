// K5 at four words (M128, csrc/ntt.cu): how one Stockham pass cuts into the
// tiles that its blocks hold in shared memory.  Host C++ only, so that g++
// can build it where there is no card (tests/test_torch_stockham_l8.py holds
// the tiles to their invariants); ntt.cu queries the card's SM count and
// calls plan_tile.  The split of a transform into passes of at most
// kMaxStages stages is ops/ntt._stockham_passes (ntt_kernels.k5_l8_split):
// the launcher takes the stage count of each pass from its caller.
//
// A pass of s stages takes x (R, Bk, c, B) to (R, 2^s Bk, c / 2^s, B): group
// (r, k, j, b) is the E = 2^s elements x[r, k, j + t hq, b], t < E, hq = c /
// E.  The groups of one (r, k) are the inner = hq B columns jb = j B + b,
// each at stride inner from the next t.  A tile is E elements of each of
// 2^lw neighbouring columns of 2^lq neighbouring (r, k) blocks: either one
// block's columns jb0 ... jb0 + 2^lw - 1 (lq = 0; a warp's loads run along
// jb), or 2^lq whole blocks (lw = log2 inner: then the tile is one run of
// memory).  The plan takes the largest tile of at most kTileMax elements that
// still gives each of the card's SMs a block, else the smallest with kRun
// columns (whole 32-byte sectors of each limb plane) or as many as kTileMax
// holds at s stages (2 at s = 10), or one group a tile (a 2^10-point
// transform of 64 rows: 64 blocks).  A pass with elements always gets one
// tile or more.
#pragma once

#include <algorithm>
#include <cstdint>

namespace myzkp_stockham {

constexpr int kMaxStages = 10;  // stages a pass: a group of 2^10 elements a tile at most
// The most elements a tile and the most threads a block (unroll_sweep.py
// ntt, PERF.md PR 21 runs H and J: tiles of 1,024 within 2%, 128 threads
// 9-11% slower on the prove's transforms).
constexpr int kTileMax = 2048;
constexpr int kThreadsMax = 256;
// The fewest neighbouring columns a tile where a block has that many: a
// 32-byte sector of each limb plane (1 column: +6% on the prove's
// transforms, PERF.md PR 21 run H).
constexpr int kRun = 8;
constexpr int kMaxPairs = 4;  // pairs a thread a stage: the kernel's instances 1, 2, 4

constexpr bool pow2(int64_t v) { return v > 0 && (v & (v - 1)) == 0; }
constexpr int floor_log2(int64_t v) {
  int k = 0;
  while (v > 1) v >>= 1, ++k;
  return k;
}

static_assert(pow2(kTileMax) && kTileMax >= (1 << kMaxStages), "a tile holds a group");
static_assert(kTileMax / 2 / kThreadsMax <= kMaxPairs, "more than 4 pairs a thread");

struct Tile {
  int ls;       // stages: E = 2^ls elements a group
  int lw;       // 2^lw neighbouring columns jb a tile
  int lq;       // 2^lq neighbouring (r, k) blocks a tile
  int lkq;      // log2 of the k a tile spans inside one r: min(lq, log2 Bk)
  int threads;  // a block
  int pairs;    // a thread a stage: 2^(ls + lw + lq) / 2 / threads
  int64_t tiles_j;  // tiles across the columns of one (r, k)
  int64_t tiles;    // blocks
  int last;         // stages of the last step: 2 where it is a quad
  bool staged_out;  // the output goes through a second tile (out_tile)
  int smem;         // bytes of dynamic shared memory a block
};

// Stages a step: two (a quad) where a thread runs an even number of pairs.
inline bool quads(int pairs) { return pairs % 2 == 0; }

// The tiles of a pass of s stages on x (R, Bk, c, B) on a card of `sms` SMs.
// The caller has checked 1 <= s <= kMaxStages and that 2^s divides c.
inline Tile plan_tile(int64_t R, int64_t Bk, int64_t c, int64_t B, int s, int64_t sms) {
  const int64_t inner = (c >> s) * B, rows = R * Bk;
  const int lin = floor_log2(inner);
  const bool whole = pow2(inner) && pow2(Bk);  // a tile may hold several (r, k) blocks
  Tile t{};
  t.ls = s;
  // 2^lg groups a tile, from the most a tile holds down to kRun columns, but
  // at least once: at s = 9 or 10 a tile holds fewer than kRun groups
  const int lg_max = floor_log2(kTileMax) - s;
  const int lg_min = std::min(lg_max, std::min(lin, floor_log2(kRun)));
  for (int lg = lg_max; lg >= lg_min; --lg) {
    t.lw = whole && lg > lin ? lin : std::min(lg, lin);
    t.lq = whole && lg > lin ? lg - lin : 0;
    t.tiles_j = (inner + (int64_t{1} << t.lw) - 1) >> t.lw;
    t.tiles = ((rows + (int64_t{1} << t.lq) - 1) >> t.lq) * t.tiles_j;
    if (t.tiles >= sms) break;
  }
  t.lkq = std::min(t.lq, floor_log2(Bk));
  // two pairs a thread (one quad: two stages in registers), more past
  // kThreadsMax threads
  const int pairs = 1 << (s + t.lw + t.lq - 1);
  t.threads = std::min(kThreadsMax, std::max(1, pairs / 2));
  t.pairs = pairs / t.threads;
  t.last = quads(t.pairs) && s >= 2 ? 2 : 1;
  // The last step's stores run along the output in runs of 2^(s - last)
  // positions, of the tile's columns and k where those span the whole
  // output row: below 8 (32 bytes a limb plane) the output goes to a second
  // tile first and out along memory, where the tile's output is one run
  // (its columns all of hq B and its k all of Bk).
  const bool flat = pow2(inner) && t.lw == lin && pow2(Bk) && t.lkq == floor_log2(Bk);
  t.staged_out = flat && (s - t.last) < 3;
  // the tile, its columns' entries of the stage rows ((2^s - 1) 2^lw) and
  // the output tile, at 16 bytes each
  const int tile = 1 << (s + t.lw + t.lq);
  t.smem = 16 * (tile + (((1 << s) - 1) << t.lw) + (t.staged_out ? tile : 0));
  return t;
}

}  // namespace myzkp_stockham
