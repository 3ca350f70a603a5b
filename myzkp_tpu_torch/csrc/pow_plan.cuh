// K1's chain (csrc/mont_mul.cu): which of its two forms raises n elements
// to a host exponent on a card of `sms` SMs.  Host C++ only, so that g++ can
// build it where there is no card (tests/test_torch_chain.py holds it at
// the edge of its threshold); mont_mul.cu queries the card's SM count and
// calls pow_form.
//
// The lane pair is one product deep a bit and runs two products a bit an
// element: it wins while the card has lanes to spare, where a chain's time
// is its depth.  The one-thread window form runs fewer products an element
// (about 1.3 a bit) but one after another: it wins once the elements fill
// the card's schedulers, where the time is the products' count.  The
// crossover is a count of elements a streaming multiprocessor.
#pragma once

#include <cstdint>

// A build may set it with -D (unroll_sweep.py pow): the most elements an SM
// for which the lane pair runs.
#ifndef MYZKP_K1_PAIR_SM
#define MYZKP_K1_PAIR_SM 64
#endif

namespace myzkp_pow {

constexpr int64_t kPairPerSm = MYZKP_K1_PAIR_SM;
static_assert(kPairPerSm >= 0, "MYZKP_K1_PAIR_SM");

enum Form { kPair = 0, kWide = 1 };

inline int pow_form(int64_t n, int64_t sms) { return n <= sms * kPairPerSm ? kPair : kWide; }

}  // namespace myzkp_pow
