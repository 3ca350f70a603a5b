// F_q2 = F_q[u]/(u^2 + 1) over field.cuh's Fe: the CUDA counterpart of TileFq2
// (myzkp_tpu/fields/tile_ops.py:185-218) and of Fq2Ops
// (myzkp_tpu_torch/curves/field_ops.py).  Karatsuba product (3 base products)
// and a 2-product square.  Every result is canonical, so a kernel built on
// these agrees with the int64 plain version bit for bit.
#pragma once

#include "field.cuh"

namespace myzkp {

struct Fe2 {
  Fe c0, c1;
};

__device__ __forceinline__ Fe2 fe2_add(const Fe2& a, const Fe2& b,
                                       const FieldConsts& c) {
  return Fe2{fe_add(a.c0, b.c0, c), fe_add(a.c1, b.c1, c)};
}

__device__ __forceinline__ Fe2 fe2_sub(const Fe2& a, const Fe2& b,
                                       const FieldConsts& c) {
  return Fe2{fe_sub(a.c0, b.c0, c), fe_sub(a.c1, b.c1, c)};
}

// (a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + ((a0 + a1)(b0 + b1) - a0 b0 - a1 b1) u
__device__ __forceinline__ Fe2 fe2_mul(const Fe2& a, const Fe2& b,
                                       const FieldConsts& c) {
  Fe t0 = fe_mul(a.c0, b.c0, c);
  Fe t1 = fe_mul(a.c1, b.c1, c);
  Fe t2 = fe_mul(fe_add(a.c0, a.c1, c), fe_add(b.c0, b.c1, c), c);
  return Fe2{fe_sub(t0, t1, c), fe_sub(t2, fe_add(t0, t1, c), c)};
}

// (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u
__device__ __forceinline__ Fe2 fe2_sqr(const Fe2& a, const FieldConsts& c) {
  Fe t = fe_mul(a.c0, a.c1, c);
  return Fe2{fe_mul(fe_add(a.c0, a.c1, c), fe_sub(a.c0, a.c1, c), c),
             fe_add(t, t, c)};
}

}  // namespace myzkp
