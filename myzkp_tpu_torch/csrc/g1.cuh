// BN254 G1 group law for one point per thread: the complete projective
// formulas of Renes-Costello-Batina 2016 for a = 0, step for step as
// myzkp_tpu/curves/weierstrass.py writes them (padd :49-83, Algorithm 7;
// pdbl :147-173, Algorithm 9).  Shared by curve.cu and bucket_scan.cu.
#pragma once

#include "field.cuh"

namespace myzkp {

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ Pt pt_infinity(const FieldConsts& c) {
  return Pt{fe_zero(), fe_one(c), fe_zero()};
}

__device__ __forceinline__ Pt g1_padd(const Pt& p, const Pt& q, const Fe& b3,
                                      const FieldConsts& c) {
  Fe t0 = fe_mul(p.x, q.x, c);
  Fe t1 = fe_mul(p.y, q.y, c);
  Fe t2 = fe_mul(p.z, q.z, c);
  Fe t3 = fe_mul(fe_add(p.x, p.y, c), fe_add(q.x, q.y, c), c);
  t3 = fe_sub(t3, fe_add(t0, t1, c), c);
  Fe t4 = fe_mul(fe_add(p.y, p.z, c), fe_add(q.y, q.z, c), c);
  t4 = fe_sub(t4, fe_add(t1, t2, c), c);
  Fe x3 = fe_mul(fe_add(p.x, p.z, c), fe_add(q.x, q.z, c), c);
  Fe y3 = fe_sub(x3, fe_add(t0, t2, c), c);
  x3 = fe_add(t0, t0, c);
  t0 = fe_add(x3, t0, c);
  t2 = fe_mul(b3, t2, c);
  Fe z3 = fe_add(t1, t2, c);
  t1 = fe_sub(t1, t2, c);
  y3 = fe_mul(b3, y3, c);
  x3 = fe_mul(t4, y3, c);
  x3 = fe_sub(fe_mul(t3, t1, c), x3, c);
  y3 = fe_mul(y3, t0, c);
  y3 = fe_add(fe_mul(t1, z3, c), y3, c);
  t0 = fe_mul(t0, t3, c);
  z3 = fe_add(fe_mul(z3, t4, c), t0, c);
  return Pt{x3, y3, z3};
}

__device__ __forceinline__ Pt g1_pdbl(const Pt& p, const Fe& b3,
                                      const FieldConsts& c) {
  Fe t0 = fe_sqr(p.y, c);
  Fe z3 = fe_add(t0, t0, c);
  z3 = fe_add(z3, z3, c);
  z3 = fe_add(z3, z3, c);
  Fe t1 = fe_mul(p.y, p.z, c);
  Fe t2 = fe_sqr(p.z, c);
  t2 = fe_mul(b3, t2, c);
  Fe x3 = fe_mul(t2, z3, c);
  Fe y3 = fe_add(t0, t2, c);
  z3 = fe_mul(t1, z3, c);
  t1 = fe_add(t2, t2, c);
  t2 = fe_add(t1, t2, c);
  t0 = fe_sub(t0, t2, c);
  y3 = fe_mul(t0, y3, c);
  y3 = fe_add(x3, y3, c);
  t1 = fe_mul(p.x, p.y, c);
  x3 = fe_mul(t0, t1, c);
  x3 = fe_add(x3, x3, c);
  return Pt{x3, y3, z3};
}

}  // namespace myzkp
