// BN254 group law for one point per thread, G1 over F_q and G2 over F_q2: the
// complete projective formulas of Renes-Costello-Batina 2016 for a = 0, step
// for step as myzkp_tpu/curves/weierstrass.py writes them (padd :49-83,
// Algorithm 7; padd_mixed :113-132, Algorithm 8; pdbl :147-173, Algorithm 9),
// as templates over the element type, so that one formula text serves both
// groups and every product and add (Fe, FeU, FeC, Fe2, Fe2pU) as in the
// reference.  Shared by curve.cu (K2, K3, K9), curve2.cu (K7, K8, K10) and
// bucket_scan.cu (K4 and its G2 instance).
#pragma once

#include "fq2.cuh"

namespace myzkp {

// The element types' ring operations under one set of names.
__device__ __forceinline__ Fe add(const Fe& a, const Fe& b, const FieldConsts& c) {
  return fe_add(a, b, c);
}
__device__ __forceinline__ Fe sub(const Fe& a, const Fe& b, const FieldConsts& c) {
  return fe_sub(a, b, c);
}
__device__ __forceinline__ Fe mul(const Fe& a, const Fe& b, const FieldConsts& c) {
  return fe_mul(a, b, c);
}
__device__ __forceinline__ Fe sqr(const Fe& a, const FieldConsts& c) {
  return fe_sqr(a, c);
}
__device__ __forceinline__ Fe2 add(const Fe2& a, const Fe2& b, const FieldConsts& c) {
  return fe2_add(a, b, c);
}
__device__ __forceinline__ Fe2 sub(const Fe2& a, const Fe2& b, const FieldConsts& c) {
  return fe2_sub(a, b, c);
}
__device__ __forceinline__ Fe2 mul(const Fe2& a, const Fe2& b, const FieldConsts& c) {
  return fe2_mul(a, b, c);
}
__device__ __forceinline__ Fe2 sqr(const Fe2& a, const FieldConsts& c) {
  return fe2_sqr(a, c);
}
__device__ __forceinline__ Fe neg(const Fe& a, const FieldConsts& c) {
  return fe_neg(a, c);
}
__device__ __forceinline__ Fe2 neg(const Fe2& a, const FieldConsts& c) {
  return Fe2{fe_neg(a.c0, c), fe_neg(a.c1, c)};
}

// An F_q element whose products unroll U of the Montgomery product's rows
// (field.cuh's fe_mul_u): the same arithmetic as Fe in less code, for the
// kernels that run faster in less code (K2's one-thread body).
template <int U>
struct FeU {
  Fe v;
};
template <int U>
__device__ __forceinline__ FeU<U> add(const FeU<U>& a, const FeU<U>& b, const FieldConsts& c) {
  return FeU<U>{fe_add(a.v, b.v, c)};
}
template <int U>
__device__ __forceinline__ FeU<U> sub(const FeU<U>& a, const FeU<U>& b, const FieldConsts& c) {
  return FeU<U>{fe_sub(a.v, b.v, c)};
}
template <int U>
__device__ __forceinline__ FeU<U> mul(const FeU<U>& a, const FeU<U>& b, const FieldConsts& c) {
  return FeU<U>{fe_mul_u<U>(a.v, b.v, c)};
}

// An F_q element on the carry chains (field.cuh): adds and subs by
// fe_add_cc / fe_sub_cc, products by fe_mul_cc (CIOS on PTX carry flags).
// K9 runs padd_mixed over it.
struct FeC {
  Fe v;
};
__device__ __forceinline__ FeC add(const FeC& a, const FeC& b, const FieldConsts& c) {
  return FeC{fe_add_cc(a.v, b.v, c)};
}
__device__ __forceinline__ FeC sub(const FeC& a, const FeC& b, const FieldConsts& c) {
  return FeC{fe_sub_cc(a.v, b.v, c)};
}
__device__ __forceinline__ FeC mul(const FeC& a, const FeC& b, const FieldConsts& c) {
  return FeC{fe_mul_cc(a.v, b.v, c)};
}

template <class E>
struct Point {
  E x, y, z;
};
using Pt = Point<Fe>;    // G1
using Pt2 = Point<Fe2>;  // G2

__device__ __forceinline__ Pt pt_infinity(const FieldConsts& c) {
  return Pt{fe_zero(), fe_one(c), fe_zero()};
}

// m ? a : b word by word (a ternary on the structs can go through local
// memory).
__device__ __forceinline__ Pt pt_select(bool m, const Pt& a, const Pt& b) {
  return Pt{fe_select(m, a.x, b.x), fe_select(m, a.y, b.y), fe_select(m, a.z, b.z)};
}

// G1 complete add with products unrolled U rows deep (FeU above).
template <int U>
__device__ __forceinline__ Pt padd_u(const Pt& p, const Pt& q, const Fe& b3,
                                     const FieldConsts& c) {
  using P = Point<FeU<U>>;
  const P r = padd(P{{p.x}, {p.y}, {p.z}}, P{{q.x}, {q.y}, {q.z}}, FeU<U>{b3}, c);
  return Pt{r.x.v, r.y.v, r.z.v};
}

// padd reads Q's coordinates through x_of / y_of / z_of, and only in its
// first six products: Q may be a Point in registers, or a point that a caller
// keeps elsewhere and loads where the formula needs it (bucket_scan.cu reads
// Q from shared memory, which keeps the G2 instance's registers down).
template <class E>
__device__ __forceinline__ const E& x_of(const Point<E>& q) { return q.x; }
template <class E>
__device__ __forceinline__ const E& y_of(const Point<E>& q) { return q.y; }
template <class E>
__device__ __forceinline__ const E& z_of(const Point<E>& q) { return q.z; }

template <class E, class Q>
__device__ __forceinline__ Point<E> padd(const Point<E>& p, const Q& q,
                                         const E& b3, const FieldConsts& c) {
  E t0 = mul(p.x, x_of(q), c);
  E t1 = mul(p.y, y_of(q), c);
  E t2 = mul(p.z, z_of(q), c);
  E t3 = mul(add(p.x, p.y, c), add(x_of(q), y_of(q), c), c);
  t3 = sub(t3, add(t0, t1, c), c);
  E t4 = mul(add(p.y, p.z, c), add(y_of(q), z_of(q), c), c);
  t4 = sub(t4, add(t1, t2, c), c);
  E x3 = mul(add(p.x, p.z, c), add(x_of(q), z_of(q), c), c);
  E y3 = sub(x3, add(t0, t2, c), c);
  x3 = add(t0, t0, c);
  t0 = add(x3, t0, c);
  t2 = mul(b3, t2, c);
  E z3 = add(t1, t2, c);
  t1 = sub(t1, t2, c);
  y3 = mul(b3, y3, c);
  x3 = mul(t4, y3, c);
  x3 = sub(mul(t3, t1, c), x3, c);
  y3 = mul(y3, t0, c);
  y3 = add(mul(t1, z3, c), y3, c);
  t0 = mul(t0, t3, c);
  z3 = add(mul(z3, t4, c), t0, c);
  return Point<E>{x3, y3, z3};
}

// P + (qx, qy, 1): padd with Z2 = 1, so t2 = Z1 for free and the two pair
// products through Z2 become Z1 qy + Y1 and Z1 qx + X1; 13 products.  Q must
// not be infinity (the affine form cannot express it); P may be.
template <class E>
__device__ __forceinline__ Point<E> padd_mixed(const Point<E>& p, const E& qx,
                                               const E& qy, const E& b3,
                                               const FieldConsts& c) {
  E t0 = mul(p.x, qx, c);
  E t1 = mul(p.y, qy, c);
  E t3 = mul(add(p.x, p.y, c), add(qx, qy, c), c);
  t3 = sub(t3, add(t0, t1, c), c);
  E t4 = add(mul(p.z, qy, c), p.y, c);
  E y3 = add(mul(p.z, qx, c), p.x, c);
  E x3 = add(t0, t0, c);
  t0 = add(x3, t0, c);
  E t2 = mul(b3, p.z, c);
  E z3 = add(t1, t2, c);
  t1 = sub(t1, t2, c);
  y3 = mul(b3, y3, c);
  x3 = mul(t4, y3, c);
  x3 = sub(mul(t3, t1, c), x3, c);
  y3 = mul(y3, t0, c);
  y3 = add(mul(t1, z3, c), y3, c);
  t0 = mul(t0, t3, c);
  z3 = add(mul(z3, t4, c), t0, c);
  return Point<E>{x3, y3, z3};
}

template <class E>
__device__ __forceinline__ Point<E> pdbl(const Point<E>& p, const E& b3,
                                         const FieldConsts& c) {
  E t0 = sqr(p.y, c);
  E z3 = add(t0, t0, c);
  z3 = add(z3, z3, c);
  z3 = add(z3, z3, c);
  E t1 = mul(p.y, p.z, c);
  E t2 = sqr(p.z, c);
  t2 = mul(b3, t2, c);
  E x3 = mul(t2, z3, c);
  E y3 = add(t0, t2, c);
  z3 = mul(t1, z3, c);
  t1 = add(t2, t2, c);
  t2 = add(t1, t2, c);
  t0 = sub(t0, t2, c);
  y3 = mul(t0, y3, c);
  y3 = add(x3, y3, c);
  t1 = mul(p.x, p.y, c);
  x3 = mul(t0, t1, c);
  x3 = add(x3, x3, c);
  return Point<E>{x3, y3, z3};
}

}  // namespace myzkp
