// Host BN254 pairing engine for the verifier: 4x64-bit Montgomery Fq, the
// Fq2/Fq6/Fq12 tower and the optimal ate pairing.  A copy of the JAX
// package's engine (myzkp_tpu/native/src/bn254.cpp), kept so that the port
// imports nothing of that package; the single pairing and the multi-pairing
// are exported.  Same
// Miller loop shape (generic affine points on E(Fq12), normalized line
// function `get_lambda`) and final exponent (q^12-1)/r, decomposed as
// (q^6-1)(q^2+1) * (q^4-q^2+1)/r.  This is host code, built with g++, not a
// GPU kernel: the verifier's twelve pairings are a handful of scalar tower
// operations.
//
// ABI: plain C over little-endian u64[4] standard-form (non-Montgomery)
// coefficient arrays; Fq12 crosses the boundary in the single-variable poly
// basis Fq[x]/(x^12 - 18 x^6 + 82) (x <-> w, since w^12 - 18 w^6 + 82 = 0 in
// the tower).

#include <cstdint>
#include <cstring>

#include "bn254_constants.h"

namespace bn254 {

typedef unsigned __int128 u128;

// ---------------------------------------------------------------------------
// Fq: 4x64-bit Montgomery
// ---------------------------------------------------------------------------

struct Fq {
  uint64_t v[4];
};

static inline bool fq_is_zero(const Fq &a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

static inline bool fq_eq(const Fq &a, const Fq &b) {
  return a.v[0] == b.v[0] && a.v[1] == b.v[1] && a.v[2] == b.v[2] &&
         a.v[3] == b.v[3];
}

static inline bool geq_q(const uint64_t t[4]) {
  for (int i = 3; i >= 0; --i) {
    if (t[i] > Q_LIMBS[i]) return true;
    if (t[i] < Q_LIMBS[i]) return false;
  }
  return true;  // equal
}

static inline void sub_q(uint64_t t[4]) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)t[i] - Q_LIMBS[i] - borrow;
    t[i] = (uint64_t)d;
    borrow = (d >> 64) & 1;
  }
}

static inline Fq fq_add(const Fq &a, const Fq &b) {
  Fq r;
  u128 c = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + c;
    r.v[i] = (uint64_t)s;
    c = s >> 64;
  }
  if (c || geq_q(r.v)) sub_q(r.v);
  return r;
}

static inline Fq fq_sub(const Fq &a, const Fq &b) {
  Fq r;
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    r.v[i] = (uint64_t)d;
    borrow = (d >> 64) & 1;
  }
  if (borrow) {
    u128 c = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)r.v[i] + Q_LIMBS[i] + c;
      r.v[i] = (uint64_t)s;
      c = s >> 64;
    }
  }
  return r;
}

static inline Fq fq_neg(const Fq &a) {
  Fq z = {{0, 0, 0, 0}};
  if (fq_is_zero(a)) return z;
  return fq_sub(z, a);
}

// CIOS Montgomery multiplication.
static inline Fq fq_mul(const Fq &a, const Fq &b) {
  uint64_t t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 c = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)a.v[i] * b.v[j] + t[j] + c;
      t[j] = (uint64_t)s;
      c = s >> 64;
    }
    u128 s = (u128)t[4] + c;
    t[4] = (uint64_t)s;
    t[5] = (uint64_t)(s >> 64);

    uint64_t m = t[0] * Q_NP;
    c = ((u128)m * Q_LIMBS[0] + t[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 s2 = (u128)m * Q_LIMBS[j] + t[j] + c;
      t[j - 1] = (uint64_t)s2;
      c = s2 >> 64;
    }
    s = (u128)t[4] + c;
    t[3] = (uint64_t)s;
    t[4] = t[5] + (uint64_t)(s >> 64);
    t[5] = 0;
  }
  Fq r = {{t[0], t[1], t[2], t[3]}};
  if (t[4] || geq_q(r.v)) sub_q(r.v);
  return r;
}

static inline Fq fq_sqr(const Fq &a) { return fq_mul(a, a); }

static const Fq FQ_ZERO = {{0, 0, 0, 0}};

static inline Fq fq_one() {
  Fq r;
  memcpy(r.v, MONT_ONE, sizeof(r.v));
  return r;
}

static inline Fq fq_from_limbs(const uint64_t *limbs) {
  Fq r, r2;
  memcpy(r.v, limbs, sizeof(r.v));
  memcpy(r2.v, R2, sizeof(r2.v));
  return fq_mul(r, r2);  // to Montgomery form
}

static inline void fq_to_limbs(const Fq &a, uint64_t *out) {
  Fq one = {{1, 0, 0, 0}};
  Fq s = fq_mul(a, one);  // from Montgomery form
  memcpy(out, s.v, sizeof(s.v));
}

// Fermat inversion (inv(0) = 0, matching the library convention).
static inline Fq fq_inv(const Fq &a) {
  Fq acc = fq_one();
  for (int i = 0; i < Q_MINUS_2_NBITS; ++i) {
    acc = fq_sqr(acc);
    if (Q_MINUS_2_BITS[i]) acc = fq_mul(acc, a);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u]/(u^2 + 1)
// ---------------------------------------------------------------------------

struct Fq2 {
  Fq c0, c1;
};

static inline Fq2 fq2_make(const Fq &a, const Fq &b) { return Fq2{a, b}; }
static inline Fq2 fq2_zero() { return Fq2{FQ_ZERO, FQ_ZERO}; }
static inline Fq2 fq2_one() { return Fq2{fq_one(), FQ_ZERO}; }

static inline bool fq2_is_zero(const Fq2 &a) {
  return fq_is_zero(a.c0) && fq_is_zero(a.c1);
}
static inline bool fq2_eq(const Fq2 &a, const Fq2 &b) {
  return fq_eq(a.c0, b.c0) && fq_eq(a.c1, b.c1);
}
static inline Fq2 fq2_add(const Fq2 &a, const Fq2 &b) {
  return Fq2{fq_add(a.c0, b.c0), fq_add(a.c1, b.c1)};
}
static inline Fq2 fq2_sub(const Fq2 &a, const Fq2 &b) {
  return Fq2{fq_sub(a.c0, b.c0), fq_sub(a.c1, b.c1)};
}
static inline Fq2 fq2_neg(const Fq2 &a) {
  return Fq2{fq_neg(a.c0), fq_neg(a.c1)};
}
static inline Fq2 fq2_conj(const Fq2 &a) {
  return Fq2{a.c0, fq_neg(a.c1)};
}

static inline Fq2 fq2_mul(const Fq2 &a, const Fq2 &b) {
  // Karatsuba: (a0 b0 - a1 b1) + ((a0+a1)(b0+b1) - a0 b0 - a1 b1) u
  Fq t0 = fq_mul(a.c0, b.c0);
  Fq t1 = fq_mul(a.c1, b.c1);
  Fq t2 = fq_mul(fq_add(a.c0, a.c1), fq_add(b.c0, b.c1));
  return Fq2{fq_sub(t0, t1), fq_sub(t2, fq_add(t0, t1))};
}

static inline Fq2 fq2_sqr(const Fq2 &a) {
  // (a0+a1)(a0-a1) + 2 a0 a1 u
  Fq t0 = fq_mul(fq_add(a.c0, a.c1), fq_sub(a.c0, a.c1));
  Fq t1 = fq_mul(a.c0, a.c1);
  return Fq2{t0, fq_add(t1, t1)};
}

static inline Fq2 fq2_scale(const Fq2 &a, const Fq &s) {
  return Fq2{fq_mul(a.c0, s), fq_mul(a.c1, s)};
}

static inline Fq2 fq2_inv(const Fq2 &a) {
  Fq norm = fq_add(fq_sqr(a.c0), fq_sqr(a.c1));
  Fq ninv = fq_inv(norm);
  return Fq2{fq_mul(a.c0, ninv), fq_neg(fq_mul(a.c1, ninv))};
}

// multiply by the Fq6 non-residue xi = 9 + u
static inline Fq2 fq2_mul_xi(const Fq2 &a) {
  Fq nine;
  memcpy(nine.v, MONT_NINE, sizeof(nine.v));
  // (9 a0 - a1) + (a0 + 9 a1) u
  return Fq2{fq_sub(fq_mul(nine, a.c0), a.c1),
             fq_add(a.c0, fq_mul(nine, a.c1))};
}

// ---------------------------------------------------------------------------
// Fq6 = Fq2[v]/(v^3 - xi)
// ---------------------------------------------------------------------------

struct Fq6 {
  Fq2 c0, c1, c2;
};

static inline Fq6 fq6_zero() { return Fq6{fq2_zero(), fq2_zero(), fq2_zero()}; }
static inline Fq6 fq6_one() { return Fq6{fq2_one(), fq2_zero(), fq2_zero()}; }
static inline bool fq6_is_zero(const Fq6 &a) {
  return fq2_is_zero(a.c0) && fq2_is_zero(a.c1) && fq2_is_zero(a.c2);
}
static inline bool fq6_eq(const Fq6 &a, const Fq6 &b) {
  return fq2_eq(a.c0, b.c0) && fq2_eq(a.c1, b.c1) && fq2_eq(a.c2, b.c2);
}
static inline Fq6 fq6_add(const Fq6 &a, const Fq6 &b) {
  return Fq6{fq2_add(a.c0, b.c0), fq2_add(a.c1, b.c1), fq2_add(a.c2, b.c2)};
}
static inline Fq6 fq6_sub(const Fq6 &a, const Fq6 &b) {
  return Fq6{fq2_sub(a.c0, b.c0), fq2_sub(a.c1, b.c1), fq2_sub(a.c2, b.c2)};
}
static inline Fq6 fq6_neg(const Fq6 &a) {
  return Fq6{fq2_neg(a.c0), fq2_neg(a.c1), fq2_neg(a.c2)};
}

static inline Fq6 fq6_mul(const Fq6 &a, const Fq6 &b) {
  Fq2 v0 = fq2_mul(a.c0, b.c0);
  Fq2 v1 = fq2_mul(a.c1, b.c1);
  Fq2 v2 = fq2_mul(a.c2, b.c2);
  // c0 = v0 + xi((a1+a2)(b1+b2) - v1 - v2)
  Fq2 t = fq2_mul(fq2_add(a.c1, a.c2), fq2_add(b.c1, b.c2));
  Fq2 c0 = fq2_add(v0, fq2_mul_xi(fq2_sub(t, fq2_add(v1, v2))));
  // c1 = (a0+a1)(b0+b1) - v0 - v1 + xi v2
  t = fq2_mul(fq2_add(a.c0, a.c1), fq2_add(b.c0, b.c1));
  Fq2 c1 = fq2_add(fq2_sub(t, fq2_add(v0, v1)), fq2_mul_xi(v2));
  // c2 = (a0+a2)(b0+b2) - v0 - v2 + v1
  t = fq2_mul(fq2_add(a.c0, a.c2), fq2_add(b.c0, b.c2));
  Fq2 c2 = fq2_add(fq2_sub(t, fq2_add(v0, v2)), v1);
  return Fq6{c0, c1, c2};
}

static inline Fq6 fq6_sqr(const Fq6 &a) { return fq6_mul(a, a); }

// multiply by v: (c0, c1, c2) -> (xi c2, c0, c1)
static inline Fq6 fq6_mul_v(const Fq6 &a) {
  return Fq6{fq2_mul_xi(a.c2), a.c0, a.c1};
}

static inline Fq6 fq6_inv(const Fq6 &a) {
  Fq2 t0 = fq2_sub(fq2_sqr(a.c0), fq2_mul_xi(fq2_mul(a.c1, a.c2)));
  Fq2 t1 = fq2_sub(fq2_mul_xi(fq2_sqr(a.c2)), fq2_mul(a.c0, a.c1));
  Fq2 t2 = fq2_sub(fq2_sqr(a.c1), fq2_mul(a.c0, a.c2));
  Fq2 den = fq2_add(
      fq2_mul(a.c0, t0),
      fq2_mul_xi(fq2_add(fq2_mul(a.c2, t1), fq2_mul(a.c1, t2))));
  Fq2 dinv = fq2_inv(den);
  return Fq6{fq2_mul(t0, dinv), fq2_mul(t1, dinv), fq2_mul(t2, dinv)};
}

// ---------------------------------------------------------------------------
// Fq12 = Fq6[w]/(w^2 - v)
// ---------------------------------------------------------------------------

struct Fq12 {
  Fq6 c0, c1;
};

static inline Fq12 fq12_zero() { return Fq12{fq6_zero(), fq6_zero()}; }
static inline Fq12 fq12_one() { return Fq12{fq6_one(), fq6_zero()}; }
static inline bool fq12_is_zero(const Fq12 &a) {
  return fq6_is_zero(a.c0) && fq6_is_zero(a.c1);
}
static inline bool fq12_eq(const Fq12 &a, const Fq12 &b) {
  return fq6_eq(a.c0, b.c0) && fq6_eq(a.c1, b.c1);
}
static inline Fq12 fq12_add(const Fq12 &a, const Fq12 &b) {
  return Fq12{fq6_add(a.c0, b.c0), fq6_add(a.c1, b.c1)};
}
static inline Fq12 fq12_sub(const Fq12 &a, const Fq12 &b) {
  return Fq12{fq6_sub(a.c0, b.c0), fq6_sub(a.c1, b.c1)};
}
static inline Fq12 fq12_neg(const Fq12 &a) {
  return Fq12{fq6_neg(a.c0), fq6_neg(a.c1)};
}

static inline Fq12 fq12_mul(const Fq12 &a, const Fq12 &b) {
  // Karatsuba over Fq6 with w^2 = v
  Fq6 v0 = fq6_mul(a.c0, b.c0);
  Fq6 v1 = fq6_mul(a.c1, b.c1);
  Fq6 t = fq6_mul(fq6_add(a.c0, a.c1), fq6_add(b.c0, b.c1));
  return Fq12{fq6_add(v0, fq6_mul_v(v1)), fq6_sub(t, fq6_add(v0, v1))};
}

static inline Fq12 fq12_sqr(const Fq12 &a) {
  // complex squaring: (a0 + a1 w)^2 = (a0^2 + v a1^2) + 2 a0 a1 w
  //   with a0^2 + v a1^2 = (a0 + a1)(a0 + v a1) - a0 a1 - v a0 a1
  Fq6 t0 = fq6_mul(a.c0, a.c1);
  Fq6 t1 = fq6_mul(fq6_add(a.c0, a.c1), fq6_add(a.c0, fq6_mul_v(a.c1)));
  Fq6 c0 = fq6_sub(t1, fq6_add(t0, fq6_mul_v(t0)));
  return Fq12{c0, fq6_add(t0, t0)};
}

static inline Fq12 fq12_conj(const Fq12 &a) {  // = frobenius^6
  return Fq12{a.c0, fq6_neg(a.c1)};
}

static inline Fq12 fq12_inv(const Fq12 &a) {
  Fq6 norm = fq6_sub(fq6_sqr(a.c0), fq6_mul_v(fq6_sqr(a.c1)));
  Fq6 ninv = fq6_inv(norm);
  return Fq12{fq6_mul(a.c0, ninv), fq6_neg(fq6_mul(a.c1, ninv))};
}

// Frobenius x -> x^q.  Coefficient of w^k (k = 0..5, in Fq2) maps to
// conj(c_k) * gamma_k with gamma_k = xi^(k (q-1)/6).
// Slot order: w^0 = c0.c0, w^2 = c0.c1, w^4 = c0.c2,
//             w^1 = c1.c0, w^3 = c1.c1, w^5 = c1.c2.
static inline Fq2 frob_gamma(int k) {
  Fq2 g;
  switch (k) {
    case 1:
      memcpy(g.c0.v, FROB_GAMMA1_C0, 32);
      memcpy(g.c1.v, FROB_GAMMA1_C1, 32);
      break;
    case 2:
      memcpy(g.c0.v, FROB_GAMMA2_C0, 32);
      memcpy(g.c1.v, FROB_GAMMA2_C1, 32);
      break;
    case 3:
      memcpy(g.c0.v, FROB_GAMMA3_C0, 32);
      memcpy(g.c1.v, FROB_GAMMA3_C1, 32);
      break;
    case 4:
      memcpy(g.c0.v, FROB_GAMMA4_C0, 32);
      memcpy(g.c1.v, FROB_GAMMA4_C1, 32);
      break;
    default:
      memcpy(g.c0.v, FROB_GAMMA5_C0, 32);
      memcpy(g.c1.v, FROB_GAMMA5_C1, 32);
      break;
  }
  return g;
}

static inline Fq12 fq12_frobenius(const Fq12 &a) {
  Fq12 r;
  r.c0.c0 = fq2_conj(a.c0.c0);                              // w^0
  r.c0.c1 = fq2_mul(fq2_conj(a.c0.c1), frob_gamma(2));      // w^2
  r.c0.c2 = fq2_mul(fq2_conj(a.c0.c2), frob_gamma(4));      // w^4
  r.c1.c0 = fq2_mul(fq2_conj(a.c1.c0), frob_gamma(1));      // w^1
  r.c1.c1 = fq2_mul(fq2_conj(a.c1.c1), frob_gamma(3));      // w^3
  r.c1.c2 = fq2_mul(fq2_conj(a.c1.c2), frob_gamma(5));      // w^5
  return r;
}

static inline Fq12 fq12_pow_bits(const Fq12 &a, const uint8_t *bits,
                                 int nbits) {
  Fq12 acc = fq12_one();
  for (int i = 0; i < nbits; ++i) {
    acc = fq12_sqr(acc);
    if (bits[i]) acc = fq12_mul(acc, a);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// E(Fq12): y^2 = x^3 + 3, affine, mirroring python_field.PyPoint semantics
// ---------------------------------------------------------------------------

struct Pt {
  Fq12 x, y;
  bool inf;
};

static inline Pt pt_inf() { return Pt{fq12_zero(), fq12_zero(), true}; }

static inline bool pt_eq(const Pt &a, const Pt &b) {
  if (a.inf || b.inf) return a.inf == b.inf;
  return fq12_eq(a.x, b.x) && fq12_eq(a.y, b.y);
}

static inline Pt pt_neg(const Pt &a) {
  if (a.inf) return a;
  return Pt{a.x, fq12_neg(a.y), false};
}

// chord/tangent slope (parity: python_field.line_slope / curve.rs:56-70)
static inline Fq12 line_slope(const Pt &p, const Pt &q) {
  if (pt_eq(p, q)) {
    // (3 x^2) / (2 y)   [a = 0]
    Fq12 x2 = fq12_sqr(p.x);
    Fq12 num = fq12_add(fq12_add(x2, x2), x2);
    Fq12 den = fq12_add(p.y, p.y);
    return fq12_mul(num, fq12_inv(den));
  }
  Fq12 num = fq12_sub(q.y, p.y);
  Fq12 den = fq12_sub(q.x, p.x);
  return fq12_mul(num, fq12_inv(den));
}

static inline Pt pt_add(const Pt &p, const Pt &q) {
  if (p.inf) return q;
  if (q.inf) return p;
  if (fq12_eq(p.x, q.x)) {
    if (!fq12_eq(p.y, q.y) || fq12_is_zero(p.y)) return pt_inf();
  }
  Fq12 s = line_slope(p, q);
  Fq12 x3 = fq12_sub(fq12_sub(fq12_sqr(s), p.x), q.x);
  Fq12 y3 = fq12_sub(fq12_mul(s, fq12_sub(p.x, x3)), p.y);
  return Pt{x3, y3, false};
}

// Normalized Miller line: line through P,Q over vertical through P+Q,
// evaluated at R (parity: python_field.get_lambda / curve.rs:285-311).
static inline Fq12 get_lambda(const Pt &p, const Pt &q, const Pt &r) {
  if (p.inf || q.inf || r.inf) return fq12_one();
  if ((pt_eq(p, q) && fq12_is_zero(p.y)) ||
      (!pt_eq(p, q) && fq12_eq(p.x, q.x))) {
    return fq12_sub(r.x, p.x);
  }
  Fq12 s = line_slope(p, q);
  Fq12 num = fq12_sub(fq12_sub(r.y, p.y), fq12_mul(s, fq12_sub(r.x, p.x)));
  Fq12 den =
      fq12_sub(fq12_add(fq12_add(r.x, p.x), q.x), fq12_sqr(s));
  return fq12_mul(num, fq12_inv(den));
}

// Miller loop: returns f_{m,P}(Q) and [m]P (parity: curve.rs:313-339).
static inline Fq12 miller(const Pt &p, const Pt &q, Pt *t_out) {
  Fq12 f = fq12_one();
  Pt t = p;
  for (int i = 1; i < ATE_LOOP_NBITS; ++i) {
    f = fq12_mul(fq12_sqr(f), get_lambda(t, t, q));
    t = pt_add(t, t);
    if (ATE_LOOP_BITS[i]) {
      f = fq12_mul(f, get_lambda(t, p, q));
      t = pt_add(t, p);
    }
  }
  *t_out = t;
  return f;
}

// final exponentiation f^((q^12-1)/r) decomposed as
// (q^6-1)(q^2+1) * (q^4-q^2+1)/r — exact identity, so bit-identical to the
// naive exponent the Python side uses (bn128.rs:179-180 parity).
static inline Fq12 final_exp(const Fq12 &f) {
  Fq12 t = fq12_mul(fq12_conj(f), fq12_inv(f));           // f^(q^6-1)
  t = fq12_mul(fq12_frobenius(fq12_frobenius(t)), t);     // ^(q^2+1)
  return fq12_pow_bits(t, FINAL_EXP_HARD_BITS, FINAL_EXP_HARD_NBITS);
}

// ---------------------------------------------------------------------------
// Tower -> poly-basis (Fq[x]/(x^12 - 18 x^6 + 82)) conversion
// ---------------------------------------------------------------------------

// tower element Sum_j (x_j + y_j u) w^j  ==  poly coeffs
//   p_j = x_j - 9 y_j,  p_{j+6} = y_j        (u = w^6 - 9)
static inline void tower_to_poly(const Fq12 &a, Fq out[12]) {
  const Fq2 *slots[6] = {&a.c0.c0, &a.c1.c0, &a.c0.c1,
                         &a.c1.c1, &a.c0.c2, &a.c1.c2};  // w^0..w^5
  Fq nine;
  memcpy(nine.v, MONT_NINE, sizeof(nine.v));
  for (int j = 0; j < 6; ++j) {
    out[j] = fq_sub(slots[j]->c0, fq_mul(nine, slots[j]->c1));
    out[j + 6] = slots[j]->c1;
  }
}

// The inverse of tower_to_poly: x_j = p_j + 9 p_{j+6}, y_j = p_{j+6}.
static inline Fq12 poly_to_tower(const Fq in[12]) {
  Fq nine;
  memcpy(nine.v, MONT_NINE, sizeof(nine.v));
  Fq12 a = fq12_zero();
  Fq2 *slots[6] = {&a.c0.c0, &a.c1.c0, &a.c0.c1,
                   &a.c1.c1, &a.c0.c2, &a.c1.c2};
  for (int j = 0; j < 6; ++j) {
    slots[j]->c1 = in[j + 6];
    slots[j]->c0 = fq_add(in[j], fq_mul(nine, in[j + 6]));
  }
  return a;
}

static inline Fq12 gt_from_limbs(const uint64_t *a) {
  Fq c[12];
  for (int i = 0; i < 12; ++i) c[i] = fq_from_limbs(a + 4 * i);
  return poly_to_tower(c);
}

static inline void gt_to_limbs(const Fq12 &r, uint64_t *out) {
  Fq c[12];
  tower_to_poly(r, c);
  for (int i = 0; i < 12; ++i) fq_to_limbs(c[i], out + 4 * i);
}

// ---------------------------------------------------------------------------
// Pairing entry points
// ---------------------------------------------------------------------------

// G1 (x, y) embeds as scalars; G2 ((x0,x1),(y0,y1)) untwists to
// (x * w^2, y * w^3): w^2 = v (Fq6 c1 slot of c0), w^3 = v w (Fq6 c1 of c1).
static inline Pt embed_g1(const uint64_t *xy, int inf) {
  if (inf) return pt_inf();
  Pt p;
  p.inf = false;
  p.x = fq12_zero();
  p.y = fq12_zero();
  p.x.c0.c0.c0 = fq_from_limbs(xy);
  p.y.c0.c0.c0 = fq_from_limbs(xy + 4);
  return p;
}

static inline Pt embed_g2(const uint64_t *xy, int inf) {
  if (inf) return pt_inf();
  Pt p;
  p.inf = false;
  p.x = fq12_zero();
  p.y = fq12_zero();
  p.x.c0.c1 = fq2_make(fq_from_limbs(xy), fq_from_limbs(xy + 4));
  p.y.c1.c1 = fq2_make(fq_from_limbs(xy + 8), fq_from_limbs(xy + 12));
  return p;
}

// Miller value including the two Frobenius correction lines (unexponentiated),
// mirroring bn254.py::optimal_ate_pairing / bn128.rs:147-181.
static inline Fq12 ate_miller(const Pt &p, const Pt &q) {
  if (p.inf || q.inf || pt_eq(p, q)) return fq12_one();
  Pt t;
  Fq12 f = miller(q, p, &t);
  Pt q1 = Pt{fq12_frobenius(q.x), fq12_frobenius(q.y), false};
  Pt nq2 = Pt{fq12_frobenius(q1.x), fq12_neg(fq12_frobenius(q1.y)), false};
  f = fq12_mul(f, get_lambda(t, q1, p));
  t = pt_add(t, q1);
  f = fq12_mul(f, get_lambda(t, nq2, p));
  return f;
}

extern "C" {

// e(P, Q).  g1: 8 u64 (x, y), g2: 16 u64 (x0, x1, y0, y1), out: 48 u64
// poly-basis coefficients; all standard-form little-endian limbs.
void bn254_pairing(const uint64_t *g1, int g1_inf, const uint64_t *g2,
                   int g2_inf, uint64_t *out) {
  Pt p = embed_g1(g1, g1_inf);
  Pt q = embed_g2(g2, g2_inf);
  Fq12 f = final_exp(ate_miller(p, q));
  Fq coeffs[12];
  tower_to_poly(f, coeffs);
  for (int i = 0; i < 12; ++i) fq_to_limbs(coeffs[i], out + 4 * i);
}

// prod_i e(P_i, Q_i) with a single shared final exponentiation.  g1s: 8 u64
// (x, y) per point, g2s: 16 u64 (x0, x1, y0, y1), out: 48 u64 poly-basis
// coefficients; all standard-form little-endian limbs.
void bn254_multi_pairing(int n, const uint64_t *g1s, const int *g1_infs,
                         const uint64_t *g2s, const int *g2_infs,
                         uint64_t *out) {
  Fq12 acc = fq12_one();
  for (int i = 0; i < n; ++i) {
    Pt p = embed_g1(g1s + 8 * i, g1_infs[i]);
    Pt q = embed_g2(g2s + 16 * i, g2_infs[i]);
    acc = fq12_mul(acc, ate_miller(p, q));
  }
  Fq12 f = final_exp(acc);
  Fq coeffs[12];
  tower_to_poly(f, coeffs);
  for (int i = 0; i < 12; ++i) fq_to_limbs(coeffs[i], out + 4 * i);
}

// GT (poly-basis F_q12) helpers: a, b, out are 48-u64 standard-form blobs.
void bn254_gt_mul(const uint64_t *a, const uint64_t *b, uint64_t *out) {
  gt_to_limbs(fq12_mul(gt_from_limbs(a), gt_from_limbs(b)), out);
}

// e: nbits MSB-first bits.
void bn254_gt_pow(const uint64_t *a, const uint8_t *bits, int nbits,
                  uint64_t *out) {
  gt_to_limbs(fq12_pow_bits(gt_from_limbs(a), bits, nbits), out);
}

void bn254_gt_inv(const uint64_t *a, uint64_t *out) {
  gt_to_limbs(fq12_inv(gt_from_limbs(a)), out);
}

}  // extern "C"

}  // namespace bn254
