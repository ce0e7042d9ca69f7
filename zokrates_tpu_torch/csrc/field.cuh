// Montgomery field and Jacobian EC arithmetic for the kernels of csrc/
// (sm_90a): the MSM walks and suffix epilogue, the elementwise field
// kernels and the NTT.
//
// Device counterpart of the plain helpers in kernels/pallas_field.py (and
// of the JAX package's kernels/pallas_field.py _F / _F2 / _general_add /
// _mixed_add_inline and msm_sorted._double_inline). Elements are N limbs
// of 32 bits, a template parameter: N = 8 for BN254's fields and the
// 255-bit scalar fields of BLS12-381 and BLS12-377, N = 12 for the BLS12
// base fields and BW6-761's scalar field, N = 24 for BW6-761's base field;
// products are native 32x32->64. The Montgomery radix is
// R = 2^(32N), the same R as the public 2N x 16-bit limb layout, so
// Montgomery values cross the boundary unchanged.
//
// Every op returns the canonical residue in [0, p), and every formula
// computes the same residues as its plain PyTorch version, in the same
// order, including the values left in X and Y of a point at infinity.
// That is what makes kernel and plain outputs bit-equal. Where the plain
// version computes a branch and selects (the doubling inside the adds),
// the kernel branches instead; the selected value is the same.
//
// The modulus and Montgomery constants arrive as a FieldParams<N> kernel
// argument, filled by the Python wrapper from fields/params.py.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace zkt {

template <int N>  // N: 32-bit limbs per element
struct Fq {
  static constexpr int kN = N;
  uint32_t v[N];
};

template <int N>
struct Fq2 {
  static constexpr int kN = N;
  Fq<N> c0, c1;  // c0 + c1*u, u^2 = -beta_abs
};

template <int N>
struct FieldParams {
  Fq<N> p;       // modulus
  Fq<N> one;     // R mod p (Montgomery one)
  uint32_t n0;   // -p^-1 mod 2^32
  int beta_abs;  // Fq2 non-residue magnitude: u^2 = -beta_abs
};

// The width of the multiply-rate probe (probe.cu): the 254/255-bit fields
// (BN254's base and scalar fields, the BLS12 curves' scalar fields). The
// other kernels are templates over N.
constexpr int NL = 8;
using Fq8 = Fq<NL>;
using FieldParams8 = FieldParams<NL>;

// ---------------------------------------------------------------------------
// Fq
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ uint32_t add_raw(Fq<N>& r, const Fq<N>& a, const Fq<N>& b) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

template <int N>
__device__ __forceinline__ uint32_t sub_raw(Fq<N>& r, const Fq<N>& a, const Fq<N>& b) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t d = (uint64_t)a.v[i] - b.v[i] - borrow;
    r.v[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return borrow;
}

// t + hi*2^(32N) (< 2p) -> [0, p)
template <int N>
__device__ __forceinline__ Fq<N> cond_sub_p(const Fq<N>& t, uint32_t hi, const FieldParams<N>& P) {
  Fq<N> d;
  uint32_t borrow = sub_raw(d, t, P.p);
  return (hi != 0 || borrow == 0) ? d : t;
}

template <int N>
__device__ __forceinline__ bool is_zero(const Fq<N>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) acc |= a.v[i];
  return acc == 0;
}

template <int N>
__device__ __forceinline__ Fq<N> add(const Fq<N>& a, const Fq<N>& b, const FieldParams<N>& P) {
  Fq<N> s;
  uint32_t c = add_raw(s, a, b);
  return cond_sub_p(s, c, P);
}

template <int N>
__device__ __forceinline__ Fq<N> sub(const Fq<N>& a, const Fq<N>& b, const FieldParams<N>& P) {
  Fq<N> d;
  if (sub_raw(d, a, b)) add_raw(d, d, P.p);  // wraps back into [0, p)
  return d;
}

template <int N>
__device__ __forceinline__ Fq<N> neg(const Fq<N>& a, const FieldParams<N>& P) {
  if (is_zero(a)) return a;
  Fq<N> d;
  sub_raw(d, P.p, a);
  return d;
}

// CIOS Montgomery product a*b*R^-1 mod p, inlined only into the two
// out-of-line products below: the EC formulas call them 11-69 times per
// point op, and inlining every call multiplies the kernels' code size
// (and nvcc's compile time) for little gain. Per limb i of a: N products
// a_i*b_j and N products m*p_j, low and high halves, and m = t_0*n0 (low
// half only): N*(4N+1) 32-bit multiplies a product, 264 at N = 8 and 588
// at N = 12.
template <int N>
__device__ __forceinline__ Fq<N> mont_mul(const Fq<N>& a, const Fq<N>& b, const FieldParams<N>& P) {
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t C = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a.v[i] * b.v[j] + t[j] + C;
      t[j] = (uint32_t)s;
      C = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + C;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * P.n0;
    s = (uint64_t)m * P.p.v[0] + t[0];
    C = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * P.p.v[j] + t[j] + C;
      t[j - 1] = (uint32_t)s;
      C = s >> 32;
    }
    s = (uint64_t)t[N] + C;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  Fq<N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = t[i];
  return cond_sub_p(r, t[N], P);
}

template <int N>
__device__ __noinline__ Fq<N> mul(Fq<N> a, Fq<N> b, const FieldParams<N>& P) {
  return mont_mul(a, b, P);
}

template <int N>
__device__ __forceinline__ Fq<N> select(bool c, const Fq<N>& a, const Fq<N>& b) { return c ? a : b; }

template <int N>
__device__ __forceinline__ void set_zero(Fq<N>& a) {
#pragma unroll
  for (int i = 0; i < N; ++i) a.v[i] = 0;
}

template <int N>
__device__ __forceinline__ void set_one(Fq<N>& a, const FieldParams<N>& P) { a = P.one; }

// ---------------------------------------------------------------------------
// Fq2 (Karatsuba, c0 = t0 - beta_abs*t1 by an add chain)
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ bool is_zero(const Fq2<N>& a) { return is_zero(a.c0) && is_zero(a.c1); }

template <int N>
__device__ __forceinline__ Fq2<N> add(const Fq2<N>& a, const Fq2<N>& b, const FieldParams<N>& P) {
  return {add(a.c0, b.c0, P), add(a.c1, b.c1, P)};
}

template <int N>
__device__ __forceinline__ Fq2<N> sub(const Fq2<N>& a, const Fq2<N>& b, const FieldParams<N>& P) {
  return {sub(a.c0, b.c0, P), sub(a.c1, b.c1, P)};
}

template <int N>
__device__ __forceinline__ Fq2<N> neg(const Fq2<N>& a, const FieldParams<N>& P) {
  return {neg(a.c0, P), neg(a.c1, P)};
}

template <int N>
__device__ __forceinline__ Fq<N> mul_small(const Fq<N>& x, int k, const FieldParams<N>& P) {
  Fq<N> acc, dbl = x;
  bool have = false;
  while (k) {
    if (k & 1) {
      acc = have ? add(acc, dbl, P) : dbl;
      have = true;
    }
    k >>= 1;
    if (k) dbl = add(dbl, dbl, P);
  }
  return acc;
}

// One out-of-line call for the three Fq products of a Karatsuba step,
// inlined together: their independent multiply chains interleave, the
// Fq2 point ops make a third of the calls, and the Fq2 kernels spill
// less than with three out-of-line Fq products (times in PERF.md).
template <int N>
__device__ __noinline__ Fq2<N> mul(Fq2<N> a, Fq2<N> b, const FieldParams<N>& P) {
  const Fq<N> s = add(a.c0, a.c1, P);
  const Fq<N> t = add(b.c0, b.c1, P);
  const Fq<N> t0 = mont_mul(a.c0, b.c0, P);
  const Fq<N> t1 = mont_mul(a.c1, b.c1, P);
  const Fq<N> t2 = mont_mul(s, t, P);
  return {sub(t0, mul_small(t1, P.beta_abs, P), P), sub(sub(t2, t0, P), t1, P)};
}

template <int N>
__device__ __forceinline__ Fq2<N> select(bool c, const Fq2<N>& a, const Fq2<N>& b) { return c ? a : b; }

template <int N>
__device__ __forceinline__ void set_zero(Fq2<N>& a) {
  set_zero(a.c0);
  set_zero(a.c1);
}

template <int N>
__device__ __forceinline__ void set_one(Fq2<N>& a, const FieldParams<N>& P) {
  a.c0 = P.one;
  set_zero(a.c1);
}

// ---------------------------------------------------------------------------
// Jacobian points over E in {Fq<N>, Fq2<N>}; Z == 0 is infinity; curves have a = 0
// ---------------------------------------------------------------------------

template <class E>
struct Jac {
  E X, Y, Z;
};

// dbl-2009-l
template <class E>
__device__ Jac<E> ec_double(const Jac<E>& P1, const FieldParams<E::kN>& P) {
  E A = mul(P1.X, P1.X, P);
  E Bv = mul(P1.Y, P1.Y, P);
  E C = mul(Bv, Bv, P);
  E t = add(P1.X, Bv, P);
  E D = sub(sub(mul(t, t, P), A, P), C, P);
  D = add(D, D, P);
  E Ee = add(add(A, A, P), A, P);
  E Fv = mul(Ee, Ee, P);
  Jac<E> R;
  R.X = sub(Fv, add(D, D, P), P);
  E C8 = add(C, C, P);
  C8 = add(C8, C8, P);
  C8 = add(C8, C8, P);
  R.Y = sub(mul(Ee, sub(D, R.X, P), P), C8, P);
  E YZ = mul(P1.Y, P1.Z, P);
  R.Z = add(YZ, YZ, P);
  return R;
}

// Complete Jacobian + Jacobian add (same selection order as the plain
// _general_add: q_inf -> P1, else p_inf -> P2, else double / cancel / sum).
template <class E>
__device__ Jac<E> ec_add(const Jac<E>& P1, const Jac<E>& P2, const FieldParams<E::kN>& P) {
  if (is_zero(P2.Z)) return P1;
  if (is_zero(P1.Z)) return P2;
  E Z1Z1 = mul(P1.Z, P1.Z, P);
  E Z2Z2 = mul(P2.Z, P2.Z, P);
  E U1 = mul(P1.X, Z2Z2, P);
  E U2 = mul(P2.X, Z1Z1, P);
  E S1 = mul(mul(P1.Y, P2.Z, P), Z2Z2, P);
  E S2 = mul(mul(P2.Y, P1.Z, P), Z1Z1, P);
  E H = sub(U2, U1, P);
  E R = sub(S2, S1, P);
  bool same_x = is_zero(H);
  bool same_y = is_zero(R);
  if (same_x && same_y) return ec_double(P1, P);
  E H2 = add(H, H, P);
  E I = mul(H2, H2, P);
  E J = mul(H, I, P);
  E R2 = add(R, R, P);
  E V = mul(U1, I, P);
  E R2sq = mul(R2, R2, P);
  Jac<E> O;
  O.X = sub(sub(R2sq, J, P), add(V, V, P), P);
  E S1J = mul(S1, J, P);
  O.Y = sub(mul(R2, sub(V, O.X, P), P), add(S1J, S1J, P), P);
  if (same_x) {  // P2 == -P1
    set_zero(O.Z);
  } else {
    E Zs = add(P1.Z, P2.Z, P);
    O.Z = mul(sub(sub(mul(Zs, Zs, P), Z1Z1, P), Z2Z2, P), H, P);
  }
  return O;
}

// Mixed Jacobian + affine add. SAFE=false skips the doubling branch and
// reports through is_dbl that the result is wrong (P1 == Q); the caller
// reruns with SAFE=true.
template <class E, bool SAFE>
__device__ Jac<E> ec_mixed_add(const Jac<E>& P1, const E& Qx, const E& Qy, bool& is_dbl,
                               const FieldParams<E::kN>& P) {
  is_dbl = false;
  Jac<E> O;
  if (is_zero(P1.Z)) {
    O.X = Qx;
    O.Y = Qy;
    set_one(O.Z, P);
    return O;
  }
  E Z1Z1 = mul(P1.Z, P1.Z, P);
  E U2 = mul(Qx, Z1Z1, P);
  E S2 = mul(mul(Qy, P1.Z, P), Z1Z1, P);
  E H = sub(U2, P1.X, P);
  E R = sub(S2, P1.Y, P);
  bool same_x = is_zero(H);
  bool same_y = is_zero(R);
  is_dbl = same_x && same_y;
  if (SAFE && is_dbl) return ec_double(P1, P);
  E H2 = add(H, H, P);
  E I = mul(H2, H2, P);
  E J = mul(H, I, P);
  E R2 = add(R, R, P);
  E V = mul(P1.X, I, P);
  E R2sq = mul(R2, R2, P);
  O.X = sub(sub(R2sq, J, P), add(V, V, P), P);
  E Y1J = mul(P1.Y, J, P);
  O.Y = sub(mul(R2, sub(V, O.X, P), P), add(Y1J, Y1J, P), P);
  if (same_x && !same_y) {
    set_zero(O.Z);
  } else {
    O.Z = mul(add(P1.Z, P1.Z, P), H, P);
  }
  return O;
}

// ---------------------------------------------------------------------------
// Public limb layout: int32 rows of 16-bit limbs, lane-minor. Coordinate
// rows of E start at `row`; Fq2 is [c0 limbs | c1 limbs].
// ---------------------------------------------------------------------------

template <class E>
struct Rows;
template <int N>
struct Rows<Fq<N>> {
  static constexpr int value = 2 * N;
};
template <int N>
struct Rows<Fq2<N>> {
  static constexpr int value = 4 * N;
};

template <int N>
__device__ __forceinline__ void load(Fq<N>& a, const int32_t* base, size_t row, size_t L, size_t lane) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint32_t lo = (uint32_t)base[(row + 2 * i) * L + lane];
    uint32_t hi = (uint32_t)base[(row + 2 * i + 1) * L + lane];
    a.v[i] = lo | (hi << 16);
  }
}

template <int N>
__device__ __forceinline__ void load(Fq2<N>& a, const int32_t* base, size_t row, size_t L, size_t lane) {
  load(a.c0, base, row, L, lane);
  load(a.c1, base, row + 2 * N, L, lane);
}

template <int N>
__device__ __forceinline__ void store(int32_t* base, size_t row, size_t L, size_t lane, const Fq<N>& a) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    base[(row + 2 * i) * L + lane] = (int32_t)(a.v[i] & 0xFFFFu);
    base[(row + 2 * i + 1) * L + lane] = (int32_t)(a.v[i] >> 16);
  }
}

template <int N>
__device__ __forceinline__ void store(int32_t* base, size_t row, size_t L, size_t lane, const Fq2<N>& a) {
  store(base, row, L, lane, a.c0);
  store(base, row + 2 * N, L, lane, a.c1);
}

template <class E>
__device__ __forceinline__ void load_jac(Jac<E>& Pt, const int32_t* base, size_t row, size_t L, size_t lane) {
  constexpr int ER = Rows<E>::value;
  load(Pt.X, base, row, L, lane);
  load(Pt.Y, base, row + ER, L, lane);
  load(Pt.Z, base, row + 2 * ER, L, lane);
}

template <class E>
__device__ __forceinline__ void store_jac(int32_t* base, size_t row, size_t L, size_t lane, const Jac<E>& Pt) {
  constexpr int ER = Rows<E>::value;
  store(base, row, L, lane, Pt.X);
  store(base, row + ER, L, lane, Pt.Y);
  store(base, row + 2 * ER, L, lane, Pt.Z);
}

// ---------------------------------------------------------------------------
// Element-major layout of the plain field ops: one element is 2*N int64
// words, each holding a 16-bit limb, least significant first (Fq2: c0's
// words, then c1's). The words of an element are 16-byte aligned whenever
// the tensor starts on an element boundary.
// ---------------------------------------------------------------------------

template <int N = NL>
__device__ __forceinline__ Fq<N> load_wide(const int64_t* src) {
  const longlong2* v = reinterpret_cast<const longlong2*>(src);
  Fq<N> a;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const longlong2 w = __ldg(v + i);
    a.v[i] = (uint32_t)w.x | ((uint32_t)w.y << 16);
  }
  return a;
}

template <int N>
__device__ __forceinline__ void store_wide(int64_t* dst, const Fq<N>& a) {
  longlong2* v = reinterpret_cast<longlong2*>(dst);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = make_longlong2(a.v[i] & 0xFFFFu, a.v[i] >> 16);
}

template <int N>
__device__ __forceinline__ void store_wide(int64_t* dst, const Fq2<N>& a) {
  store_wide(dst, a.c0);
  store_wide(dst + 2 * N, a.c1);
}

// Host side: the constants of a FieldParams<N> from little-endian 32-bit limbs.
template <int N>
inline FieldParams<N> make_params(const uint32_t* p, const uint32_t* one, uint32_t n0, int beta_abs) {
  FieldParams<N> P;
  for (int i = 0; i < N; ++i) {
    P.p.v[i] = p[i];
    P.one.v[i] = one[i];
  }
  P.n0 = n0;
  P.beta_abs = beta_abs;
  return P;
}

}  // namespace zkt
