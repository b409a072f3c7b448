// GF(2^255 - 19) and twisted-Edwards (a = -1) arithmetic in 10 signed
// limbs of radix 2^26, held in int32, for every kernel of the port:
// madd_chain.cu (madd_chain_entries: ten threads a lane, one limb each;
// madd_chain_fused: one lane a thread), ladder.cu (ten threads a lane)
// and finish.cu (one lane a thread for its product tree and lane work,
// ten threads for the one inversion of a block, `ginvert`).
//
// Boundary. The torch code and the comb tables use 20 limbs of radix
// 2^13. 10 x 26 = 20 x 13 = 260 bits, so limb i here is exactly
// l13[2i] + (l13[2i + 1] << 13) (`pack13`), and a result leaves through
// `to_boundary`, which brings it back to the 20 x 13 loose range
// [-608, 2^13 + 608) that the torch `fe_carry` produces (limbs 1..19 in
// [0, 2^13)). 2^260 = 32 * 2^255 = 32 * 19 = 608 (mod p).
//
// Product. a * b is a 10 x 10 schoolbook into int64 columns. Column k
// (k < 10) has weight 2^(26k) ("lo"); column k + 10 has weight
// 2^260 * 2^(26k) ("hi", hi[9] = 0) and folds into limb k times 608.
// Limb-parallel, thread k of a lane's group forms lo[k] and hi[k]: the
// ten products a[i] * b[(k - i) mod 10] split into lo (i <= k) and hi
// (i > k), so every thread does exactly ten wide multiply-adds.
//
// Carry (`round1_t`, `round1_s`, `take`; both layouts run the same
// arithmetic, the group passes the carries with one shuffle a round):
//   t[k] = lo[k] + 608 * (hi[k] & M)          hi is carried BEFORE the
//   s[k] = (t[k] >> 26) + 608 * (hi[k] >> 26)   x608, so no column is
//   u[k] = (t[k] & M) + s[k - 1]                ever multiplied whole
//   u[0] = (t[0] & M) + 608 * s[9]
//   out[k] = (u[k] & M) + (u[k - 1] >> 26), out[0] gets 608 * (u[9] >> 26)
//
// Bounds (checked by tests/test_torch_field_r26.py on a model of this
// arithmetic, with interval bounds and with random worst-case inputs):
// * a product's output ("loose") has limb 0 in (-2^22.6, 2^26.2) and
//   limbs 1..9 in (-2^16.7, 2^26 + 2^16.7);
// * the point formulas multiply sums and differences of at most four
//   loose values (2Z + c, 2c + a - b, ...) and canonical table limbs:
//   |limb| < 2^28.2, inside int32;
// * then every column, t and s stay below 2^59.4 in magnitude: int64
//   holds all of it with three bits to spare, and the output is loose
//   again (the range is closed).
#pragma once

#include <cstdint>

namespace r26 {

constexpr int NL = 10;
constexpr int RADIX = 26;
constexpr int64_t MASK = (int64_t{1} << RADIX) - 1;
constexpr int64_t FOLD = 608;
constexpr unsigned FULL = 0xffffffffu;

// 2d in radix 2^26 (static: one copy in each kernel source)
static __constant__ int32_t kD2[NL] = {45281625, 27714825, 51736253, 40503822, 57364,
                                       62714956, 15208238, 66296934, 31217375, 590262};

// ---------------------------------------------------------------------------
// carry steps shared by both layouts (per limb; `take` receives limb
// k-1's carry, or limb 9's for k = 0 with the 608 applied)

__device__ __forceinline__ int64_t round1_t(int64_t lo, int64_t hi) {
  return lo + FOLD * (hi & MASK);
}
__device__ __forceinline__ int64_t round1_s(int64_t t, int64_t hi) {
  return (t >> RADIX) + FOLD * (hi >> RADIX);
}
__device__ __forceinline__ int64_t take(int64_t from_below, int k) {
  return k == 0 ? FOLD * from_below : from_below;
}

// ---------------------------------------------------------------------------
// one lane per thread: an element is int32_t[10]

__device__ __forceinline__ void fe_mul(int32_t out[NL], const int32_t a[NL],
                                       const int32_t b[NL]) {
  int64_t lo[NL], hi[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) lo[k] = hi[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const int64_t p = static_cast<int64_t>(a[i]) * b[j];
      if (i + j < NL) lo[i + j] += p;
      else hi[i + j - NL] += p;
    }
  }
  int64_t t[NL], s[NL], u[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    t[k] = round1_t(lo[k], hi[k]);
    s[k] = round1_s(t[k], hi[k]);
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) u[k] = (t[k] & MASK) + take(s[(k + NL - 1) % NL], k);
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    out[k] = static_cast<int32_t>((u[k] & MASK) + take(u[(k + NL - 1) % NL] >> RADIX, k));
  }
}

// 20 x 13-bit limbs (canonical, as the tables hold them) -> radix 2^26
__device__ __forceinline__ void pack13(int32_t out[NL], const int32_t* l13) {
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = l13[2 * i] + (l13[2 * i + 1] << 13);
}

// acc += entry (ypx, ymx, t2d), madd-2008-hwcd-3 with a = -1, Z2 = 1:
// 7 multiplies, the formula of the torch `pt_madd`
__device__ __forceinline__ void madd(int32_t X[NL], int32_t Y[NL], int32_t Z[NL],
                                     int32_t T[NL], const int32_t ypx[NL],
                                     const int32_t ymx[NL], const int32_t t2d[NL]) {
  int32_t a[NL], b[NL], c[NL], u[NL], v[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    u[i] = Y[i] - X[i];
    v[i] = Y[i] + X[i];
  }
  fe_mul(a, u, ymx);
  fe_mul(b, v, ypx);
  fe_mul(c, T, t2d);
  int32_t e[NL], f[NL], g[NL], h[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int32_t d = 2 * Z[i];
    e[i] = b[i] - a[i];
    f[i] = d - c[i];
    g[i] = d + c[i];
    h[i] = b[i] + a[i];
  }
  fe_mul(X, e, f);
  fe_mul(Y, g, h);
  fe_mul(Z, f, g);
  fe_mul(T, e, h);
}

// P1 += P2, both extended: add-2008-hwcd-3, a = -1, 9 multiplies, the
// formula of the torch `pt_add`. d2 is 2d packed.
__device__ __forceinline__ void add(int32_t X[NL], int32_t Y[NL], int32_t Z[NL],
                                    int32_t T[NL], const int32_t X2[NL],
                                    const int32_t Y2[NL], const int32_t Z2[NL],
                                    const int32_t T2[NL], const int32_t d2[NL]) {
  int32_t ypx[NL], ymx[NL], z2[NL], t2d[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    ypx[i] = Y2[i] + X2[i];
    ymx[i] = Y2[i] - X2[i];
    z2[i] = 2 * Z2[i];
  }
  fe_mul(t2d, T2, d2);
  int32_t a[NL], b[NL], c[NL], d[NL], u[NL], v[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    u[i] = Y[i] - X[i];
    v[i] = Y[i] + X[i];
  }
  fe_mul(a, u, ymx);
  fe_mul(b, v, ypx);
  fe_mul(c, T, t2d);
  fe_mul(d, Z, z2);
  int32_t e[NL], f[NL], g[NL], h[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    e[i] = b[i] - a[i];
    f[i] = d[i] - c[i];
    g[i] = d[i] + c[i];
    h[i] = b[i] + a[i];
  }
  fe_mul(X, e, f);
  fe_mul(Y, g, h);
  fe_mul(Z, f, g);
  fe_mul(T, e, h);
}

__device__ __forceinline__ void set_identity(int32_t X[NL], int32_t Y[NL], int32_t Z[NL],
                                             int32_t T[NL]) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    X[i] = 0;
    Y[i] = i == 0;
    Z[i] = i == 0;
    T[i] = 0;
  }
}

// ---------------------------------------------------------------------------
// whole-element helpers on int64 limbs (every thread of a group holds the
// whole element after `gather`)

// radix 2^26 -> 20 x 13 limbs with two sequential carry passes: limbs
// 1..19 in [0, 2^13), limb 0 in [-608, 2^13 + 608)
__device__ __forceinline__ void to_boundary(int32_t out[2 * NL], const int64_t v[NL]) {
  int64_t c[2 * NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    c[2 * i] = v[i] & 8191;
    c[2 * i + 1] = v[i] >> 13;
  }
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    int64_t carry = 0;
#pragma unroll
    for (int i = 0; i < 2 * NL; ++i) {
      const int64_t x = c[i] + carry;
      carry = x >> 13;
      c[i] = x & 8191;
    }
    c[0] += FOLD * carry;
  }
#pragma unroll
  for (int i = 0; i < 2 * NL; ++i) out[i] = static_cast<int32_t>(c[i]);
}

// sequential carry of 10 limbs, the carry out of limb 9 folded by 608
__device__ __forceinline__ void carry_seq(int64_t v[NL]) {
  int64_t carry = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int64_t x = v[i] + carry;
    carry = x >> RADIX;
    v[i] = x & MASK;
  }
  v[0] += FOLD * carry;
}

// the canonical representative in [0, p), limbs in [0, 2^26), from a
// loose element (the steps of the torch `fe_canon`)
__device__ __forceinline__ void canon(int64_t v[NL]) {
  carry_seq(v);
  carry_seq(v);  // value in [-608, 2^260 + 608)
  // + 16p = 2^259 - 304 makes it positive and leaves it below 2^261
  v[0] += MASK + 1 - 304;
#pragma unroll
  for (int i = 1; i < NL - 1; ++i) v[i] += MASK;
  v[NL - 1] += (int64_t{1} << 25) - 1;
#pragma unroll
  for (int r = 0; r < 3; ++r) {  // fold bits >= 255 (limb 9 holds 234..259)
    carry_seq(v);
    const int64_t top = v[NL - 1] >> 21;
    v[NL - 1] &= (int64_t{1} << 21) - 1;
    v[0] += 19 * top;
  }
  carry_seq(v);
  // now below 2^255 + 19 * 2: subtract p once when v >= p
  bool ge = v[0] >= MASK + 1 - 19 && v[NL - 1] == (int64_t{1} << 21) - 1;
#pragma unroll
  for (int i = 1; i < NL - 1; ++i) ge = ge && v[i] == MASK;
  if (ge) {
    v[0] -= MASK + 1 - 19;
#pragma unroll
    for (int i = 1; i < NL; ++i) v[i] = 0;
  }
}

// ---------------------------------------------------------------------------
// limb-parallel: ten threads of a warp hold one element, thread k limb k.
// Lanes 0..29 of a warp form three groups; lanes 30 and 31 run the same
// code on junk, so every shuffle is over the full mask and no thread
// leaves a shuffle early.

struct Group {
  int k;     // this thread's limb
  int base;  // warp lane of the group's limb 0
};

__device__ __forceinline__ Group group_of_thread() {
  const int wl = threadIdx.x & 31;
  return Group{wl % NL, wl - wl % NL};
}

// every limb of the element, in every thread of the group
__device__ __forceinline__ void gather(int64_t all[NL], int32_t mine, const Group& g) {
#pragma unroll
  for (int i = 0; i < NL; ++i) all[i] = __shfl_sync(FULL, mine, g.base + i);
}

// limb k-1's value (limb 9's for k = 0)
__device__ __forceinline__ int64_t from_below(int64_t v, const Group& g) {
  return __shfl_sync(FULL, v, g.base + (g.k + NL - 1) % NL);
}

// one coordinate of a lane into out (4, 20, B), back in the boundary
// form: thread k writes limbs 2k and 2k + 1 (indices are compile-time in
// the unrolled select, so the limbs stay in registers)
__device__ __forceinline__ void gstore(int32_t* out, int coord, int32_t mine, const Group& g,
                                       int64_t lane, int64_t B, bool active) {
  int64_t v[NL];
  gather(v, mine, g);
  int32_t l13[2 * NL];
  to_boundary(l13, v);
  if (active) {
    int32_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      if (i == g.k) {
        lo = l13[2 * i];
        hi = l13[2 * i + 1];
      }
    }
    out[(coord * 2 * NL + 2 * g.k) * B + lane] = lo;
    out[(coord * 2 * NL + 2 * g.k + 1) * B + lane] = hi;
  }
}

// The product a[i] * b[(k - i) mod 10] goes to lo (i <= k) or hi: the
// factor a[i] is masked, not the sum, and even and odd i sum apart, so
// the four sums are independent chains of five multiply-adds (the same
// integers as one chain of ten with a select after each: the chain of
// `ginvert` is latency-bound on this step).
__device__ __forceinline__ int32_t gmul(int32_t a, int32_t b, const Group& g) {
  int64_t lo[2] = {0, 0}, hi[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int32_t ai = __shfl_sync(FULL, a, g.base + i);
    const int32_t bj = __shfl_sync(FULL, b, g.base + (g.k - i + NL) % NL);
    const int32_t a_lo = i <= g.k ? ai : 0;
    lo[i & 1] += static_cast<int64_t>(a_lo) * bj;
    hi[i & 1] += static_cast<int64_t>(ai - a_lo) * bj;
  }
  const int64_t t = round1_t(lo[0] + lo[1], hi[0] + hi[1]);
  const int64_t s = round1_s(t, hi[0] + hi[1]);
  const int64_t u = (t & MASK) + take(from_below(s, g), g.k);
  return static_cast<int32_t>((u & MASK) + take(from_below(u >> RADIX, g), g.k));
}

__device__ __forceinline__ int32_t gsq_n(int32_t x, int n, const Group& g) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = gmul(x, x, g);
  return x;
}

// z^(p - 2), the addition chain of the torch `fe_invert` (254
// squarings, 11 multiplies): 1/z, and 0 for z = 0
__device__ inline int32_t ginvert(int32_t z, const Group& g) {
  const int32_t z2 = gmul(z, z, g);
  const int32_t z9 = gmul(gsq_n(z2, 2, g), z, g);
  const int32_t z11 = gmul(z9, z2, g);
  const int32_t z5 = gmul(gmul(z11, z11, g), z9, g);
  const int32_t z10 = gmul(gsq_n(z5, 5, g), z5, g);
  const int32_t z20 = gmul(gsq_n(z10, 10, g), z10, g);
  const int32_t z40 = gmul(gsq_n(z20, 20, g), z20, g);
  const int32_t z50 = gmul(gsq_n(z40, 10, g), z10, g);
  const int32_t z100 = gmul(gsq_n(z50, 50, g), z50, g);
  const int32_t z200 = gmul(gsq_n(z100, 100, g), z100, g);
  const int32_t z250 = gmul(gsq_n(z200, 50, g), z50, g);
  return gmul(gsq_n(z250, 5, g), z11, g);
}

struct GPoint {
  int32_t X, Y, Z, T;
};

// doubling, dbl-2008-hwcd (the torch `pt_double`): 4 squarings and 3
// multiplies, and T (the fourth multiply) only when with_t
__device__ __forceinline__ GPoint gdbl(const GPoint& p, bool with_t, const Group& g) {
  const int32_t a = gmul(p.X, p.X, g);
  const int32_t b = gmul(p.Y, p.Y, g);
  const int32_t c = gmul(p.Z, p.Z, g);
  const int32_t s = p.X + p.Y;
  const int32_t ss = gmul(s, s, g);
  const int32_t h = a + b;
  const int32_t e = h - ss;
  const int32_t gg = a - b;
  const int32_t f = 2 * c + gg;
  GPoint r;
  r.X = gmul(e, f, g);
  r.Y = gmul(gg, h, g);
  r.Z = gmul(f, gg, g);
  r.T = with_t ? gmul(e, h, g) : 0;
  return r;
}

// p + q with q in cached form (Y + X, Y - X, 2d T, 2Z): 8 multiplies
struct GCached {
  int32_t ypx, ymx, t2d, z2;
};

__device__ __forceinline__ GCached gcache(const GPoint& q, int32_t d2, const Group& g) {
  return GCached{q.Y + q.X, q.Y - q.X, gmul(q.T, d2, g), 2 * q.Z};
}

__device__ __forceinline__ GPoint gadd(const GPoint& p, const GCached& q, const Group& g) {
  const int32_t a = gmul(p.Y - p.X, q.ymx, g);
  const int32_t b = gmul(p.Y + p.X, q.ypx, g);
  const int32_t c = gmul(p.T, q.t2d, g);
  const int32_t d = gmul(p.Z, q.z2, g);
  const int32_t e = b - a, f = d - c, gg = d + c, h = b + a;
  return GPoint{gmul(e, f, g), gmul(gg, h, g), gmul(f, gg, g), gmul(e, h, g)};
}

// p + affine entry (ypx, ymx, t2d), Z2 = 1: 7 multiplies
__device__ __forceinline__ GPoint gmadd(const GPoint& p, int32_t ypx, int32_t ymx,
                                        int32_t t2d, const Group& g) {
  const int32_t a = gmul(p.Y - p.X, ymx, g);
  const int32_t b = gmul(p.Y + p.X, ypx, g);
  const int32_t c = gmul(p.T, t2d, g);
  const int32_t d = 2 * p.Z;
  const int32_t e = b - a, f = d - c, gg = d + c, h = b + a;
  return GPoint{gmul(e, f, g), gmul(gg, h, g), gmul(f, gg, g), gmul(e, h, g)};
}

__device__ __forceinline__ GPoint gidentity(const Group& g) {
  const int32_t one = g.k == 0;
  return GPoint{0, one, one, 0};
}

}  // namespace r26
