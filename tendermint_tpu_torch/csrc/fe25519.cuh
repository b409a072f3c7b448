// GF(2^255 - 19) and twisted-Edwards (a = -1) arithmetic for one lane
// per thread, shared by madd_chain.cu and ladder.cu.
//
// Field elements are 20 signed limbs of radix 2^13 held in int32, the
// representation the torch code and the comb tables use at the kernels'
// boundary. Inside fe_mul the 39 schoolbook columns are summed in
// int64_t: signed int32 overflow is undefined in C++, and 64-bit sums
// leave room for operands that were only added or subtracted, so no
// carry is needed between a point formula's additions and its
// multiplies. Every fe_mul result is back in the loose range
// [-608, 2^13 + 608) that the torch `fe_carry` produces, so the torch
// finish (`_finish_encode_compare`) can multiply kernel outputs as they
// are.
//
// Computes what `_mul_planes`, `_madd_planes` and `_double_planes` of the
// JAX package compute (tendermint_tpu/ops/ed25519_tables.py,
// tendermint_tpu/ops/ed25519_ladder_pallas.py) on per-thread arrays
// instead of (8, 128) planes.
#pragma once

#include <cstdint>

namespace fe25519 {

constexpr int NL = 20;           // limbs per field element
constexpr int RADIX = 13;
constexpr int64_t MASK = (1 << RADIX) - 1;
constexpr int64_t FOLD = 608;    // 2^260 = 32 * 2^255 = 32 * 19 (mod p)

// Two sequential carry passes over 20 int64 columns, folding the carry
// out of limb 19 back into limb 0. After the first pass the value is
// below 2^260 + 2^41 in magnitude, so the second pass leaves a carry of
// -1, 0 or 1: limbs 1..19 end in [0, 2^13), limb 0 in [-608, 2^13 + 608).
__device__ __forceinline__ void carry_out(int32_t out[NL], int64_t c[NL]) {
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    int64_t carry = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int64_t v = c[i] + carry;
      carry = v >> RADIX;  // arithmetic shift: floor division
      c[i] = v & MASK;
    }
    c[0] += FOLD * carry;
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = static_cast<int32_t>(c[i]);
}

// out = a * b mod p. Operands may be any sum or difference of a few
// loose elements (|limb| < 2^16): each column is at most 20 * 2^32 and
// the fold adds 608 times that, far inside int64. out may alias a or b.
__device__ __forceinline__ void fe_mul(int32_t out[NL], const int32_t a[NL],
                                       const int32_t b[NL]) {
  int64_t c[2 * NL - 1];
#pragma unroll
  for (int k = 0; k < 2 * NL - 1; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      c[i + j] += static_cast<int64_t>(a[i]) * b[j];
    }
  }
  // column k >= 20 has weight 2^(13k) = 2^260 * 2^(13(k-20))
#pragma unroll
  for (int k = NL; k < 2 * NL - 1; ++k) c[k - NL] += FOLD * c[k];
  carry_out(out, c);
}

// acc += entry, with the entry an affine point in precomp form
// (ypx, ymx, t2d) = (y + x, y - x, 2d x y): madd-2008-hwcd-3, a = -1,
// Z2 = 1, 7 field multiplies. Same formula as the torch `pt_madd`.
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

// acc = 2 * acc: dbl-2008-hwcd, a = -1, 4 multiplies + 4 squarings.
// Same formula as the torch `pt_double`.
__device__ __forceinline__ void dbl(int32_t X[NL], int32_t Y[NL], int32_t Z[NL],
                                    int32_t T[NL]) {
  int32_t a[NL], b[NL], c[NL], s[NL];
  fe_mul(a, X, X);
  fe_mul(b, Y, Y);
  fe_mul(c, Z, Z);
#pragma unroll
  for (int i = 0; i < NL; ++i) s[i] = X[i] + Y[i];
  fe_mul(s, s, s);
  int32_t e[NL], f[NL], g[NL], h[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    h[i] = a[i] + b[i];
    e[i] = h[i] - s[i];
    g[i] = a[i] - b[i];
    f[i] = 2 * c[i] + g[i];
  }
  fe_mul(X, e, f);
  fe_mul(Y, g, h);
  fe_mul(Z, f, g);
  fe_mul(T, e, h);
}

// extended identity (0, 1, 1, 0)
__device__ __forceinline__ void set_identity(int32_t X[NL], int32_t Y[NL],
                                             int32_t Z[NL], int32_t T[NL]) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    X[i] = 0;
    Y[i] = i == 0;
    Z[i] = i == 0;
    T[i] = 0;
  }
}

// out is (4, 20, B): coordinate-major, lanes adjacent
__device__ __forceinline__ void store_point(int32_t* out, int64_t lane, int64_t B,
                                            const int32_t X[NL], const int32_t Y[NL],
                                            const int32_t Z[NL], const int32_t T[NL]) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    out[(0 * NL + i) * B + lane] = X[i];
    out[(1 * NL + i) * B + lane] = Y[i];
    out[(2 * NL + i) * B + lane] = Z[i];
    out[(3 * NL + i) * B + lane] = T[i];
  }
}

}  // namespace fe25519
