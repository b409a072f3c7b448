// RIPEMD-160 (ISO/IEC 10118-3) for one message a thread, and the Merkle
// inner node H(0x01 || L || R) of the reference-compatible tree.
//
// Replaces the JAX package's `_compress160` and `_inner_node_words_ripemd`
// (tendermint_tpu/ops/ripemd160_kernel.py, merkle_kernel.py), which run
// each 16-step round group as a `lax.scan` with a gather of message words
// a step. Here one thread runs both 80-step lines for its own message.
//
// The word selection, rotation and constant tables are compile-time
// constants, not __constant__ memory: a step reads its message word as
// x[r], and with r known only at run time the 16-word block would have
// to leave the registers for local memory. Each step is a template on
// its index, so r, the rotation and K are immediates.
//
// 32-bit instructions a compression, counted from the code below as the
// card can issue it: a step is its boolean function (one LOP3), the sum of
// a, f, x[r] and K (two IADD3, one where K is 0), the rotate, the addition
// of e and the rotate of c; 128 steps of 6 and 32 of 5, plus 5 three-term
// sums = 933. The inner node adds 11 (a funnel shift a message word).
#pragma once

#include <cstdint>
#include <utility>

namespace ripemd160 {

constexpr int kWords = 5;  // digest words (little-endian)

// message word a step selects, left and right line
constexpr int kRL[80] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
    3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
    1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
    4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13,
};
constexpr int kRR[80] = {
    5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
    6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
    15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
    8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
    12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11,
};
// rotation a step applies, left and right line
constexpr int kSL[80] = {
    11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
    7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
    11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
    11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
    9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6,
};
constexpr int kSR[80] = {
    8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
    9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
    9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
    15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
    8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11,
};
// group constants: floor(2^30 sqrt(0, 2, 3, 5, 7)), floor(2^30 cbrt(2, 3, 5, 7)), 0
constexpr uint32_t kKL[5] = {0x00000000u, 0x5a827999u, 0x6ed9eba1u, 0x8f1bbcdcu, 0xa953fd4eu};
constexpr uint32_t kKR[5] = {0x50a28be6u, 0x5c4dd124u, 0x6d703ef3u, 0x7a6d76e9u, 0x00000000u};

// table reads as constant expressions (device code may read a constexpr
// array's elements only inside a constant-evaluated call)
__host__ __device__ constexpr int sel(bool right, int j) { return right ? kRR[j] : kRL[j]; }
__host__ __device__ constexpr int rot(bool right, int j) { return right ? kSR[j] : kSL[j]; }
__host__ __device__ constexpr uint32_t kconst(bool right, int g) { return right ? kKR[g] : kKL[g]; }

__device__ __forceinline__ void init(uint32_t h[5]) {
  h[0] = 0x67452301u;
  h[1] = 0xefcdab89u;
  h[2] = 0x98badcfeu;
  h[3] = 0x10325476u;
  h[4] = 0xc3d2e1f0u;
}

template <int S>
__device__ __forceinline__ uint32_t rotl(uint32_t x) {
  return (x << S) | (x >> (32 - S));
}

template <int F>
__device__ __forceinline__ uint32_t f(uint32_t x, uint32_t y, uint32_t z) {
  if constexpr (F == 0) return x ^ y ^ z;
  else if constexpr (F == 1) return (x & y) | (~x & z);
  else if constexpr (F == 2) return (x | ~y) ^ z;
  else if constexpr (F == 3) return (x & z) | (y & ~z);
  else return x ^ (y | ~z);
}

// step J of one line: (a, b, c, d, e) <- (e, t, b, rotl10(c), d)
template <bool kRight, int J>
__device__ __forceinline__ void step(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d, uint32_t& e,
                                     const uint32_t x[16]) {
  constexpr int g = J / 16;
  constexpr int fn = kRight ? 4 - g : g;
  constexpr int r = sel(kRight, J);
  constexpr int s = rot(kRight, J);
  constexpr uint32_t k = kconst(kRight, g);
  const uint32_t t = rotl<s>(a + f<fn>(b, c, d) + x[r] + k) + e;
  a = e;
  e = d;
  d = rotl<10>(c);
  c = b;
  b = t;
}

template <bool kRight, int... J>
__device__ __forceinline__ void line(uint32_t v[5], const uint32_t x[16], std::integer_sequence<int, J...>) {
  uint32_t a = v[0], b = v[1], c = v[2], d = v[3], e = v[4];
  (step<kRight, J>(a, b, c, d, e, x), ...);
  v[0] = a;
  v[1] = b;
  v[2] = c;
  v[3] = d;
  v[4] = e;
}

// h <- compress(h, x): x is 16 little-endian words
__device__ __forceinline__ void compress(uint32_t h[5], const uint32_t x[16]) {
  uint32_t l[5], r[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) l[i] = r[i] = h[i];
  line<false>(l, x, std::make_integer_sequence<int, 80>{});
  line<true>(r, x, std::make_integer_sequence<int, 80>{});
  const uint32_t t = h[1] + l[2] + r[3];
  h[1] = h[2] + l[3] + r[4];
  h[2] = h[3] + l[4] + r[0];
  h[3] = h[4] + l[0] + r[1];
  h[4] = h[0] + l[1] + r[2];
  h[0] = t;
}

// out = RIPEMD-160(0x01 || L || R): 41 bytes, one block; the prefix
// shifts every digest byte by one the other way from SHA-256's
__device__ __forceinline__ void inner_node(const uint32_t l[5], const uint32_t r[5], uint32_t out[5]) {
  uint32_t w[16];
  w[0] = 0x01u | (l[0] << 8);
#pragma unroll
  for (int i = 1; i < 5; ++i) w[i] = (l[i - 1] >> 24) | (l[i] << 8);
  w[5] = (l[4] >> 24) | (r[0] << 8);
#pragma unroll
  for (int i = 1; i < 5; ++i) w[5 + i] = (r[i - 1] >> 24) | (r[i] << 8);
  w[10] = (r[4] >> 24) | 0x8000u;  // last byte of R, then the 0x80 pad byte
  w[11] = w[12] = w[13] = 0;
  w[14] = 41 * 8;  // bit length, little-endian 64 bits
  w[15] = 0;
  init(out);
  compress(out, w);
}

}  // namespace ripemd160
