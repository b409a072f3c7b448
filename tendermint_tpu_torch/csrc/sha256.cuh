// SHA-256 (FIPS 180-4) for one message a thread, and the Merkle inner
// node H(0x01 || L || R) built in registers.
//
// Replaces the JAX package's `_compress` and `sha256_fixed2_from_words`
// (tendermint_tpu/ops/sha256_kernel.py), which run the 48 schedule steps
// and 64 rounds as two `lax.scan`s over the whole batch; here one
// thread runs them for its own message, fully unrolled, with the
// 16-word schedule as a ring in registers and K in constant memory
// (every index is a compile-time constant after unrolling, so each K is
// an operand from the constant bank).
//
// 32-bit instructions a compression, counted from the code below as the
// card can issue it (a logic function of three words is one LOP3, a sum
// of three words one IADD3, a rotate one funnel shift): 48 schedule steps
// of 10, 64 rounds of 14, 8 final additions = 1,384. The inner node adds
// 18 (a message word is one funnel shift of two digest words). Its
// second block is one run-time word, 14 zeros and the bit length, so the
// unrolled schedule folds: 367 of its 480 instructions remain.
//
// The header holds only __device__ functions of registers, so the tests
// can compile it as host C++ (with the qualifiers defined empty) and hold
// it against hashlib.
#pragma once

#include <cstdint>

namespace sha256 {

__constant__ uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u,
    0x3956c25bu, 0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u,
    0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u,
    0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u,
    0xc6e00bf3u, 0xd5a79147u, 0x06ca6351u, 0x14292967u,
    0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u,
    0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u,
    0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu, 0x682e6ff3u,
    0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

constexpr int kWords = 8;  // digest words (big-endian)

__device__ __forceinline__ void init(uint32_t s[8]) {
  s[0] = 0x6a09e667u;
  s[1] = 0xbb67ae85u;
  s[2] = 0x3c6ef372u;
  s[3] = 0xa54ff53au;
  s[4] = 0x510e527fu;
  s[5] = 0x9b05688cu;
  s[6] = 0x1f83d9abu;
  s[7] = 0x5be0cd19u;
}

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

// s <- compress(s, block): block is 16 big-endian words
__device__ __forceinline__ void compress(uint32_t s[8], const uint32_t block[16]) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = block[i];
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3], e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt = w[t & 15];
    if (t >= 16) {
      // W[t] = W[t-16] + s0(W[t-15]) + W[t-7] + s1(W[t-2]); W[t-16] is w[t & 15]
      const uint32_t x = w[(t - 15) & 15];
      const uint32_t y = w[(t - 2) & 15];
      const uint32_t s0 = rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3);
      const uint32_t s1 = rotr(y, 17) ^ rotr(y, 19) ^ (y >> 10);
      wt = wt + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + kK[t] + wt;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t2 = S0 + maj;
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  s[0] += a;
  s[1] += b;
  s[2] += c;
  s[3] += d;
  s[4] += e;
  s[5] += f;
  s[6] += g;
  s[7] += h;
}

// out = SHA-256(0x01 || L || R): 65 bytes, two blocks. The one-byte
// prefix shifts every digest byte by one, so each message word joins the
// low byte of one digest word and the high three bytes of the next.
__device__ __forceinline__ void inner_node(const uint32_t l[8], const uint32_t r[8], uint32_t out[8]) {
  uint32_t w[16];
  w[0] = 0x01000000u | (l[0] >> 8);
#pragma unroll
  for (int i = 1; i < 8; ++i) w[i] = (l[i - 1] << 24) | (l[i] >> 8);
  w[8] = (l[7] << 24) | (r[0] >> 8);
#pragma unroll
  for (int i = 1; i < 8; ++i) w[8 + i] = (r[i - 1] << 24) | (r[i] >> 8);
  init(out);
  compress(out, w);
  w[0] = (r[7] << 24) | 0x00800000u;  // last byte of R, then the 0x80 pad byte
#pragma unroll
  for (int i = 1; i < 15; ++i) w[i] = 0;
  w[15] = 65 * 8;  // bit length
  compress(out, w);
}

}  // namespace sha256
