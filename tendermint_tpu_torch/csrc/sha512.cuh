// SHA-512 (FIPS 180-4) in native 64-bit words, as two functions that
// run on two threads of one message: `schedule` expands a block into
// W[t] + K[t] (t = 0..79) and `rounds` runs the 80 rounds on those.
//
// Replaces the JAX package's `_compress512`
// (tendermint_tpu/ops/sha512_kernel.py), which emulates every 64-bit
// word as a (hi, lo) pair of u32 (the TPU has no 64-bit vector path) and
// runs the 64 schedule steps and 80 rounds as `lax.scan`s. The card
// has 64-bit integer registers (each 64-bit operation is two 32-bit
// ones), so the kernel reads the pairs, joins them once, and splits the
// digest back into (hi, lo) on the way out.
//
// 32-bit instructions a compression, counted from the code below as the
// card can issue it: a 64-bit rotate or shift is two funnel shifts, a
// 64-bit logic function of three words two LOP3, a sum of three 64-bit
// words two IADD3 (the low halves' carries into the high halves); 64
// schedule steps of 20, 80 rounds of 28 (counting K's addition, which
// `schedule` makes, and the sums as `rounds` groups them), 8 final
// additions of 2 = 3,536.
#pragma once

#include <cstdint>

namespace sha512 {

__constant__ uint64_t kK[80] = {
    0x428a2f98d728ae22ull, 0x7137449123ef65cdull, 0xb5c0fbcfec4d3b2full, 0xe9b5dba58189dbbcull,
    0x3956c25bf348b538ull, 0x59f111f1b605d019ull, 0x923f82a4af194f9bull, 0xab1c5ed5da6d8118ull,
    0xd807aa98a3030242ull, 0x12835b0145706fbeull, 0x243185be4ee4b28cull, 0x550c7dc3d5ffb4e2ull,
    0x72be5d74f27b896full, 0x80deb1fe3b1696b1ull, 0x9bdc06a725c71235ull, 0xc19bf174cf692694ull,
    0xe49b69c19ef14ad2ull, 0xefbe4786384f25e3ull, 0x0fc19dc68b8cd5b5ull, 0x240ca1cc77ac9c65ull,
    0x2de92c6f592b0275ull, 0x4a7484aa6ea6e483ull, 0x5cb0a9dcbd41fbd4ull, 0x76f988da831153b5ull,
    0x983e5152ee66dfabull, 0xa831c66d2db43210ull, 0xb00327c898fb213full, 0xbf597fc7beef0ee4ull,
    0xc6e00bf33da88fc2ull, 0xd5a79147930aa725ull, 0x06ca6351e003826full, 0x142929670a0e6e70ull,
    0x27b70a8546d22ffcull, 0x2e1b21385c26c926ull, 0x4d2c6dfc5ac42aedull, 0x53380d139d95b3dfull,
    0x650a73548baf63deull, 0x766a0abb3c77b2a8ull, 0x81c2c92e47edaee6ull, 0x92722c851482353bull,
    0xa2bfe8a14cf10364ull, 0xa81a664bbc423001ull, 0xc24b8b70d0f89791ull, 0xc76c51a30654be30ull,
    0xd192e819d6ef5218ull, 0xd69906245565a910ull, 0xf40e35855771202aull, 0x106aa07032bbd1b8ull,
    0x19a4c116b8d2d0c8ull, 0x1e376c085141ab53ull, 0x2748774cdf8eeb99ull, 0x34b0bcb5e19b48a8ull,
    0x391c0cb3c5c95a63ull, 0x4ed8aa4ae3418acbull, 0x5b9cca4f7763e373ull, 0x682e6ff3d6b2b8a3ull,
    0x748f82ee5defb2fcull, 0x78a5636f43172f60ull, 0x84c87814a1f0ab72ull, 0x8cc702081a6439ecull,
    0x90befffa23631e28ull, 0xa4506cebde82bde9ull, 0xbef9a3f7b2c67915ull, 0xc67178f2e372532bull,
    0xca273eceea26619cull, 0xd186b8c721c0c207ull, 0xeada7dd6cde0eb1eull, 0xf57d4f7fee6ed178ull,
    0x06f067aa72176fbaull, 0x0a637dc5a2c898a6ull, 0x113f9804bef90daeull, 0x1b710b35131c471bull,
    0x28db77f523047d84ull, 0x32caab7b40c72493ull, 0x3c9ebe0a15c9bebcull, 0x431d67c49c100d4cull,
    0x4cc5d4becb3e42b6ull, 0x597f299cfc657e2aull, 0x5fcb6fab3ad6faecull, 0x6c44198c4a475817ull,
};

__device__ __forceinline__ void init(uint64_t s[8]) {
  s[0] = 0x6a09e667f3bcc908ull;
  s[1] = 0xbb67ae8584caa73bull;
  s[2] = 0x3c6ef372fe94f82bull;
  s[3] = 0xa54ff53a5f1d36f1ull;
  s[4] = 0x510e527fade682d1ull;
  s[5] = 0x9b05688c2b3e6c1full;
  s[6] = 0x1f83d9abfb41bd6bull;
  s[7] = 0x5be0cd19137e2179ull;
}

__device__ __forceinline__ uint64_t rotr(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

// wk[t * stride] = W[t] + K[t], t = 0..79, for one block of 16
// big-endian 64-bit words
__device__ __forceinline__ void schedule(uint64_t* wk, int stride, const uint64_t block[16]) {
  uint64_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = block[i];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    uint64_t wt = w[t & 15];
    if (t >= 16) {
      const uint64_t x = w[(t - 15) & 15];
      const uint64_t y = w[(t - 2) & 15];
      const uint64_t s0 = rotr(x, 1) ^ rotr(x, 8) ^ (x >> 7);
      const uint64_t s1 = rotr(y, 19) ^ rotr(y, 61) ^ (y >> 6);
      wt = wt + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    wk[t * stride] = wt + kK[t];
  }
}

// s <- s + the 80 rounds on s, given W[t] + K[t] at wk[t * stride].
// A round's only dependence on the last one's e is S1(e) and ch(e, f, g):
// h + W + K and d + h + W + K are formed from values known rounds ahead,
// so e's path is one rotate, one XOR and one three-term sum a round.
__device__ __forceinline__ void rounds(uint64_t s[8], const uint64_t* wk, int stride) {
  uint64_t a = s[0], b = s[1], c = s[2], d = s[3], e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    const uint64_t hw = h + wk[t * stride];
    const uint64_t dhw = d + hw;
    const uint64_t S1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
    const uint64_t ch = (e & f) ^ (~e & g);
    const uint64_t S0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39);
    const uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint64_t t1 = hw + S1 + ch;
    h = g;
    g = f;
    f = e;
    e = dhw + S1 + ch;  // d + t1
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
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

}  // namespace sha512
