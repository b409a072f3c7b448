// Generic double-scalar verify for flat batches with no cached validator
// set: per lane, decompress A, then [S]B + [h](-A) in extended
// coordinates for the finish kernel (finish.cu: invert, encode, compare).
//
// Replaces tendermint_tpu/ops/ed25519_ladder_pallas.py::_ladder_pallas
// (body _make_ladder_kernel, entry verify_kernel_pallas) together with
// the per-lane part of its XLA prologue (decompression, the -A and
// B - A table entries, one batched inversion).
//
// Per lane, from the 32-byte encoding of A and the 128 nibbles of
// (S, h) that `_digits_w4` packs:
//   1. decompress A as `pt_decompress` does, with its rejection rules
//      (y >= p, not on the curve, x = 0 with the sign bit set), and
//      negate. A rejected lane continues with -A = O and a_ok = 0;
//   2. a table of 16 multiples j(-A) in cached form (Y + X, Y - X, 2dT,
//      2Z), then [h](-A) with a 4-bit fixed window, msb first: 252
//      doublings (T only where an addition follows) and 64 additions;
//   3. [S]B as 64 mixed additions from the shared w = 4 comb
//      (`sb_table_w4`, read through L1/L2);
//   4. one extended addition of the two halves.
// The twisted-Edwards formulas are complete, so digit 0, the identity
// and small-order keys take no branch.
//
// Design: ten threads a lane, thread k holding limb k of every
// coordinate in radix 2^26 (fe25519_r26.cuh). A field multiply is ten
// wide multiply-adds and twenty shuffles a thread and two shuffled
// carry rounds. Three lanes fill lanes 0..29 of a warp, so a 4,096-lane
// bucket is 1,366 warps: 10.3 a SM over 132 SMs, where one thread a
// lane gave 128 warps in all. The table of -A multiples lives in shared
// memory, one column a thread (each thread reads only what it wrote:
// no barrier, no bank conflict).
//
// Bound on this card: integer multiply-adds (about 3,200 field
// multiplies of 100 limb products a lane against 160 bytes of input and
// 324 of output).
#include <cuda_runtime.h>

#include "fe25519_r26.cuh"

using namespace r26;

namespace {

constexpr int kThreads = 128;
constexpr int kLanesPerWarp = 3;
constexpr int kLanesPerBlock = kLanesPerWarp * (kThreads / 32);
constexpr int kTab = 16;
constexpr int kDigits = 128;  // 64 nibbles of S, then 64 of h

__constant__ int32_t kD[NL] = {56195235, 47411844, 25868126, 20251911, 28682,
                               31357478, 7604119,  66702899, 15608687, 1343707};
__constant__ int32_t kSqrtM1[NL] = {34513072, 59165138, 38243406, 1750207, 53429016,
                                    58652137, 13633939, 58469549, 8409025,  712905};

// a^((p - 5) / 8): the addition chain of the torch `fe_pow_p58`
__device__ int32_t gpow_p58(int32_t a, const Group& g) {
  const int32_t z2 = gmul(a, a, g);
  const int32_t z9 = gmul(gsq_n(z2, 2, g), a, g);
  const int32_t z11 = gmul(z9, z2, g);
  const int32_t z5 = gmul(gmul(z11, z11, g), z9, g);
  const int32_t z10 = gmul(gsq_n(z5, 5, g), z5, g);
  const int32_t z20 = gmul(gsq_n(z10, 10, g), z10, g);
  const int32_t z40 = gmul(gsq_n(z20, 20, g), z20, g);
  const int32_t z50 = gmul(gsq_n(z40, 10, g), z10, g);
  const int32_t z100 = gmul(gsq_n(z50, 50, g), z50, g);
  const int32_t z200 = gmul(gsq_n(z100, 100, g), z100, g);
  const int32_t z250 = gmul(gsq_n(z200, 50, g), z50, g);
  return gmul(gsq_n(z250, 2, g), a, g);
}

// value == 0 (mod p), the same answer in every thread of the group
__device__ __forceinline__ bool gis_zero(int32_t a, const Group& g) {
  int64_t v[NL];
  gather(v, a, g);
  canon(v);
  bool z = true;
#pragma unroll
  for (int i = 0; i < NL; ++i) z = z && v[i] == 0;
  return z;
}

__global__ void __launch_bounds__(kThreads)
    ladder_kernel(const uint8_t* __restrict__ pub, const int32_t* __restrict__ digits,
                  const int32_t* __restrict__ sb, int32_t* __restrict__ out,
                  uint8_t* __restrict__ a_ok, int64_t B) {
  __shared__ int32_t tab[kTab * 4][kThreads];
  const Group g = group_of_thread();
  const int tid = threadIdx.x;
  const int slot = (tid & 31) / NL;  // 3: lanes 30, 31 of the warp
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kLanesPerBlock +
                       (tid >> 5) * kLanesPerWarp + (slot < kLanesPerWarp ? slot : 0);
  const bool active = slot < kLanesPerWarp && lane < B;
  const int64_t row = lane < B ? lane : B - 1;  // junk threads read a real row
  const int32_t one = g.k == 0;

  // -- 1. decompress A ------------------------------------------------------
  const uint32_t* enc = reinterpret_cast<const uint32_t*>(pub + row * 32);
  const int bit = RADIX * g.k;
  const int wi = bit >> 5;
  uint64_t bits = __ldg(enc + wi);
  if (wi + 1 < 8) bits |= static_cast<uint64_t>(__ldg(enc + wi + 1)) << 32;
  int32_t y = static_cast<int32_t>((bits >> (bit & 31)) & MASK);
  if (g.k == NL - 1) y &= (1 << 21) - 1;  // bit 255 is the sign of x
  const bool sign = (__ldg(enc + 7) >> 31) != 0;
  int64_t yv[NL];
  gather(yv, y, g);
  bool y_ge_p = yv[0] >= MASK + 1 - 19 && yv[NL - 1] == (1 << 21) - 1;
#pragma unroll
  for (int i = 1; i < NL - 1; ++i) y_ge_p = y_ge_p && yv[i] == MASK;

  const int32_t y2 = gmul(y, y, g);
  const int32_t u = y2 - one;
  const int32_t v = gmul(y2, kD[g.k], g) + one;
  const int32_t v3 = gmul(gmul(v, v, g), v, g);
  const int32_t v7 = gmul(gmul(v3, v3, g), v, g);
  int32_t x = gmul(gmul(u, v3, g), gpow_p58(gmul(u, v7, g), g), g);
  const int32_t vxx = gmul(v, gmul(x, x, g), g);
  const bool ok_direct = gis_zero(vxx - u, g);
  const bool ok_flip = gis_zero(vxx + u, g);
  const int32_t xi = gmul(x, kSqrtM1[g.k], g);
  if (ok_flip && !ok_direct) x = xi;
  int64_t xv[NL];
  gather(xv, x, g);
  canon(xv);
  bool x_zero = true;
#pragma unroll
  for (int i = 0; i < NL; ++i) x_zero = x_zero && xv[i] == 0;
  if (((xv[0] & 1) != 0) != sign) x = -x;
  const bool ok = (ok_direct || ok_flip) && !y_ge_p && !(x_zero && sign);
  // -A, or the identity for a rejected encoding
  GPoint na;
  na.X = ok ? -x : 0;
  na.Y = ok ? y : one;
  na.Z = one;
  na.T = gmul(na.X, na.Y, g);

  // -- 2. [h](-A): 16 multiples, then a 4-bit window --------------------------
  const int32_t d2 = kD2[g.k];
  const GCached nac = gcache(na, d2, g);
  GPoint p = gidentity(g);
  tab[0][tid] = one;
  tab[1][tid] = one;
  tab[2][tid] = 0;
  tab[3][tid] = 2 * one;
#pragma unroll 1
  for (int j = 1; j < kTab; ++j) {
    p = gadd(p, nac, g);
    const GCached c = gcache(p, d2, g);
    tab[4 * j + 0][tid] = c.ypx;
    tab[4 * j + 1][tid] = c.ymx;
    tab[4 * j + 2][tid] = c.t2d;
    tab[4 * j + 3][tid] = c.z2;
  }
  const int32_t* dig = digits + row * kDigits;
  GPoint acc = gidentity(g);
#pragma unroll 1
  for (int w = 63; w >= 0; --w) {
    if (w != 63) {
      acc = gdbl(acc, false, g);
      acc = gdbl(acc, false, g);
      acc = gdbl(acc, false, g);
      acc = gdbl(acc, true, g);
    }
    const int d = __ldg(dig + 64 + w);
    const GCached e{tab[4 * d][tid], tab[4 * d + 1][tid], tab[4 * d + 2][tid],
                    tab[4 * d + 3][tid]};
    acc = gadd(acc, e, g);
  }

  // -- 3. [S]B from the comb, (64, 16, 60) int32 13-bit limbs ---------------
  GPoint accb = gidentity(g);
#pragma unroll 1
  for (int w = 0; w < 64; ++w) {
    const int d = __ldg(dig + w);
    const int32_t* e = sb + (w * 16 + d) * 6 * NL + 2 * g.k;
    const int32_t ypx = __ldg(e) + (__ldg(e + 1) << 13);
    const int32_t ymx = __ldg(e + 2 * NL) + (__ldg(e + 2 * NL + 1) << 13);
    const int32_t t2d = __ldg(e + 4 * NL) + (__ldg(e + 4 * NL + 1) << 13);
    accb = gmadd(accb, ypx, ymx, t2d, g);
  }

  // -- 4. the two halves ------------------------------------------------------
  acc = gadd(acc, gcache(accb, d2, g), g);
  gstore(out, 0, acc.X, g, lane, B, active);
  gstore(out, 1, acc.Y, g, lane, B, active);
  gstore(out, 2, acc.Z, g, lane, B, active);
  gstore(out, 3, acc.T, g, lane, B, active);
  if (active && g.k == 0) a_ok[lane] = ok;
}

}  // namespace

extern "C" {

// pub (B, 32) uint8 encodings of A, digits (B, 128) int32 nibbles
// (`_digits_w4`), sb (64, 16, 60) int32 comb -> out (4, 20, B) int32
// extended [S]B + [h](-A), a_ok (B,) uint8
int ladder(const void* pub, const void* digits, const void* sb, void* out, void* a_ok,
           long long B, void* stream) {
  if (B <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((B + kLanesPerBlock - 1) / kLanesPerBlock);
  ladder_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pub), static_cast<const int32_t*>(digits),
      static_cast<const int32_t*>(sb), static_cast<int32_t*>(out),
      static_cast<uint8_t*>(a_ok), B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
