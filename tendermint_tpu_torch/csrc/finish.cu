// The verdict of every verify path: encode(X/Z, Y/Z) == R.
//
// Replaces an XLA stage of the JAX package, not a Pallas kernel:
// tendermint_tpu/ops/ed25519_tables.py::_finish_encode_compare (with
// fe_batch_invert, fe_canon, fe_to_bytes), which the entries, fused and
// ladder paths all end in. Lane b is true when the canonical 32-byte
// encoding of y = Y/Z equals R with bit 255 cleared and the parity of
// the canonical x = X/Z equals bit 255 of R.
//
// The JAX stage inverts with a product tree, a log-depth chain of
// whole-batch steps made for one XLA program; in eager torch it was
// some 9,500 launches a call. Here each lane inverts its own Z by
// Fermat, Z^(p - 2), with the addition chain of the torch `fe_invert`
// (254 squarings, 11 multiplies), then reduces x and y to canonical
// form, encodes y and compares, all in one thread (one lane a thread,
// radix-2^26 field code of fe25519_r26.cuh).
//
// Z = 0. The inverse is unique, so on every lane with Z != 0 the verdict
// equals the tree's. The complete addition formulas keep Z != 0 on every
// input on the curve, and every chain input is (tables, combs, a rejected
// key continuing as the identity). Should Z = 0 arise all the same, the
// tree makes every inverse of the batch 0, while a per-lane 0^(p-2) = 0
// would encode y as 0 and could match an all-zero R: so a lane is true
// only when its canonical Z is not zero, and the kernel is never looser
// than the tree.
//
// Bound on this card: operations. 267 multiplies of 100 limb products a
// lane (the inversion and X, Y times 1/Z) against 240 bytes of X, Y, Z,
// 32 or 128 of R and 1 of verdict.
#include <cuda_runtime.h>

#include "fe25519_r26.cuh"

using namespace r26;

namespace {

constexpr int kThreads = 64;
constexpr int kRBytes = 32;

// 20 boundary limbs of radix 2^13 (any int32 values) at `stride` ->
// 10 loose limbs of radix 2^26: packed in int64, then two sequential
// carry passes leave limbs 1..9 in [0, 2^26) and limb 0 in
// [-608, 2^26 + 608), inside the range fe_mul takes
__device__ __forceinline__ void load_fe(int32_t out[NL], const int32_t* __restrict__ p,
                                        int64_t stride) {
  int64_t v[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    v[i] = static_cast<int64_t>(__ldg(p + 2 * i * stride)) +
           (static_cast<int64_t>(__ldg(p + (2 * i + 1) * stride)) << 13);
  }
  carry_seq(v);
  carry_seq(v);
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = static_cast<int32_t>(v[i]);
}

__device__ __forceinline__ void copy(int32_t out[NL], const int32_t a[NL]) {
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = a[i];
}

__device__ __forceinline__ void sq_n(int32_t x[NL], int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) fe_mul(x, x, x);
}

// z^(p - 2): the chain of the torch `_pow_chain` + `fe_invert`
__device__ void invert(int32_t out[NL], const int32_t z[NL]) {
  int32_t z2[NL], z9[NL], z11[NL], z5[NL], z10[NL], z50[NL], t[NL], u[NL];
  fe_mul(z2, z, z);
  copy(t, z2);
  sq_n(t, 2);
  fe_mul(z9, t, z);
  fe_mul(z11, z9, z2);
  fe_mul(t, z11, z11);
  fe_mul(z5, t, z9);  // z^(2^5 - 1)
  copy(t, z5);
  sq_n(t, 5);
  fe_mul(z10, t, z5);  // 2^10 - 1
  copy(t, z10);
  sq_n(t, 10);
  fe_mul(u, t, z10);  // 2^20 - 1
  copy(t, u);
  sq_n(t, 20);
  fe_mul(t, t, u);  // 2^40 - 1
  sq_n(t, 10);
  fe_mul(z50, t, z10);  // 2^50 - 1
  copy(t, z50);
  sq_n(t, 50);
  fe_mul(u, t, z50);  // 2^100 - 1
  copy(t, u);
  sq_n(t, 100);
  fe_mul(t, t, u);  // 2^200 - 1
  sq_n(t, 50);
  fe_mul(t, t, z50);  // 2^250 - 1
  sq_n(t, 5);
  fe_mul(out, t, z11);  // 2^255 - 21 = p - 2
}

// byte j of a canonical element (limbs in [0, 2^26))
__device__ __forceinline__ int32_t byte_of(const int64_t v[NL], int j) {
  const int bit = 8 * j;
  const int i = bit / RADIX;
  const int off = bit % RADIX;
  int64_t b = v[i] >> off;
  if (off > RADIX - 8 && i + 1 < NL) b |= v[i + 1] << (RADIX - off);
  return static_cast<int32_t>(b & 0xFF);
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                  const int32_t* __restrict__ z, int64_t lane_stride, int64_t limb_stride,
                  const R* __restrict__ r, uint8_t* __restrict__ ok, int64_t B) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= B) return;
  int32_t X[NL], Y[NL], Z[NL], zinv[NL];
  load_fe(Z, z + lane * lane_stride, limb_stride);
  invert(zinv, Z);
  load_fe(X, x + lane * lane_stride, limb_stride);
  load_fe(Y, y + lane * lane_stride, limb_stride);
  fe_mul(X, X, zinv);
  fe_mul(Y, Y, zinv);
  int64_t xc[NL], yc[NL], zc[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    xc[i] = X[i];
    yc[i] = Y[i];
    zc[i] = Z[i];
  }
  canon(xc);
  canon(yc);
  canon(zc);
  bool z_nonzero = false;
#pragma unroll
  for (int i = 0; i < NL; ++i) z_nonzero = z_nonzero || zc[i] != 0;
  const R* rr = r + lane * kRBytes;
  bool same = z_nonzero;
#pragma unroll
  for (int j = 0; j < kRBytes - 1; ++j) same = same && static_cast<int32_t>(rr[j]) == byte_of(yc, j);
  const int32_t last = static_cast<int32_t>(rr[kRBytes - 1]);
  same = same && (last & 0x7F) == byte_of(yc, kRBytes - 1);
  same = same && ((last >> 7) & 1) == (xc[0] & 1);
  ok[lane] = same;
}

}  // namespace

extern "C" {

// x, y, z (B, 20) int32 boundary limbs, element (lane, limb) at
// lane * lane_stride + limb * limb_stride (the three alike), r (B, 32)
// bytes as uint8 (r_itemsize 1) or int32 (4) -> ok (B,) uint8
int finish_encode_compare(const void* x, const void* y, const void* z, long long lane_stride,
                          long long limb_stride, const void* r, int r_itemsize, void* ok,
                          long long B, void* stream) {
  if (B <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int32_t*>(x);
  const auto* yp = static_cast<const int32_t*>(y);
  const auto* zp = static_cast<const int32_t*>(z);
  auto* okp = static_cast<uint8_t*>(ok);
  if (r_itemsize == 1) {
    finish_kernel<uint8_t><<<blocks, kThreads, 0, st>>>(
        xp, yp, zp, lane_stride, limb_stride, static_cast<const uint8_t*>(r), okp, B);
  } else {
    finish_kernel<int32_t><<<blocks, kThreads, 0, st>>>(
        xp, yp, zp, lane_stride, limb_stride, static_cast<const int32_t*>(r), okp, B);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
