// Generic Shamir ladder for flat batches with no cached validator set:
// per lane, 253 msb-first steps of acc = madd(double(acc), gtab[sel])
// over the lane's table {O, B, -A, B - A} in affine precomp form, with
// sel = s_bit + 2 * h_bit. Leaves [S]B + [h](-A) in extended
// coordinates for the torch finish (batched inversion, encode, compare).
//
// Replaces tendermint_tpu/ops/ed25519_ladder_pallas.py::_ladder_pallas
// (body _make_ladder_kernel, entry verify_kernel_pallas).
//
// Bound on this card: integer multiply-adds. A step is a doubling
// (8 field multiplies) and a mixed add (7), 400 limb products each:
// 253 * 15 * 400 multiply-adds per lane against about 2 KB of table and
// digits read, so the INT32 rate sets the bound, not memory.
//
// Design: one thread per lane, the accumulator in registers across all
// 253 steps (the loop replaces the TPU's sequential grid axis). The
// per-lane table (4, 60, B) and the selectors (253, B) are lane-minor,
// so neighbouring threads read neighbouring addresses; the table is
// read again at every step and stays in L1/L2. The TPU's tile-size
// rules (B % 1024, at most 4096 lanes a tile) do not apply: any B runs.
#include <cuda_runtime.h>

#include "fe25519.cuh"

using namespace fe25519;

namespace {

constexpr int kThreads = 64;
constexpr int kEntryLimbs = 3 * NL;
constexpr int kSteps = 253;

__global__ void ladder_kernel(const int32_t* __restrict__ gtab,
                              const int32_t* __restrict__ digits,
                              int32_t* __restrict__ out, int64_t B) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  int32_t X[NL], Y[NL], Z[NL], T[NL];
  set_identity(X, Y, Z, T);
  int32_t ypx[NL], ymx[NL], t2d[NL];
#pragma unroll 1
  for (int step = 0; step < kSteps; ++step) {
    dbl(X, Y, Z, T);
    const int sel = __ldg(digits + static_cast<int64_t>(step) * B + lane);
    const int32_t* e = gtab + static_cast<int64_t>(sel) * kEntryLimbs * B + lane;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      ypx[i] = __ldg(e + (0 * NL + i) * B);
      ymx[i] = __ldg(e + (1 * NL + i) * B);
      t2d[i] = __ldg(e + (2 * NL + i) * B);
    }
    madd(X, Y, Z, T, ypx, ymx, t2d);
  }
  store_point(out, lane, B, X, Y, Z, T);
}

}  // namespace

extern "C" {

// gtab (4, 60, B) int32 canonical limbs, digits (253, B) int32 in 0..3
// -> out (4, 20, B) int32
int ladder(const void* gtab, const void* digits, void* out, long long B,
           void* stream) {
  if (B <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  ladder_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gtab), static_cast<const int32_t*>(digits),
      static_cast<int32_t*>(out), B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
