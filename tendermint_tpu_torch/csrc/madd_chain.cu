// Mixed-add chains of the comb-table verify path: the per-lane sum of
// the selected affine entries, [S]B + [h](-A), left in extended
// coordinates for the torch finish (batched inversion, encode, compare).
//
// Replaces two Pallas kernels of the JAX package:
//   madd_chain_entries  <- tendermint_tpu/ops/ed25519_tables.py
//                          _sum_entries_pallas / _madd_chain_kernel
//                          (96 mixed adds of entries already gathered)
//   madd_chain_fused    <- tendermint_tpu/ops/ed25519_tables.py
//                          _fused_chain_pallas / _make_fused_kernel
//                          (128 mixed adds, each entry read from the
//                          validator tables inside the kernel)
//
// Bound on this card: integer multiply-adds. A mixed add is 7 field
// multiplies of 400 limb products each, so a lane costs 96 * 7 * 400
// (entries) or 128 * 7 * 400 (fused) multiply-adds against 96 * 240 or
// 128 * 120 bytes of entries read; both chains are set by the INT32
// rate, not by memory.
//
// Design: one thread per lane, the accumulator (X, Y, Z, T: 80 limbs)
// in registers for the whole chain, a loop over the steps inside the
// thread in place of the TPU's sequential grid axis. Inputs are laid
// out lane-minor — entries as (96, 60, B), digits as (128, B) — so
// neighbouring threads read neighbouring addresses. The fused kernel's
// lane b reads validator b mod N directly, so no reordering of lanes is
// needed. Spills of the 80-limb accumulator are accepted in this first
// version.
#include <cuda_runtime.h>

#include "fe25519.cuh"

using namespace fe25519;

namespace {

constexpr int kThreads = 64;
constexpr int kEntryLimbs = 3 * NL;  // ypx | ymx | t2d

__global__ void madd_chain_entries_kernel(const int32_t* __restrict__ ent,
                                          int32_t* __restrict__ out, int64_t B,
                                          int nsteps) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  int32_t X[NL], Y[NL], Z[NL], T[NL];
  set_identity(X, Y, Z, T);
#pragma unroll 1
  for (int step = 0; step < nsteps; ++step) {
    const int32_t* e = ent + static_cast<int64_t>(step) * kEntryLimbs * B + lane;
    int32_t ypx[NL], ymx[NL], t2d[NL];
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

__global__ void madd_chain_fused_kernel(const int16_t* __restrict__ tables,
                                        const int32_t* __restrict__ sb,
                                        const int32_t* __restrict__ digits,
                                        int32_t* __restrict__ out, int64_t B,
                                        int64_t N) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int64_t col = lane % N;
  int32_t X[NL], Y[NL], Z[NL], T[NL];
  set_identity(X, Y, Z, T);
  int32_t ypx[NL], ymx[NL], t2d[NL];
  // steps 0..63: w=4 fixed-base comb, sb is (64, 16, 60)
#pragma unroll 1
  for (int w = 0; w < 64; ++w) {
    const int d = __ldg(digits + static_cast<int64_t>(w) * B + lane);
    const int32_t* e = sb + (w * 16 + d) * kEntryLimbs;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      ypx[i] = __ldg(e + i);
      ymx[i] = __ldg(e + NL + i);
      t2d[i] = __ldg(e + 2 * NL + i);
    }
    madd(X, Y, Z, T, ypx, ymx, t2d);
  }
  // steps 64..127: validator tables, (64, 16, 60, N) int16
#pragma unroll 1
  for (int w = 0; w < 64; ++w) {
    const int d = __ldg(digits + static_cast<int64_t>(64 + w) * B + lane);
    const int16_t* e = tables + (static_cast<int64_t>(w) * 16 + d) * kEntryLimbs * N + col;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      ypx[i] = __ldg(e + (0 * NL + i) * N);
      ymx[i] = __ldg(e + (1 * NL + i) * N);
      t2d[i] = __ldg(e + (2 * NL + i) * N);
    }
    madd(X, Y, Z, T, ypx, ymx, t2d);
  }
  store_point(out, lane, B, X, Y, Z, T);
}

inline unsigned blocks_for(int64_t B) {
  return static_cast<unsigned>((B + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// ent (nsteps, 60, B) int32 canonical limbs -> out (4, 20, B) int32
int madd_chain_entries(const void* ent, void* out, long long B, int nsteps,
                       void* stream) {
  if (B <= 0) return 0;
  madd_chain_entries_kernel<<<blocks_for(B), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ent), static_cast<int32_t*>(out), B, nsteps);
  return static_cast<int>(cudaGetLastError());
}

// tables (64, 16, 60, N) int16, sb (64, 16, 60) int32, digits (128, B)
// int32 nibbles -> out (4, 20, B) int32
int madd_chain_fused(const void* tables, const void* sb, const void* digits,
                     void* out, long long B, long long N, void* stream) {
  if (B <= 0) return 0;
  madd_chain_fused_kernel<<<blocks_for(B), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(tables), static_cast<const int32_t*>(sb),
      static_cast<const int32_t*>(digits), static_cast<int32_t*>(out), B, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
