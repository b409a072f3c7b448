// The hash plane's four kernels: masked batch SHA-256 and RIPEMD-160
// (one message a thread), SHA-512 (two threads a message) and one level
// of a forest of Merkle trees (one node pair a thread).
//
// They replace XLA stages of the JAX package, not Pallas kernels:
// `_sha256_masked` (tendermint_tpu/ops/sha256_kernel.py),
// `_ripemd160_masked` (ripemd160_kernel.py), `_sha512_masked`
// (sha512_kernel.py) and one step of `_forest_levels` (merkle_kernel.py).
// Those scan every row over all M blocks of its bucket and mask the state
// after a row's last block; here a row's loop runs to its own n_blocks
// (clamped to [0, M]), which gives the same digest and skips the bucket's
// padding. A row with n_blocks 0 yields the initial state, as in JAX.
//
// Bound on this card: operations. A compression is 1,384 (SHA-256), 933
// (RIPEMD-160) or 3,536 (SHA-512) 32-bit integer instructions on 64 or
// 128 bytes of block, and hashing has no product for the tensor cores.
// Of these, 1,024, 480 and 2,624 are logic functions and shifts (LOP3,
// SHF), which only the 64-lane ALU pipe of a SM runs; additions may also
// issue on the FMA pipe. The ALU share sets the bound.
// The simple design is one message a thread, its state and block in
// registers, the block read as 16-byte vectors: the card is full when
// the batch holds some 20,000 messages or more (a 65,536-leaf tree's
// leaf pass). A batch of few long messages (8,192 state-sync chunks of
// 1,025 blocks) leaves most of the card idle and runs at the latency of
// one thread's chain of compressions; SHA is sequential within a
// message, so only more messages would fill it.
//
// sha512_masked's batches (4,096 messages of R || A || M) are below that
// size, where one thread a message leaves every warp latency-bound on a
// single instruction stream. A block serves B / SMs rows (at least 1, at
// most 32), so every SM holds a block, with two warps: lane i of warp 1
// expands row i's message schedule, W[t] + K[t], into a two-stage ring in
// shared memory, one message block ahead of lane i of warp 0, which runs
// only the 80 rounds on it. The two lanes of a row sit in two warps, not
// one: the lanes of a warp issue one instruction stream, so a partner in
// the same warp would put the schedule back on the rounds' stream.
//
// merkle_level: node pair i of tree t is hashed when its right child lies
// inside the level's valid prefix, ceil(counts[t] / 2^level) (the JAX
// loop's repeated (c + 1) // 2), and the left child is promoted unchanged
// otherwise. A tree of P leaves takes log2 P launches.
#include <cuda_runtime.h>

#include <cstdint>

#include "ripemd160.cuh"
#include "sha256.cuh"
#include "sha512.cuh"

namespace {

constexpr int kThreads = 64;

// 16 consecutive u32 words of a block, as four 16-byte loads
__device__ __forceinline__ void load16(uint32_t w[16], const uint4* __restrict__ p) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = __ldg(p + q);
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ int64_t row_blocks(const int32_t* __restrict__ n_blocks, int64_t row, int64_t M) {
  const int64_t n = __ldg(n_blocks + row);
  return n < 0 ? 0 : (n > M ? M : n);
}

// blocks (B, M, 16) big-endian words -> out (B, 8)
__global__ void __launch_bounds__(kThreads)
    sha256_masked_kernel(const uint32_t* __restrict__ blocks, const int32_t* __restrict__ n_blocks,
                         uint32_t* __restrict__ out, int64_t B, int64_t M) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= B) return;
  const int64_t n = row_blocks(n_blocks, row, M);
  const uint4* p = reinterpret_cast<const uint4*>(blocks + row * M * 16);
  uint32_t s[8];
  sha256::init(s);
#pragma unroll 1
  for (int64_t j = 0; j < n; ++j) {
    uint32_t w[16];
    load16(w, p + 4 * j);
    sha256::compress(s, w);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[row * 8 + i] = s[i];
}

// blocks (B, M, 16) little-endian words -> out (B, 5)
__global__ void __launch_bounds__(kThreads)
    ripemd160_masked_kernel(const uint32_t* __restrict__ blocks, const int32_t* __restrict__ n_blocks,
                            uint32_t* __restrict__ out, int64_t B, int64_t M) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= B) return;
  const int64_t n = row_blocks(n_blocks, row, M);
  const uint4* p = reinterpret_cast<const uint4*>(blocks + row * M * 16);
  uint32_t s[5];
  ripemd160::init(s);
#pragma unroll 1
  for (int64_t j = 0; j < n; ++j) {
    uint32_t w[16];
    load16(w, p + 4 * j);
    ripemd160::compress(s, w);
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) out[row * 5 + i] = s[i];
}

constexpr int kSha512Rows = 32;  // rows of a sha512_masked block at most
constexpr int kSha512Threads = 64;  // warp 0 the rounds, warp 1 the schedule

// blocks (B, M, 32): 16 big-endian 64-bit words a block as (hi, lo) u32
// pairs -> out (B, 16), the digest in the same pairs; `rows` rows a block
__global__ void __launch_bounds__(kSha512Threads)
    sha512_masked_kernel(const uint32_t* __restrict__ blocks, const int32_t* __restrict__ n_blocks,
                         uint32_t* __restrict__ out, int64_t B, int64_t M, int rows) {
  // ring[stage][t][i]: W[t] + K[t] of row i's current block
  __shared__ uint64_t ring[2][80][kSha512Rows];
  const bool rounds_warp = threadIdx.x < 32;
  const int i = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * rows + i;
  const bool live = i < rows && row < B;
  const int64_t n = live ? row_blocks(n_blocks, row, M) : 0;
  // both warps see the same rows, so the same longest row
  const int64_t n_max = __reduce_max_sync(0xffffffffu, static_cast<unsigned>(n));
  const uint4* p = reinterpret_cast<const uint4*>(blocks + row * M * 32);
  // block j's 16 words, joined from their (hi, lo) pairs
  const auto load = [&](int64_t j, uint64_t w[16]) {
    if (j < n) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint4 v = __ldg(p + 8 * j + q);
        w[2 * q] = (static_cast<uint64_t>(v.x) << 32) | v.y;
        w[2 * q + 1] = (static_cast<uint64_t>(v.z) << 32) | v.w;
      }
    }
  };
  uint64_t s[8];
  sha512::init(s);
  // the schedule warp reads a block one compression before it expands
  // it, so the load's latency hides behind the expansion before
  uint64_t next[16];
  if (!rounds_warp) {
    uint64_t first[16];
    load(0, first);
    load(1, next);
    if (n > 0) sha512::schedule(&ring[0][0][i], kSha512Rows, first);
  }
  __syncthreads();
#pragma unroll 1
  for (int64_t j = 0; j < n_max; ++j) {
    if (!rounds_warp) {
      if (j + 1 < n) {  // block j + 1 into the other stage, while the rounds read this one
        uint64_t cur[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) cur[q] = next[q];
        load(j + 2, next);
        sha512::schedule(&ring[(j + 1) & 1][0][i], kSha512Rows, cur);
      }
    } else if (j < n) {
      sha512::rounds(s, &ring[j & 1][0][i], kSha512Rows);
    }
    __syncthreads();
  }
  if (rounds_warp && live) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      out[row * 16 + 2 * k] = static_cast<uint32_t>(s[k] >> 32);
      out[row * 16 + 2 * k + 1] = static_cast<uint32_t>(s[k]);
    }
  }
}

// nodes (T, P, W) -> out (T, P / 2, W); W = 8 (SHA-256) or 5 (RIPEMD-160)
template <int W>
__global__ void __launch_bounds__(kThreads)
    merkle_level_kernel(const uint32_t* __restrict__ nodes, const int32_t* __restrict__ counts,
                        uint32_t* __restrict__ out, int64_t T, int64_t P, int level) {
  const int64_t half = P / 2;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (pair >= T * half) return;
  const int64_t tree = pair / half;
  const int64_t i = pair - tree * half;
  const int64_t c = __ldg(counts + tree);
  const int64_t valid = (c + (int64_t{1} << level) - 1) >> level;  // ceil(c / 2^level)
  const uint32_t* left = nodes + (tree * P + 2 * i) * W;
  uint32_t l[W], h[W];
#pragma unroll
  for (int k = 0; k < W; ++k) l[k] = __ldg(left + k);
  if (2 * i + 1 < valid) {
    uint32_t r[W];
#pragma unroll
    for (int k = 0; k < W; ++k) r[k] = __ldg(left + W + k);
    if constexpr (W == sha256::kWords) {
      sha256::inner_node(l, r, h);
    } else {
      ripemd160::inner_node(l, r, h);
    }
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) h[k] = l[k];  // unpaired: promoted
  }
#pragma unroll
  for (int k = 0; k < W; ++k) out[pair * W + k] = h[k];
}

unsigned grid(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// blocks (B, M, 16) int32 bit patterns of SHA-256 words, n_blocks (B,)
// int32 -> out (B, 8); the same for RIPEMD-160 (out (B, 5)) and, with
// 32 words a block and out (B, 16), SHA-512
int sha256_masked(const void* blocks, const void* n_blocks, void* out, long long B, long long M,
                  void* stream) {
  if (B <= 0) return 0;
  sha256_masked_kernel<<<grid(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), static_cast<const int32_t*>(n_blocks),
      static_cast<uint32_t*>(out), B, M);
  return static_cast<int>(cudaGetLastError());
}

int ripemd160_masked(const void* blocks, const void* n_blocks, void* out, long long B, long long M,
                     void* stream) {
  if (B <= 0) return 0;
  ripemd160_masked_kernel<<<grid(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), static_cast<const int32_t*>(n_blocks),
      static_cast<uint32_t*>(out), B, M);
  return static_cast<int>(cudaGetLastError());
}

int sha512_masked(const void* blocks, const void* n_blocks, void* out, long long B, long long M,
                  void* stream) {
  if (B <= 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // each message is one chain: a batch of fewer than 32 a SM runs
  // fastest with one block (one round warp) on every SM
  const long long per_sm = sms > 0 ? B / sms : B;
  const int rows = static_cast<int>(per_sm < 1 ? 1 : (per_sm > kSha512Rows ? kSha512Rows : per_sm));
  const unsigned blocks_n = static_cast<unsigned>((B + rows - 1) / rows);
  sha512_masked_kernel<<<blocks_n, kSha512Threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), static_cast<const int32_t*>(n_blocks),
      static_cast<uint32_t*>(out), B, M, rows);
  return static_cast<int>(cudaGetLastError());
}

// nodes (T, P, W) int32, counts (T,) int32 leaf counts of the trees,
// level l (nodes hold level l of every tree) -> out (T, P / 2, W);
// algo 0 = SHA-256 (W = 8), 1 = RIPEMD-160 (W = 5)
int merkle_level(const void* nodes, const void* counts, void* out, long long T, long long P, int level,
                 int algo, void* stream) {
  const long long pairs = T * (P / 2);
  if (pairs <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* np = static_cast<const uint32_t*>(nodes);
  const auto* cp = static_cast<const int32_t*>(counts);
  auto* op = static_cast<uint32_t*>(out);
  if (algo == 0) {
    merkle_level_kernel<sha256::kWords><<<grid(pairs), kThreads, 0, st>>>(np, cp, op, T, P, level);
  } else {
    merkle_level_kernel<ripemd160::kWords><<<grid(pairs), kThreads, 0, st>>>(np, cp, op, T, P, level);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
