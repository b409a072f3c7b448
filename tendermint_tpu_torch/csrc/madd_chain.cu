// Mixed-add chains of the comb-table verify path: the per-lane sum
// [S]B + [h](-A) of affine-precomputed entries, left in extended
// coordinates for the finish kernel (finish.cu: invert, encode,
// compare). Both chains select their own entries from the validator
// tables (64, 16, 60, N) int16 and a fixed-base comb; lane
// b = c * N + v verifies against validator v = b mod N, so any N and
// any number of whole commits run. Field code: fe25519_r26.cuh.
//
// Replaces two Pallas kernels of the JAX package:
//   madd_chain_entries  <- tendermint_tpu/ops/ed25519_tables.py
//                          _sum_entries_pallas / _madd_chain_kernel
//                          (96 mixed adds of entries the XLA gather
//                          `_select_entries` materialised: a gather is
//                          slow on the TPU; here each lane reads its own)
//   madd_chain_fused    <- tendermint_tpu/ops/ed25519_tables.py
//                          _fused_chain_pallas / _make_fused_kernel
//                          (128 mixed adds, each entry read from the
//                          validator tables inside the kernel)
//
// madd_chain_entries. Steps 0..31 take the w = 8 comb entry picked by
// byte w of S (`b_table`, 32 x 256 x 60 int32, 2 MB: stays in L2);
// steps 32..95 the table entry [w][nibble w of h][:, v]. Ten threads a
// lane, thread k holding limb k of X, Y, Z, T (the ladder's form): a
// mixed add is 7 group multiplies, three lanes a warp, so 10,000 lanes
// are 3,334 warps (25 a SM) where one thread a lane gave 157 blocks of
// 2 warps. Thread k reads limbs 2k, 2k + 1 of each entry coordinate and
// packs them; the next step's entry is loaded before this step's
// additions, so its latency hides behind them. Chosen over splitting
// the 96 steps among two or three one-lane threads joined by extended
// additions (the fused kernel's shape): that form holds whole elements
// in every thread (200 registers in the fused kernel, 2 blocks a SM)
// and, at 10,000 lanes, gives 7 warps a SM to hide the scattered table
// reads; the group form needs few registers and reuses the ladder's
// field code.
//
// Bound on this card: the table reads. The 60 limbs of an entry lie N
// int16 apart and neighbouring lanes pick other nibbles, so a lane-step
// touches 60 32-byte sectors, not 120 bytes: the bytes the kernel must
// move are the distinct sectors its lanes touch (at most the table,
// 122,880 bytes a validator: 1.23 GB at 10,000) plus S, h (256 bytes a
// lane) and the output (320 bytes a lane); `chip_smoke.py` counts the
// sectors of each run's digits. The operations, 96 x 7 multiplies of
// 100 limb products a lane, take far less time at the INT32 rate.
//
// madd_chain_fused: see the kernel's comment. A block covers 8
// validators of up to 8 commits.
#include <cuda_runtime.h>

#include "fe25519_r26.cuh"

namespace {

constexpr int kL13 = 2 * r26::NL;            // 13-bit limbs of an element
constexpr int kEntryLimbs = 3 * kL13;        // ypx | ymx | t2d

// -- madd_chain_entries: selection in the kernel, ten threads a lane ---------

constexpr int kEntriesThreads = 128;
constexpr int kLanesPerWarp = 3;
constexpr int kLanesPerBlock = kLanesPerWarp * (kEntriesThreads / 32);
constexpr int kCombSteps = 32;   // w = 8 comb of B
constexpr int kEntrySteps = 96;  // then 64 steps of the validator tables

struct Entry {
  int32_t ypx, ymx, t2d;  // this thread's limb of each, radix 2^26
};

// Step `step`'s entry, limb k of each coordinate. s_row, h_row: the
// lane's 32 bytes of S and h (int32 each); v: its validator.
__device__ __forceinline__ Entry load_entry(int step, const int16_t* __restrict__ tables,
                                            const int32_t* __restrict__ btab,
                                            const int32_t* s_row, const int32_t* h_row,
                                            int64_t N, int64_t v, int k) {
  if (step < kCombSteps) {
    const int byte = __ldg(s_row + step) & 0xFF;
    const int32_t* e = btab + (step * 256 + byte) * kEntryLimbs + 2 * k;
    return Entry{__ldg(e) + (__ldg(e + 1) << 13),
                 __ldg(e + kL13) + (__ldg(e + kL13 + 1) << 13),
                 __ldg(e + 2 * kL13) + (__ldg(e + 2 * kL13 + 1) << 13)};
  }
  const int w = step - kCombSteps;
  const int nib = (__ldg(h_row + (w >> 1)) >> (4 * (w & 1))) & 0xF;
  const int16_t* e = tables + (static_cast<int64_t>(w * 16 + nib) * kEntryLimbs + 2 * k) * N + v;
  const auto limb = [&](int i) { return static_cast<int32_t>(__ldg(e + i * N)); };
  return Entry{limb(0) + (limb(1) << 13), limb(kL13) + (limb(kL13 + 1) << 13),
               limb(2 * kL13) + (limb(2 * kL13 + 1) << 13)};
}

__global__ void __launch_bounds__(kEntriesThreads)
    madd_chain_entries_kernel(const int16_t* __restrict__ tables,
                              const int32_t* __restrict__ btab,
                              const int32_t* __restrict__ s, const int32_t* __restrict__ h,
                              int32_t* __restrict__ out, int64_t B, int64_t N) {
  const r26::Group g = r26::group_of_thread();
  const int tid = threadIdx.x;
  const int slot = (tid & 31) / r26::NL;  // 3: lanes 30, 31 of the warp
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kLanesPerBlock +
                       (tid >> 5) * kLanesPerWarp + (slot < kLanesPerWarp ? slot : 0);
  const bool active = slot < kLanesPerWarp && lane < B;
  const int64_t row = lane < B ? lane : B - 1;  // junk threads read a real row
  const int32_t* s_row = s + row * 32;
  const int32_t* h_row = h + row * 32;
  const int64_t v = row % N;

  r26::GPoint acc = r26::gidentity(g);
  Entry cur = load_entry(0, tables, btab, s_row, h_row, N, v, g.k);
#pragma unroll 1
  for (int step = 0; step < kEntrySteps; ++step) {
    const int ahead = step + 1 < kEntrySteps ? step + 1 : step;
    const Entry next = load_entry(ahead, tables, btab, s_row, h_row, N, v, g.k);
    acc = r26::gmadd(acc, cur.ypx, cur.ymx, cur.t2d, g);
    cur = next;
  }
  r26::gstore(out, 0, acc.X, g, lane, B, active);
  r26::gstore(out, 1, acc.Y, g, lane, B, active);
  r26::gstore(out, 2, acc.Z, g, lane, B, active);
  r26::gstore(out, 3, acc.T, g, lane, B, active);
}

// -- madd_chain_fused: a validator tile staged once per window ---------------

constexpr int kTileV = 8;                   // validators a block
constexpr int kMaxCommits = 8;              // commits a block
constexpr int kSlabRows = 16 * kEntryLimbs;  // (digit, limb) rows of a window
constexpr int kRowWords = kTileV / 2 + 1;   // a row's 8 int16 from a 4-byte boundary

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct FusedSlab {
  __align__(16) int32_t sb[kSlabRows];           // comb entries of the window
  uint32_t tab[kSlabRows * kRowWords];           // the tile's table rows
};

// Window w of the tile starting at validator v0 into `slab`: the comb's
// (16, 60) int32 slab in 16-byte copies, and each (digit, limb) row's
// kTileV int16 values as the 4-byte words that hold them. Row r's first
// value sits at int16 index (w * 960 + r) * N + v0 of the table, odd
// exactly when N and r are odd (v0 is a multiple of kTileV), so the
// reader skips one int16 there. Words past the table's end are zero; the
// half-word at the end of an odd-sized table is copied alone.
__device__ __forceinline__ void load_window(FusedSlab& slab, int w, const int16_t* tables,
                                            const int32_t* sb, int64_t N, int64_t v0,
                                            int64_t total) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(tables);
  for (int i = threadIdx.x; i < kSlabRows * kRowWords; i += blockDim.x) {
    const int r = i / kRowWords;
    const int64_t word = (((static_cast<int64_t>(w) * kSlabRows + r) * N + v0) >> 1) + i % kRowWords;
    if (2 * word + 1 < total) {
      cp_async4(&slab.tab[i], words + word);
    } else {
      slab.tab[i] = 2 * word < total ? static_cast<uint16_t>(tables[2 * word]) : 0u;
    }
  }
  for (int i = threadIdx.x; i < kSlabRows / 4; i += blockDim.x) {
    cp_async16(&slab.sb[4 * i], sb + static_cast<int64_t>(w) * kSlabRows + 4 * i);
  }
}

// one coordinate of a lane into out (4, 20, B), back in the boundary form
__device__ __forceinline__ void store_r26(int32_t* out, int coord, const int32_t a[r26::NL],
                                          int64_t lane, int64_t B) {
  int64_t v[r26::NL];
#pragma unroll
  for (int i = 0; i < r26::NL; ++i) v[i] = a[i];
  int32_t l13[kL13];
  r26::to_boundary(l13, v);
#pragma unroll
  for (int i = 0; i < kL13; ++i) out[(coord * kL13 + i) * B + lane] = l13[i];
}

// Block: kTileV validators x kc commits, two threads a lane (lane
// b = c * N + v). Even threads sum the 64 comb steps of [S]B, odd threads
// the 64 validator-table steps of [h](-A), each in one thread's registers
// with the radix-2^26 field code; the pair joins with one extended
// addition over a shuffle. Each window's slabs are loaded once per block
// with cp.async, double-buffered: the next window's copies fly while
// this one's additions run.
__global__ void __launch_bounds__(2 * kTileV * kMaxCommits)
    madd_chain_fused_kernel(const int16_t* __restrict__ tables,
                            const int32_t* __restrict__ sb,
                            const int32_t* __restrict__ digits,
                            int32_t* __restrict__ out, int64_t B, int64_t N,
                            int kc, int commit_groups) {
  __shared__ FusedSlab slabs[2];
  const int tile = blockIdx.x / commit_groups;
  const int cg = blockIdx.x % commit_groups;
  const int half = threadIdx.x & 1;  // 0: comb of B, 1: validator tables
  const int vl = (threadIdx.x >> 1) % kTileV;
  const int cl = (threadIdx.x >> 1) / kTileV;
  const int64_t v0 = static_cast<int64_t>(tile) * kTileV;
  const int64_t commits = B / N;
  const int64_t c = static_cast<int64_t>(cg) * kc + cl;
  const bool valid = v0 + vl < N && c < commits;
  const int64_t lane = valid ? c * N + v0 + vl : 0;
  const int64_t total = 64 * kSlabRows * N;
  const int shift_odd_rows = static_cast<int>(N & 1);

  int32_t X[r26::NL], Y[r26::NL], Z[r26::NL], T[r26::NL];
  r26::set_identity(X, Y, Z, T);
  int32_t ypx[r26::NL], ymx[r26::NL], t2d[r26::NL];

  load_window(slabs[0], 0, tables, sb, N, v0, total);
  cp_async_commit();
#pragma unroll 1
  for (int w = 0; w < 64; ++w) {
    if (w + 1 < 64) load_window(slabs[(w + 1) & 1], w + 1, tables, sb, N, v0, total);
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
    const FusedSlab& slab = slabs[w & 1];
    const int d = __ldg(digits + static_cast<int64_t>(half * 64 + w) * B + lane);
    const int row0 = d * kEntryLimbs;
    if (half == 0) {
      const int32_t* e = slab.sb + row0;
      r26::pack13(ypx, e);
      r26::pack13(ymx, e + kL13);
      r26::pack13(t2d, e + 2 * kL13);
    } else {
      int32_t l13[kEntryLimbs];
#pragma unroll
      for (int i = 0; i < kEntryLimbs; ++i) {
        const int r = row0 + i;
        const uint16_t* rowv = reinterpret_cast<const uint16_t*>(slab.tab + r * kRowWords);
        l13[i] = static_cast<int16_t>(rowv[(shift_odd_rows & r) + vl]);
      }
      r26::pack13(ypx, l13);
      r26::pack13(ymx, l13 + kL13);
      r26::pack13(t2d, l13 + 2 * kL13);
    }
    r26::madd(X, Y, Z, T, ypx, ymx, t2d);
    __syncthreads();
  }

  // join: the comb thread adds its partner's [h](-A)
  int32_t X2[r26::NL], Y2[r26::NL], Z2[r26::NL], T2[r26::NL];
#pragma unroll
  for (int i = 0; i < r26::NL; ++i) {
    X2[i] = __shfl_xor_sync(r26::FULL, X[i], 1);
    Y2[i] = __shfl_xor_sync(r26::FULL, Y[i], 1);
    Z2[i] = __shfl_xor_sync(r26::FULL, Z[i], 1);
    T2[i] = __shfl_xor_sync(r26::FULL, T[i], 1);
  }
  if (!valid || half != 0) return;
  int32_t d2[r26::NL];
#pragma unroll
  for (int i = 0; i < r26::NL; ++i) d2[i] = r26::kD2[i];
  r26::add(X, Y, Z, T, X2, Y2, Z2, T2, d2);
  store_r26(out, 0, X, lane, B);
  store_r26(out, 1, Y, lane, B);
  store_r26(out, 2, Z, lane, B);
  store_r26(out, 3, T, lane, B);
}

}  // namespace

extern "C" {

// tables (64, 16, 60, N) int16, btab (32 * 256, 60) int32 comb, s and h
// (B, 32) int32 bytes -> out (4, 20, B) int32; B a multiple of N
int madd_chain_entries(const void* tables, const void* btab, const void* s, const void* h,
                       void* out, long long B, long long N, void* stream) {
  if (B <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((B + kLanesPerBlock - 1) / kLanesPerBlock);
  madd_chain_entries_kernel<<<blocks, kEntriesThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(tables), static_cast<const int32_t*>(btab),
      static_cast<const int32_t*>(s), static_cast<const int32_t*>(h), static_cast<int32_t*>(out),
      B, N);
  return static_cast<int>(cudaGetLastError());
}

// tables (64, 16, 60, N) int16, sb (64, 16, 60) int32, digits (128, B)
// int32 nibbles -> out (4, 20, B) int32; B a multiple of N
int madd_chain_fused(const void* tables, const void* sb, const void* digits,
                     void* out, long long B, long long N, void* stream) {
  if (B <= 0) return 0;
  const long long commits = B / N;
  const int kc = static_cast<int>(commits < kMaxCommits ? commits : kMaxCommits);
  const long long groups = (commits + kc - 1) / kc;
  const long long tiles = (N + kTileV - 1) / kTileV;
  madd_chain_fused_kernel<<<static_cast<unsigned>(tiles * groups), 2 * kTileV * kc, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(tables), static_cast<const int32_t*>(sb),
      static_cast<const int32_t*>(digits), static_cast<int32_t*>(out), B, N, kc,
      static_cast<int>(groups));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
