// The verdict of every verify path: encode(X/Z, Y/Z) == R.
//
// Replaces an XLA stage of the JAX package, not a Pallas kernel:
// tendermint_tpu/ops/ed25519_tables.py::_finish_encode_compare (with
// fe_batch_invert, fe_canon, fe_to_bytes), which the entries, fused and
// ladder paths all end in. Lane b is true when the canonical 32-byte
// encoding of y = Y/Z equals R with bit 255 cleared and the parity of
// the canonical x = X/Z equals bit 255 of R.
//
// Bound on this card: operations. A batched (Montgomery) inversion needs
// 3 multiplies a lane and one z^(p-2) a call, then X and Y times 1/Z: 5
// multiplies of 100 limb products a lane, against 240 bytes of X, Y, Z,
// 32 or 128 of R and 1 of verdict.
//
// Design: one inversion a block, Montgomery's trick as a product tree.
// A block of L lanes (L threads, a power of two in [32, 256] that the
// wrapper picks so that the call has a block on every SM where it can)
//   1. loads each lane's X, Y, Z (one lane a thread) and replaces a Z
//      that is 0 mod p by 1, noting that the block saw one;
//   2. multiplies the Z values up a heap in shared memory (node i =
//      node 2i * node 2i + 1, leaves at L + lane), log2 L levels, one
//      product a thread;
//   3. inverts the root once, with the 265-multiply chain in the group
//      form of the ladder (`ginvert`: ten threads hold one element, limb
//      k in thread k; the first warp runs it, its other lanes on copies);
//   4. walks back down, 1/child = 1/parent * sibling, one product a
//      thread, so leaf L + t holds 1/Z of lane t;
//   5. each thread finishes its own lane: X and Y times 1/Z, canonical
//      form, encoding of y, comparison with R.
// Shared memory: two limb-major trees of 2L elements (40 KB at L = 256).
// The critical path is one chain a block and 2 log2 L tree products,
// and the work about 5 multiplies a lane: a chain in every lane's own
// thread would be 267 multiplies a lane, latency-bound at these batch
// sizes (some 4 warps a SM).
//
// Z = 0. The inverse of a product is unique, so every lane with Z != 0
// gets the tree's verdict. The complete addition formulas keep Z != 0 on
// every input on the curve, and every chain input is (tables, combs, a
// rejected key continuing as the identity). Should Z = 0 arise all the
// same, the JAX tree inverts every lane of the batch to 0. The rule here,
// the same on every device, is stricter: a call in which any lane has
// Z = 0 is false on every lane. Each block adds its "saw a zero" bit to
// a 64-bit word of device scratch together with one block count; the
// block that finishes last clears every verdict when any bit was set,
// and zeroes the word for the next call of its stream (the wrapper keeps
// one word a stream). One atomic a block, no host sync, no other launch.
#include <cuda_runtime.h>

#include "fe25519_r26.cuh"

using namespace r26;

namespace {

constexpr int kMinLanes = 32;
constexpr int kMaxLanes = 256;
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

// value == 0 (mod p) of a loose element
__device__ __forceinline__ bool is_zero(const int32_t a[NL]) {
  int64_t v[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) v[i] = a[i];
  canon(v);
  bool z = true;
#pragma unroll
  for (int i = 0; i < NL; ++i) z = z && v[i] == 0;
  return z;
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

// node `i` of a limb-major tree into registers, and back
__device__ __forceinline__ void node_get(int32_t out[NL], int32_t (*tree)[2 * kMaxLanes], int i) {
#pragma unroll
  for (int k = 0; k < NL; ++k) out[k] = tree[k][i];
}
__device__ __forceinline__ void node_put(int32_t (*tree)[2 * kMaxLanes], int i,
                                         const int32_t v[NL]) {
#pragma unroll
  for (int k = 0; k < NL; ++k) tree[k][i] = v[k];
}

template <typename R>
__global__ void __launch_bounds__(kMaxLanes)
    finish_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                  const int32_t* __restrict__ z, int64_t lane_stride, int64_t limb_stride,
                  const R* __restrict__ r, uint8_t* __restrict__ ok, int64_t B,
                  unsigned long long* __restrict__ scratch) {
  // limb-major, so neighbouring threads touch neighbouring words
  __shared__ int32_t prod[NL][2 * kMaxLanes];  // node i: product of its leaves
  __shared__ int32_t inv[NL][2 * kMaxLanes];   // node i: its inverse
  __shared__ int zero_seen;
  __shared__ bool clear_all;
  const int L = blockDim.x;
  const int t = threadIdx.x;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * L + t;
  const bool active = lane < B;
  if (t == 0) zero_seen = 0;

  // -- 1. leaves: Z, or 1 for a zero Z and past the last lane ---------------
  // (X and Y load here too, so the three loads wait out one latency)
  int32_t leaf[NL], X[NL], Y[NL];
  if (active) {
    load_fe(leaf, z + lane * lane_stride, limb_stride);
    load_fe(X, x + lane * lane_stride, limb_stride);
    load_fe(Y, y + lane * lane_stride, limb_stride);
  } else {
#pragma unroll
    for (int k = 0; k < NL; ++k) leaf[k] = X[k] = Y[k] = k == 0;
  }
  const bool zero = is_zero(leaf);
  if (zero) {
#pragma unroll
    for (int k = 0; k < NL; ++k) leaf[k] = k == 0;
  }
  node_put(prod, L + t, leaf);
  __syncthreads();  // zero_seen is 0 and the leaves are in place
  if (zero) atomicOr(&zero_seen, 1);

  // -- 2. up the tree --------------------------------------------------------
  for (int n = L / 2; n >= 1; n /= 2) {
    if (t < n) {
      int32_t a[NL], b[NL], c[NL];
      node_get(a, prod, 2 * (n + t));
      node_get(b, prod, 2 * (n + t) + 1);
      fe_mul(c, a, b);
      node_put(prod, n + t, c);
    }
    __syncthreads();
  }

  // -- 3. the root's inverse, in the group form (L >= 32: warp 0 is whole) ---
  if (t < 32) {
    const Group g = group_of_thread();
    const int32_t root_inv = ginvert(prod[g.k][1], g);
    if (t < NL) inv[t][1] = root_inv;
  }
  __syncthreads();

  // -- 4. down the tree: 1/child = 1/parent * sibling ------------------------
  for (int n = 1; n < L; n *= 2) {
    if (t < 2 * n) {
      const int c = 2 * n + t;
      int32_t a[NL], b[NL], d[NL];
      node_get(a, inv, c >> 1);
      node_get(b, prod, c ^ 1);
      fe_mul(d, a, b);
      node_put(inv, c, d);
    }
    __syncthreads();
  }

  // -- 5. this thread's lane -------------------------------------------------
  if (active) {
    int32_t zinv[NL];
    node_get(zinv, inv, L + t);
    fe_mul(X, X, zinv);
    fe_mul(Y, Y, zinv);
    int64_t xc[NL], yc[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      xc[i] = X[i];
      yc[i] = Y[i];
    }
    canon(xc);
    canon(yc);
    const R* rr = r + lane * kRBytes;
    bool same = true;
#pragma unroll
    for (int j = 0; j < kRBytes - 1; ++j) same = same && static_cast<int32_t>(rr[j]) == byte_of(yc, j);
    const int32_t last = static_cast<int32_t>(rr[kRBytes - 1]);
    same = same && (last & 0x7F) == byte_of(yc, kRBytes - 1);
    same = same && ((last >> 7) & 1) == (xc[0] & 1);
    ok[lane] = same;
  }

  // -- the call's Z = 0 rule -------------------------------------------------
  __threadfence();  // this thread's verdict is visible before the block counts
  __syncthreads();
  if (t == 0) {
    const unsigned long long mine = zero_seen ? (1ull << 32) : 0;
    const unsigned long long before = atomicAdd(scratch, mine + 1);
    const bool last_block = (before & 0xffffffffull) == gridDim.x - 1;
    clear_all = last_block && ((before >> 32) != 0 || mine != 0);
    if (last_block) *scratch = 0;  // every block has counted: zeroed for the next call
  }
  __syncthreads();
  if (clear_all) {
    __threadfence();
    for (int64_t i = t; i < B; i += L) ok[i] = 0;
  }
}

}  // namespace

extern "C" {

// x, y, z (B, 20) int32 boundary limbs, element (lane, limb) at
// lane * lane_stride + limb * limb_stride (the three alike), r (B, 32)
// bytes as uint8 (r_itemsize 1) or int32 (4) -> ok (B,) uint8; `lanes`
// lanes a block (a power of two in [32, 256]); scratch one 64-bit word
// of device memory, zero before the call and zero after it, used by no
// other call at the same time
int finish_encode_compare(const void* x, const void* y, const void* z, long long lane_stride,
                          long long limb_stride, const void* r, int r_itemsize, void* ok,
                          long long B, int lanes, void* scratch, void* stream) {
  if (B <= 0) return 0;
  if (lanes < kMinLanes || lanes > kMaxLanes || (lanes & (lanes - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((B + lanes - 1) / lanes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int32_t*>(x);
  const auto* yp = static_cast<const int32_t*>(y);
  const auto* zp = static_cast<const int32_t*>(z);
  auto* okp = static_cast<uint8_t*>(ok);
  auto* sp = static_cast<unsigned long long*>(scratch);
  if (r_itemsize == 1) {
    finish_kernel<uint8_t><<<blocks, lanes, 0, st>>>(
        xp, yp, zp, lane_stride, limb_stride, static_cast<const uint8_t*>(r), okp, B, sp);
  } else {
    finish_kernel<int32_t><<<blocks, lanes, 0, st>>>(
        xp, yp, zp, lane_stride, limb_stride, static_cast<const int32_t*>(r), okp, B, sp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
