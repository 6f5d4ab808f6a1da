// Exact-k fake-sample select for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_select_kernel` (called by `_select_pallas`)
// in deep_interpolation_clustering_tpu/ops/pallas_select.py. For each
// (encounter, channel) row it marks the k slots with the smallest 30-bit keys
// among the first n_valid slots, where a key is the random high bits of
// `bits` above the slot position. The mask is bit-identical to the sort
// oracle `_select_xla` (and to the port's plain version, cuda_select.py).
//
// Bound on the H100: memory. Per row it reads T 32-bit words and writes T
// bytes; the 21 radix passes at T=354 are block-wide counts on values held
// in registers, a few hundred integer operations per slot, far below the
// card's integer rate.
//
// Design: one block per row, one thread per slot (T <= 1024, blockDim is T
// rounded up to a warp). The random part of each slot's key stays in a
// register for the whole select, so the row is read from memory once.
//   1. A one-bit-per-pass MSD radix select over the 30-p random bits finds
//      v*, the k-th smallest random part; each pass is one
//      `__syncthreads_count`.
//   2. Every slot with rand < v* is taken; the `k - count(rand < v*)` ties
//      at v* are filled in position order with a block prefix count (warp
//      `__ballot_sync`/`__popc` plus per-warp totals in shared memory).
// Position-ordered tie fill equals (rand, pos)-lexicographic order, which is
// what thresholding the packed keys does. Rows with k = 0 select nothing.
//
// The packed entry `dicl_fake_select_packed` replaces `_select_kernel_packed`
// (called by `_select_pallas_packed`), the TPU kernel for T <= 192. There
// `g = 384 // T` rows share one 128-lane row and 0/1 matmuls count per
// segment: layout devices of the TPU. What carries over is only that a short
// row must not cost a block of its own. Its bound is the same: memory.
//
// Design: a warp owns a row, eight rows a block. Lane l holds the random
// parts of slots l, l + 32, ... in registers (S = ceil(T / 32) <= 6 of them,
// a template parameter; the loads coalesce), so a radix pass is S
// `__ballot_sync` + `__popc` and one compare: no barrier, no shared memory,
// and the count is taken once, not by every thread. At the scaled
// configuration (24,576 rows of T = 48) that is 24,576 independent warps.
// Since no other row waits on it, a warp also stops as soon as a pass counts
// exactly k slots at or below its threshold: those slots are the answer, and
// with random keys that happens after about log2(n_valid) + 2 of the 30 - p
// passes. Otherwise (ties in the random part at the k-th key) it runs every
// pass and fills the ties in position order: chunk by chunk, then the lanes
// below. No atomics; the mask is bit-identical to K1's.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kKeyBits = 30;

__global__ void fake_select_kernel(const uint32_t* __restrict__ bits,
                                   const int32_t* __restrict__ n_valid,
                                   const int32_t* __restrict__ k_sel,
                                   bool* __restrict__ out, int t_len,
                                   int pos_bits) {
  __shared__ int warp_ties[32];
  const int row = blockIdx.x;
  const int pos = threadIdx.x;
  const int nv = n_valid[row];
  const int k = k_sel[row];
  const int nbits = kKeyBits - pos_bits;
  const size_t base = static_cast<size_t>(row) * t_len;

  // logical shift of the uint32 pattern; invalid and out-of-row slots get
  // INT_MAX, above every random part (< 2^nbits)
  int rand = INT_MAX;
  if (pos < t_len && pos < nv) {
    rand = static_cast<int>(bits[base + pos] >> (32 - kKeyBits + pos_bits));
  }

  // smallest v with count(rand <= v) >= k, one answer bit per pass
  int prefix = 0;
  for (int b = nbits - 1; b >= 0; --b) {
    const int bit = 1 << b;
    const int c0 = __syncthreads_count(rand <= prefix + (bit - 1));
    if (c0 < k) prefix += bit;
  }
  const bool lt = rand < prefix;
  const bool eq = rand == prefix;
  const int need = k - __syncthreads_count(lt);

  // inclusive count of ties up to this slot, in position order
  const int lane = pos & 31;
  const int warp = pos >> 5;
  const unsigned ties = __ballot_sync(0xffffffffu, eq);
  if (lane == 0) warp_ties[warp] = __popc(ties);
  __syncthreads();
  int csum = __popc(ties & (0xffffffffu >> (31 - lane)));
  for (int w = 0; w < warp; ++w) csum += warp_ties[w];

  if (pos < t_len) {
    out[base + pos] = k > 0 && (lt || (eq && csum <= need));
  }
}

constexpr int kPackWarps = 8;     // rows a block of the packed select, a warp each
constexpr int kPackMaxSlots = 6;  // slots a lane holds at most: T <= 32 * this

// Set bits of the S ballots of `pred(i)`, i < S: a count over the warp's row.
template <int S, class Pred>
__device__ __forceinline__ int row_count(Pred pred) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) n += __popc(__ballot_sync(0xffffffffu, pred(i)));
  return n;
}

// A warp a row; lane l holds slots l + 32 i, i < S, with 32 S >= t_len.
template <int S>
__global__ void __launch_bounds__(32 * kPackWarps) fake_select_packed_kernel(
    const uint32_t* __restrict__ bits, const int32_t* __restrict__ n_valid,
    const int32_t* __restrict__ k_sel, bool* __restrict__ out, int rows, int t_len,
    int pos_bits) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kPackWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int nv = n_valid[row];
  const int k = k_sel[row];
  const int nbits = kKeyBits - pos_bits;
  const size_t base = static_cast<size_t>(row) * t_len;

  // invalid and out-of-row slots get INT_MAX, above every random part
  int rand[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int pos = lane + 32 * i;
    rand[i] = INT_MAX;
    if (pos < t_len && pos < nv) {
      rand[i] = static_cast<int>(bits[base + pos] >> (32 - kKeyBits + pos_bits));
    }
  }

  // smallest v with count(rand <= v) >= k, one answer bit per pass; a pass
  // that counts exactly k has found the k smallest and ends the search
  int prefix = 0;
  bool exact = k == 0;  // nothing to take: rand <= -1 selects nothing
  if (exact) prefix = -1;
  for (int b = nbits - 1; b >= 0 && !exact; --b) {
    const int thr = prefix + ((1 << b) - 1);
    const int c0 = row_count<S>([&](int i) { return rand[i] <= thr; });
    if (c0 == k) {
      prefix = thr;
      exact = true;
    } else if (c0 < k) {
      prefix = thr + 1;
    }
  }

  bool sel[S];
  if (exact) {
#pragma unroll
    for (int i = 0; i < S; ++i) sel[i] = rand[i] <= prefix;
  } else {
    // all below the k-th key, and its ties in position order
    const int need = k - row_count<S>([&](int i) { return rand[i] < prefix; });
    const unsigned upto_lane = 0xffffffffu >> (31 - lane);
    int before = 0;  // ties in the chunks before this one
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const bool eq = rand[i] == prefix;
      const unsigned ties = __ballot_sync(0xffffffffu, eq);
      sel[i] = rand[i] < prefix || (eq && before + __popc(ties & upto_lane) <= need);
      before += __popc(ties);
    }
  }
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int pos = lane + 32 * i;
    if (pos < t_len) out[base + pos] = sel[i];
  }
}

template <int S, class... Args>
inline void launch_packed(int rows, cudaStream_t s, Args... args) {
  fake_select_packed_kernel<S><<<(rows + kPackWarps - 1) / kPackWarps, 32 * kPackWarps, 0, s>>>(
      args...);
}

// The kernel that holds `slots` slots a lane.
template <class... Args>
inline void launch_packed_slots(int slots, Args... args) {
  switch (slots) {
    case 1: launch_packed<1>(args...); break;
    case 2: launch_packed<2>(args...); break;
    case 3: launch_packed<3>(args...); break;
    case 4: launch_packed<4>(args...); break;
    case 5: launch_packed<5>(args...); break;
    default: launch_packed<6>(args...); break;
  }
}
static_assert(kPackMaxSlots == 6, "launch_packed_slots names every slot count the entry takes");

}  // namespace

// bits: (rows, t_len) uint32 bit patterns; n_valid, k: (rows,) int32;
// out: (rows, t_len) bool. Launches on `stream`; returns cudaGetLastError().
extern "C" int dicl_fake_select(const void* bits, const void* n_valid,
                                const void* k, void* out, int rows, int t_len,
                                int pos_bits, void* stream) {
  if (t_len < 1 || t_len > 1024 || rows < 1) return cudaErrorInvalidValue;
  const int threads = (t_len + 31) / 32 * 32;
  fake_select_kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<const int32_t*>(n_valid),
      static_cast<const int32_t*>(k), static_cast<bool*>(out), t_len, pos_bits);
  return static_cast<int>(cudaGetLastError());
}

// The packed select for 1 <= t_len <= 192: a warp a row, `warps` rows a
// block, `slots` slots a lane. Both are the wrapper's layout (`packed_layout`
// in ops/cuda_select.py) and must be this file's for t_len. Same arguments
// and result as dicl_fake_select otherwise.
extern "C" int dicl_fake_select_packed(const void* bits, const void* n_valid,
                                       const void* k, void* out, int rows, int t_len,
                                       int slots, int warps, int pos_bits, void* stream) {
  if (t_len < 1 || t_len > 32 * kPackMaxSlots || rows < 1) return cudaErrorInvalidValue;
  if (slots != (t_len + 31) / 32 || warps != kPackWarps) return cudaErrorInvalidValue;
  launch_packed_slots(slots, rows, static_cast<cudaStream_t>(stream),
                      static_cast<const uint32_t*>(bits), static_cast<const int32_t*>(n_valid),
                      static_cast<const int32_t*>(k), static_cast<bool*>(out), rows, t_len,
                      pos_bits);
  return static_cast<int>(cudaGetLastError());
}
