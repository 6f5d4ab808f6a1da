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
// segment: layout devices of the TPU. Here one block of g*T <= 384 threads
// holds the g rows as contiguous segments of threads, so a short row does
// not leave most of a block idle (at T=48 one 64-thread block per row would
// run 16 idle threads of 64 and 8x the blocks). Its bound is the same:
// memory. Each radix pass is one warp `__ballot_sync` per warp, stored in
// shared memory; after one `__syncthreads` every thread counts its own
// segment's bits over the few warps that segment spans, each ballot masked
// to the segment's lanes first (a warp straddles segments whenever T is not
// a multiple of 32). The ties are filled in position order within each
// segment the same way. No atomics; the mask is bit-identical to K1's.

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

constexpr int kPackSlots = 384;  // g * T <= 384 threads per block

// The lanes of warp `warp` that hold slots of segment `seg` (threads
// [seg*T, seg*T + T) of the block).
__device__ __forceinline__ unsigned segment_lanes(int warp, int seg, int t_len) {
  const int lo = max(seg * t_len, warp * 32) - warp * 32;
  const int hi = min(seg * t_len + t_len, warp * 32 + 32) - warp * 32;
  if (hi <= lo) return 0u;
  const unsigned below_hi = hi >= 32 ? 0xffffffffu : ((1u << hi) - 1u);
  return below_hi & ~((1u << lo) - 1u);
}

// A segment's place among the block's warps: its first and last warp and
// their lanes in it; the warps between hold only its slots.
struct SegmentSpan {
  int w_first, w_last;
  unsigned m_first, m_last;
};

__device__ __forceinline__ SegmentSpan segment_span(int seg, int t_len) {
  const int w_first = (seg * t_len) >> 5;
  const int w_last = (seg * t_len + t_len - 1) >> 5;
  return {w_first, w_last, segment_lanes(w_first, seg, t_len),
          segment_lanes(w_last, seg, t_len)};
}

// Set bits of the per-warp ballots `wb` in the segment, over its warps up to
// `w_end` (inclusive).
__device__ __forceinline__ int segment_count(const unsigned* wb, const SegmentSpan& sp,
                                             int w_end) {
  if (w_end < sp.w_first) return 0;
  int n = __popc(wb[sp.w_first] & sp.m_first);
  for (int w = sp.w_first + 1; w <= w_end; ++w) {
    n += __popc(wb[w] & (w == sp.w_last ? sp.m_last : 0xffffffffu));
  }
  return n;
}

__global__ void fake_select_packed_kernel(const uint32_t* __restrict__ bits,
                                          const int32_t* __restrict__ n_valid,
                                          const int32_t* __restrict__ k_sel,
                                          bool* __restrict__ out, int rows,
                                          int t_len, int g, int pos_bits) {
  __shared__ unsigned wb[2][kPackSlots / 32];  // double-buffered pass ballots
  __shared__ unsigned wb_eq[kPackSlots / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seg = tid / t_len;  // g for the block's padding threads
  const int pos = tid - seg * t_len;
  const int row = blockIdx.x * g + seg;
  const bool live = seg < g && row < rows;
  const int nv = live ? n_valid[row] : 0;
  const int k = live ? k_sel[row] : 0;
  const int nbits = kKeyBits - pos_bits;
  const SegmentSpan span = segment_span(seg, t_len);
  // row * T + pos for a live thread: the block's rows are contiguous
  const size_t idx = static_cast<size_t>(blockIdx.x) * g * t_len + tid;

  int rand = INT_MAX;
  if (live && pos < nv) {
    rand = static_cast<int>(bits[idx] >> (32 - kKeyBits + pos_bits));
  }

  // per segment: smallest v with count(rand <= v) >= k, one bit per pass
  int prefix = 0;
  int buf = 0;
  for (int b = nbits - 1; b >= 0; --b) {
    const int bit = 1 << b;
    const unsigned bal = __ballot_sync(0xffffffffu, rand <= prefix + (bit - 1));
    if (lane == 0) wb[buf][warp] = bal;
    __syncthreads();
    if (live && segment_count(wb[buf], span, span.w_last) < k) prefix += bit;
    buf ^= 1;  // the other buffer was last read before this pass's barrier
  }
  const bool lt = rand < prefix;
  const bool eq = rand == prefix;
  const unsigned lt_bal = __ballot_sync(0xffffffffu, lt);
  const unsigned eq_bal = __ballot_sync(0xffffffffu, eq);
  if (lane == 0) {
    wb[buf][warp] = lt_bal;
    wb_eq[warp] = eq_bal;
  }
  __syncthreads();
  if (!live) return;
  const int need = k - segment_count(wb[buf], span, span.w_last);
  // inclusive count of ties in this segment up to this slot: the earlier
  // warps' ballots, then this warp's lanes up to this one
  int csum = segment_count(wb_eq, span, warp - 1);
  const unsigned my_lanes = warp == span.w_first ? span.m_first
                            : warp == span.w_last ? span.m_last : 0xffffffffu;
  const unsigned upto_lane = lane == 31 ? 0xffffffffu : ((2u << lane) - 1u);
  csum += __popc(eq_bal & my_lanes & upto_lane);
  out[idx] = k > 0 && (lt || (eq && csum <= need));
}

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

// The packed select for 1 <= t_len <= 192: `g` rows per block, g * t_len <=
// 384. Same arguments and result as dicl_fake_select.
extern "C" int dicl_fake_select_packed(const void* bits, const void* n_valid,
                                       const void* k, void* out, int rows, int t_len,
                                       int g, int pos_bits, void* stream) {
  if (t_len < 1 || t_len > 192 || g < 1 || g * t_len > kPackSlots || rows < 1) {
    return cudaErrorInvalidValue;
  }
  const int threads = (g * t_len + 31) / 32 * 32;
  const int blocks = (rows + g - 1) / g;
  fake_select_packed_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<const int32_t*>(n_valid),
      static_cast<const int32_t*>(k), static_cast<bool*>(out), rows, t_len, g, pos_bits);
  return static_cast<int>(cudaGetLastError());
}
