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
