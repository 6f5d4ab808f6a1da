// Exact-k fake-sample select for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_select_kernel` (called by `_select_pallas`)
// and `_select_kernel_packed` (called by `_select_pallas_packed`, T <= 192) in
// deep_interpolation_clustering_tpu/ops/pallas_select.py. Both are instances
// of the one template below; ops/cuda_select.py wraps them as `fake_select`
// and `fake_select_packed`, each with its own launch count. For each
// (encounter, channel) row the kernel marks the k slots with the smallest
// 30-bit keys among the first n_valid slots, where a key is the random high
// bits of `bits` above the slot position. The mask is bit-identical to the
// sort oracle `_select_xla` (and to the port's plain version, cuda_select.py).
//
// Bound on the H100: memory. A row is T 32-bit words in and T bytes out; the
// radix passes are integer work on values held in registers, far below the
// card's integer rate. The first kernel (one block a row, a thread a slot)
// was held back by the passes, not the bytes: each of the 30 - p passes (21 at
// T = 354) was a block-wide `__syncthreads_count`, and all of them ran. The
// TPU kernels' layout devices (rows packed into 128 lanes, 0/1 matmuls that
// count segments, a triangular matmul for the tie fill) do not carry over.
//
// Design: a row belongs to a team of W warps, the fewest of 1, 2 or 4 that
// keep a lane to kLaneSlots = 6 slots, chosen from T by the C entry
// (`select_layout` in ops/cuda_select.py is the same rule):
//   T <= 192          a warp a row, kWarpRows = 8 rows a block, 1-6 slots a lane;
//   192 < T <= 384    2 warps a row, one row a block, 4-6 slots a lane;
//   384 < T <= 1024   4 warps a row, one row a block, 4-8 slots a lane;
//   T > 1024          kLoopWarps = 8 warps a row, one row a block, the row
//                     streamed from memory on every pass (below).
// Measured on the H100 (PERF.md), a warp a row with up to 32 slots a lane
// loses to these teams at every T above 192: a pass costs a barrier in a
// team, but S ballots in a row's one warp, and a long row gives few warps.
// Warp w of the team holds the S x 32 consecutive slots from 32 S w on, lane
// l the slots 32 S w + l + 32 i, i < S (S = ceil(T / 32 W), a template
// parameter): read once, coalesced, and kept in registers. A radix pass
// counts the slots at or below a threshold: S `__ballot_sync` + `__popc` in
// each warp and, with W > 1, the warps' counts added through shared memory
// behind one barrier (the two halves of the count buffer alternate, so the
// next pass can write before anyone reads again). Every warp of a team reads
// the same total and takes the same branch. A row stops at the first pass
// that counts exactly k slots at or below its threshold: those are the k
// smallest whatever the ties, and with random keys that happens after about
// log2(n_valid) + 2 of the 30 - p passes. Otherwise (ties in the random part
// at the k-th key) it runs every pass and fills the ties in position order:
// the warps below, the chunks below, then the lanes below. No atomics.
//
// Rows longer than kMaxT do not fit in registers at 8 slots a lane. There a
// block of kLoopWarps warps owns the row and warp w walks the same 32 S
// consecutive slots (S = ceil(T / 32 W), a runtime count), 32 at a time,
// reading the keys again on every pass: from memory on the first, from L2
// after it (a 2^20-slot call is 4 MB of keys). Only the slots below n_valid
// are read; a pass is the walk's ballots and one barrier, the tie fill the
// same walk twice (the warp's ties, then the fill in position order).

#include <climits>
#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int kKeyBits = 30;

// --------------------------------------------------- the layout's constants
constexpr int kMaxT = 1024;    // the longest row held in registers
constexpr int kLoopWarps = 8;  // warps of the block that walks a longer row
constexpr int kLaneSlots = 6;  // a row takes the fewest warps that keep a lane to this many slots
constexpr int kMaxWarps = 4;   // ... but no more warps than this (one row a block above 1)
constexpr int kWarpRows = 8;   // rows a block when a warp owns a row
// slots a lane at most with the most warps
constexpr int kTopSlots = (kMaxT + 32 * kMaxWarps - 1) / (32 * kMaxWarps);

// The team's warps add one count each through shared memory: one barrier,
// and `half` alternates so that a warp running ahead writes the half no
// warp still reads. Returns the sum over the warps below `warp`; `total`
// gets the sum over all of them.
template <int W>
__device__ __forceinline__ int team_add(int n, int (&buf)[2][W], int& half, int lane, int warp,
                                        int& total) {
  if (lane == 0) buf[half][warp] = n;
  __syncthreads();
  int below = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int c = buf[half][w];
    total += c;
    below += w < warp ? c : 0;
  }
  half ^= 1;
  return below;
}

// Set bits of the S ballots of `pred(i)`, i < S, over the warp's slots.
template <int S, class Pred>
__device__ __forceinline__ int warp_count(Pred pred) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) n += __popc(__ballot_sync(0xffffffffu, pred(i)));
  return n;
}

// The count of `pred` over the row: the warp's, then the team's.
template <int S, int W, class Pred>
__device__ __forceinline__ int row_count(Pred pred, int (&buf)[2][W], int& half, int lane,
                                         int warp) {
  int n = warp_count<S>(pred);
  if constexpr (W > 1) team_add<W>(n, buf, half, lane, warp, n);
  return n;
}

// S slots a lane, W warps a row, ROWS rows a block (ROWS = 1 when W > 1).
template <int S, int W, int ROWS>
__global__ void __launch_bounds__(32 * W * ROWS) fake_select_kernel(
    const uint32_t* __restrict__ bits, const int32_t* __restrict__ n_valid,
    const int32_t* __restrict__ k_sel, bool* __restrict__ out, int rows, int t_len,
    int pos_bits) {
  static_assert(W == 1 || ROWS == 1, "a team of warps owns its block");
  __shared__ int buf[2][W];  // W > 1: each warp's count of a pass
  const int lane = threadIdx.x & 31;
  const int warp = W > 1 ? threadIdx.x >> 5 : 0;  // the warp's place in the team
  const int row = W > 1 ? blockIdx.x : blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;  // W = 1: the whole warp leaves together; W > 1: never
  int half = 0;
  const int nv = n_valid[row];
  const int k = k_sel[row];
  const int nbits = kKeyBits - pos_bits;
  const size_t base = static_cast<size_t>(row) * t_len + 32 * S * warp + lane;
  const int first = 32 * S * warp + lane;  // this lane's first slot

  // invalid and out-of-row slots get INT_MAX, above every random part
  int rand[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int pos = first + 32 * i;
    rand[i] = INT_MAX;
    if (pos < t_len && pos < nv) {
      rand[i] = static_cast<int>(bits[base + 32 * i] >> (32 - kKeyBits + pos_bits));
    }
  }

  // smallest v with count(rand <= v) >= k, one answer bit per pass; a pass
  // that counts exactly k has found the k smallest and ends the search
  int prefix = 0;
  bool exact = k == 0;  // nothing to take: rand <= -1 selects nothing
  if (exact) prefix = -1;
  for (int b = nbits - 1; b >= 0 && !exact; --b) {
    const int thr = prefix + ((1 << b) - 1);
    const int c0 = row_count<S, W>([&](int i) { return rand[i] <= thr; }, buf, half, lane, warp);
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
    const int need =
        k - row_count<S, W>([&](int i) { return rand[i] < prefix; }, buf, half, lane, warp);
    int before = 0;  // ties in the warps below, then in the chunks below
    if constexpr (W > 1) {
      int all;
      before = team_add<W>(warp_count<S>([&](int i) { return rand[i] == prefix; }), buf, half,
                           lane, warp, all);
    }
    const unsigned upto_lane = 0xffffffffu >> (31 - lane);
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
    if (first + 32 * i < t_len) out[base + 32 * i] = sel[i];
  }
}

// Rows longer than kMaxT: W warps own the row, warp w the `slots` x 32
// consecutive slots from 32 x slots x w on, which it walks 32 at a time on
// every pass; the same search and tie fill as fake_select_kernel.
template <int W>
__global__ void __launch_bounds__(32 * W) fake_select_loop_kernel(
    const uint32_t* __restrict__ bits, const int32_t* __restrict__ n_valid,
    const int32_t* __restrict__ k_sel, bool* __restrict__ out, int t_len, int slots,
    int pos_bits) {
  __shared__ int buf[2][W];  // each warp's count of a pass
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = blockIdx.x;
  int half = 0;
  const int nv = n_valid[row];
  const int k = k_sel[row];
  const int nbits = kKeyBits - pos_bits;
  const int shift = 32 - kKeyBits + pos_bits;
  const uint32_t* row_bits = bits + row * t_len;
  bool* row_out = out + row * t_len;
  const int first = 32 * slots * warp;                      // the warp's first slot
  const int stop = min(first + 32 * slots, t_len);          // ... and its end in the row
  const int keyed = min(stop, nv);                          // ... and the end of its keys
  // the random part of slot pos; INT_MAX past n_valid, above every random part
  auto key = [&](int pos) {
    return pos < keyed ? static_cast<int>(row_bits[pos] >> shift) : INT_MAX;
  };
  // the warp's count of `pred` over its keyed slots (a slot past them never
  // counts: every threshold is below INT_MAX)
  auto walk_count = [&](auto pred) {
    int n = 0;
    for (int base = first; base < keyed; base += 32) {
      n += __popc(__ballot_sync(0xffffffffu, pred(key(base + lane))));
    }
    return n;
  };

  int prefix = 0;
  bool exact = k == 0;
  if (exact) prefix = -1;
  for (int b = nbits - 1; b >= 0 && !exact; --b) {
    const int thr = prefix + ((1 << b) - 1);
    int c0;
    team_add<W>(walk_count([&](int r) { return r <= thr; }), buf, half, lane, warp, c0);
    if (c0 == k) {
      prefix = thr;
      exact = true;
    } else if (c0 < k) {
      prefix = thr + 1;
    }
  }

  if (exact) {
    for (int pos = first + lane; pos < stop; pos += 32) row_out[pos] = key(pos) <= prefix;
    return;
  }
  // all below the k-th key, and its ties in position order
  int below;
  team_add<W>(walk_count([&](int r) { return r < prefix; }), buf, half, lane, warp, below);
  const int need = k - below;
  int all;
  int before = team_add<W>(walk_count([&](int r) { return r == prefix; }), buf, half, lane,
                           warp, all);
  const unsigned upto_lane = 0xffffffffu >> (31 - lane);
  for (int base = first; base < stop; base += 32) {
    const int pos = base + lane;
    const int r = key(pos);
    const bool eq = r == prefix;
    const unsigned ties = __ballot_sync(0xffffffffu, eq);
    if (pos < stop) row_out[pos] = r < prefix || (eq && before + __popc(ties & upto_lane) <= need);
    before += __popc(ties);
  }
}

// The layout for rows of t_len slots: warps a row, slots a lane, rows a block.
inline void layout(int t_len, int& warps, int& slots, int& block_rows) {
  if (t_len > kMaxT) {
    warps = kLoopWarps;
    slots = (t_len + 32 * warps - 1) / (32 * warps);
    block_rows = 1;
    return;
  }
  warps = 1;
  while (warps < kMaxWarps && t_len > 32 * warps * kLaneSlots) warps *= 2;
  slots = (t_len + 32 * warps - 1) / (32 * warps);
  block_rows = warps == 1 ? kWarpRows : 1;
}

template <int S, int W, int ROWS, class... Args>
inline bool launch(int rows, cudaStream_t s, Args... args) {
  fake_select_kernel<S, W, ROWS><<<(rows + ROWS - 1) / ROWS, 32 * W * ROWS, 0, s>>>(args...);
  return true;
}

// Launches the instance that holds `slots` slots a lane: every count from 1
// to sizeof...(S) has one.
template <int W, int ROWS, int... S, class... Args>
inline void launch_slots(int slots, std::integer_sequence<int, S...>, int rows, cudaStream_t s,
                         Args... args) {
  (void)((slots == S + 1 && launch<S + 1, W, ROWS>(rows, s, args...)) || ...);
}

static_assert(kMaxWarps == 4, "dicl_fake_select names every team size layout can choose");

}  // namespace

// bits: (rows, t_len) uint32 bit patterns; n_valid, k: (rows,) int32;
// out: (rows, t_len) bool. `warps`, `slots` and `block_rows` are the
// wrapper's layout (`select_layout` in ops/cuda_select.py) and must be this
// file's for t_len. Launches on `stream`; returns cudaGetLastError().
extern "C" int dicl_fake_select(const void* bits, const void* n_valid, const void* k, void* out,
                                int rows, int t_len, int warps, int slots, int block_rows,
                                int pos_bits, void* stream) {
  if (t_len < 1 || rows < 1) return cudaErrorInvalidValue;
  int want_warps, want_slots, want_rows;
  layout(t_len, want_warps, want_slots, want_rows);
  if (warps != want_warps || slots != want_slots || block_rows != want_rows) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const uint32_t*>(bits);
  const auto* nv = static_cast<const int32_t*>(n_valid);
  const auto* kp = static_cast<const int32_t*>(k);
  auto* o = static_cast<bool*>(out);
  if (t_len > kMaxT) {
    fake_select_loop_kernel<kLoopWarps><<<rows, 32 * kLoopWarps, 0, s>>>(b, nv, kp, o, t_len,
                                                                       slots, pos_bits);
  } else if (warps == 1) {
    launch_slots<1, kWarpRows>(slots, std::make_integer_sequence<int, kLaneSlots>{}, rows, s, b,
                               nv, kp, o, rows, t_len, pos_bits);
  } else if (warps == 2) {
    launch_slots<2, 1>(slots, std::make_integer_sequence<int, kLaneSlots>{}, rows, s, b, nv, kp,
                       o, rows, t_len, pos_bits);
  } else {
    launch_slots<4, 1>(slots, std::make_integer_sequence<int, kTopSlots>{}, rows, s, b, nv, kp,
                       o, rows, t_len, pos_bits);
  }
  return static_cast<int>(cudaGetLastError());
}
