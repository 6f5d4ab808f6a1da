// mTAN's GRU recurrences for Hopper (sm_90a): the whole sequence of one
// single-layer GRU, every direction, forward and backward, from three C
// entries.
//
// Replaces no Pallas kernel. The JAX package has no GRU; mTAN's encoder,
// decoder and classifier (github.com/reml-lab/mTAN `models.py`) call
// `nn.GRU`, which is cuDNN on the card, and cuDNN runs every step of every
// direction as its own launches (a product, then an elementwise kernel; in
// the backward a product and two). These kernels walk all the steps in one
// launch each. The input side stays outside: the wrapper
// (ops/cuda_gru.py) forms x W_ih^T + b_ih for every step as one product and
// takes dx, dW_ih, dW_hh and the biases' gradients from large products of
// what the walks write.
//
// The math is PyTorch's nn.GRU, gate order [r|z|n], h0 = 0:
//   r = sigmoid(xg_r + (h W_hr^T + b_hr))    z likewise
//   n = tanh(xg_n + r * (h W_hn^T + b_hn))   h' = n + z * (h - n)
// with xg = x W_ih^T + b_ih. Direction 1 walks the steps in reverse; the
// outputs are time-aligned. Float32, accurate expf/tanhf (no fast math), no
// tensor cores: the port keeps TF32 off, and wgmma has no float32 mode.
//
//   gru_fwd_kernel  the forward walk. Writes h at every step and what the
//                   backward takes: r, z, n, h W_hn^T + b_hn and the step's
//                   h_prev ("saved", five values a unit; none in eval).
//   gru_bwd_kernel  the reverse walk. Carries dh across the steps and writes
//                   each step's pre-activation gradients twice: the input
//                   side's [dr|dz|dn] (dxg) and the recurrent side's
//                   [dr|dz|dn * r] (dgh), from which the wrapper takes
//                   dW_hh = dgh^T h_prev and db_hh with large products.
//
// What bounds them on the H100: float32 operations by the count, 25.8 GFLOP
// of h W_hh^T a walk at the encoder's shape (B = 256, 128 steps, H = 256,
// two directions), 0.39 ms at 67 TFLOP/s; in fact the serial chain of the
// 128 steps: each needs all of a direction's W_hh (768 KB at H = 256)
// against a block's 227 KB of shared memory, and ends in an exchange. So W_hh lives in registers, split by hidden unit over the blocks
// of a thread-block cluster, and what a step makes goes to the blocks that
// need it through distributed shared memory, with one cluster barrier a
// step. At H <= 64 one block of 64 units holds all of W_hh (the "cluster" is
// that block); above, up to H = 256, a cluster of ceil(H / 32) blocks of 32
// units (8 blocks at H = 256). A block has 512 threads either way. The
// cluster walks `rows` batch rows (a multiple of 8 up to 48, as shared
// memory allows; dicl_gru_rows picks them from how many clusters the card
// holds at once) in chunks of 8.
//
// Forward: a thread is one (unit u, split s of the k sum), kSplits splits
// (16 for the clusters, 8 for the one block): it keeps W_hh[g H + u][k] for
// its unit's three gates at k = s, s + kSplits, ... in registers (48 at H =
// 256). For a chunk it sums its split's share for 8 rows, one fmaf chain from
// 0 in increasing k: two float4 reads of h (laid out (k, row), rows padded to
// rows + 4 floats so that the splits' reads spread over the banks) feed 24
// FMAs. Warp shuffles then add the splits' partials (xor kSplits / 2, ...,
// 1), each of the first three halving the rows a lane keeps, so that one lane
// ends with the whole sums of a row; it applies the gates and sends the new
// h to every block of the cluster. h is double-buffered (a step reads one
// buffer, writes the other). The step's xg is copied in (cp.async) during
// the step before, and its outputs leave from a staging buffer during the
// step after, coalesced, so no load or store latency sits in a step.
//
// Backward: partial sums, which send a third of what broadcasting the
// gradients would. A block forms its own units' pre-activation gradients
// (one thread a (unit, row): dh is the carried dh * z, plus the partials
// its units received, plus the output's cotangent) into shared memory; then
// thread (k, part) sums dgh_j W_hh[j][k] over its part of the block's 3 * 32
// gate rows j (48 registers of W_hh; the gradients read as broadcasts) for
// every row; part 0 adds the other parts' sums in part order and sends the
// block's partial to the block that owns unit k, which adds its blocks'
// partials in rank order. Inputs are copied in a step ahead and outputs
// staged, as forward.
//
// Every sum has a fixed order, set by the row's position mod 8 and never by
// the tiling or the schedule: two runs give the same bits, whatever `rows`
// is. No float atomics.

#include <cooperative_groups.h>

#include <cstdint>

#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = 8;                      // rows a chunk
constexpr int kMaxRows = 48;                   // batch rows a cluster walks, as smem allows
constexpr int kSmallHidden = 64;               // up to this H, one block of 64 units
constexpr int kClusterUnits = 32;              // units a block of a cluster
constexpr int kMaxHidden = 256;                // the widest GRU the kernels take
constexpr int kSaved = 5;                      // r, z, n, h W_hn^T + b_hn, h_prev
constexpr int kStaged = 6;                     // values a (unit, row) stages in or out
constexpr int kSmemLimit = 232448;             // the most shared memory a Hopper block can have

// The two shapes of block: units, splits of the forward's k sum, the k range
// the registers cover, and the parts of the backward's sum over the block's
// gate rows (thread t: k = t mod kKWidth, part = t / kKWidth).
template <bool kLarge>
struct Shape {
  static constexpr int kUnits = kLarge ? kClusterUnits : kSmallHidden;
  static constexpr int kSplits = kThreads / kUnits;  // 16 or 8
  static constexpr int kKWidth = kLarge ? kMaxHidden : kSmallHidden;
  static constexpr int kKps = kKWidth / kSplits;  // 16 or 8: k a split
  static constexpr int kParts = kThreads / kKWidth;  // 2 or 8
  static constexpr int kJpp = 3 * kUnits / kParts;  // 48 or 24: gate rows a part
  static constexpr int kLanesPerRow = kSplits / kChunk;  // lanes that end with a row
};

__host__ __device__ constexpr int row_stride(int rows) { return rows + 4; }

// shared memory, in floats
__host__ __device__ constexpr int fwd_smem_floats(bool large, int rows) {
  const int units = large ? kClusterUnits : kSmallHidden;
  const int k_width = large ? kMaxHidden : kSmallHidden;
  // two h buffers (k, row); two xg stages (row, gate, unit); two output
  // stages (row, value, unit)
  return 2 * k_width * row_stride(rows) + 2 * rows * 3 * units + 2 * rows * kStaged * units;
}
__host__ __device__ constexpr int bwd_smem_floats(bool large, int rows, int cluster) {
  const int units = large ? kClusterUnits : kSmallHidden;
  const int k_width = large ? kMaxHidden : kSmallHidden;
  const int parts = kThreads / k_width;
  // two receive buffers (block, row, unit); the input and output stages;
  // the block's gradients (gate row, row); the carried dh (row, unit); two
  // buffers of the parts' partials of a chunk (part, row, k)
  return 2 * cluster * rows * units + 2 * rows * kStaged * units + 3 * units * rows +
         rows * units + 2 * (parts - 1) * kChunk * k_width;
}

// 1 / (1 + e^-x), the reciprocal correctly rounded (the bits of the division)
__device__ __forceinline__ float sigmoid_acc(float x) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ void copy_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void copy_async8(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void copy_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;\n" ::); }

// The step's barrier, split: a cluster arrives (release) once its exchange
// is written and waits (acquire) after the work that needs none of it; the
// one block of the small shape takes a plain block barrier at the wait.
template <bool kLarge>
__device__ __forceinline__ void step_arrive() {
  if constexpr (kLarge) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
template <bool kLarge>
__device__ __forceinline__ void step_wait() {
  if constexpr (kLarge)
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  else
    __syncthreads();
}

// For each staged value of the block's tile that lies in the batch and the
// hidden units, f(width, i, row, plane, unit), with kWidth units moved at
// once: a stage holds (row, plane, unit) at i = (row * kPlanes + plane) *
// kUnits + unit. The clusters move four units at once (H a multiple of 4),
// the one block two where H is even; the tensors start on 16 bytes.
template <int N>
struct Width {
  static constexpr int value = N;
};
template <int kWidth, int kUnits, int kPlanes, typename F>
__device__ __forceinline__ void each_staged(int rows, int units_valid, int rows_valid, F f) {
  constexpr int kPerRow = kUnits / kWidth;
  for (int i = threadIdx.x; i < rows * kPlanes * kPerRow; i += kThreads) {
    const int l = i % kPerRow * kWidth, plane = i / kPerRow % kPlanes, row = i / (kPlanes * kPerRow);
    if (l < units_valid && row < rows_valid)
      f(Width<kWidth>{}, (row * kPlanes + plane) * kUnits + l, row, plane, l);
  }
}
template <bool kLarge, int kPlanes, typename F>
__device__ __forceinline__ void each_move(int rows, int hidden, int units_valid, int rows_valid,
                                          F f) {
  constexpr int kUnits = kLarge ? kClusterUnits : kSmallHidden;
  if constexpr (kLarge)
    each_staged<4, kUnits, kPlanes>(rows, units_valid, rows_valid, f);
  else if (hidden % 2 == 0)
    each_staged<2, kUnits, kPlanes>(rows, units_valid, rows_valid, f);
  else
    each_staged<1, kUnits, kPlanes>(rows, units_valid, rows_valid, f);
}
template <int kWidth>
__device__ __forceinline__ void fetch_one(float* smem, const float* gmem) {
  if constexpr (kWidth == 4)
    copy_async16(smem, gmem);
  else if constexpr (kWidth == 2)
    copy_async8(smem, gmem);
  else
    copy_async4(smem, gmem);
}
template <int kWidth>
__device__ __forceinline__ void store_one(float* gmem, const float* smem) {
  if constexpr (kWidth == 4)
    *reinterpret_cast<float4*>(gmem) = *reinterpret_cast<const float4*>(smem);
  else if constexpr (kWidth == 2)
    *reinterpret_cast<float2*>(gmem) = *reinterpret_cast<const float2*>(smem);
  else
    *gmem = *smem;
}

// a[r][g]: this lane's partial sums of the chunk's 8 rows (G values a row),
// one lane for each of kSplits splits of a unit's sum. Three rounds (xor
// kSplits / 2, / 4, / 8) each keep the half of the rows that the split's bit
// selects and add the partner's copy of it; the rounds left (xor kSplits /
// 16, ...) add the partner's whole sums. v then holds the sums of row
// split / (kSplits / 8), which the lanes of a row agree on bit for bit.
template <int kSplits, int G>
__device__ __forceinline__ void reduce_scatter(const float (&a)[kChunk][G], int split,
                                               float (&v)[G]) {
  constexpr unsigned kAll = 0xffffffffu;
  float b[4][G];
  const bool up4 = (split & (kSplits / 2)) != 0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float give = up4 ? a[r][g] : a[r + 4][g];
      const float keep = up4 ? a[r + 4][g] : a[r][g];
      b[r][g] = __fadd_rn(keep, __shfl_xor_sync(kAll, give, kSplits / 2));
    }
  float c[2][G];
  const bool up2 = (split & (kSplits / 4)) != 0;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float give = up2 ? b[r][g] : b[r + 2][g];
      const float keep = up2 ? b[r + 2][g] : b[r][g];
      c[r][g] = __fadd_rn(keep, __shfl_xor_sync(kAll, give, kSplits / 4));
    }
  const bool up1 = (split & (kSplits / 8)) != 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float give = up1 ? c[0][g] : c[1][g];
    const float keep = up1 ? c[1][g] : c[0][g];
    v[g] = __fadd_rn(keep, __shfl_xor_sync(kAll, give, kSplits / 8));
  }
#pragma unroll
  for (int m = kSplits / 16; m >= 1; m /= 2)
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = __fadd_rn(v[g], __shfl_xor_sync(kAll, v[g], m));
}

// The 8 values of a chunk's rows at p (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&v)[kChunk]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// Where a cluster's block sits: its direction, its first batch row, its
// first unit, and the step's (b, t, d) slot of a row.
struct Place {
  int d, b0, u0, t_len, dirs;
  __device__ int64_t slot(int s, int row) const {
    const int t = d == 0 ? s : t_len - 1 - s;
    return (static_cast<int64_t>(b0 + row) * t_len + t) * dirs + d;
  }
};

// ------------------------------------------------------------------ forward
// grid (cluster * tiles, dirs), clusters of `cluster` blocks along x,
// kThreads threads. xg (B, T, D, 3H); w_hh (D, 3H, H); b_hh (D, 3H); out (B,
// T, D, H); saved (B, T, D, kSaved, H) or null.
//
// Step s: the outputs of step s - 1 leave their stage and the xg of step
// s + 1 starts into its stage while the chunks' sums and gates run (h to
// every block, the outputs to stage s mod 2); each thread waits for its
// copies; the step's barrier.
template <bool kLarge>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_kernel(const float* __restrict__ xg, const float* __restrict__ w_hh,
               const float* __restrict__ b_hh, float* __restrict__ out,
               float* __restrict__ saved, int batch, int t_len, int dirs, int hidden, int rows) {
  using S = Shape<kLarge>;
  constexpr int kUnits = S::kUnits, kSplits = S::kSplits, kKps = S::kKps;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Place at{static_cast<int>(blockIdx.y), static_cast<int>(blockIdx.x) / n_blocks * rows,
                 rank * kUnits, t_len, dirs};
  const int stride = row_stride(rows);
  const int g3 = 3 * hidden;
  const int xs_size = rows * 3 * kUnits, os_size = rows * kStaged * kUnits;
  float* const hbuf = smem;                              // [2][kKWidth][stride]
  float* const xs = hbuf + 2 * S::kKWidth * stride;      // [2][rows][3][kUnits]
  float* const os = xs + 2 * xs_size;                    // [2][rows][kStaged][kUnits]
  const int units_valid = hidden - at.u0, rows_valid = batch - at.b0;

  const int lane = threadIdx.x & 31;
  const int split = lane % kSplits;
  const int lu = (threadIdx.x >> 5) * (32 / kSplits) + lane / kSplits;
  const int u = at.u0 + lu;
  const bool valid = u < hidden;
  const int my_row = split / S::kLanesPerRow;         // the row this lane ends with
  const bool writer = split % S::kLanesPerRow == 0;   // one lane a (unit, row) writes

  for (int i = threadIdx.x; i < 2 * S::kKWidth * stride + 2 * xs_size; i += kThreads)
    smem[i] = 0.0f;
  __syncthreads();

  auto fetch_x = [&](int s) {
    float* dst = xs + (s & 1) * xs_size;
    each_move<kLarge, 3>(rows, hidden, units_valid, rows_valid,
                         [&](auto width, int i, int row, int g, int l) {
      fetch_one<decltype(width)::value>(dst + i,
                                        xg + at.slot(s, row) * g3 + g * hidden + at.u0 + l);
    });
  };
  auto store = [&](int s) {
    const float* src = os + (s & 1) * os_size;
    each_move<kLarge, kStaged>(rows, hidden, units_valid, rows_valid,
                               [&](auto width, int i, int row, int q, int l) {
      constexpr int kWidth = decltype(width)::value;
      const int64_t slot = at.slot(s, row);
      if (q == 0)
        store_one<kWidth>(out + slot * hidden + at.u0 + l, src + i);
      else if (saved != nullptr)
        store_one<kWidth>(saved + (slot * kSaved + q - 1) * hidden + at.u0 + l, src + i);
    });
  };

  float w[3][kKps];
  const float* wd = w_hh + static_cast<int64_t>(at.d) * g3 * hidden;
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < kKps; ++i) {
      const int k = split + kSplits * i;
      w[g][i] = (valid && k < hidden) ? wd[static_cast<int64_t>(g * hidden + u) * hidden + k]
                                      : 0.0f;
    }
  float bias[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) bias[g] = valid ? b_hh[at.d * g3 + g * hidden + u] : 0.0f;

  fetch_x(0);
  copy_async_wait();
  cluster.sync();  // every block's buffers zeroed, the first xg in, before any exchange

  const int chunks = rows / kChunk;
  for (int s = 0; s < t_len; ++s) {
    if (s > 0) store(s - 1);
    if (s + 1 < t_len) fetch_x(s + 1);
    const float* hcur = hbuf + (s & 1) * S::kKWidth * stride;
    float* hnext = hbuf + ((s & 1) ^ 1) * S::kKWidth * stride;
    const float* xc = xs + (s & 1) * xs_size;
    float* oc = os + (s & 1) * os_size;
    for (int c = 0; c < chunks; ++c) {
      float acc[kChunk][3];
#pragma unroll
      for (int r = 0; r < kChunk; ++r)
#pragma unroll
        for (int g = 0; g < 3; ++g) acc[r][g] = 0.0f;
      const float* hc = hcur + c * kChunk;
#pragma unroll
      for (int i = 0; i < kKps; ++i) {
        float hv[kChunk];
        load8(hc + (split + kSplits * i) * stride, hv);
#pragma unroll
        for (int r = 0; r < kChunk; ++r)
#pragma unroll
          for (int g = 0; g < 3; ++g) acc[r][g] = fmaf(hv[r], w[g][i], acc[r][g]);
      }
      float gh[3];
      reduce_scatter<kSplits, 3>(acc, split, gh);
      // every lane of the row applies the gates (the same bits); 4 rows'
      // h gather on the lane of the first, which sends them as one float4
      const int row = c * kChunk + my_row;
      const float* x = xc + row * 3 * kUnits + lu;
      const float h_prev = hcur[u * stride + row];
      const float hr = __fadd_rn(gh[0], bias[0]);
      const float hz = __fadd_rn(gh[1], bias[1]);
      const float hn = __fadd_rn(gh[2], bias[2]);
      const float r = sigmoid_acc(__fadd_rn(x[0], hr));
      const float z = sigmoid_acc(__fadd_rn(x[kUnits], hz));
      const float n = tanhf(__fadd_rn(x[2 * kUnits], __fmul_rn(r, hn)));
      const float h = __fadd_rn(n, __fmul_rn(z, __fsub_rn(h_prev, n)));
      constexpr int kNext = S::kLanesPerRow;  // lane distance of consecutive rows
      const float4 h4 = make_float4(h, __shfl_down_sync(0xffffffffu, h, kNext),
                                    __shfl_down_sync(0xffffffffu, h, 2 * kNext),
                                    __shfl_down_sync(0xffffffffu, h, 3 * kNext));
      if (valid && writer && my_row % 4 == 0) {
        const int at_h = u * stride + row;
        if constexpr (kLarge) {
          for (int q = 0; q < n_blocks; ++q)
            *reinterpret_cast<float4*>(cluster.map_shared_rank(hnext, q) + at_h) = h4;
        } else {
          *reinterpret_cast<float4*>(hnext + at_h) = h4;
        }
      }
      if (valid && writer) {
        float* o = oc + row * kStaged * kUnits + lu;
        o[0] = h;
        o[kUnits] = r;
        o[2 * kUnits] = z;
        o[3 * kUnits] = n;
        o[4 * kUnits] = hn;
        o[5 * kUnits] = h_prev;
      }
    }
    copy_async_wait();
    step_arrive<kLarge>();
    step_wait<kLarge>();
  }
  store(t_len - 1);
}

// ----------------------------------------------------------------- backward
// grid and threads as the forward. dout (B, T, D, H) the outputs'
// cotangent; saved the forward's; w_hh (D, 3H, H) -> dxg, dgh (B, T, D, 3H).
//
// Step s: the gates' gradients of the block's (unit, row)s (to the output
// stage and to `grad`); block barrier; the outputs leave their stage and
// the inputs of step s - 1 start into theirs while the partials go to the
// units' blocks; the step's barrier.
template <bool kLarge>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_kernel(const float* __restrict__ dout, const float* __restrict__ saved,
               const float* __restrict__ w_hh, float* __restrict__ dxg,
               float* __restrict__ dgh, int batch, int t_len, int dirs, int hidden, int rows) {
  using S = Shape<kLarge>;
  constexpr int kUnits = S::kUnits, kJpp = S::kJpp, kParts = S::kParts;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Place at{static_cast<int>(blockIdx.y), static_cast<int>(blockIdx.x) / n_blocks * rows,
                 rank * kUnits, t_len, dirs};
  const int g3 = 3 * hidden;
  const int recv_size = n_blocks * rows * kUnits;
  const int stage_size = rows * kStaged * kUnits;
  float* const recv = smem;                          // [2][n_blocks][rows][kUnits]
  float* const in = recv + 2 * recv_size;            // [rows][kStaged][kUnits]: g, r, z, n, hn, h_prev
  float* const os = in + stage_size;                 // [rows][kStaged][kUnits]: dxg, dgh
  float* const grad = os + stage_size;               // [3 kUnits][rows]: the block's dgh
  float* const carry = grad + 3 * kUnits * rows;     // [rows][kUnits]: dh * z
  float* const parts = carry + rows * kUnits;        // [2][kParts - 1][kChunk][kKWidth]
  constexpr int kPartsSize = (kParts - 1) * kChunk * S::kKWidth;
  const int units_valid = hidden - at.u0, rows_valid = batch - at.b0;

  for (int i = threadIdx.x; i < 2 * recv_size + 2 * stage_size + 4 * kUnits * rows; i += kThreads)
    smem[i] = 0.0f;
  __syncthreads();

  auto fetch = [&](int s) {
    each_move<kLarge, kStaged>(rows, hidden, units_valid, rows_valid,
                               [&](auto width, int i, int row, int q, int l) {
      const int64_t slot = at.slot(s, row);
      fetch_one<decltype(width)::value>(
          in + i, q == 0 ? dout + slot * hidden + at.u0 + l
                         : saved + (slot * kSaved + q - 1) * hidden + at.u0 + l);
    });
  };
  auto store = [&](int s) {
    each_move<kLarge, kStaged>(rows, hidden, units_valid, rows_valid,
                               [&](auto width, int i, int row, int q, int l) {
      const int64_t at_g = at.slot(s, row) * g3 + q % 3 * hidden + at.u0 + l;
      store_one<decltype(width)::value>((q < 3 ? dxg : dgh) + at_g, os + i);
    });
  };

  // thread (k, part): W_hh[j][k] for the part's gate rows j of the block
  const int k = threadIdx.x % S::kKWidth;
  const int part = threadIdx.x / S::kKWidth;
  const bool k_valid = k < hidden;
  float w[kJpp];
  const float* wd = w_hh + static_cast<int64_t>(at.d) * g3 * hidden;
#pragma unroll
  for (int i = 0; i < kJpp; ++i) {
    const int jl = part * kJpp + i;  // the block's gate row: gate jl / kUnits, unit jl % kUnits
    const int uj = at.u0 + jl % kUnits;
    w[i] = (k_valid && uj < hidden)
               ? wd[static_cast<int64_t>(jl / kUnits * hidden + uj) * hidden + k]
               : 0.0f;
  }
  const int owner = k / kUnits;  // the block of the cluster that holds unit k

  fetch(t_len - 1);
  copy_async_wait();
  cluster.sync();

  const int chunks = rows / kChunk;
  for (int s = t_len - 1; s >= 0; --s) {
    const int cur = s & 1;
    // the step's gates' gradients, a (unit, row) a thread
    const float* got = recv + (cur ^ 1) * recv_size;  // what step s + 1 sent
    for (int p = threadIdx.x; p < rows * kUnits; p += kThreads) {
      const int l = p % kUnits, row = p / kUnits;
      float rec = 0.0f;
      if (s + 1 < t_len) {
        rec = got[row * kUnits + l];
        for (int src = 1; src < n_blocks; ++src)
          rec = __fadd_rn(rec, got[(src * rows + row) * kUnits + l]);
      }
      const float* e = in + row * kStaged * kUnits + l;
      const float g = e[0], r = e[kUnits], z = e[2 * kUnits], n = e[3 * kUnits],
                  hn = e[4 * kUnits], h_prev = e[5 * kUnits];
      const float dh = __fadd_rn(__fadd_rn(carry[p], rec), g);
      const float dn = __fmul_rn(dh, __fsub_rn(1.0f, z));
      const float dz = __fmul_rn(dh, __fsub_rn(h_prev, n));
      const float dn_pre = __fmul_rn(dn, __fsub_rn(1.0f, __fmul_rn(n, n)));
      const float dz_pre = __fmul_rn(dz, __fmul_rn(z, __fsub_rn(1.0f, z)));
      const float dr_pre = __fmul_rn(__fmul_rn(dn_pre, hn), __fmul_rn(r, __fsub_rn(1.0f, r)));
      const float dhn = __fmul_rn(dn_pre, r);
      carry[p] = __fmul_rn(dh, z);
      grad[l * rows + row] = dr_pre;
      grad[(kUnits + l) * rows + row] = dz_pre;
      grad[(2 * kUnits + l) * rows + row] = dhn;
      float* o = os + row * kStaged * kUnits + l;
      o[0] = dr_pre;
      o[kUnits] = dz_pre;
      o[2 * kUnits] = dn_pre;
      o[3 * kUnits] = dr_pre;
      o[4 * kUnits] = dz_pre;
      o[5 * kUnits] = dhn;
    }
    __syncthreads();  // the block's gradients and outputs staged; the inputs read
    store(s);
    if (s > 0) {
      fetch(s - 1);
      // dh_prev[k] over the block's gate rows, part by part, the parts
      // added in order by part 0, which sends the sum to unit k's block
      float* mine = recv + cur * recv_size;
      float* dst = kLarge ? cluster.map_shared_rank(mine, owner) : mine;
      dst += static_cast<int64_t>(rank) * rows * kUnits + k % kUnits;
      for (int c = 0; c < chunks; ++c) {
        float acc[kChunk];
#pragma unroll
        for (int r = 0; r < kChunk; ++r) acc[r] = 0.0f;
        const float* gc = grad + part * kJpp * rows + c * kChunk;
#pragma unroll
        for (int i = 0; i < kJpp; ++i) {
          float pv[kChunk];
          load8(gc + i * rows, pv);
#pragma unroll
          for (int r = 0; r < kChunk; ++r) acc[r] = fmaf(pv[r], w[i], acc[r]);
        }
        float* pc = parts + (c & 1) * kPartsSize;  // [part - 1][row][k]
        if (part > 0) {
#pragma unroll
          for (int r = 0; r < kChunk; ++r) pc[((part - 1) * kChunk + r) * S::kKWidth + k] = acc[r];
        }
        __syncthreads();
        if (part == 0 && k_valid) {
#pragma unroll
          for (int r = 0; r < kChunk; ++r) {
            float sum = acc[r];
            for (int q = 1; q < kParts; ++q)
              sum = __fadd_rn(sum, pc[((q - 1) * kChunk + r) * S::kKWidth + k]);
            dst[(c * kChunk + r) * kUnits] = sum;
          }
        }
      }
    }
    copy_async_wait();
    step_arrive<kLarge>();
    step_wait<kLarge>();
  }
}

// ---------------------------------------------------------------- launches
// cudaFuncSetAttribute once for each kernel and device, at the most shared
// memory it can take (a launch made while a CUDA graph is captured then sets
// no attribute: the warm-up's launches have set it).
cudaError_t set_smem_once(const void* kernel, int bytes) {
  constexpr int kSlots = 16;
  static const void* done[kSlots];
  static int done_device[kSlots];
  static int n_done = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n_done; ++i)
    if (done[i] == kernel && done_device[i] == device) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && n_done < kSlots) {
    done[n_done] = kernel;
    done_device[n_done] = device;
    ++n_done;
  }
  return err;
}

bool is_large(int hidden) { return hidden > kSmallHidden; }
int cluster_of(int hidden) {
  return is_large(hidden) ? (hidden + kClusterUnits - 1) / kClusterUnits : 1;
}

int smem_bytes(bool backward, int hidden, int rows) {
  const bool large = is_large(hidden);
  return 4 * (backward ? bwd_smem_floats(large, rows, cluster_of(hidden))
                       : fwd_smem_floats(large, rows));
}

const void* kernel_of(bool backward, bool large) {
  if (backward)
    return large ? reinterpret_cast<const void*>(gru_bwd_kernel<true>)
                 : reinterpret_cast<const void*>(gru_bwd_kernel<false>);
  return large ? reinterpret_cast<const void*>(gru_fwd_kernel<true>)
               : reinterpret_cast<const void*>(gru_fwd_kernel<false>);
}

void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int hidden, int batch,
                   int dirs, int rows, int smem, cudaStream_t stream) {
  const int tiles = (batch + rows - 1) / rows;
  const int cluster = cluster_of(hidden);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster * tiles, dirs, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

bool args_ok(bool backward, int batch, int t_len, int dirs, int hidden, int cluster, int units,
             int rows) {
  if (batch < 1 || t_len < 1 || dirs < 1 || dirs > 2 || hidden < 1 || hidden > kMaxHidden)
    return false;
  const int want_units = is_large(hidden) ? kClusterUnits : kSmallHidden;
  if (is_large(hidden) && hidden % 4 != 0) return false;
  return cluster == cluster_of(hidden) && units == want_units && rows >= kChunk &&
         rows <= kMaxRows && rows % kChunk == 0 && smem_bytes(backward, hidden, rows) <= kSmemLimit;
}

// the most shared memory any launch of a kernel takes: its widest cluster,
// the most rows that fit
int smem_limit(bool backward, bool large) {
  int most = 0;
  for (int rows = kChunk; rows <= kMaxRows; rows += kChunk) {
    const int bytes = smem_bytes(backward, large ? kMaxHidden : kSmallHidden, rows);
    if (bytes <= kSmemLimit && bytes > most) most = bytes;
  }
  return most;
}

}  // namespace

// The batch rows a cluster walks (a multiple of 8 up to 48) in the forward
// (backward = 0) or backward walk of a GRU of `hidden` units, `dirs`
// directions and `batch` rows: the fewest waves of clusters times the
// steps' chunks (one chunk of 8 rows costing 4, a step's fixed work 1), of
// the rows whose shared memory fits. Writes it and the clusters the card
// holds at once at it to rows_out[0] and rows_out[1]. The sums do not
// depend on it. Returns the first CUDA error.
extern "C" int dicl_gru_rows(void* rows_out, int hidden, int batch, int dirs, int backward,
                             void* stream) {
  if (batch < 1 || dirs < 1 || dirs > 2 || hidden < 1 || hidden > kMaxHidden)
    return cudaErrorInvalidValue;
  const bool bwd = backward != 0;
  const void* kernel = kernel_of(bwd, is_large(hidden));
  cudaError_t err = set_smem_once(kernel, smem_limit(bwd, is_large(hidden)));
  if (err != cudaSuccess) return err;
  int chosen = 0, chosen_fit = 0;
  int64_t best = 0;
  for (int rows = kChunk; rows <= kMaxRows; rows += kChunk) {
    const int smem = smem_bytes(bwd, hidden, rows);
    if (smem > kSmemLimit) continue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    launch_config(&cfg, &attr, hidden, batch, dirs, rows, smem, static_cast<cudaStream_t>(stream));
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (fit < 1) continue;
    const int64_t clusters = static_cast<int64_t>((batch + rows - 1) / rows) * dirs;
    const int64_t cost = (clusters + fit - 1) / fit * (4 * (rows / kChunk) + 1);
    if (chosen == 0 || cost < best) {
      chosen = rows;
      chosen_fit = fit;
      best = cost;
    }
  }
  if (chosen == 0) return cudaErrorInvalidConfiguration;
  static_cast<int*>(rows_out)[0] = chosen;
  static_cast<int*>(rows_out)[1] = chosen_fit;
  return cudaSuccess;
}

// xg (batch, t_len, dirs, 3 hidden), w_hh (dirs, 3 hidden, hidden), b_hh
// (dirs, 3 hidden), all float32 and contiguous -> out (batch, t_len, dirs,
// hidden) and, unless null, saved (batch, t_len, dirs, 5, hidden). cluster
// and units: ops/cuda_gru.py's geometry, checked against this file's; rows:
// dicl_gru_rows's. Returns the first CUDA error.
extern "C" int dicl_gru_forward(const void* xg, const void* w_hh, const void* b_hh, void* out,
                                void* saved, int batch, int t_len, int dirs, int hidden,
                                int cluster, int units, int rows, void* stream) {
  if (!args_ok(false, batch, t_len, dirs, hidden, cluster, units, rows))
    return cudaErrorInvalidValue;
  const bool large = is_large(hidden);
  cudaError_t err = set_smem_once(kernel_of(false, large), smem_limit(false, large));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, hidden, batch, dirs, rows, smem_bytes(false, hidden, rows),
                static_cast<cudaStream_t>(stream));
  const auto* x = static_cast<const float*>(xg);
  const auto* w = static_cast<const float*>(w_hh);
  const auto* b = static_cast<const float*>(b_hh);
  auto* o = static_cast<float*>(out);
  auto* sv = static_cast<float*>(saved);
  err = large ? cudaLaunchKernelEx(&cfg, gru_fwd_kernel<true>, x, w, b, o, sv, batch, t_len, dirs,
                                   hidden, rows)
              : cudaLaunchKernelEx(&cfg, gru_fwd_kernel<false>, x, w, b, o, sv, batch, t_len,
                                   dirs, hidden, rows);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

// dout (batch, t_len, dirs, hidden), the forward's saved and w_hh ->
// dxg and dgh (batch, t_len, dirs, 3 hidden). Returns the first CUDA error.
extern "C" int dicl_gru_backward(const void* dout, const void* saved, const void* w_hh,
                                 void* dxg, void* dgh, int batch, int t_len, int dirs,
                                 int hidden, int cluster, int units, int rows, void* stream) {
  if (!args_ok(true, batch, t_len, dirs, hidden, cluster, units, rows))
    return cudaErrorInvalidValue;
  const bool large = is_large(hidden);
  cudaError_t err = set_smem_once(kernel_of(true, large), smem_limit(true, large));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, hidden, batch, dirs, rows, smem_bytes(true, hidden, rows),
                static_cast<cudaStream_t>(stream));
  const auto* go = static_cast<const float*>(dout);
  const auto* sv = static_cast<const float*>(saved);
  const auto* w = static_cast<const float*>(w_hh);
  auto* dx = static_cast<float*>(dxg);
  auto* dg = static_cast<float*>(dgh);
  err = large ? cudaLaunchKernelEx(&cfg, gru_bwd_kernel<true>, go, sv, w, dx, dg, batch, t_len,
                                   dirs, hidden, rows)
              : cudaLaunchKernelEx(&cfg, gru_bwd_kernel<false>, go, sv, w, dx, dg, batch, t_len,
                                   dirs, hidden, rows);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}
