// The biLSTM recurrence for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (called by
// `_recurrence_fwd_raw`) and `_bwd_kernel` (called by `_vjp_bwd`) in
// deep_interpolation_clustering_tpu/ops/pallas_lstm.py, with their interface:
// pre-projected input gates xg_f, xg_b (T, B, 4H), the backward direction NOT
// flipped; [i|f|g|o] gate order; gates `(xg + h W_hh^T) + b_hh` in that
// association order; outputs time-aligned per direction.
//
// Numerics: float32 with accurate expf/tanhf (no fast math) and no tensor
// cores: the port keeps TF32 off, and wgmma has no full-float32 mode.
//
// Bound on the H100: float32 operations. At the encoder's shape (T=6,
// B=512, H=128) the forward's h W_hh^T products are 0.8 GFLOP against
// ~20 MB of inputs and outputs; the backward does three such products
// (gate recompute, dh = dpre W_hh, dW = h^T dpre).
//
// Forward design: one launch runs all T steps of both directions. Grid =
// (batch tiles of kRows rows, direction), 4H threads (16 warps at H=128; 512
// threads with two warp items each above). What bounds it on the H100 is
// W_hh^T: every step needs all of one direction's (256 KB at H=128) against
// a block's 227 KB of shared memory, and the steps are serial, so a block
// that waits on L2 for W at every step is bound by that latency. So:
//  - W_hh^T resident. The block keeps the first rows of its direction's
//    W_hh^T that fit beside the tile's h (104 of 128 at H=128) in dynamic
//    shared memory, copied in once with cp.async while h0, c0, the biases
//    and the first inputs load; each thread keeps its share of the next
//    kFwdTailIters * 4 rows in registers (all of the rest at H=128), and
//    only rows beyond those (H > 128) are read from L2 at every step.
//  - A warp item is kFwdGroup = 8 hidden units x kFwdSplits = 4 splits of k
//    (lane = 8 * split + unit). Each lane forms a register tile of the four
//    gates of its unit for all kRows rows over its split k = split, split +
//    4, ..., one fmaf chain from 0 in increasing k: four shared-memory words
//    of W (row stride = 8 mod 32 words, so the 32 lanes hit 32 banks) and
//    kRows / 4 float4 broadcasts of h (laid out (k, row)) feed 4 * kRows
//    FMAs. The four gates of a unit are H columns apart; owning them
//    together puts them where the pointwise part needs them.
//  - The splits are summed by two warp shuffles that also scatter the tile:
//    pre = (p0 + p1) + (p2 + p3) in that fixed order, and the lane of split
//    s ends with the gates of its unit for one quarter of the tile's rows
//    (kRows / 4 (unit, row) pairs), whose c it keeps in registers. No shared
//    memory for partials, no atomics: two runs give the same bits.
//  - The step's xg values are loaded before its products, so their latency
//    hides behind the FMAs; h is double-buffered in shared memory, so one
//    __syncthreads a step is the only synchronisation.
//  H=100 (4H = 400, 13 warp items) masks the lanes of its last item; H=256
//  (1 MB of W_hh^T a direction) keeps 52 rows resident and reads the rest
//  from L2. kRows is the trade between blocks (fewer with more rows) and
//  each block's FMAs; the rows-per-block sweep (utils/lstm_rows_sweep.py)
//  chose it. The launch geometry comes from the wrapper (`forward_geometry`
//  in ops/cuda_lstm.py) and is checked against this file's constants.
//
// Backward design: as the TPU kernel, it recomputes the gates from the saved
// h/c and saves no activations, in four launches on the stream:
//  1. lstm_gate_products_kernel: the gates' h_prev W_hh^T for every (t, row)
//     pair at once, a register-tiled float32 SGEMM (8 x 8 outputs a thread),
//     one fmaf chain over k = 0..H-1. The forward sums k in four splits, so
//     the recomputed products differ from the forward's by float32 rounding
//     (a few 1e-7 of a gate); the gradients stay within 1e-4 of their
//     largest element at every tested shape. It writes them into the dxg
//     buffers. The TPU kernel recomputes them inside its reverse walk, but
//     they do not depend on that walk.
//  2. lstm_bwd_kernel: the reverse walk. Grid = (batch tiles of kBwdRows
//     rows, direction), 4H threads (16 warps at H=128; 512 threads with two
//     work items each above). Each step is two phases between barriers: the
//     (unit, row) pairs form dpre from the gates (writing it over them in
//     dxg and into shared memory) and carry dc; then ~4H work items, each 4
//     units of dh = dpre W_hh over one of 16 splits of the 4H columns, as 4
//     x kBwdRows register tiles (one float4 of W and kBwdRows / 4 float4
//     broadcasts of dpre feed 32 FMAs); the next step adds the 16 partials
//     in split order. The next step's inputs are loaded during the products.
//  3. lstm_dw_partial_kernel: dW_hh^T = h_prev^T dpre and db_hh over fixed
//     chunks of the (t, row) axis, the same SGEMM tile, enough chunks for
//     two blocks per SM, partials into a scratch buffer from the wrapper;
//  4. lstm_dw_reduce_kernel: the partials summed in chunk order. On the TPU
//     dW accumulates across a sequential grid; Hopper's blocks run in no
//     order. No float atomics anywhere: two runs give the same bits.
//
// What bounds the walk on the H100: W_hh. Each step needs all of one
// direction's W_hh (256 KB at H=128) against a block's 227 KB of shared
// memory, beside the tile's partials, dpre and dc. So the walk keeps the
// first rows of W_hh that fit (278 of 512 at H=128, copied in with cp.async
// during the first step) in shared memory and reads the rest from L2 at
// every step. Recomputing the gates inside the walk as well would read all
// of W in both layouts, 512 KB per block per step, and the L2's rate then
// bounds the walk (PERF.md, the B7 findings). The steps are serial, so the
// walk is bound by each block's own latency: the decoder's half batch takes
// about as long as the encoder's.
// kBwdRows is the trade between W reads (fewer with more rows a block) and
// the FMAs of each block (more); the rows-per-block sweep
// (utils/lstm_rows_sweep.py) chose it.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxHidden = 256;     // the widest recurrence either kernel takes
constexpr int kSmemLimit = 232448;  // the most shared memory a Hopper block can have

__device__ __forceinline__ float sigmoid_acc(float x) {
  return 1.0f / (1.0f + expf(-x));
}

struct Gates {
  float i, f, g, o;
};

// (xg + h W_hh^T) + b_hh, the JAX association order, from the input gates
// `x` and the gate products `pre` of one (unit, row).
__device__ __forceinline__ Gates activate_values(const float (&x)[4], const float (&pre)[4],
                                                 const float (&bias)[4]) {
  const float pi = __fadd_rn(__fadd_rn(x[0], pre[0]), bias[0]);
  const float pf = __fadd_rn(__fadd_rn(x[1], pre[1]), bias[1]);
  const float pg = __fadd_rn(__fadd_rn(x[2], pre[2]), bias[2]);
  const float po = __fadd_rn(__fadd_rn(x[3], pre[3]), bias[3]);
  return {sigmoid_acc(pi), sigmoid_acc(pf), tanhf(pg), sigmoid_acc(po)};
}

// The same with x pointing at the unit's input gate i in device memory.
__device__ __forceinline__ Gates activate_pre(const float* __restrict__ x,
                                              const float (&pre)[4],
                                              const float (&bias)[4], int hidden) {
  const float xv[4] = {x[0], x[hidden], x[2 * hidden], x[3 * hidden]};
  return activate_values(xv, pre, bias);
}

// Asynchronous 16-byte copy from device to shared memory (cp.async, which
// bypasses the registers); copy_async_wait() waits for this thread's copies.
__device__ __forceinline__ void copy_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;\n" ::); }

// -------------------------------------------------------- recurrence forward
constexpr int kRows = 8;             // batch rows per block
constexpr int kFwdMaxThreads = 512;  // one warp item a warp up to H = 128, two above
constexpr int kFwdGroup = 8;         // hidden units per warp item
constexpr int kFwdSplits = 4;        // splits of k, one per kFwdGroup lanes of a warp
constexpr int kFwdTailIters = 6;     // k iterations past the resident rows kept in registers
static_assert(kRows % 4 == 0, "rows are read as float4 and scattered over the four splits");
static_assert(kFwdGroup * kFwdSplits == 32, "a warp item is one warp");

// Shared memory of the forward, in floats: h of the tile, (k, row), twice
// (read and written in turn), k padded to the splits; then as many rows of
// W_hh^T as the rest holds, a multiple of the splits, each padded to a
// stride of 8 mod 32 words.
__host__ __device__ constexpr int fwd_k_rows(int hidden) {
  return (hidden + kFwdSplits - 1) / kFwdSplits * kFwdSplits;
}
__host__ __device__ constexpr int fwd_h_floats(int hidden) { return 2 * fwd_k_rows(hidden) * kRows; }
__host__ __device__ constexpr int fwd_w_stride(int hidden) { return (4 * hidden + 31) / 32 * 32 + 8; }
__host__ __device__ constexpr int fwd_resident_rows(int hidden) {
  const int fit = (kSmemLimit / 4 - fwd_h_floats(hidden)) / fwd_w_stride(hidden) / kFwdSplits *
                  kFwdSplits;
  return fit < fwd_k_rows(hidden) ? fit : fwd_k_rows(hidden);
}
__host__ __device__ constexpr int fwd_smem_bytes(int hidden) {
  return 4 * (fwd_h_floats(hidden) + fwd_resident_rows(hidden) * fwd_w_stride(hidden));
}

// acc[q][r] = fmaf(h[r], w[q], acc[q][r]) for the four gates q and the
// tile's rows r; h4 points at the kRows values of h[:, k].
__device__ __forceinline__ void tile_fma(const float (&w)[4], const float4* h4,
                                         float (&acc)[4][kRows]) {
  float h[kRows];
#pragma unroll
  for (int v = 0; v < kRows / 4; ++v) {
    const float4 f = h4[v];
    h[4 * v] = f.x;
    h[4 * v + 1] = f.y;
    h[4 * v + 2] = f.z;
    h[4 * v + 3] = f.w;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[q][r] = fmaf(h[r], w[q], acc[q][r]);
}

// Grid (batch tiles of kRows rows, direction), blockDim.x threads (a
// multiple of 32, at most kFwdMaxThreads, with kItems warp items a warp
// covering the ceil(H / kFwdGroup) items), fwd_smem_bytes(hidden) of dynamic
// shared memory. Lane = kFwdGroup * split + unit of its warp item. kTail is
// the number of k iterations past the resident rows whose W a thread holds
// in registers; rows past those are read from L2 at every step. Per step:
//   1. load the step's xg values of this lane's (unit, row) pairs;
//   2. acc[gate][row] over k = split + 4 i, i ascending: resident rows from
//      shared memory, then the register rows, then L2;
//   3. two shuffles add the splits as (p0 + p1) + (p2 + p3) and leave each
//      lane the gates of its unit for kRows / 4 rows;
//   4. pointwise: c in registers, h and c out, h into the other h buffer.
template <int kItems, int kTail>
__global__ void __launch_bounds__(kFwdMaxThreads) lstm_fwd_kernel(
    const float* __restrict__ xgf, const float* __restrict__ xgb,
    const float* __restrict__ w_hhT, const float* __restrict__ b_hh,
    const float* __restrict__ h0, const float* __restrict__ c0,
    float* __restrict__ ysf, float* __restrict__ ysb, float* __restrict__ csf,
    float* __restrict__ csb, int t_len, int batch, int hidden) {
  constexpr int R = kRows;
  constexpr int P = R / 4;  // (unit, row) pairs a lane finishes per item
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ float4 smem4[];
  const int H = hidden;
  const int G = 4 * hidden;
  const int kp = fwd_k_rows(H);
  const int ldw = fwd_w_stride(H);
  const int n_res = fwd_resident_rows(H);
  float* hs = reinterpret_cast<float*>(smem4);  // [2][k < kp][row]
  float* ws = hs + 2 * kp * R;                  // [k < n_res][ldw]: W_hh^T
  const int d = blockIdx.y;
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;
  const int split = (tid & 31) / kFwdGroup;
  const int n_items = (H + kFwdGroup - 1) / kFwdGroup;
  const int n_iters = kp / kFwdSplits;
  const int i_res = n_res / kFwdSplits;
  // the tile rows this lane finishes: the split's quarter of the tile
  const int r_own = (split & 1) * (R / 2) + (split >> 1) * P;
  const float* xg = d ? xgb : xgf;
  float* ys = d ? ysb : ysf;
  float* cs = d ? csb : csf;
  const float* w = w_hhT + static_cast<size_t>(d) * H * G;

  // the resident rows of W_hh^T (rows of H float4), then zeros for its
  // rows past H and for h's rows past H in both buffers
  const int n_copy = n_res < H ? n_res : H;
  for (int i = tid; i < n_copy * H; i += nt) {
    const int k = i / H;
    const int c4 = i - k * H;
    copy_async16(ws + k * ldw + 4 * c4, w + static_cast<size_t>(k) * G + 4 * c4);
  }
  for (int i = tid; i < (n_res - n_copy) * ldw; i += nt) ws[n_copy * ldw + i] = 0.0f;
  for (int i = tid; i < (kp - H) * R; i += nt) {
    hs[H * R + i] = 0.0f;
    hs[kp * R + H * R + i] = 0.0f;
  }

  int unit[kItems];        // this lane's hidden unit of each item
  int unit_ld[kItems];     // the same, clamped to H - 1 for loads
  float c[kItems][P];
  float bias[kItems][4];
  float wt[kItems][kTail > 0 ? kTail : 1][4];  // W of the register rows
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int j = (warp + it * n_warps) * kFwdGroup + (tid & 31) % kFwdGroup;
    unit[it] = j;
    unit_ld[it] = j < H ? j : H - 1;
    const int jl = unit_ld[it];
#pragma unroll
    for (int q = 0; q < 4; ++q) bias[it][q] = b_hh[d * G + q * H + jl];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int r = r_own + p;
      const int row = row0 + r;
      const bool ok = j < H && row < batch;
      const size_t o = (static_cast<size_t>(d) * batch + (ok ? row : 0)) * H + jl;
      c[it][p] = ok ? c0[o] : 0.0f;
      if (j < H) hs[j * R + r] = ok ? h0[o] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kTail; ++u) {
      const int k = (i_res + u) * kFwdSplits + split;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wt[it][u][q] = k < H ? __ldg(w + static_cast<size_t>(k) * G + q * H + jl) : 0.0f;
      }
    }
  }
  copy_async_wait();
  __syncthreads();

  for (int s = 0; s < t_len; ++s) {
    const int t = d ? t_len - 1 - s : s;
    const float* h_cur = hs + (s & 1) * kp * R;
    float* h_next = hs + ((s & 1) ^ 1) * kp * R;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (warp + it * n_warps >= n_items) break;  // the whole warp leaves together
      const int j = unit[it];
      const int jl = unit_ld[it];
      // 1
      float xin[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int row = row0 + r_own + p;
        const size_t base = static_cast<size_t>(t) * batch + (row < batch ? row : 0);
#pragma unroll
        for (int q = 0; q < 4; ++q) xin[p][q] = xg[base * G + q * H + jl];
      }
      // 2
      float acc[4][R];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[q][r] = 0.0f;
#pragma unroll 4
      for (int i = 0; i < i_res; ++i) {
        const int k = i * kFwdSplits + split;
        const float* wk = ws + k * ldw + jl;
        const float wq[4] = {wk[0], wk[H], wk[2 * H], wk[3 * H]};
        tile_fma(wq, reinterpret_cast<const float4*>(h_cur + k * R), acc);
      }
#pragma unroll
      for (int u = 0; u < kTail; ++u) {
        if (i_res + u < n_iters) {
          const int k = (i_res + u) * kFwdSplits + split;
          tile_fma(wt[it][u], reinterpret_cast<const float4*>(h_cur + k * R), acc);
        }
      }
#pragma unroll 2
      for (int i = i_res + kTail; i < n_iters; ++i) {
        const int k = i * kFwdSplits + split;
        const float* wk = w + static_cast<size_t>(k < H ? k : H - 1) * G + jl;
        float wq[4] = {__ldg(wk), __ldg(wk + H), __ldg(wk + 2 * H), __ldg(wk + 3 * H)};
        if (k >= H) wq[0] = wq[1] = wq[2] = wq[3] = 0.0f;
        tile_fma(wq, reinterpret_cast<const float4*>(h_cur + k * R), acc);
      }
      // 3: splits 0|1 and 2|3 swap half the rows, then 0|2 and 1|3 a quarter
      const bool odd = split & 1;
      float half[4][R / 2];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < R / 2; ++r) {
          const float keep = odd ? acc[q][r + R / 2] : acc[q][r];
          const float send = odd ? acc[q][r] : acc[q][r + R / 2];
          half[q][r] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, kFwdGroup));
        }
      const bool upper = split & 2;
      float pre[P][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float keep = upper ? half[q][p + P] : half[q][p];
          const float send = upper ? half[q][p] : half[q][p + P];
          pre[p][q] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, 2 * kFwdGroup));
        }
      // 4
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int r = r_own + p;
        const int row = row0 + r;
        float h = 0.0f;
        if (j < H && row < batch) {
          const size_t base = static_cast<size_t>(t) * batch + row;
          const Gates a = activate_values(xin[p], pre[p], bias[it]);
          c[it][p] = __fadd_rn(__fmul_rn(a.f, c[it][p]), __fmul_rn(a.i, a.g));
          h = __fmul_rn(a.o, tanhf(c[it][p]));
          ys[base * H + j] = h;
          cs[base * H + j] = c[it][p];
        }
        if (j < H) h_next[j * R + r] = h;
      }
    }
    __syncthreads();  // h_next is whole, and every warp is done with h_cur
  }
}

// ------------------------------------------------------- recurrence backward
constexpr int kBwdRows = 8;          // batch rows per block
constexpr int kBwdMaxThreads = 512;  // one work item a thread up to H = 128, two above
constexpr int kBwdGroup = 8;         // units side by side in the (unit, row) mapping
constexpr int kBwdCols = 4;          // units per dh work item: one float4 of W_hh
constexpr int kDhSplits = 16;        // splits of n in the dh products
constexpr int kBwdPairCap = kBwdRows / 2;  // (unit, row) pairs a thread holds at H = 256
static_assert(kBwdRows % 4 == 0, "rows are read and written as float4");

// Shared memory of the recurrence, in floats: the dh partials (split, row,
// unit) with a padded unit stride, dpre (4H x rows), dc (H x rows), then as
// many rows of W_hh (padded to a float4 multiple) as the rest holds.
__host__ __device__ constexpr int bwd_unit_stride(int hidden) { return (hidden + 3) / 4 * 4; }
__host__ __device__ constexpr int bwd_part_stride(int hidden) { return bwd_unit_stride(hidden) + 8; }
__host__ __device__ constexpr int bwd_fixed_floats(int hidden) {
  return kDhSplits * kBwdRows * bwd_part_stride(hidden) + 5 * hidden * kBwdRows;
}
__host__ __device__ constexpr int bwd_resident_rows(int hidden) {
  const int rows = (kSmemLimit / 4 - bwd_fixed_floats(hidden)) / bwd_unit_stride(hidden);
  return rows < 0 ? 0 : rows < 4 * hidden ? rows : 4 * hidden;
}
__host__ __device__ constexpr int bwd_smem_bytes(int hidden) {
  return 4 * (bwd_fixed_floats(hidden) + bwd_resident_rows(hidden) * bwd_unit_stride(hidden));
}

// Slot p of the (unit j, row r) pairs of a tile: kBwdGroup consecutive units
// of one row side by side, so that a warp reads and writes 32-byte runs of
// each of four rows in device memory and hits shared memory with at most two
// lanes on one bank.
__device__ __forceinline__ void bwd_pair(int p, int& j, int& r) {
  const int group = p / (kBwdGroup * kBwdRows);
  const int w = p - group * (kBwdGroup * kBwdRows);
  j = group * kBwdGroup + w % kBwdGroup;
  r = w / kBwdGroup;
}

// acc[c][r] = sum over i in [lo, hi), in i order, of w(i)[c] * v[i][r]:
// w(i) is kBwdCols consecutive columns of one row of W as a float4, v is in
// shared memory as (i, row) float4 rows. One float4 of W
// and kBwdRows / 4 float4 broadcasts feed kBwdCols x kBwdRows FMAs.
template <class LoadW>
__device__ __forceinline__ void tile_products(LoadW w, const float4* v, int lo, int hi,
                                              float (&acc)[kBwdCols][kBwdRows]) {
#pragma unroll
  for (int c = 0; c < kBwdCols; ++c)
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) acc[c][r] = 0.0f;
#pragma unroll 4
  for (int i = lo; i < hi; ++i) {
    const float4 w4 = w(i);
    const float wc[kBwdCols] = {w4.x, w4.y, w4.z, w4.w};
    float x[kBwdRows];
#pragma unroll
    for (int q = 0; q < kBwdRows / 4; ++q) {
      const float4 f = v[i * (kBwdRows / 4) + q];
      x[4 * q] = f.x;
      x[4 * q + 1] = f.y;
      x[4 * q + 2] = f.z;
      x[4 * q + 3] = f.w;
    }
#pragma unroll
    for (int c = 0; c < kBwdCols; ++c)
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) acc[c][r] = fmaf(x[r], wc[c], acc[c][r]);
  }
}

// What the pointwise part of one step reads from device memory for one
// (unit, row): prefetched during the previous step's dh products.
struct PairIn {
  float pre[4];  // h_prev W_hh^T of the four gates (lstm_gate_products_kernel)
  float c, c_prev, dy, dc;
};

// Grid (batch tiles of kBwdRows rows, direction), blockDim.x threads (a
// multiple of 32, at most kBwdMaxThreads, with blockDim.x * kPairs pairs at
// least those of a tile), bwd_smem_bytes(hidden) of dynamic shared memory.
// The gates' products h_prev W_hh^T arrive in dxg (lstm_gate_products_kernel
// wrote them there), and dpre replaces them. The resident rows of W_hh are
// copied in asynchronously during the first step's pointwise phase. Each
// reverse step is two phases between barriers:
//   C. (unit, row) pairs: dh = the previous step's 16 partials summed in
//      split order, the gates, dpre (written as dxg and kept in shared
//      memory), dc carried; then the next step's inputs are loaded;
//   D. ~4H items (units 4g..4g+3, n split q of 16): part[q][r][j] = sum
//      over n in split q, in n order, of dpre[r][n] W_hh[n][j], with W_hh
//      read from shared memory for its resident rows and from L2 after.
template <int kPairs>
__global__ void __launch_bounds__(kBwdMaxThreads) lstm_bwd_kernel(
    const float* __restrict__ w_hh, const float* __restrict__ b_hh,
    const float* __restrict__ c0, const float* __restrict__ xgf,
    const float* __restrict__ xgb, const float* __restrict__ csf,
    const float* __restrict__ csb, const float* __restrict__ dysf,
    const float* __restrict__ dysb, const float* __restrict__ dcsf,
    const float* __restrict__ dcsb, float* __restrict__ dxgf,
    float* __restrict__ dxgb, float* __restrict__ dh0, float* __restrict__ dc0,
    int t_len, int batch, int hidden) {
  constexpr int R = kBwdRows;
  extern __shared__ float4 smem4[];
  const int H = hidden;
  const int G = 4 * hidden;
  const int ldu = bwd_unit_stride(H);
  const int ldp = bwd_part_stride(H);
  const int n_res = bwd_resident_rows(H);
  float* part = reinterpret_cast<float*>(smem4);  // (split, row, unit)
  float* pd = part + kDhSplits * R * ldp;         // (n, row): dpre
  float* dcs_t = pd + G * R;                      // (j, row)
  float* ws = dcs_t + H * R;                      // (n < n_res, unit): W_hh
  const float4* pd4 = reinterpret_cast<const float4*>(pd);
  const float4* ws4 = reinterpret_cast<const float4*>(ws);
  const int d = blockIdx.y;
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n_slots = (H + kBwdGroup - 1) / kBwdGroup * kBwdGroup * R;
  const int n_groups = ldu / kBwdCols;  // unit groups of phase D
  const float* xg = d ? xgb : xgf;
  const float* cs = d ? csb : csf;
  const float* dys = d ? dysb : dysf;
  const float* dcs = d ? dcsb : dcsf;
  float* dxg = d ? dxgb : dxgf;
  const float* wt = w_hh + static_cast<size_t>(d) * G * H;
  const float* bias_d = b_hh + d * G;

  const auto load_in = [&](int s, int p, PairIn& in) {
    int j, r;
    bwd_pair(p, j, r);
    const int row = row0 + r;
    if (p >= n_slots || j >= H || row >= batch) return;
    const int t = d ? t_len - 1 - s : s;
    const size_t base = static_cast<size_t>(t) * batch + row;
#pragma unroll
    for (int q = 0; q < 4; ++q) in.pre[q] = dxg[base * G + q * H + j];
    in.c = cs[base * H + j];
    const int t_prev = d ? t + 1 : t - 1;  // read only when s > 0
    in.c_prev = s > 0 ? cs[(static_cast<size_t>(t_prev) * batch + row) * H + j]
                      : c0[(static_cast<size_t>(d) * batch + row) * H + j];
    in.dy = dys[base * H + j];
    in.dc = dcs[base * H + j];
  };
  if (H == ldu) {  // the resident rows are one contiguous run of float4
    for (int i = tid; i < n_res * ldu / 4; i += nt) {
      copy_async16(ws + 4 * i, wt + 4 * static_cast<size_t>(i));
    }
  } else {
    for (int i = tid; i < n_res * ldu; i += nt) {
      const int n = i / ldu;
      const int j = i - n * ldu;
      ws[i] = j < H ? wt[static_cast<size_t>(n) * H + j] : 0.0f;
    }
  }
  PairIn in[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) load_in(t_len - 1, tid + i * nt, in[i]);

  for (int s = t_len - 1; s >= 0; --s) {
    const int t = d ? t_len - 1 - s : s;
    // C
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int p = tid + i * nt;
      if (p >= n_slots) break;
      int j, r;
      bwd_pair(p, j, r);
      if (j >= H) continue;
      const int row = row0 + r;
      float dpre[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (row < batch) {
        const size_t base = static_cast<size_t>(t) * batch + row;
        const float bias[4] = {__ldg(bias_d + j), __ldg(bias_d + H + j),
                               __ldg(bias_d + 2 * H + j), __ldg(bias_d + 3 * H + j)};
        const Gates a = activate_pre(xg + base * G + j, in[i].pre, bias, H);
        const float tc = tanhf(in[i].c);
        float dh = 0.0f;
        if (s < t_len - 1) {
          for (int q = 0; q < kDhSplits; ++q) dh += part[(q * R + r) * ldp + j];
        }
        dh += in[i].dy;
        float dc = s < t_len - 1 ? dcs_t[j * R + r] : 0.0f;
        dc += in[i].dc;
        const float d_o = dh * tc;
        dc += dh * a.o * (1.0f - tc * tc);
        const float di = dc * a.g;
        const float df = dc * in[i].c_prev;
        const float dg = dc * a.i;
        dpre[0] = di * a.i * (1.0f - a.i);
        dpre[1] = df * a.f * (1.0f - a.f);
        dpre[2] = dg * (1.0f - a.g * a.g);
        dpre[3] = d_o * a.o * (1.0f - a.o);
        float* dx = dxg + base * G + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) dx[q * H] = dpre[q];
        dcs_t[j * R + r] = dc * a.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) pd[(q * H + j) * R + r] = dpre[q];
    }
    if (s == t_len - 1) copy_async_wait();  // the resident W, before the barrier
    __syncthreads();
    if (s > 0) {
#pragma unroll
      for (int i = 0; i < kPairs; ++i) load_in(s - 1, tid + i * nt, in[i]);
    }
    // D
    for (int u = tid; u < kDhSplits * n_groups; u += nt) {
      const int g = u % n_groups;
      const int q = u / n_groups;
      const int lo = q * G / kDhSplits;
      const int hi = (q + 1) * G / kDhSplits;
      const int j0 = kBwdCols * g;
      float acc[kBwdCols][R];
      if (H % kBwdCols == 0) {
        const float4* wt4 = reinterpret_cast<const float4*>(wt);
        tile_products(
            [&](int n) {
              return n < n_res ? ws4[n * n_groups + g]
                               : __ldg(wt4 + static_cast<size_t>(n) * n_groups + g);
            },
            pd4, lo, hi, acc);
      } else {  // rows of W_hh in device memory are not float4-aligned
        tile_products(
            [&](int n) {
              if (n < n_res) return ws4[n * n_groups + g];
              const float* p = wt + static_cast<size_t>(n) * H + j0;
              return make_float4(__ldg(p), j0 + 1 < H ? __ldg(p + 1) : 0.0f,
                                 j0 + 2 < H ? __ldg(p + 2) : 0.0f,
                                 j0 + 3 < H ? __ldg(p + 3) : 0.0f);
            },
            pd4, lo, hi, acc);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        *reinterpret_cast<float4*>(part + (q * R + r) * ldp + j0) =
            make_float4(acc[0][r], acc[1][r], acc[2][r], acc[3][r]);
      }
    }
    __syncthreads();
  }
  for (int p = tid; p < n_slots; p += nt) {
    int j, r;
    bwd_pair(p, j, r);
    const int row = row0 + r;
    if (j >= H || row >= batch) continue;
    float dh = 0.0f;
    for (int q = 0; q < kDhSplits; ++q) dh += part[(q * R + r) * ldp + j];
    const size_t o = (static_cast<size_t>(d) * batch + row) * H + j;
    dh0[o] = dh;
    dc0[o] = dcs_t[j * R + r];
  }
}

// ------------------------------ register-tiled float32 products of the pass
// Two products over all (t, row) pairs at once, as a float32 SGEMM tile: the
// gates' h_prev W_hh^T before the recurrence (summed over k) and dW_hh^T =
// h_prev^T dpre after it (summed over the pairs). A block of kGemmThreads
// threads computes a kGemmTileA x kGemmTileN tile of the output; thread
// (ty, tx) owns rows {4 ty, 32 + 4 ty} + {0..3} and columns {4 tx, 64 +
// 4 tx} + {0..3}: per step of the sum, four float4 shared-memory reads feed
// 64 FMAs. The sum runs in stages of kGemmStage, the next stage loaded into
// registers while the current one is multiplied out of shared memory.
constexpr int kGemmTileA = 64;    // output rows per block
constexpr int kGemmTileN = 128;   // output columns per block
constexpr int kGemmStage = 16;    // summed index per shared-memory stage
constexpr int kGemmThreads = 128;
constexpr int kGemmLdA = kGemmTileA + 4;  // padded: the gates' A tile is stored transposed
constexpr int kGemmLoadA = kGemmStage * kGemmTileA / kGemmThreads;
constexpr int kGemmLoadB = kGemmStage * kGemmTileN / kGemmThreads;
static_assert(kGemmTileN == kGemmThreads && kGemmThreads % kGemmTileA == 0, "load mapping");

struct GemmStage {
  float a[kGemmStage][kGemmLdA];
  float b[kGemmStage][kGemmTileN];
};

// acc[i][c] += sum over the stage, in order, of a[s][row i] * b[s][column c].
__device__ __forceinline__ void stage_products(const GemmStage& st, int tx, int ty,
                                               float (&acc)[8][8]) {
#pragma unroll
  for (int s = 0; s < kGemmStage; ++s) {
    const float4 a0 = *reinterpret_cast<const float4*>(&st.a[s][4 * ty]);
    const float4 a1 = *reinterpret_cast<const float4*>(&st.a[s][32 + 4 * ty]);
    const float4 b0 = *reinterpret_cast<const float4*>(&st.b[s][4 * tx]);
    const float4 b1 = *reinterpret_cast<const float4*>(&st.b[s][64 + 4 * tx]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
  }
}

// The stages [begin, end) in steps of kGemmStage through two shared-memory
// buffers: load(s0) fills registers, store(stage) moves them to shared
// memory, compute(stage) multiplies a stage out.
template <class Load, class Store, class Compute>
__device__ __forceinline__ void pipelined_stages(GemmStage (&st)[2], int begin, int end,
                                                 Load load, Store store, Compute compute) {
  int buf = 0;
  load(begin);
  store(st[0]);
  __syncthreads();
  for (int s0 = begin; s0 < end; s0 += kGemmStage) {
    const bool more = s0 + kGemmStage < end;
    if (more) load(s0 + kGemmStage);
    compute(st[buf]);
    if (more) store(st[buf ^ 1]);
    __syncthreads();
    buf ^= 1;
  }
}

// Output row of thread row index i (0..7) of a tile.
__device__ __forceinline__ int tile_row(int ty, int i) {
  return i < 4 ? 4 * ty + i : 32 + 4 * ty + i - 4;
}

// Row of h_prev (the state the step at time t started from) of direction d
// for the m-th (t, row) pair, m = t * batch + row, without a division:
// forward, t = 0 is h0 and t > 0 is ys_f[t - 1]; backward, t = T - 1 is h0
// and t < T - 1 is ys_b[t + 1].
__device__ __forceinline__ const float* h_prev_row(int d, int m, int t_len, int batch,
                                                   int hidden, const float* __restrict__ h0,
                                                   const float* __restrict__ ysf,
                                                   const float* __restrict__ ysb) {
  if (d == 0) {
    return m < batch ? h0 + static_cast<size_t>(m) * hidden
                     : ysf + static_cast<size_t>(m - batch) * hidden;
  }
  const int last = (t_len - 1) * batch;
  return m >= last ? h0 + static_cast<size_t>(m - last + batch) * hidden
                   : ysb + static_cast<size_t>(m + batch) * hidden;
}

// Grid (ceil(4H / kGemmTileN), ceil(T B / kGemmTileA), 2): pre[d][m][n] =
// sum over k, in k order, of h_prev[d][m][k] W_hh^T[d][k][n] (the forward's
// products up to float32 rounding: it sums k in four splits), written into
// the dxg buffers.
__global__ void __launch_bounds__(kGemmThreads) lstm_gate_products_kernel(
    const float* __restrict__ h0, const float* __restrict__ ysf,
    const float* __restrict__ ysb, const float* __restrict__ w_hhT,
    float* __restrict__ pref, float* __restrict__ preb, int t_len, int batch, int hidden) {
  __shared__ __align__(16) GemmStage st[2];
  const int G = 4 * hidden;
  const int m_total = t_len * batch;
  const int n0 = blockIdx.x * kGemmTileN;
  const int m0 = blockIdx.y * kGemmTileA;
  const int d = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float* w = w_hhT + static_cast<size_t>(d) * hidden * G;
  float* pre = d ? preb : pref;
  // this thread's loads: A at (k = ka, m = ma + 8 l), B at (k = l, n = tid)
  const int ka = tid % kGemmStage;
  const int ma = tid / kGemmStage;
  const float* arow[kGemmLoadA];
#pragma unroll
  for (int l = 0; l < kGemmLoadA; ++l) {
    const int m = m0 + ma + (kGemmThreads / kGemmStage) * l;
    arow[l] = m < m_total ? h_prev_row(d, m, t_len, batch, hidden, h0, ysf, ysb) : nullptr;
  }
  const bool n_ok = n0 + tid < G;
  float ra[kGemmLoadA], rb[kGemmLoadB];
  float acc[8][8] = {};
  pipelined_stages(
      st, 0, hidden,
      [&](int k0) {
#pragma unroll
        for (int l = 0; l < kGemmLoadA; ++l) {
          ra[l] = arow[l] != nullptr && k0 + ka < hidden ? arow[l][k0 + ka] : 0.0f;
        }
#pragma unroll
        for (int l = 0; l < kGemmLoadB; ++l) {
          rb[l] = k0 + l < hidden && n_ok ? __ldg(w + static_cast<size_t>(k0 + l) * G + n0 + tid)
                                          : 0.0f;
        }
      },
      [&](GemmStage& s) {
#pragma unroll
        for (int l = 0; l < kGemmLoadA; ++l) {
          s.a[ka][ma + (kGemmThreads / kGemmStage) * l] = ra[l];
        }
#pragma unroll
        for (int l = 0; l < kGemmLoadB; ++l) s.b[l][tid] = rb[l];
      },
      [&](const GemmStage& s) { stage_products(s, tx, ty, acc); });
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tile_row(ty, i);
    if (m >= m_total) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + 64 * half + 4 * tx;  // G = 4H: n < G covers n + 3
      if (n < G) {
        *reinterpret_cast<float4*>(pre + static_cast<size_t>(m) * G + n) =
            make_float4(acc[i][4 * half], acc[i][4 * half + 1], acc[i][4 * half + 2],
                        acc[i][4 * half + 3]);
      }
    }
  }
}

// Grid (ceil(4H / kGemmTileN), ceil(H / kGemmTileA), 2 * nsplit): block z =
// 2 * split + d writes the partial of dW_hh^T[d] (and, in the first row of
// k tiles, of db_hh[d]) summed over the pairs m in [split * chunk, (split +
// 1) * chunk), in increasing order.
__global__ void __launch_bounds__(kGemmThreads) lstm_dw_partial_kernel(
    const float* __restrict__ h0, const float* __restrict__ ysf,
    const float* __restrict__ ysb, const float* __restrict__ dxgf,
    const float* __restrict__ dxgb, float* __restrict__ dw_part,
    float* __restrict__ db_part, int t_len, int batch, int hidden, int chunk) {
  __shared__ __align__(16) GemmStage st[2];
  const int G = 4 * hidden;
  const int n0 = blockIdx.x * kGemmTileN;
  const int k0 = blockIdx.y * kGemmTileA;
  const int d = blockIdx.z & 1;
  const int split = blockIdx.z >> 1;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m_begin = split * chunk;
  const int m_end = min(t_len * batch, m_begin + chunk);
  const float* dxg = d ? dxgb : dxgf;
  const bool db_thread = blockIdx.y == 0 && ty == 0;
  // this thread's loads: A at (m = ma + 2 l, k = kk), B at (m = l, n = tid)
  const int kk = tid % kGemmTileA;
  const int ma = tid / kGemmTileA;
  const bool k_ok = k0 + kk < hidden;
  const bool n_ok = n0 + tid < G;
  float ra[kGemmLoadA], rb[kGemmLoadB];
  float acc[8][8] = {};
  float dbs[8] = {};
  pipelined_stages(
      st, m_begin, m_end,
      [&](int m0) {
#pragma unroll
        for (int l = 0; l < kGemmLoadA; ++l) {
          const int m = m0 + ma + (kGemmThreads / kGemmTileA) * l;
          ra[l] = m < m_end && k_ok
                      ? h_prev_row(d, m, t_len, batch, hidden, h0, ysf, ysb)[k0 + kk]
                      : 0.0f;
        }
#pragma unroll
        for (int l = 0; l < kGemmLoadB; ++l) {
          const int m = m0 + l;
          rb[l] = m < m_end && n_ok ? dxg[static_cast<size_t>(m) * G + n0 + tid] : 0.0f;
        }
      },
      [&](GemmStage& s) {
#pragma unroll
        for (int l = 0; l < kGemmLoadA; ++l) s.a[ma + (kGemmThreads / kGemmTileA) * l][kk] = ra[l];
#pragma unroll
        for (int l = 0; l < kGemmLoadB; ++l) s.b[l][tid] = rb[l];
      },
      [&](const GemmStage& s) {
        stage_products(s, tx, ty, acc);
        if (db_thread) {
#pragma unroll
          for (int m = 0; m < kGemmStage; ++m) {
#pragma unroll
            for (int c = 0; c < 8; ++c) dbs[c] += s.b[m][(c < 4 ? 0 : 60) + 4 * tx + c];
          }
        }
      });
  const size_t plane = static_cast<size_t>(split) * 2 + d;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + tile_row(ty, i);
    if (k >= hidden) continue;
    float* out = dw_part + (plane * hidden + k) * G;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + 64 * half + 4 * tx;  // G = 4H: n < G covers n + 3
      if (n < G) {
        *reinterpret_cast<float4*>(out + n) =
            make_float4(acc[i][4 * half], acc[i][4 * half + 1], acc[i][4 * half + 2],
                        acc[i][4 * half + 3]);
      }
    }
  }
  if (db_thread) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + 64 * half + 4 * tx;
      if (n < G) {
        *reinterpret_cast<float4*>(db_part + plane * G + n) =
            make_float4(dbs[4 * half], dbs[4 * half + 1], dbs[4 * half + 2], dbs[4 * half + 3]);
      }
    }
  }
}

// dw[i] = sum over splits of dw_part[split][i], in split order; then db.
__global__ void lstm_dw_reduce_kernel(const float* __restrict__ dw_part,
                                      const float* __restrict__ db_part,
                                      float* __restrict__ dw, float* __restrict__ db,
                                      int n_dw, int n_db, int nsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_dw) {
    float s = 0.0f;
    for (int p = 0; p < nsplit; ++p) s += dw_part[static_cast<size_t>(p) * n_dw + i];
    dw[i] = s;
  } else if (i < n_dw + n_db) {
    const int i2 = i - n_dw;
    float s = 0.0f;
    for (int p = 0; p < nsplit; ++p) s += db_part[static_cast<size_t>(p) * n_db + i2];
    db[i2] = s;
  }
}

bool bad_shape(int t_len, int batch, int hidden) {
  return t_len < 1 || batch < 1 || hidden < 1 || hidden > kMaxHidden;
}

}  // namespace

// xgf, xgb: (T, B, 4H); w_hhT: (2, H, 4H); b_hh: (2, 4H); h0, c0: (2, B, H);
// ysf, ysb, csf, csb: (T, B, H). float32, contiguous. The launch geometry
// comes from the wrapper (`forward_geometry` in ops/cuda_lstm.py): `rows`
// must be kRows, `threads` a multiple of 32 up to kFwdMaxThreads whose warps
// cover the ceil(H / kFwdGroup) warp items at two a warp, and `smem_bytes`
// must be fwd_smem_bytes(hidden). Returns the first CUDA error that is not 0.
extern "C" int dicl_lstm_fwd(const void* xgf, const void* xgb, const void* w_hhT,
                             const void* b_hh, const void* h0, const void* c0,
                             void* ysf, void* ysb, void* csf, void* csb, int t_len,
                             int batch, int hidden, int rows, int threads,
                             int smem_bytes, void* stream) {
  if (bad_shape(t_len, batch, hidden)) return cudaErrorInvalidValue;
  const int n_items = (hidden + kFwdGroup - 1) / kFwdGroup;
  if (rows != kRows || threads < 32 || threads > kFwdMaxThreads || threads % 32 != 0 ||
      threads / 32 * 2 < n_items || smem_bytes != fwd_smem_bytes(hidden) ||
      smem_bytes > kSmemLimit) {
    return cudaErrorInvalidValue;
  }
  // one warp item a warp keeps the first rows of W past the resident ones
  // in registers; two items a warp (H > 128) leave no registers for that
  const auto kernel = threads / 32 >= n_items ? lstm_fwd_kernel<1, kFwdTailIters>
                                              : lstm_fwd_kernel<2, 0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + kRows - 1) / kRows, 2);
  kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xgf), static_cast<const float*>(xgb),
      static_cast<const float*>(w_hhT), static_cast<const float*>(b_hh),
      static_cast<const float*>(h0), static_cast<const float*>(c0),
      static_cast<float*>(ysf), static_cast<float*>(ysb), static_cast<float*>(csf),
      static_cast<float*>(csb), t_len, batch, hidden);
  return static_cast<int>(cudaGetLastError());
}

// The forward's inputs and outputs, w_hh (2, 4H, H) = w_hhT transposed, the
// cotangents dys*, dcs* (T, B, H) -> dxgf, dxgb (T, B, 4H), dw_hhT (2, H, 4H),
// db_hh (2, 4H), dh0, dc0 (2, B, H). dw_part (nsplit, 2, H, 4H) and db_part
// (nsplit, 2, 4H) are scratch. The launch geometry comes from the wrapper
// (`backward_geometry` in ops/cuda_lstm.py): `rows` must be kBwdRows,
// `threads` a multiple of 32 up to kBwdMaxThreads that holds a tile's pairs
// at kBwdPairCap a thread, and the nsplit chunks of `chunk` (t, row) pairs
// must each hold at least one pair. Four launches on `stream`; returns the
// first CUDA error that is not 0.
extern "C" int dicl_lstm_bwd(
    const void* xgf, const void* xgb, const void* w_hhT, const void* w_hh,
    const void* b_hh, const void* h0, const void* c0, const void* ysf,
    const void* ysb, const void* csf, const void* csb, const void* dysf,
    const void* dysb, const void* dcsf, const void* dcsb, void* dxgf, void* dxgb,
    void* dw_hhT, void* db_hh, void* dh0, void* dc0, void* dw_part, void* db_part,
    int t_len, int batch, int hidden, int rows, int threads, int nsplit, int chunk,
    void* stream) {
  if (bad_shape(t_len, batch, hidden)) return cudaErrorInvalidValue;
  const long long m_total = static_cast<long long>(t_len) * batch;
  const int n_slots = (hidden + kBwdGroup - 1) / kBwdGroup * kBwdGroup * kBwdRows;
  if (rows != kBwdRows || threads < 32 || threads > kBwdMaxThreads || threads % 32 != 0 ||
      threads * kBwdPairCap < n_slots || bwd_fixed_floats(hidden) > kSmemLimit / 4 ||
      nsplit < 1 || nsplit > 1024 || chunk < 1 ||
      static_cast<long long>(nsplit) * chunk < m_total ||
      static_cast<long long>(nsplit - 1) * chunk >= m_total) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto out = [](void* p) { return static_cast<float*>(p); };
  const int G = 4 * hidden;
  const dim3 pgrid((G + kGemmTileN - 1) / kGemmTileN,
                   static_cast<int>((m_total + kGemmTileA - 1) / kGemmTileA), 2);
  lstm_gate_products_kernel<<<pgrid, kGemmThreads, 0, s>>>(
      f(h0), f(ysf), f(ysb), f(w_hhT), out(dxgf), out(dxgb), t_len, batch, hidden);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // a thread holds kBwdPairCap / 2 pairs up to H = 128 (4H threads), twice
  // that at H = 256 (512 threads); the kernel keeps them in registers
  const auto kernel = threads * (kBwdPairCap / 2) >= n_slots ? lstm_bwd_kernel<kBwdPairCap / 2>
                                                             : lstm_bwd_kernel<kBwdPairCap>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bwd_smem_bytes(hidden));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + kBwdRows - 1) / kBwdRows, 2);
  kernel<<<grid, threads, bwd_smem_bytes(hidden), s>>>(
      f(w_hh), f(b_hh), f(c0), f(xgf), f(xgb), f(csf), f(csb), f(dysf), f(dysb), f(dcsf),
      f(dcsb), out(dxgf), out(dxgb), out(dh0), out(dc0), t_len, batch, hidden);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 ggrid((G + kGemmTileN - 1) / kGemmTileN, (hidden + kGemmTileA - 1) / kGemmTileA,
                   2 * nsplit);
  lstm_dw_partial_kernel<<<ggrid, kGemmThreads, 0, s>>>(
      f(h0), f(ysf), f(ysb), f(dxgf), f(dxgb), out(dw_part), out(db_part), t_len, batch,
      hidden, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_dw = 2 * hidden * G;
  const int n_db = 2 * G;
  lstm_dw_reduce_kernel<<<(n_dw + n_db + 255) / 256, 256, 0, s>>>(
      f(dw_part), f(db_part), out(dw_hhT), out(db_hh), n_dw, n_db, nsplit);
  return static_cast<int>(cudaGetLastError());
}
