// Gaussian RBF push for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rbf_kernel` (called by `_rbf_pallas_raw`)
// in deep_interpolation_clustering_tpu/ops/pallas_interp.py. For every slot
// j of row (b, c), from the per-channel grid values proj[b, c, :R]:
//   phi_r = exp(-beta_c (t_j - ref_r)^2) * m_j
//   out_j = sum_r phi_r proj_r / (sum_r phi_r + 1e-10) * m_j
//
// Bound on the H100: memory. Each slot reads t and m and writes out, three
// float planes of (rows, T); proj and beta are a few KB that stay in cache.
// R accurate expf per observed slot take well under the planes' read time.
// At 1,536 x 354 the planes are 6.5 MB, about what the card keeps in flight
// in one memory latency, so the kernel is bound by round trips and by the
// loads each thread has in flight, not by bandwidth. The first kernel (a
// thread a slot over a flat index) spent its time on a 64-bit division and
// modulo per slot to find the row and on reloading beta and the row's proj
// in every thread, with one slot's loads in flight a thread.
//
// Design: the SCI kernels' layout (csrc/sci.cu; `sci_row_layout` in
// ops/cuda_interp.py is the rule for both files, and the C entry checks it):
//   T <= 64          one warp a row (4 rows a block), 1 or 2 slots a lane;
//   64 < T <= 384    one block of 128 threads a row, 1 to 3 slots a thread;
//   T > 384          one block a row that loops over the row.
// The row comes from the block and warp index. A thread issues the t and m
// loads of all its slots before it uses any, then reads beta and the row's R
// proj values once (the same addresses in every thread of the row: one
// cached line). Padded slots (m = 0) skip the exp and write 0, which is what
// the formula gives for finite inputs; observations are front-packed, so
// whole warps past n_valid skip together. R (<= 8) is unrolled in registers.
// Accurate expf and the same rounding of the exponent as the plain version
// (`__fmul_rn`), so the 1e-5 agreement holds. The backward is PyTorch
// autodiff of the plain formula (cuda_interp.RBFFunction), as in the JAX
// package.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kNormEps = 1e-10f;

// --------------------------- the layout's constants, equal to csrc/sci.cu's
constexpr int kRowThreads = 128;  // threads per block (sci.cu: kBwdThreads)
constexpr int kWarpSlots = 2;     // a warp takes a row of up to 32 * this slots (kBwdWarpSlots)
constexpr int kBlockSlots = 3;    // a block holds a row of up to 128 * this slots (kBwdBlockSlots)

// out_j of one slot from its t and m.
template <int R>
__device__ __forceinline__ float push(float tv, float mv, float beta, const float (&ref)[R],
                                      const float (&pr)[R]) {
  if (mv == 0.0f) return 0.0f;
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float d = tv - ref[r];
    const float phi = expf(__fmul_rn(-beta, __fmul_rn(d, d))) * mv;
    num += phi * pr[r];
    den += phi;
  }
  return num / (den + kNormEps) * mv;
}

// W = 1: grid ceil(rows / 4), a warp a row. W = 4: grid rows, a block a row.
// S > 0: thread `tl` of the row's team holds slots tl, tl + 32 W, ... (S of
// them, which must cover t_len). S = 0: it loops over its slots.
template <int R, int W, int S>
__global__ void __launch_bounds__(kRowThreads) rbf_push_kernel(
    const float* __restrict__ t, const float* __restrict__ m, const float* __restrict__ proj,
    const float* __restrict__ beta_c, const float* __restrict__ ref_t, float* __restrict__ out,
    int rows, int n_chan, int t_len) {
  constexpr int kTeam = 32 * W;
  constexpr int kTeams = kRowThreads / kTeam;  // rows a block
  const int warp = threadIdx.x >> 5;
  const int tl = W > 1 ? threadIdx.x : threadIdx.x & 31;
  const int row = W > 1 ? blockIdx.x : blockIdx.x * kTeams + warp;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * t_len;
  const float* tr = t + base;
  const float* mr = m + base;
  float* outr = out + base;

  float tv[S > 0 ? S : 1], mv[S > 0 ? S : 1];
  if constexpr (S > 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int j = tl + i * kTeam;
      const bool in = j < t_len;
      mv[i] = in ? mr[j] : 0.0f;
      tv[i] = in ? tr[j] : 0.0f;
    }
  }
  const float beta = beta_c[row % n_chan];
  float ref[R], pr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ref[r] = ref_t[r];
    pr[r] = proj[static_cast<size_t>(row) * R + r];
  }
  if constexpr (S > 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int j = tl + i * kTeam;
      if (j < t_len) outr[j] = push<R>(tv[i], mv[i], beta, ref, pr);
    }
  } else {
    for (int j = tl; j < t_len; j += kTeam) outr[j] = push<R>(tr[j], mr[j], beta, ref, pr);
  }
}

// The layout for rows of t_len slots: warps a row and slots a thread holds
// in registers (0: it loops). csrc/sci.cu's `row_layout`.
inline void row_layout(int t_len, int& warps, int& slots) {
  if (t_len <= 32 * kWarpSlots) {
    warps = 1;
    slots = (t_len + 31) / 32;
  } else {
    warps = kRowThreads / 32;
    slots = t_len <= kRowThreads * kBlockSlots ? (t_len + kRowThreads - 1) / kRowThreads : 0;
  }
}

template <int R, int W, int S, class... Args>
inline void launch(int rows, cudaStream_t s, Args... args) {
  const int rows_per_block = kRowThreads / (32 * W);
  rbf_push_kernel<R, W, S><<<(rows + rows_per_block - 1) / rows_per_block, kRowThreads, 0, s>>>(
      args...);
}

// The kernel of the layout (warps, slots), as row_layout chose it.
template <int R, class... Args>
inline void launch_layout(int warps, int slots, Args... args) {
  if (warps == 1) {
    if (slots == 1) launch<R, 1, 1>(args...); else launch<R, 1, 2>(args...);
  } else if (slots == 1) {
    launch<R, 4, 1>(args...);
  } else if (slots == 2) {
    launch<R, 4, 2>(args...);
  } else if (slots == 3) {
    launch<R, 4, 3>(args...);
  } else {
    launch<R, 4, 0>(args...);
  }
}
static_assert(kRowThreads == 4 * 32 && kWarpSlots == 2 && kBlockSlots == 3,
              "launch_layout names every layout row_layout can choose");

}  // namespace

// t, m: (rows, t_len) float32; proj: (rows, R); beta: (n_chan,); ref_t: (R,);
// out: (rows, t_len). `warps` and `slots` are the wrapper's layout
// (`sci_row_layout` in ops/cuda_interp.py) and must be this file's for t_len.
// Returns cudaGetLastError().
extern "C" int dicl_rbf_push(const void* t, const void* m, const void* proj, const void* beta,
                             const void* ref_t, void* out, int rows, int n_chan, int t_len,
                             int ref_points, int warps, int slots, void* stream) {
  if (rows < 1 || n_chan < 1 || t_len < 1) return cudaErrorInvalidValue;
  int want_warps, want_slots;
  row_layout(t_len, want_warps, want_slots);
  if (warps != want_warps || slots != want_slots) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* tp = static_cast<const float*>(t);
  const auto* mp = static_cast<const float*>(m);
  const auto* pp = static_cast<const float*>(proj);
  const auto* bp = static_cast<const float*>(beta);
  const auto* rp = static_cast<const float*>(ref_t);
  auto* op = static_cast<float*>(out);
  switch (ref_points) {
#define DICL_RBF_CASE(R_VALUE)                                                                  \
  case R_VALUE:                                                                                 \
    launch_layout<R_VALUE>(warps, slots, rows, s, tp, mp, pp, bp, rp, op, rows, n_chan, t_len); \
    break;
    DICL_RBF_CASE(1) DICL_RBF_CASE(2) DICL_RBF_CASE(3) DICL_RBF_CASE(4)
    DICL_RBF_CASE(5) DICL_RBF_CASE(6) DICL_RBF_CASE(7) DICL_RBF_CASE(8)
#undef DICL_RBF_CASE
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
