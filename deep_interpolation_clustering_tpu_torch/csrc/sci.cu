// SingleChannelInterp forward and backward for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels `_sci_kernel` (called by `_sci_pallas_raw`)
// and `_sci_bwd_kernel` (called by `_sci_bwd_pallas`) in
// deep_interpolation_clustering_tpu/ops/pallas_interp.py. Rows are the
// flattened (encounter, channel) pairs, row = b*C + c, each with T slots.
//
// Forward, for each reference point r (R <= 8, unrolled):
//   l_j = -alpha_c (t_j - ref_r)^2 on observed slots (mask > 0; the mask is
//   0/1, so log(mask) adds 0 there and padded slots drop out exactly)
//   w_r = m + log sum_j exp(l_j - m),        m = max_j l_j
//   y_r = sum_j exp(l_j - m) x_j / sum_j exp(l_j - m)
//   yt_r: the same with the kappa=10 sharpened logits 10 l_j (max 10 m)
// written straight into the (B, R, 3C) [y | w | yt] layout.
//
// Backward (the math of `_sci_bwd_kernel`'s docstring), with p, q the two
// softmaxes over the slots and g = (gy, gw, gyt) the output cotangent:
//   glog = p (gw + gy (x - y)),  glogt = q gyt (x - yt),  gl = glog + 10 glogt
//   dx = sum_r gy p + gyt q      dt = -2 alpha sum_r gl d      (d = t - ref_r)
//   dm = sum_r glog + glogt      dalpha_row = -sum_{j,r} gl d^2
// dx/dt/dm are zero on padded slots and are written only when asked for
// (training needs dalpha alone). dkernel = sum_b dalpha * sigmoid(kernel)
// is taken outside, in PyTorch.
//
// Bound on the H100: memory for the forward (three (rows, T) float planes
// in, a (B, R, 3C) block out) and for the backward that writes the plane
// cotangents; the backward that emits dalpha alone reads the same three
// planes. Each observed slot costs 2R accurate expf, about a third of the
// time the planes take to read at full bandwidth.
//
// Design of both kernels. What bounds them on the H100 is not the bytes
// (three planes, 6.5 MB at 1,536 x 354) but a serial chain in too few warps:
// 2R accurate expf per observed slot and the reductions over the row. So a
// row gets a team of threads wide enough to hold it in registers, chosen
// from T by the C entries (`sci_row_layout` in ops/cuda_interp.py is the
// same rule):
//   T <= 64          one warp a row (4 rows a block), 1 or 2 slots a lane;
//   64 < T <= 384    one block of 128 threads a row, 1 to 3 slots a thread;
//   T > 384          one block a row that loops over the row.
// Each thread reads its slots' x, t and mask once from device memory and
// keeps them. Phase 1 takes the per-r maxima; phase 2 computes e = exp(l - m)
// and et = exp(10 l - 10 m) once per (slot, r) and adds the four sums of
// each r. The maxima and the 4R sums are reduced over a warp by shuffles
// that halve the values a lane carries at each level (31 shuffles for 24
// sums, not 120), then over a block's four warps in warp order by the
// team's first R threads. Every reduction has a fixed order and there are no
// atomics: two runs give the same bits.
//
// The forward ends there: the first R threads write y, w and yt of their r.
//
// The backward keeps e and et for a third phase, the cotangents, where p
// and q are e and et times one reciprocal of the row's sums per r (the loop
// layout recomputes them instead), and reduces dalpha the same way. What the
// whole row shares (maxima, reciprocals, y, yt, the output cotangent) lives
// in shared memory, written by the team's first R threads, and not in every
// thread's registers. The dalpha of a call that also writes the planes
// equals that of a call that does not (the same instructions, rounded
// explicitly).
// Accurate expf/logf and the logits' step-by-step rounding: the port's 1e-5
// agreement with the plain version depends on them, so no --use_fast_math.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kKappa = 10.0f;

// -alpha (t - ref)^2, rounded step by step as the plain version does:
// __fmul_rn keeps nvcc from fusing the products into the following add.
__device__ __forceinline__ float logit(float alpha, float d) {
  return __fmul_rn(-alpha, __fmul_rn(d, d));
}

// --------------------------------------------------- the layout's constants
constexpr int kBwdThreads = 128;   // threads per block of both kernels
constexpr int kBwdWarpSlots = 2;   // a warp takes a row of up to 32 * this slots
constexpr int kBwdBlockSlots = 3;  // a block holds a row of up to kBwdThreads * this slots

__host__ __device__ constexpr int ceil_pow2(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}
__host__ __device__ constexpr int log2_of(int p) {
  int l = 0;
  for (; p > 1; p /= 2) ++l;
  return l;
}

// One level of the warp reduction below: the lanes O apart swap half of
// their N values and combine the half they keep, until one value is left,
// which the remaining levels combine as a butterfly.
template <int N, int O, int P, class Op>
__device__ __forceinline__ void warp_reduce_level(float (&v)[P], int lane, Op op) {
  if constexpr (O >= 1) {
    if constexpr (N > 1) {
      const bool upper = lane & O;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float keep = upper ? v[i + N / 2] : v[i];
        const float send = upper ? v[i] : v[i + N / 2];
        v[i] = op(keep, __shfl_xor_sync(0xffffffffu, send, O));
      }
      warp_reduce_level<N / 2, O / 2>(v, lane, op);
    } else {
      v[0] = op(v[0], __shfl_xor_sync(0xffffffffu, v[0], O));
      warp_reduce_level<1, O / 2>(v, lane, op);
    }
  }
}

// Reduces each of the P (a power of two <= 32) values over the warp's lanes
// in P - 1 shuffles (not 5 P) and a fixed order: afterwards v[0] of lane L
// is the warp's value of index L >> (5 - log2 P). The first `n` of them go
// to out[index].
template <int P, class Op>
__device__ __forceinline__ void warp_reduce_to(float (&v)[P], int n, float* out, int lane,
                                               Op op) {
  warp_reduce_level<P, 16>(v, lane, op);
  constexpr int kShift = 5 - log2_of(P);
  const int index = lane >> kShift;
  if ((lane & ((1 << kShift) - 1)) == 0 && index < n) out[index] = v[0];
}

// The threads of a row's team meet: a block (W warps a row) or a warp.
template <int W>
__device__ __forceinline__ void team_sync() {
  if constexpr (W > 1) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

// e = exp(l - m) and et = exp(10 l - 10 m) of one (slot, r), each product
// rounded on its own (km = 10 m), added into the four sums of r.
__device__ __forceinline__ void pair_exp(float alpha, float ref, float tj, float xj, float m,
                                         float km, float& e, float& et, float& s, float& sx,
                                         float& st, float& stx) {
  const float l = logit(alpha, tj - ref);
  e = expf(l - m);
  et = expf(__fmul_rn(kKappa, l) - km);
  s += e;
  sx = fmaf(e, xj, sx);
  st += et;
  stx = fmaf(et, xj, stx);
}

// ------------------------------------------------------------------- forward
// W = 1: grid ceil(rows / 4), a warp a row. W = 4: grid rows, a block a row.
// S > 0: thread `tl` of the row's team holds slots tl, tl + 32 W, ... (S of
// them, which must cover t_len) in registers. S = 0: it loops over its slots
// twice. The maxima live in shared memory; the team's first R threads write
// y, w and yt of their r. The backward below repeats phases 1 and 2.
template <int R, int W, int S>
__global__ void __launch_bounds__(kBwdThreads) sci_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ t, const float* __restrict__ mask,
    const float* __restrict__ alpha_c, const float* __restrict__ ref_t, float* __restrict__ out,
    int rows, int n_chan, int t_len) {
  constexpr int kTeam = 32 * W;
  constexpr int kTeams = kBwdThreads / kTeam;  // rows a block
  constexpr int kHeld = S > 0 ? S : 1;
  constexpr int PM = ceil_pow2(R);
  constexpr int PS = ceil_pow2(4 * R);
  __shared__ float red_m[kTeams][W][R];      // each warp's maxima
  __shared__ float red_s[kTeams][W][4 * R];  // each warp's [s | sx | st | stx]
  __shared__ float row_m[kTeams][R];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int team = W > 1 ? 0 : warp;
  const int team_warp = W > 1 ? warp : 0;
  const int tl = W > 1 ? threadIdx.x : lane;
  const int row = W > 1 ? blockIdx.x : blockIdx.x * kTeams + warp;
  if (row >= rows) return;  // W = 1: the whole warp leaves together; W > 1: no block does
  const int c = row % n_chan;
  const int b = row / n_chan;
  const float alpha = alpha_c[c];
  float ref[R];
#pragma unroll
  for (int r = 0; r < R; ++r) ref[r] = ref_t[r];
  const size_t base = static_cast<size_t>(row) * t_len;
  const float* xr = x + base;
  const float* tr = t + base;
  const float* mr = mask + base;

  // the held slots, read once
  float xs[kHeld], ts[kHeld];
  bool obs[kHeld];
  if constexpr (S > 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int j = tl + i * kTeam;
      const bool in = j < t_len;
      obs[i] = in && mr[j] > 0.0f;
      xs[i] = in ? xr[j] : 0.0f;
      ts[i] = in ? tr[j] : 0.0f;
    }
  }

  // 1. the per-r maxima over observed slots
  float m[PM];
#pragma unroll
  for (int r = 0; r < PM; ++r) m[r] = -INFINITY;
  if constexpr (S > 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (obs[i]) {
#pragma unroll
        for (int r = 0; r < R; ++r) m[r] = fmaxf(m[r], logit(alpha, ts[i] - ref[r]));
      }
    }
  } else {
    for (int j = tl; j < t_len; j += kTeam) {
      if (mr[j] > 0.0f) {
        const float tj = tr[j];
#pragma unroll
        for (int r = 0; r < R; ++r) m[r] = fmaxf(m[r], logit(alpha, tj - ref[r]));
      }
    }
  }
  warp_reduce_to<PM>(m, R, red_m[team][team_warp], lane,
                     [](float a, float v) { return fmaxf(a, v); });
  team_sync<W>();
  if (tl < R) {
    float a = red_m[team][0][tl];
#pragma unroll
    for (int w = 1; w < W; ++w) a = fmaxf(a, red_m[team][w][tl]);
    row_m[team][tl] = a;
  }
  team_sync<W>();

  // 2. each exponential once, and the four sums of each r
  float sums[PS];  // [s | sx | st | stx], each R wide
#pragma unroll
  for (int i = 0; i < PS; ++i) sums[i] = 0.0f;
  float e, et;  // not kept: the forward has no third pass
  if constexpr (S > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float m_r = row_m[team][r];
      const float km_r = __fmul_rn(kKappa, m_r);
#pragma unroll
      for (int i = 0; i < S; ++i) {
        if (obs[i]) {
          pair_exp(alpha, ref[r], ts[i], xs[i], m_r, km_r, e, et, sums[r], sums[R + r],
                   sums[2 * R + r], sums[3 * R + r]);
        }
      }
    }
  } else {
    for (int j = tl; j < t_len; j += kTeam) {
      if (mr[j] > 0.0f) {
        const float tj = tr[j];
        const float xj = xr[j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float m_r = row_m[team][r];
          pair_exp(alpha, ref[r], tj, xj, m_r, __fmul_rn(kKappa, m_r), e, et, sums[r],
                   sums[R + r], sums[2 * R + r], sums[3 * R + r]);
        }
      }
    }
  }
  warp_reduce_to<PS>(sums, 4 * R, red_s[team][team_warp], lane,
                     [](float a, float v) { return a + v; });
  team_sync<W>();
  if (tl < R) {
    float tot[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      tot[q] = red_s[team][0][q * R + tl];
#pragma unroll
      for (int w = 1; w < W; ++w) tot[q] += red_s[team][w][q * R + tl];
    }
    float* o = out + (static_cast<size_t>(b) * R + tl) * 3 * n_chan;
    o[c] = tot[1] / tot[0];
    o[n_chan + c] = row_m[team][tl] + logf(tot[0]);
    o[2 * n_chan + c] = tot[3] / tot[2];
  }
}

// ------------------------------------------------------------------ backward
// What the cotangent pass knows of the row for one r: the reciprocals of
// the two softmax sums, y, yt and the output cotangent.
struct RefTerms {
  float ref, inv_s, inv_st, y, yt, gy, gw, gyt;
};

// One observed (slot, r)'s share of dalpha and, when `planes`, of the
// slot's dx, dt, dm. The dalpha chain is rounded explicitly, so it is the
// same with and without the planes.
__device__ __forceinline__ void pair_cotangents(float alpha, const RefTerms& k, float tj,
                                                float xj, float e, float et, bool planes,
                                                float& dal, float& dxj, float& dtj,
                                                float& dmj) {
  const float d = tj - k.ref;
  const float p = __fmul_rn(e, k.inv_s);
  const float q = __fmul_rn(et, k.inv_st);
  const float glog = __fmul_rn(p, fmaf(k.gy, xj - k.y, k.gw));
  const float glogt = __fmul_rn(q, __fmul_rn(k.gyt, xj - k.yt));
  const float gl = fmaf(kKappa, glogt, glog);
  dal = fmaf(-gl, __fmul_rn(d, d), dal);
  if (planes) {
    dxj = fmaf(k.gy, p, fmaf(k.gyt, q, dxj));
    dtj = fmaf(-2.0f * alpha * d, gl, dtj);
    dmj += glog + glogt;
  }
}

// W = 1: grid ceil(rows / 4), a warp a row. W = 4: grid rows, a block a row.
// S > 0: thread `tl` of the row's team holds slots tl, tl + 32 W, ... (S of
// them, which must cover t_len) and their exponentials in registers. S = 0:
// it loops over its slots and recomputes. What is the same for the whole
// row (the maxima, the sums' reciprocals, y, yt, the output cotangent)
// lives in shared memory, written by the team's first R threads.
template <int R, int W, int S>
__global__ void __launch_bounds__(kBwdThreads) sci_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ t, const float* __restrict__ mask,
    const float* __restrict__ alpha_c, const float* __restrict__ ref_t,
    const float* __restrict__ g, float* __restrict__ dx, float* __restrict__ dt,
    float* __restrict__ dm, float* __restrict__ dalpha, int rows, int n_chan, int t_len) {
  constexpr int kTeam = 32 * W;
  constexpr int kTeams = kBwdThreads / kTeam;  // rows a block
  constexpr int kHeld = S > 0 ? S : 1;
  constexpr int PM = ceil_pow2(R);
  constexpr int PS = ceil_pow2(4 * R);
  __shared__ float red_m[kTeams][W][R];      // each warp's maxima
  __shared__ float red_s[kTeams][W][4 * R];  // each warp's [s | sx | st | stx]
  __shared__ float red_a[kTeams][W];         // each warp's dalpha
  __shared__ float row_m[kTeams][R];
  __shared__ float row_fin[kTeams][4 * R];   // [1/s | 1/st | y | yt]
  __shared__ float row_g[kTeams][3 * R];     // [gy | gw | gyt]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int team = W > 1 ? 0 : warp;
  const int team_warp = W > 1 ? warp : 0;
  const int tl = W > 1 ? threadIdx.x : lane;
  const int row = W > 1 ? blockIdx.x : blockIdx.x * kTeams + warp;
  if (row >= rows) return;  // W = 1: the whole warp leaves together; W > 1: no block does
  const int c = row % n_chan;
  const int b = row / n_chan;
  const float alpha = alpha_c[c];
  float ref[R];
#pragma unroll
  for (int r = 0; r < R; ++r) ref[r] = ref_t[r];
  if (tl < R) {  // read by the cotangent pass, two team_syncs from here
    const float* gr = g + (static_cast<size_t>(b) * R + tl) * 3 * n_chan;
    row_g[team][tl] = gr[c];
    row_g[team][R + tl] = gr[n_chan + c];
    row_g[team][2 * R + tl] = gr[2 * n_chan + c];
  }
  const size_t base = static_cast<size_t>(row) * t_len;
  const float* xr = x + base;
  const float* tr = t + base;
  const float* mr = mask + base;
  const bool planes = dx != nullptr;

  // the held slots, read once
  float xs[kHeld], ts[kHeld];
  bool obs[kHeld];
  if constexpr (S > 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int j = tl + i * kTeam;
      const bool in = j < t_len;
      obs[i] = in && mr[j] > 0.0f;
      xs[i] = in ? xr[j] : 0.0f;
      ts[i] = in ? tr[j] : 0.0f;
    }
  }

  // 1. the per-r maxima over observed slots
  float m[PM];
#pragma unroll
  for (int r = 0; r < PM; ++r) m[r] = -INFINITY;
  if constexpr (S > 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (obs[i]) {
#pragma unroll
        for (int r = 0; r < R; ++r) m[r] = fmaxf(m[r], logit(alpha, ts[i] - ref[r]));
      }
    }
  } else {
    for (int j = tl; j < t_len; j += kTeam) {
      if (mr[j] > 0.0f) {
        const float tj = tr[j];
#pragma unroll
        for (int r = 0; r < R; ++r) m[r] = fmaxf(m[r], logit(alpha, tj - ref[r]));
      }
    }
  }
  warp_reduce_to<PM>(m, R, red_m[team][team_warp], lane,
                     [](float a, float v) { return fmaxf(a, v); });
  team_sync<W>();
  if (tl < R) {
    float a = red_m[team][0][tl];
#pragma unroll
    for (int w = 1; w < W; ++w) a = fmaxf(a, red_m[team][w][tl]);
    row_m[team][tl] = a;
  }
  team_sync<W>();

  // 2. each exponential once, and the four sums of each r
  float e[kHeld][R], et[kHeld][R];
  float sums[PS];  // [s | sx | st | stx], each R wide
#pragma unroll
  for (int i = 0; i < PS; ++i) sums[i] = 0.0f;
  if constexpr (S > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float m_r = row_m[team][r];
      const float km_r = __fmul_rn(kKappa, m_r);
#pragma unroll
      for (int i = 0; i < S; ++i) {
        if (obs[i]) {
          pair_exp(alpha, ref[r], ts[i], xs[i], m_r, km_r, e[i][r], et[i][r], sums[r],
                   sums[R + r], sums[2 * R + r], sums[3 * R + r]);
        }
      }
    }
  } else {
    for (int j = tl; j < t_len; j += kTeam) {
      if (mr[j] > 0.0f) {
        const float tj = tr[j];
        const float xj = xr[j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float m_r = row_m[team][r];
          pair_exp(alpha, ref[r], tj, xj, m_r, __fmul_rn(kKappa, m_r), e[0][r], et[0][r],
                   sums[r], sums[R + r], sums[2 * R + r], sums[3 * R + r]);
        }
      }
    }
  }
  warp_reduce_to<PS>(sums, 4 * R, red_s[team][team_warp], lane,
                     [](float a, float v) { return a + v; });
  team_sync<W>();
  if (tl < R) {
    float tot[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      tot[q] = red_s[team][0][q * R + tl];
#pragma unroll
      for (int w = 1; w < W; ++w) tot[q] += red_s[team][w][q * R + tl];
    }
    row_fin[team][tl] = 1.0f / tot[0];
    row_fin[team][R + tl] = 1.0f / tot[2];
    row_fin[team][2 * R + tl] = tot[1] / tot[0];
    row_fin[team][3 * R + tl] = tot[3] / tot[2];
  }
  team_sync<W>();

  // 3. the cotangents
  float dal[1] = {0.0f};
  const auto terms = [&](int r) {
    return RefTerms{ref[r], row_fin[team][r], row_fin[team][R + r], row_fin[team][2 * R + r],
                    row_fin[team][3 * R + r], row_g[team][r], row_g[team][R + r],
                    row_g[team][2 * R + r]};
  };
  if constexpr (S > 0) {
    float dxj[S], dtj[S], dmj[S];
#pragma unroll
    for (int i = 0; i < S; ++i) dxj[i] = dtj[i] = dmj[i] = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const RefTerms k = terms(r);
#pragma unroll
      for (int i = 0; i < S; ++i) {
        if (obs[i]) {
          pair_cotangents(alpha, k, ts[i], xs[i], e[i][r], et[i][r], planes, dal[0], dxj[i],
                          dtj[i], dmj[i]);
        }
      }
    }
    if (planes) {
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int j = tl + i * kTeam;
        if (j < t_len) {
          dx[base + j] = dxj[i];
          dt[base + j] = dtj[i];
          dm[base + j] = dmj[i];
        }
      }
    }
  } else {
    for (int j = tl; j < t_len; j += kTeam) {
      float dxj = 0.0f, dtj = 0.0f, dmj = 0.0f;
      if (mr[j] > 0.0f) {
        const float tj = tr[j];
        const float xj = xr[j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float m_r = row_m[team][r];
          float unused[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          pair_exp(alpha, ref[r], tj, xj, m_r, __fmul_rn(kKappa, m_r), e[0][r], et[0][r],
                   unused[0], unused[1], unused[2], unused[3]);
          pair_cotangents(alpha, terms(r), tj, xj, e[0][r], et[0][r], planes, dal[0], dxj, dtj,
                          dmj);
        }
      }
      if (planes) {
        dx[base + j] = dxj;
        dt[base + j] = dtj;
        dm[base + j] = dmj;
      }
    }
  }
  warp_reduce_to<1>(dal, 1, &red_a[team][team_warp], lane,
                    [](float a, float v) { return a + v; });
  team_sync<W>();
  if (tl == 0) {
    float a = red_a[team][0];
#pragma unroll
    for (int w = 1; w < W; ++w) a += red_a[team][w];
    dalpha[row] = a;
  }
}

// The layout of both kernels for rows of t_len slots: warps a row and slots
// a thread holds in registers (0: it loops).
inline void row_layout(int t_len, int& warps, int& slots) {
  if (t_len <= 32 * kBwdWarpSlots) {
    warps = 1;
    slots = (t_len + 31) / 32;
  } else {
    warps = kBwdThreads / 32;
    slots = t_len <= kBwdThreads * kBwdBlockSlots ? (t_len + kBwdThreads - 1) / kBwdThreads : 0;
  }
}

template <int R, int W, int S, class... Args>
inline void launch_bwd(int rows, cudaStream_t s, Args... args) {
  const int rows_per_block = kBwdThreads / (32 * W);
  sci_bwd_kernel<R, W, S><<<(rows + rows_per_block - 1) / rows_per_block, kBwdThreads, 0, s>>>(
      args...);
}

// The kernel of the layout (warps, slots), as row_layout chose it.
template <int R, class... Args>
inline void launch_bwd_layout(int warps, int slots, Args... args) {
  if (warps == 1) {
    if (slots == 1) launch_bwd<R, 1, 1>(args...); else launch_bwd<R, 1, 2>(args...);
  } else if (slots == 1) {
    launch_bwd<R, 4, 1>(args...);
  } else if (slots == 2) {
    launch_bwd<R, 4, 2>(args...);
  } else if (slots == 3) {
    launch_bwd<R, 4, 3>(args...);
  } else {
    launch_bwd<R, 4, 0>(args...);
  }
}
static_assert(kBwdThreads == 4 * 32 && kBwdWarpSlots == 2 && kBwdBlockSlots == 3,
              "launch_bwd_layout and launch_fwd_layout name every layout row_layout can choose");

template <int R, int W, int S, class... Args>
inline void launch_fwd(int rows, cudaStream_t s, Args... args) {
  const int rows_per_block = kBwdThreads / (32 * W);
  sci_fwd_kernel<R, W, S><<<(rows + rows_per_block - 1) / rows_per_block, kBwdThreads, 0, s>>>(
      args...);
}

template <int R, class... Args>
inline void launch_fwd_layout(int warps, int slots, Args... args) {
  if (warps == 1) {
    if (slots == 1) launch_fwd<R, 1, 1>(args...); else launch_fwd<R, 1, 2>(args...);
  } else if (slots == 1) {
    launch_fwd<R, 4, 1>(args...);
  } else if (slots == 2) {
    launch_fwd<R, 4, 2>(args...);
  } else if (slots == 3) {
    launch_fwd<R, 4, 3>(args...);
  } else {
    launch_fwd<R, 4, 0>(args...);
  }
}

}  // namespace

#define DICL_SWITCH_R(R_VALUE, ...)          \
  switch (R_VALUE) {                         \
    case 1: { constexpr int R = 1; __VA_ARGS__; break; } \
    case 2: { constexpr int R = 2; __VA_ARGS__; break; } \
    case 3: { constexpr int R = 3; __VA_ARGS__; break; } \
    case 4: { constexpr int R = 4; __VA_ARGS__; break; } \
    case 5: { constexpr int R = 5; __VA_ARGS__; break; } \
    case 6: { constexpr int R = 6; __VA_ARGS__; break; } \
    case 7: { constexpr int R = 7; __VA_ARGS__; break; } \
    case 8: { constexpr int R = 8; __VA_ARGS__; break; } \
    default: return cudaErrorInvalidValue;   \
  }

// x, t, mask: (rows, t_len) float32; alpha: (n_chan,); ref_t: (R,);
// out: (rows / n_chan, R, 3 n_chan). `warps` and `slots` are the wrapper's
// layout (`sci_row_layout` in ops/cuda_interp.py) and must be this file's for
// t_len. Returns cudaGetLastError().
extern "C" int dicl_sci_fwd(const void* x, const void* t, const void* mask,
                            const void* alpha, const void* ref_t, void* out,
                            int rows, int n_chan, int t_len, int ref_points,
                            int warps, int slots, void* stream) {
  if (rows < 1 || n_chan < 1 || t_len < 1) return cudaErrorInvalidValue;
  int want_warps, want_slots;
  row_layout(t_len, want_warps, want_slots);
  if (warps != want_warps || slots != want_slots) return cudaErrorInvalidValue;
  DICL_SWITCH_R(ref_points,
    launch_fwd_layout<R>(
        warps, slots, rows, static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
        static_cast<const float*>(t), static_cast<const float*>(mask),
        static_cast<const float*>(alpha), static_cast<const float*>(ref_t),
        static_cast<float*>(out), rows, n_chan, t_len))
  return static_cast<int>(cudaGetLastError());
}

// As dicl_sci_fwd plus g: (rows / n_chan, R, 3 n_chan) cotangent. dx, dt, dm
// ((rows, t_len)) may all be null, then only dalpha ((rows,)) is written.
// `warps` and `slots` are the wrapper's layout (`sci_row_layout` in
// ops/cuda_interp.py) and must be this file's for t_len.
extern "C" int dicl_sci_bwd(const void* x, const void* t, const void* mask,
                            const void* alpha, const void* ref_t, const void* g,
                            void* dx, void* dt, void* dm, void* dalpha,
                            int rows, int n_chan, int t_len, int ref_points,
                            int warps, int slots, void* stream) {
  if (rows < 1 || n_chan < 1 || t_len < 1) return cudaErrorInvalidValue;
  if ((dx == nullptr) != (dt == nullptr) || (dx == nullptr) != (dm == nullptr)) {
    return cudaErrorInvalidValue;
  }
  int want_warps, want_slots;
  row_layout(t_len, want_warps, want_slots);
  if (warps != want_warps || slots != want_slots) return cudaErrorInvalidValue;
  DICL_SWITCH_R(ref_points,
    launch_bwd_layout<R>(
        warps, slots, rows, static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
        static_cast<const float*>(t), static_cast<const float*>(mask),
        static_cast<const float*>(alpha), static_cast<const float*>(ref_t),
        static_cast<const float*>(g), static_cast<float*>(dx), static_cast<float*>(dt),
        static_cast<float*>(dm), static_cast<float*>(dalpha), rows, n_chan, t_len))
  return static_cast<int>(cudaGetLastError());
}
