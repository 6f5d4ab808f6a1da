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
// Design: one warp per row, so every reduction over T is a warp shuffle and
// a row's sums need no atomics and no second kernel: results do not depend
// on the run. Lanes stride the row, so loads coalesce. Pass 1 takes the
// per-r maxima (no exp), pass 2 the sums; the backward's pass 3 recomputes
// the softmaxes slot by slot. Passes 2 and 3 re-read the row from L1/L2,
// not device memory. Accurate expf/logf: the port's 1e-5 agreement with
// the plain version depends on it, so no --use_fast_math.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kKappa = 10.0f;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// -alpha (t - ref)^2, rounded step by step as the plain version does:
// __fmul_rn keeps nvcc from fusing the products into the following add.
__device__ __forceinline__ float logit(float alpha, float d) {
  return __fmul_rn(-alpha, __fmul_rn(d, d));
}

// Per-row maxima over observed slots and the four softmax sums of each r.
template <int R>
__device__ __forceinline__ void row_sums(const float* __restrict__ xr,
                                         const float* __restrict__ tr,
                                         const float* __restrict__ mr, int t_len,
                                         float alpha, const float (&ref)[R],
                                         int lane, float (&m)[R], float (&s)[R],
                                         float (&sx)[R], float (&st)[R],
                                         float (&stx)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) m[r] = -INFINITY;
  for (int j = lane; j < t_len; j += 32) {
    if (mr[j] > 0.0f) {
      const float tj = tr[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d = tj - ref[r];
        m[r] = fmaxf(m[r], logit(alpha, d));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = warp_max(m[r]);
    s[r] = sx[r] = st[r] = stx[r] = 0.0f;
  }
  for (int j = lane; j < t_len; j += 32) {
    if (mr[j] > 0.0f) {
      const float tj = tr[j];
      const float xj = xr[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d = tj - ref[r];
        const float l = logit(alpha, d);
        const float e = expf(l - m[r]);
        const float et = expf(__fmul_rn(kKappa, l) - __fmul_rn(kKappa, m[r]));
        s[r] += e;
        sx[r] += e * xj;
        st[r] += et;
        stx[r] += et * xj;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    s[r] = warp_sum(s[r]);
    sx[r] = warp_sum(sx[r]);
    st[r] = warp_sum(st[r]);
    stx[r] = warp_sum(stx[r]);
  }
}

template <int R>
__global__ void sci_fwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ t,
                               const float* __restrict__ mask,
                               const float* __restrict__ alpha_c,
                               const float* __restrict__ ref_t,
                               float* __restrict__ out, int rows, int n_chan,
                               int t_len) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const int c = row % n_chan;
  const int b = row / n_chan;
  const float alpha = alpha_c[c];
  float ref[R];
#pragma unroll
  for (int r = 0; r < R; ++r) ref[r] = ref_t[r];
  const size_t base = static_cast<size_t>(row) * t_len;

  float m[R], s[R], sx[R], st[R], stx[R];
  row_sums<R>(x + base, t + base, mask + base, t_len, alpha, ref, lane, m, s,
              sx, st, stx);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float* o = out + (static_cast<size_t>(b) * R + r) * 3 * n_chan;
      o[c] = sx[r] / s[r];
      o[n_chan + c] = m[r] + logf(s[r]);
      o[2 * n_chan + c] = stx[r] / st[r];
    }
  }
}

template <int R>
__global__ void sci_bwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ t,
                               const float* __restrict__ mask,
                               const float* __restrict__ alpha_c,
                               const float* __restrict__ ref_t,
                               const float* __restrict__ g,
                               float* __restrict__ dx, float* __restrict__ dt,
                               float* __restrict__ dm,
                               float* __restrict__ dalpha, int rows,
                               int n_chan, int t_len) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int c = row % n_chan;
  const int b = row / n_chan;
  const float alpha = alpha_c[c];
  float ref[R], gy[R], gw[R], gyt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ref[r] = ref_t[r];
    const float* gr = g + (static_cast<size_t>(b) * R + r) * 3 * n_chan;
    gy[r] = gr[c];
    gw[r] = gr[n_chan + c];
    gyt[r] = gr[2 * n_chan + c];
  }
  const size_t base = static_cast<size_t>(row) * t_len;
  const float* xr = x + base;
  const float* tr = t + base;
  const float* mr = mask + base;

  float m[R], s[R], sx[R], st[R], stx[R];
  row_sums<R>(xr, tr, mr, t_len, alpha, ref, lane, m, s, sx, st, stx);
  float y[R], yt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    y[r] = sx[r] / s[r];
    yt[r] = stx[r] / st[r];
  }

  const bool planes = dx != nullptr;
  float dal = 0.0f;
  for (int j = lane; j < t_len; j += 32) {
    float dxj = 0.0f, dtj = 0.0f, dmj = 0.0f;
    if (mr[j] > 0.0f) {
      const float tj = tr[j];
      const float xj = xr[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d = tj - ref[r];
        const float d2 = __fmul_rn(d, d);
        const float l = logit(alpha, d);
        const float p = expf(l - m[r]) / s[r];
        const float q = expf(__fmul_rn(kKappa, l) - __fmul_rn(kKappa, m[r])) / st[r];
        const float glog = p * (gw[r] + gy[r] * (xj - y[r]));
        const float glogt = q * (gyt[r] * (xj - yt[r]));
        const float gl = glog + kKappa * glogt;
        dxj += gy[r] * p + gyt[r] * q;
        dal -= gl * d2;
        dtj -= 2.0f * alpha * d * gl;
        dmj += glog + glogt;
      }
    }
    if (planes) {
      dx[base + j] = dxj;
      dt[base + j] = dtj;
      dm[base + j] = dmj;
    }
  }
  dal = warp_sum(dal);
  if (lane == 0) dalpha[row] = dal;
}

inline dim3 grid_for(int rows) {
  return dim3((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
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
// out: (rows / n_chan, R, 3 n_chan). Returns cudaGetLastError().
extern "C" int dicl_sci_fwd(const void* x, const void* t, const void* mask,
                            const void* alpha, const void* ref_t, void* out,
                            int rows, int n_chan, int t_len, int ref_points,
                            void* stream) {
  if (rows < 1 || n_chan < 1 || t_len < 1) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  DICL_SWITCH_R(ref_points,
    sci_fwd_kernel<R><<<grid_for(rows), 32 * kWarpsPerBlock, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(t),
        static_cast<const float*>(mask), static_cast<const float*>(alpha),
        static_cast<const float*>(ref_t), static_cast<float*>(out), rows,
        n_chan, t_len))
  return static_cast<int>(cudaGetLastError());
}

// As dicl_sci_fwd plus g: (rows / n_chan, R, 3 n_chan) cotangent. dx, dt, dm
// ((rows, t_len)) may all be null, then only dalpha ((rows,)) is written.
extern "C" int dicl_sci_bwd(const void* x, const void* t, const void* mask,
                            const void* alpha, const void* ref_t, const void* g,
                            void* dx, void* dt, void* dm, void* dalpha,
                            int rows, int n_chan, int t_len, int ref_points,
                            void* stream) {
  if (rows < 1 || n_chan < 1 || t_len < 1) return cudaErrorInvalidValue;
  if ((dx == nullptr) != (dt == nullptr) || (dx == nullptr) != (dm == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  DICL_SWITCH_R(ref_points,
    sci_bwd_kernel<R><<<grid_for(rows), 32 * kWarpsPerBlock, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(t),
        static_cast<const float*>(mask), static_cast<const float*>(alpha),
        static_cast<const float*>(ref_t), static_cast<const float*>(g),
        static_cast<float*>(dx), static_cast<float*>(dt),
        static_cast<float*>(dm), static_cast<float*>(dalpha), rows, n_chan,
        t_len))
  return static_cast<int>(cudaGetLastError());
}
