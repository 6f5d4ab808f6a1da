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
//
// Design: one thread per slot, consecutive threads on consecutive slots, so
// the plane loads and the store coalesce; R (<= 8) is unrolled in
// registers. Padded slots (m = 0) skip the exp and write 0, which is what
// the formula gives for finite inputs. The backward is PyTorch autodiff of
// the plain formula (cuda_interp.RBFFunction), as in the JAX package.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kNormEps = 1e-10f;
constexpr int kThreads = 256;

template <int R>
__global__ void rbf_push_kernel(const float* __restrict__ t,
                                const float* __restrict__ m,
                                const float* __restrict__ proj,
                                const float* __restrict__ beta_c,
                                const float* __restrict__ ref_t,
                                float* __restrict__ out, int64_t n, int n_chan,
                                int t_len) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float mv = m[i];
  if (mv == 0.0f) {
    out[i] = 0.0f;
    return;
  }
  const int64_t row = i / t_len;
  const float beta = beta_c[row % n_chan];
  const float tv = t[i];
  const float* pr = proj + row * R;
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float d = tv - ref_t[r];
    const float phi = expf(__fmul_rn(-beta, __fmul_rn(d, d))) * mv;
    num += phi * pr[r];
    den += phi;
  }
  out[i] = num / (den + kNormEps) * mv;
}

}  // namespace

// t, m: (rows, t_len) float32; proj: (rows, R); beta: (n_chan,); ref_t: (R,);
// out: (rows, t_len). Returns cudaGetLastError().
extern "C" int dicl_rbf_push(const void* t, const void* m, const void* proj,
                             const void* beta, const void* ref_t, void* out,
                             int rows, int n_chan, int t_len, int ref_points,
                             void* stream) {
  if (rows < 1 || n_chan < 1 || t_len < 1) return cudaErrorInvalidValue;
  const int64_t n = static_cast<int64_t>(rows) * t_len;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* tp = static_cast<const float*>(t);
  const auto* mp = static_cast<const float*>(m);
  const auto* pp = static_cast<const float*>(proj);
  const auto* bp = static_cast<const float*>(beta);
  const auto* rp = static_cast<const float*>(ref_t);
  auto* op = static_cast<float*>(out);
  switch (ref_points) {
    case 1: rbf_push_kernel<1><<<grid, kThreads, 0, s>>>(tp, mp, pp, bp, rp, op, n, n_chan, t_len); break;
    case 2: rbf_push_kernel<2><<<grid, kThreads, 0, s>>>(tp, mp, pp, bp, rp, op, n, n_chan, t_len); break;
    case 3: rbf_push_kernel<3><<<grid, kThreads, 0, s>>>(tp, mp, pp, bp, rp, op, n, n_chan, t_len); break;
    case 4: rbf_push_kernel<4><<<grid, kThreads, 0, s>>>(tp, mp, pp, bp, rp, op, n, n_chan, t_len); break;
    case 5: rbf_push_kernel<5><<<grid, kThreads, 0, s>>>(tp, mp, pp, bp, rp, op, n, n_chan, t_len); break;
    case 6: rbf_push_kernel<6><<<grid, kThreads, 0, s>>>(tp, mp, pp, bp, rp, op, n, n_chan, t_len); break;
    case 7: rbf_push_kernel<7><<<grid, kThreads, 0, s>>>(tp, mp, pp, bp, rp, op, n, n_chan, t_len); break;
    case 8: rbf_push_kernel<8><<<grid, kThreads, 0, s>>>(tp, mp, pp, bp, rp, op, n, n_chan, t_len); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
