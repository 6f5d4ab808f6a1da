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
// (batch tiles of kRows rows, direction); one thread per hidden unit j owns
// that unit's four gates for the tile's rows and keeps their c in registers.
// The tile's h lives in shared memory, laid out (k, row) so that one float4
// pair broadcasts all kRows values of h[:, k]; each W_hh^T element read
// (from L2: one direction's W_hh is 4H x H floats = 256 KB at H=128, more
// than a block's shared memory, and both directions stay resident in the
// 50 MB L2) feeds kRows FMAs. A row lives in one block, so two
// __syncthreads per step are the only synchronisation.
//
// Backward design: as the TPU kernel, it recomputes the gates from the saved
// h/c and saves no activations. The same (tile, direction) blocks walk the
// steps in reverse with dh and dc of the tile's rows in registers; the
// tile's dpre (kRows x 4H) goes to shared memory so that each thread can
// form its unit's dh = dpre W_hh. dW_hh^T and db_hh sum over every (t, row)
// pair of all tiles: on the TPU they accumulate across a sequential grid, but
// Hopper's blocks run in no order. So two more kernels follow on the stream:
// a tiled float32 product h_prev^T dpre over fixed chunks of the (t, row)
// axis writes per-chunk partials into a scratch buffer from the wrapper, and
// a last pass sums the partials in chunk order. No float atomics: two runs
// give the same bits.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;         // batch rows per block of the recurrence
constexpr int kMaxHidden = 256;  // one thread per hidden unit

__device__ __forceinline__ float sigmoid_acc(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[q][r] = sum_k h[r][k] * w[k][q*H + j] for the four gates q of unit j,
// h in shared memory as hs4[(k * kRows + r) / 4], w = W_hh^T (H, 4H).
__device__ __forceinline__ void gate_products(const float* __restrict__ w,
                                              const float4* hs4, int hidden,
                                              int j, float (&acc)[4][kRows]) {
  const int G = 4 * hidden;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[q][r] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < hidden; ++k) {
    const float* wk = w + static_cast<size_t>(k) * G + j;
    const float wq[4] = {__ldg(wk), __ldg(wk + hidden), __ldg(wk + 2 * hidden),
                         __ldg(wk + 3 * hidden)};
    const float4 a = hs4[2 * k];
    const float4 b = hs4[2 * k + 1];
    const float h[kRows] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[q][r] = fmaf(h[r], wq[q], acc[q][r]);
  }
}

struct Gates {
  float i, f, g, o;
};

__device__ __forceinline__ Gates activate(const float* __restrict__ x,
                                          const float (&acc)[4][kRows], int r,
                                          const float (&bias)[4], int hidden) {
  // (xg + h W_hh^T) + b_hh, the JAX association order
  const float pi = __fadd_rn(__fadd_rn(x[0], acc[0][r]), bias[0]);
  const float pf = __fadd_rn(__fadd_rn(x[hidden], acc[1][r]), bias[1]);
  const float pg = __fadd_rn(__fadd_rn(x[2 * hidden], acc[2][r]), bias[2]);
  const float po = __fadd_rn(__fadd_rn(x[3 * hidden], acc[3][r]), bias[3]);
  return {sigmoid_acc(pi), sigmoid_acc(pf), tanhf(pg), sigmoid_acc(po)};
}

__global__ void __launch_bounds__(kMaxHidden) lstm_fwd_kernel(
    const float* __restrict__ xgf, const float* __restrict__ xgb,
    const float* __restrict__ w_hhT, const float* __restrict__ b_hh,
    const float* __restrict__ h0, const float* __restrict__ c0,
    float* __restrict__ ysf, float* __restrict__ ysb, float* __restrict__ csf,
    float* __restrict__ csb, int t_len, int batch, int hidden) {
  __shared__ float4 hs4[kMaxHidden * kRows / 4];
  float* hs = reinterpret_cast<float*>(hs4);
  const int d = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int j = threadIdx.x;
  const int G = 4 * hidden;
  const float* xg = d ? xgb : xgf;
  float* ys = d ? ysb : ysf;
  float* cs = d ? csb : csf;
  const float* w = w_hhT + static_cast<size_t>(d) * hidden * G;
  float bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bias[q] = b_hh[d * G + q * hidden + j];

  float c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    const size_t o = (static_cast<size_t>(d) * batch + row) * hidden + j;
    const bool ok = row < batch;
    hs[j * kRows + r] = ok ? h0[o] : 0.0f;
    c[r] = ok ? c0[o] : 0.0f;
  }
  __syncthreads();

  for (int s = 0; s < t_len; ++s) {
    const int t = d ? t_len - 1 - s : s;
    float acc[4][kRows];
    gate_products(w, hs4, hidden, j, acc);
    __syncthreads();  // every thread has read h before it is overwritten
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (row >= batch) continue;
      const size_t base = static_cast<size_t>(t) * batch + row;
      const Gates a = activate(xg + base * G + j, acc, r, bias, hidden);
      c[r] = __fadd_rn(__fmul_rn(a.f, c[r]), __fmul_rn(a.i, a.g));
      const float h = __fmul_rn(a.o, tanhf(c[r]));
      ys[base * hidden + j] = h;
      cs[base * hidden + j] = c[r];
      hs[j * kRows + r] = h;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kMaxHidden) lstm_bwd_kernel(
    const float* __restrict__ xgf, const float* __restrict__ xgb,
    const float* __restrict__ w_hhT, const float* __restrict__ w_hh,
    const float* __restrict__ b_hh, const float* __restrict__ h0,
    const float* __restrict__ c0, const float* __restrict__ ysf,
    const float* __restrict__ ysb, const float* __restrict__ csf,
    const float* __restrict__ csb, const float* __restrict__ dysf,
    const float* __restrict__ dysb, const float* __restrict__ dcsf,
    const float* __restrict__ dcsb, float* __restrict__ dxgf,
    float* __restrict__ dxgb, float* __restrict__ dh0, float* __restrict__ dc0,
    int t_len, int batch, int hidden) {
  __shared__ float4 hs4[kMaxHidden * kRows / 4];
  __shared__ float4 dp4[4 * kMaxHidden * kRows / 4];
  float* hs = reinterpret_cast<float*>(hs4);
  float* dp = reinterpret_cast<float*>(dp4);  // (n, row) for n in [0, 4H)
  const int d = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int j = threadIdx.x;
  const int G = 4 * hidden;
  const float* xg = d ? xgb : xgf;
  const float* ys = d ? ysb : ysf;
  const float* cs = d ? csb : csf;
  const float* dys = d ? dysb : dysf;
  const float* dcs = d ? dcsb : dcsf;
  float* dxg = d ? dxgb : dxgf;
  const float* w = w_hhT + static_cast<size_t>(d) * hidden * G;
  const float* wt = w_hh + static_cast<size_t>(d) * G * hidden;
  float bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bias[q] = b_hh[d * G + q * hidden + j];

  float dh[kRows], dc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) dh[r] = dc[r] = 0.0f;

  for (int s = t_len - 1; s >= 0; --s) {
    const int t = d ? t_len - 1 - s : s;
    const int t_prev = d ? t_len - s : s - 1;  // read only when s > 0
    float c_prev[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      float hv = 0.0f, cv = 0.0f;
      if (row < batch) {
        if (s > 0) {
          const size_t o = (static_cast<size_t>(t_prev) * batch + row) * hidden + j;
          hv = ys[o];
          cv = cs[o];
        } else {
          const size_t o = (static_cast<size_t>(d) * batch + row) * hidden + j;
          hv = h0[o];
          cv = c0[o];
        }
      }
      hs[j * kRows + r] = hv;
      c_prev[r] = cv;
    }
    __syncthreads();
    float acc[4][kRows];
    gate_products(w, hs4, hidden, j, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      float dpre[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (row < batch) {
        const size_t base = static_cast<size_t>(t) * batch + row;
        const Gates a = activate(xg + base * G + j, acc, r, bias, hidden);
        const float tc = tanhf(cs[base * hidden + j]);
        dh[r] += dys[base * hidden + j];
        dc[r] += dcs[base * hidden + j];
        const float d_o = dh[r] * tc;
        dc[r] += dh[r] * a.o * (1.0f - tc * tc);
        const float di = dc[r] * a.g;
        const float df = dc[r] * c_prev[r];
        const float dg = dc[r] * a.i;
        dpre[0] = di * a.i * (1.0f - a.i);
        dpre[1] = df * a.f * (1.0f - a.f);
        dpre[2] = dg * (1.0f - a.g * a.g);
        dpre[3] = d_o * a.o * (1.0f - a.o);
        float* dx = dxg + base * G + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) dx[q * hidden] = dpre[q];
        dc[r] *= a.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) dp[(q * hidden + j) * kRows + r] = dpre[q];
    }
    __syncthreads();
    // dh[r] = sum_n dpre[r][n] * W_hh[n][j], W_hh (4H, H)
    float acc2[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc2[r] = 0.0f;
#pragma unroll 4
    for (int n = 0; n < G; ++n) {
      const float wv = __ldg(wt + static_cast<size_t>(n) * hidden + j);
      const float4 a = dp4[2 * n];
      const float4 b = dp4[2 * n + 1];
      const float v[kRows] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc2[r] = fmaf(v[r], wv, acc2[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) dh[r] = acc2[r];
    __syncthreads();  // hs and dp are rewritten by the next step
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row >= batch) continue;
    const size_t o = (static_cast<size_t>(d) * batch + row) * hidden + j;
    dh0[o] = dh[r];
    dc0[o] = dc[r];
  }
}

// ------------------------------------------------ dW_hh^T and db_hh partials
constexpr int kTileK = 32;   // rows k of dW_hh^T per block
constexpr int kTileN = 64;   // columns n per block
constexpr int kChunkM = 16;  // (t, row) pairs per shared-memory stage
constexpr int kGemmThreads = 256;

// h_prev of direction d at the m-th (t, row) pair, m = t * batch + row:
// the state the step at time t started from.
__device__ __forceinline__ float h_prev_at(int d, int m, int k, int t_len,
                                           int batch, int hidden,
                                           const float* __restrict__ h0,
                                           const float* __restrict__ ysf,
                                           const float* __restrict__ ysb) {
  const int t = m / batch;
  const int r = m - t * batch;
  if (d == 0) {
    return t == 0 ? h0[static_cast<size_t>(r) * hidden + k]
                  : ysf[(static_cast<size_t>(t - 1) * batch + r) * hidden + k];
  }
  return t == t_len - 1
             ? h0[(static_cast<size_t>(batch) + r) * hidden + k]
             : ysb[(static_cast<size_t>(t + 1) * batch + r) * hidden + k];
}

// Grid (ceil(4H / kTileN), ceil(H / kTileK), 2 * nsplit): block z = 2 * split
// + d sums m over [split * chunk, (split + 1) * chunk) in increasing order.
// Thread (ty, tx) owns k = k0 + 2 ty + {0, 1}, n = n0 + 4 tx + {0..3}; the
// threads with ty = 0 of the first k tile also sum db over the same m.
__global__ void __launch_bounds__(kGemmThreads) lstm_dw_partial_kernel(
    const float* __restrict__ h0, const float* __restrict__ ysf,
    const float* __restrict__ ysb, const float* __restrict__ dxgf,
    const float* __restrict__ dxgb, float* __restrict__ dw_part,
    float* __restrict__ db_part, int t_len, int batch, int hidden, int chunk) {
  __shared__ float as[kChunkM][kTileK];
  __shared__ __align__(16) float bs[kChunkM][kTileN];
  const int G = 4 * hidden;
  const int n0 = blockIdx.x * kTileN;
  const int k0 = blockIdx.y * kTileK;
  const int d = blockIdx.z & 1;
  const int split = blockIdx.z >> 1;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m_total = t_len * batch;
  const int m_begin = split * chunk;
  const int m_end = min(m_total, m_begin + chunk);
  const float* dxg = d ? dxgb : dxgf;
  const bool db_thread = blockIdx.y == 0 && ty == 0;

  float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
  float dbs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int m0 = m_begin; m0 < m_end; m0 += kChunkM) {
    for (int i = tid; i < kChunkM * kTileK; i += kGemmThreads) {
      const int mm = i / kTileK, kk = i % kTileK;
      const int m = m0 + mm, k = k0 + kk;
      as[mm][kk] = (m < m_end && k < hidden)
                       ? h_prev_at(d, m, k, t_len, batch, hidden, h0, ysf, ysb)
                       : 0.0f;
    }
    for (int i = tid; i < kChunkM * kTileN; i += kGemmThreads) {
      const int mm = i / kTileN, nn = i % kTileN;
      const int m = m0 + mm, n = n0 + nn;
      bs[mm][nn] = (m < m_end && n < G) ? dxg[static_cast<size_t>(m) * G + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < kChunkM; ++mm) {
      const float a[2] = {as[mm][2 * ty], as[mm][2 * ty + 1]};
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[mm][4 * tx]);
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) acc[i][jn] = fmaf(a[i], b[jn], acc[i][jn]);
      if (db_thread) {
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) dbs[jn] += b[jn];
      }
    }
    __syncthreads();
  }
  const size_t plane = static_cast<size_t>(split) * 2 + d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = k0 + 2 * ty + i;
    if (k >= hidden) continue;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int n = n0 + 4 * tx + jn;
      if (n < G) dw_part[(plane * hidden + k) * G + n] = acc[i][jn];
    }
  }
  if (db_thread) {
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int n = n0 + 4 * tx + jn;
      if (n < G) db_part[plane * G + n] = dbs[jn];
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
// ysf, ysb, csf, csb: (T, B, H). float32, contiguous. Returns
// cudaGetLastError().
extern "C" int dicl_lstm_fwd(const void* xgf, const void* xgb, const void* w_hhT,
                             const void* b_hh, const void* h0, const void* c0,
                             void* ysf, void* ysb, void* csf, void* csb, int t_len,
                             int batch, int hidden, void* stream) {
  if (bad_shape(t_len, batch, hidden)) return cudaErrorInvalidValue;
  const dim3 grid((batch + kRows - 1) / kRows, 2);
  lstm_fwd_kernel<<<grid, hidden, 0, static_cast<cudaStream_t>(stream)>>>(
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
// (nsplit, 2, 4H) are scratch. Three launches on `stream`; returns the first
// cudaGetLastError() that is not 0.
extern "C" int dicl_lstm_bwd(
    const void* xgf, const void* xgb, const void* w_hhT, const void* w_hh,
    const void* b_hh, const void* h0, const void* c0, const void* ysf,
    const void* ysb, const void* csf, const void* csb, const void* dysf,
    const void* dysb, const void* dcsf, const void* dcsb, void* dxgf, void* dxgb,
    void* dw_hhT, void* db_hh, void* dh0, void* dc0, void* dw_part, void* db_part,
    int t_len, int batch, int hidden, int nsplit, void* stream) {
  if (bad_shape(t_len, batch, hidden) || nsplit < 1 || nsplit > 1024) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const dim3 grid((batch + kRows - 1) / kRows, 2);
  lstm_bwd_kernel<<<grid, hidden, 0, s>>>(
      f(xgf), f(xgb), f(w_hhT), f(w_hh), f(b_hh), f(h0), f(c0), f(ysf), f(ysb),
      f(csf), f(csb), f(dysf), f(dysb), f(dcsf), f(dcsb), static_cast<float*>(dxgf),
      static_cast<float*>(dxgb), static_cast<float*>(dh0), static_cast<float*>(dc0),
      t_len, batch, hidden);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int G = 4 * hidden;
  const int m_total = t_len * batch;
  const int chunk = (m_total + nsplit - 1) / nsplit;
  const dim3 ggrid((G + kTileN - 1) / kTileN, (hidden + kTileK - 1) / kTileK, 2 * nsplit);
  lstm_dw_partial_kernel<<<ggrid, kGemmThreads, 0, s>>>(
      f(h0), f(ysf), f(ysb), static_cast<const float*>(dxgf),
      static_cast<const float*>(dxgb), static_cast<float*>(dw_part),
      static_cast<float*>(db_part), t_len, batch, hidden, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_dw = 2 * hidden * G;
  const int n_db = 2 * G;
  lstm_dw_reduce_kernel<<<(n_dw + n_db + 255) / 256, 256, 0, s>>>(
      f(dw_part), f(db_part), static_cast<float*>(dw_hhT), static_cast<float*>(db_hh),
      n_dw, n_db, nsplit);
  return static_cast<int>(cudaGetLastError());
}
