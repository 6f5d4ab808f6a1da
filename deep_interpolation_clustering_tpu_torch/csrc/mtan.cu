// mTAN's encoder attention for Hopper (sm_90a): per-channel multi-time
// attention of the shared reference-time queries over each channel's own
// observed times, forward and backward, from two C entries.
//
// Replaces no Pallas kernel. The JAX package has no mTAN; mTAN's own code
// (github.com/reml-lab/mTAN, `multiTimeAttention.attention`) repeats the
// (B, R, keys) scores over the value columns and softmaxes each copy under its
// column's mask, a (B, R, keys, 2C) tensor. Here a head is one (encounter,
// channel): its keys are that channel's T slots, its values the channel's
// observations and mask (columns c and C + c of mTAN's [x ; m], which both
// take channel c's mask), so no tensor with both an (R, T) pair and a value
// axis exists, in device memory or anywhere else.
//
//   mtan_attn_fwd_kernel  for each head and query r: the scores q_r . k_t *
//                         scale over the observed keys (mask != 0), an online
//                         softmax over chunks of kKeys keys, and the weighted
//                         sums of ob and of mask; the row's max and log-sum.
//                         A head with no observed key takes the uniform
//                         average over its T slots, which is what mTAN's
//                         -1e9 fill gives.
//   mtan_attn_bwd_kernel  recomputes each chunk's scores, alpha = exp(s - lse)
//                         and ds = alpha * (g . v - g . out); writes dK and
//                         the cotangent of ob, and accumulates dQ over its
//                         heads in registers, written as the block's partial.
//   mtan_dq_sum_kernel    dQ: the blocks' partials summed in block order.
// A chunk with no observed key is skipped (its dK and dob rows written 0):
// the work follows the observed slots, not T. No float atomics: a run
// repeats bit for bit.
//
// Bound on the H100: float32 operations. At R = 128 queries and D = 128 a
// head does 2 * R * D operations a key forward (the scores) and 6 * R * D
// backward (the scores again, dK and dQ), against 4 * D bytes of K read (and
// dK written): some 64 operations a byte, above the card's 20 (67 TFLOP/s
// over 3.35 TB/s). The queries sit in shared memory for the whole block
// (every head shares them), a chunk of keys beside them, and each thread
// computes a 4 x 4 tile of scores (queries ty + 32i, keys tx + 8j) from
// float4 loads, two loads for 16 FMAs; rows padded to 132 floats so that the
// 8 threads of a quarter warp read 8 consecutive rows without a conflict.
// Blocks are persistent: block b takes heads b, b + G, b + 2G, ...

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kR = 128;        // the most queries a head takes (ops/cuda_mtan.py: MAX_QUERIES)
constexpr int kD = 128;        // the widest query and key (ops/cuda_mtan.py: MAX_DIM)
constexpr int kKeys = 32;      // keys a chunk
constexpr int kThreads = 256;
constexpr int kStride = kD + 4;   // a row of Qs and Ks in shared memory
constexpr int kSStride = kKeys + 1;  // a row of the score tile
constexpr int kRowGroups = kThreads / kKeys;  // the elementwise pass: 8 groups of rows
constexpr float kMasked = -1e9f;  // mTAN's fill of a masked score

// shared memory, in floats: Qs, Ks, the score tile, the chunk's ob and mask,
// four per-row vectors and the elementwise pass's per-group column sums
constexpr int kSmemFloats = kR * kStride + kKeys * kStride + kR * kSStride + 2 * kKeys +
                            4 * kR + kRowGroups * kKeys + 4;
constexpr int kSmemBytes = kSmemFloats * 4;
static_assert(kSmemBytes <= 232448, "a Hopper block's shared memory");

struct Smem {
  float* q;     // [kR][kStride]
  float* k;     // [kKeys][kStride]
  float* s;     // [kR][kSStride]
  float* vob;   // [kKeys]
  float* vm;    // [kKeys]
  float* row0;  // [kR] x 4
  float* part;  // [kRowGroups][kKeys]
  float* misc;  // [4]
};

__device__ __forceinline__ Smem carve(float* base) {
  Smem m;
  m.q = base;
  m.k = m.q + kR * kStride;
  m.s = m.k + kKeys * kStride;
  m.vob = m.s + kR * kSStride;
  m.vm = m.vob + kKeys;
  m.row0 = m.vm + kKeys;
  m.part = m.row0 + 4 * kR;
  m.misc = m.part + kRowGroups * kKeys;
  return m;
}

// The shared queries into m.q, rows past r and columns past d zero.
__device__ __forceinline__ void load_queries(const Smem& m, const float* q, int r, int d) {
  for (int i = threadIdx.x; i < kR * kD; i += kThreads) {
    const int row = i / kD, col = i % kD;
    m.q[row * kStride + col] = (row < r && col < d) ? q[row * d + col] : 0.0f;
  }
}

// The chunk's mask and ob into m.vm, m.vob (zero past t_len); returns, to
// every thread, whether any of its keys is observed. A barrier.
__device__ __forceinline__ bool load_chunk_values(const Smem& m, const float* ob,
                                                  const float* mask, int64_t base, int t0,
                                                  int t_len) {
  float mv = 0.0f;
  if (threadIdx.x < kKeys) {
    const int t = t0 + threadIdx.x;
    mv = t < t_len ? mask[base + t] : 0.0f;
    m.vm[threadIdx.x] = mv;
    m.vob[threadIdx.x] = t < t_len ? ob[base + t] : 0.0f;
  }
  return __syncthreads_or(mv != 0.0f) != 0;
}

// The chunk's keys into m.k (rows past t_len zero), d a multiple of 4.
__device__ __forceinline__ void load_keys(const Smem& m, const float* k, int64_t base, int t0,
                                          int t_len, int d) {
  const int quads = d / 4;
  for (int i = threadIdx.x; i < kKeys * quads; i += kThreads) {
    const int j = i / quads, c = (i % quads) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (t0 + j < t_len) v = *reinterpret_cast<const float4*>(k + (base + t0 + j) * d + c);
    *reinterpret_cast<float4*>(m.k + j * kStride + c) = v;
  }
}

// The chunk's scaled scores into m.s: thread (ty, tx) computes queries
// ty + 32i and keys tx + 8j, the d sum in order.
__device__ __forceinline__ void chunk_scores(const Smem& m, int d, float scale) {
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int c = 0; c < d; c += 4) {
    float4 qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qv[i] = *reinterpret_cast<const float4*>(m.q + (ty + 32 * i) * kStride + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kv[j] = *reinterpret_cast<const float4*>(m.k + (tx + 8 * j) * kStride + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = acc[i][j];
        a = fmaf(qv[i].x, kv[j].x, a);
        a = fmaf(qv[i].y, kv[j].y, a);
        a = fmaf(qv[i].z, kv[j].z, a);
        a = fmaf(qv[i].w, kv[j].w, a);
        acc[i][j] = a;
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) m.s[(ty + 32 * i) * kSStride + tx + 8 * j] = acc[i][j] * scale;
}

// Every observed key of the head? A pass over its mask; a barrier.
__device__ __forceinline__ bool head_observed(const float* mask, int64_t base, int t_len) {
  bool any = false;
  for (int t0 = 0; t0 < t_len; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    any = __syncthreads_or(t < t_len && mask[base + t] != 0.0f) != 0;
    if (any) break;  // the same on every thread
  }
  return any;
}

__global__ void __launch_bounds__(kThreads) mtan_attn_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ ob,
    const float* __restrict__ mask, float* __restrict__ out_ob, float* __restrict__ out_m,
    float* __restrict__ mx, float* __restrict__ lse, int n_heads, int t_len, int r, int d,
    float scale) {
  extern __shared__ float4 smem4[];
  const Smem m = carve(reinterpret_cast<float*>(smem4));
  load_queries(m, q, r, d);
  for (int head = blockIdx.x; head < n_heads; head += gridDim.x) {
    const int64_t base = static_cast<int64_t>(head) * t_len;
    float row_m = -INFINITY, row_l = 0.0f, acc_ob = 0.0f, acc_m = 0.0f;
    bool seen = false;
    for (int t0 = 0; t0 < t_len; t0 += kKeys) {
      if (!load_chunk_values(m, ob, mask, base, t0, t_len)) continue;
      seen = true;
      load_keys(m, k, base, t0, t_len, d);
      __syncthreads();
      chunk_scores(m, d, scale);
      __syncthreads();
      if (threadIdx.x < r) {
        const float* srow = m.s + threadIdx.x * kSStride;
        float cm = row_m;
        for (int j = 0; j < kKeys; ++j)
          if (m.vm[j] != 0.0f) cm = fmaxf(cm, srow[j]);
        const float corr = expf(row_m - cm);  // 0 at the first observed chunk
        row_l *= corr;
        acc_ob *= corr;
        acc_m *= corr;
        for (int j = 0; j < kKeys; ++j) {
          if (m.vm[j] != 0.0f) {
            const float p = expf(srow[j] - cm);
            row_l += p;
            acc_ob = fmaf(p, m.vob[j], acc_ob);
            acc_m = fmaf(p, m.vm[j], acc_m);
          }
        }
        row_m = cm;
      }
      __syncthreads();  // the chunk's tiles are read before the next one lands
    }
    if (!seen) {
      // no observed key: the uniform average over the T slots, in slot order
      if (threadIdx.x == 0) {
        float s_ob = 0.0f, s_m = 0.0f;
        for (int t = 0; t < t_len; ++t) {
          s_ob += ob[base + t];
          s_m += mask[base + t];
        }
        m.misc[0] = s_ob / static_cast<float>(t_len);
        m.misc[1] = s_m / static_cast<float>(t_len);
      }
      __syncthreads();
    }
    if (threadIdx.x < r) {
      const int64_t o = static_cast<int64_t>(head) * r + threadIdx.x;
      if (seen) {
        out_ob[o] = acc_ob / row_l;
        out_m[o] = acc_m / row_l;
        mx[o] = row_m;
        lse[o] = row_m + logf(row_l);
      } else {
        out_ob[o] = m.misc[0];
        out_m[o] = m.misc[1];
        mx[o] = kMasked;
        lse[o] = kMasked + logf(static_cast<float>(t_len));
      }
    }
    __syncthreads();  // m.misc is read before the next head writes it
  }
}

__global__ void __launch_bounds__(kThreads) mtan_attn_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ ob,
    const float* __restrict__ mask, const float* __restrict__ out_ob,
    const float* __restrict__ out_m, const float* __restrict__ lse,
    const float* __restrict__ g_ob, const float* __restrict__ g_m, float* __restrict__ dk,
    float* __restrict__ dob, float* __restrict__ dq_partials, int n_heads, int t_len, int r,
    int d, float scale) {
  extern __shared__ float4 smem4[];
  const Smem m = carve(reinterpret_cast<float*>(smem4));
  float* const s_lse = m.row0;
  float* const s_gob = m.row0 + kR;
  float* const s_gm = m.row0 + 2 * kR;
  float* const s_dd = m.row0 + 3 * kR;
  load_queries(m, q, r, d);
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  // this block's dQ: rows ty + 32i, columns tx * 4 + 32 * jj + e
  float dq[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 16; ++c) dq[i][c] = 0.0f;

  for (int head = blockIdx.x; head < n_heads; head += gridDim.x) {
    const int64_t base = static_cast<int64_t>(head) * t_len;
    if (threadIdx.x < kR) {
      const int row = threadIdx.x;
      float l = 0.0f, gb = 0.0f, gm = 0.0f, dd = 0.0f;
      if (row < r) {
        const int64_t o = static_cast<int64_t>(head) * r + row;
        l = lse[o];
        gb = g_ob[o];
        gm = g_m[o];
        dd = gb * out_ob[o] + gm * out_m[o];
      }
      s_lse[row] = l;
      s_gob[row] = gb;
      s_gm[row] = gm;
      s_dd[row] = dd;
    }
    const bool any = head_observed(mask, base, t_len);  // a barrier
    if (!any && threadIdx.x == 0) {
      float gsum = 0.0f;  // uniform weights 1/T: dob_t = sum_r g_ob,r / T
      for (int row = 0; row < r; ++row) gsum += s_gob[row];
      m.misc[0] = gsum / static_cast<float>(t_len);
    }
    for (int t0 = 0; t0 < t_len; t0 += kKeys) {
      if (!load_chunk_values(m, ob, mask, base, t0, t_len)) {
        // no observed key: dK rows 0; dob 0, or the uniform share
        const float fill = any ? 0.0f : m.misc[0];
        for (int i = threadIdx.x; i < kKeys * (d / 4); i += kThreads) {
          const int j = i / (d / 4), c = (i % (d / 4)) * 4;
          if (t0 + j < t_len)
            *reinterpret_cast<float4*>(dk + (base + t0 + j) * d + c) =
                make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        if (threadIdx.x < kKeys && t0 + threadIdx.x < t_len) dob[base + t0 + threadIdx.x] = fill;
        continue;
      }
      load_keys(m, k, base, t0, t_len, d);
      __syncthreads();
      chunk_scores(m, d, scale);
      __syncthreads();
      {
        // alpha and ds over the tile: key j = lane, rows 16 a group in order
        const int j = threadIdx.x % kKeys, group = threadIdx.x / kKeys;
        const float obs = m.vm[j], v_ob = m.vob[j];
        float col = 0.0f;
        for (int row = group * (kR / kRowGroups); row < (group + 1) * (kR / kRowGroups);
             ++row) {
          float* cell = m.s + row * kSStride + j;
          float ds = 0.0f;
          if (row < r && obs != 0.0f) {
            const float alpha = expf(*cell - s_lse[row]);
            col = fmaf(alpha, s_gob[row], col);
            ds = alpha * (s_gob[row] * v_ob + s_gm[row] * obs - s_dd[row]) * scale;
          }
          *cell = ds;
        }
        m.part[group * kKeys + j] = col;
      }
      __syncthreads();
      if (threadIdx.x < kKeys && t0 + threadIdx.x < t_len) {
        float col = 0.0f;
        for (int g = 0; g < kRowGroups; ++g) col += m.part[g * kKeys + threadIdx.x];
        dob[base + t0 + threadIdx.x] = col;
      }
      // dK for key ty: sum over the queries in order
      {
        float acc[16];
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[c] = 0.0f;
        for (int row = 0; row < r; ++row) {
          const float ds = m.s[row * kSStride + ty];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float4 qv = *reinterpret_cast<const float4*>(m.q + row * kStride + tx * 4 +
                                                               32 * jj);
            acc[4 * jj + 0] = fmaf(ds, qv.x, acc[4 * jj + 0]);
            acc[4 * jj + 1] = fmaf(ds, qv.y, acc[4 * jj + 1]);
            acc[4 * jj + 2] = fmaf(ds, qv.z, acc[4 * jj + 2]);
            acc[4 * jj + 3] = fmaf(ds, qv.w, acc[4 * jj + 3]);
          }
        }
        if (t0 + ty < t_len) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int c = tx * 4 + 32 * jj;
            if (c < d)
              *reinterpret_cast<float4*>(dk + (base + t0 + ty) * d + c) =
                  make_float4(acc[4 * jj], acc[4 * jj + 1], acc[4 * jj + 2], acc[4 * jj + 3]);
          }
        }
      }
      // dQ of queries ty + 32i: the chunk's keys in order
      for (int j = 0; j < kKeys; ++j) {
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[i] = m.s[(ty + 32 * i) * kSStride + j];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 kv = *reinterpret_cast<const float4*>(m.k + j * kStride + tx * 4 + 32 * jj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dq[i][4 * jj + 0] = fmaf(ds[i], kv.x, dq[i][4 * jj + 0]);
            dq[i][4 * jj + 1] = fmaf(ds[i], kv.y, dq[i][4 * jj + 1]);
            dq[i][4 * jj + 2] = fmaf(ds[i], kv.z, dq[i][4 * jj + 2]);
            dq[i][4 * jj + 3] = fmaf(ds[i], kv.w, dq[i][4 * jj + 3]);
          }
        }
      }
      __syncthreads();  // the chunk's tiles are read before the next one lands
    }
    __syncthreads();  // the per-row vectors are read before the next head's
  }
  // the block's partial dQ, (R, D) row-major
  float* out = dq_partials + static_cast<int64_t>(blockIdx.x) * r * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 32 * i;
    if (row >= r) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = tx * 4 + 32 * jj;
      if (c < d)
        *reinterpret_cast<float4*>(out + row * d + c) =
            make_float4(dq[i][4 * jj], dq[i][4 * jj + 1], dq[i][4 * jj + 2], dq[i][4 * jj + 3]);
    }
  }
}

// dq[i] = the sum over the blocks' partials of element i, in block order.
__global__ void __launch_bounds__(kThreads) mtan_dq_sum_kernel(
    const float* __restrict__ partials, float* __restrict__ dq, int n, int blocks) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partials[static_cast<int64_t>(b) * n + i];
  dq[i] = s;
}

// Once for each kernel and device (a launch made while a CUDA graph is
// captured then calls nothing of the runtime but the launch: the warm-up has
// made the same call first): the shared-memory attribute, and the blocks
// that fit on the card at once, the persistent grid's most.
cudaError_t resident_blocks(const void* kernel, int slot, int* out) {
  static int cached[2][16];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 16 && cached[slot][device] > 0) {
    *out = cached[slot][device];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return err;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (device < 16) cached[slot][device] = *out;
  return cudaSuccess;
}

int grid_of(int resident, int n_heads, int cap) {
  int g = resident < n_heads ? resident : n_heads;
  return g < cap ? g : cap;
}

bool shapes_ok(int n_heads, int t_len, int r, int d, int blocks) {
  return n_heads >= 1 && t_len >= 1 && r >= 1 && r <= kR && d >= 4 && d <= kD && d % 4 == 0 &&
         blocks >= 1;
}

}  // namespace

// q (r, d), k (n_heads, t_len, d), ob and mask (n_heads, t_len), all float32
// and contiguous, k 16-byte aligned -> out_ob, out_m, mx, lse (n_heads, r).
// At most `blocks` persistent blocks, and no more than fit on the card at
// once. Returns the first CUDA error.
extern "C" int dicl_mtan_attn_forward(const void* q, const void* k, const void* ob,
                                      const void* mask, void* out_ob, void* out_m, void* mx,
                                      void* lse, int n_heads, int t_len, int r, int d,
                                      int blocks, double scale, void* stream) {
  if (!shapes_ok(n_heads, t_len, r, d, blocks)) return cudaErrorInvalidValue;
  int resident = 0;
  cudaError_t err =
      resident_blocks(reinterpret_cast<const void*>(mtan_attn_fwd_kernel), 0, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = grid_of(resident, n_heads, blocks);
  mtan_attn_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(ob),
      static_cast<const float*>(mask), static_cast<float*>(out_ob), static_cast<float*>(out_m),
      static_cast<float*>(mx), static_cast<float*>(lse), n_heads, t_len, r, d,
      static_cast<float>(scale));
  return static_cast<int>(cudaGetLastError());
}

// The forward's inputs, its out_ob, out_m and lse, and the cotangents g_ob,
// g_m (n_heads, r) -> dk (n_heads, t_len, d), dob (n_heads, t_len), dq (r, d);
// dq_partials: float32 scratch of blocks * r * d, `blocks` the persistent
// grid's most (as the forward). Returns the first CUDA error.
extern "C" int dicl_mtan_attn_backward(const void* q, const void* k, const void* ob,
                                       const void* mask, const void* out_ob, const void* out_m,
                                       const void* lse, const void* g_ob, const void* g_m,
                                       void* dk, void* dob, void* dq_partials, void* dq,
                                       int n_heads, int t_len, int r, int d, int blocks,
                                       double scale, void* stream) {
  if (!shapes_ok(n_heads, t_len, r, d, blocks)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int resident = 0;
  cudaError_t err =
      resident_blocks(reinterpret_cast<const void*>(mtan_attn_bwd_kernel), 1, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = grid_of(resident, n_heads, blocks);
  mtan_attn_bwd_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(ob),
      static_cast<const float*>(mask), static_cast<const float*>(out_ob),
      static_cast<const float*>(out_m), static_cast<const float*>(lse),
      static_cast<const float*>(g_ob), static_cast<const float*>(g_m), static_cast<float*>(dk),
      static_cast<float*>(dob), static_cast<float*>(dq_partials), n_heads, t_len, r, d,
      static_cast<float>(scale));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int n = r * d;
  mtan_dq_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(dq_partials), static_cast<float*>(dq), n, grid);
  return static_cast<int>(cudaGetLastError());
}
