// The train step's optimizer tail for Hopper (sm_90a): the global-norm clip,
// the L2 weight decay folded into the gradient and amsgrad Adam, over every
// parameter leaf in two launches, from one C entry.
//
// Replaces no Pallas kernel. The JAX package runs this tail as XLA ops on one
// raveled parameter vector (`_flat_params_wrapper`, JAX train/optim.py); the
// port ran it as PyTorch's per-leaf chains, some 250 small kernels a step at
// the model's 37 leaves, each at the ~2 us floor of a launch even inside a
// CUDA graph. Here:
//   optim_partials_kernel  each block sums g*g over its tile of one leaf into
//                          its own slot of a partials buffer; the first block
//                          of a leaf advances the leaf's float64 step count;
//   optim_update_kernel    each block reduces every partial in one fixed
//                          order to the global norm (the same bits in every
//                          block), then updates its tile: the clip (scale by
//                          max_norm / norm when norm >= max_norm, no +1e-6,
//                          as optax.clip_by_global_norm; none at max_norm
//                          <= 0, whatever the norm), the clipped gradient
//                          written back, g + wd * p, the moments,
//                          max_exp_avg_sq and the parameter.
// The update follows PyTorch's capturable multi-tensor Adam
// (`_multi_tensor_adam`, capturable branch, on float64 step counts) operation
// by operation: the bias corrections in double from the step count and the
// rate, rounded to float where that Adam divides a float32 tensor by them. No
// float atomics: a run repeats bit for bit.
//
// Bound on the H100: memory. A step reads g, p, m, v and vmax and writes p,
// m, v and vmax (and g when the clip scales it), 36-40 bytes an element:
// about 28 MB at the model's 648k parameters, ~9 us at 3.35 TB/s. Each
// thread issues all its loads of a tile before it uses any.
//
// Leaves travel by value as kernel arguments (`Leaves`, under the 4 KB of a
// launch's parameters); past kMaxLeaves leaves the entry launches both
// kernels once for each group of them, every update launch reducing the
// partials of all groups.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLeaves = 48;  // leaves a launch (ops/cuda_optim.py: MAX_LEAVES)
constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;  // elements a block (ops/cuda_optim.py: TILE)

struct Leaves {
  float* p[kMaxLeaves];
  float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  float* vmax[kMaxLeaves];
  double* step[kMaxLeaves];
  int n[kMaxLeaves];
  int first_block[kMaxLeaves + 1];  // a leaf's tiles are blocks [first_block[i], first_block[i + 1])
  int count;
};
static_assert(sizeof(Leaves) + 64 <= 4096, "a launch's parameters hold the leaves");

struct Hyper {
  float max_norm;      // <= 0: no clip
  float weight_decay;
  float lerp_weight;   // 1 - beta1
  float beta2;
  float one_minus_beta2;
  float eps;
  double beta1_d;      // the bias corrections' bases, in double as the step counts
  double beta2_d;
};

// The leaf whose tiles hold `block` (every leaf has at least one).
__device__ __forceinline__ int leaf_of(const Leaves& L, int block) {
  int lo = 0, hi = L.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (L.first_block[mid] <= block) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The sum over the block of one value a thread, in a fixed tree order; every
// thread gets it.
template <typename T>
__device__ __forceinline__ T block_sum(T x, T* shared) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) shared[warp] = x;
  __syncthreads();
  T total = shared[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) total += shared[w];
  return total;
}

__global__ void __launch_bounds__(kThreads) optim_partials_kernel(Leaves L, float* partials,
                                                                  int slot0) {
  __shared__ float shared[kThreads / 32];
  const int leaf = leaf_of(L, blockIdx.x);
  const int tile = blockIdx.x - L.first_block[leaf];
  const float* g = L.g[leaf];
  const int n = L.n[leaf];
  const int start = tile * kTile + threadIdx.x;
  float x[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = start + k * kThreads;
    x[k] = i < n ? g[i] : 0.0f;
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) s = fmaf(x[k], x[k], s);
  s = block_sum(s, shared);
  if (threadIdx.x == 0) {
    partials[slot0 + blockIdx.x] = s;
    if (tile == 0) *L.step[leaf] += 1.0;
  }
}

__global__ void __launch_bounds__(kThreads) optim_update_kernel(
    Leaves L, const float* __restrict__ partials, int n_partials, float* norm_out,
    const float* __restrict__ lr, Hyper h) {
  __shared__ double shared[kThreads / 32];
  __shared__ float scales[2];
  const int leaf = leaf_of(L, blockIdx.x);
  const int tile = blockIdx.x - L.first_block[leaf];
  const int n = L.n[leaf];
  const int start = tile * kTile + threadIdx.x;
  float* __restrict__ g = L.g[leaf];
  float* __restrict__ p = L.p[leaf];
  float* __restrict__ m = L.m[leaf];
  float* __restrict__ v = L.v[leaf];
  float* __restrict__ vmax = L.vmax[leaf];

  // the tile's loads first: they overlap the norm's reduction
  float gx[kPerThread], px[kPerThread], mx[kPerThread], vx[kPerThread], wx[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = start + k * kThreads;
    const bool in = i < n;
    gx[k] = in ? g[i] : 0.0f;
    px[k] = in ? p[i] : 0.0f;
    mx[k] = in ? m[i] : 0.0f;
    vx[k] = in ? v[i] : 0.0f;
    wx[k] = in ? vmax[i] : 0.0f;
  }

  double part = 0.0;
  for (int i = threadIdx.x; i < n_partials; i += kThreads) part += partials[i];
  const float norm = static_cast<float>(sqrt(block_sum(part, shared)));
  if (blockIdx.x == 0 && threadIdx.x == 0) *norm_out = norm;
  const bool clip = h.max_norm > 0.0f && norm >= h.max_norm;

  if (threadIdx.x == 0) {
    // PyTorch's capturable Adam: step_size = 1 / ((beta1^t - 1) / lr) and
    // sqrt(-(beta2^t - 1)), in double, each rounded to float where a float32
    // tensor is divided by it
    const double t = *L.step[leaf];
    const double bc1 = (pow(h.beta1_d, t) - 1.0) / static_cast<double>(*lr);
    scales[0] = static_cast<float>(1.0 / bc1);
    scales[1] = static_cast<float>(sqrt(-(pow(h.beta2_d, t) - 1.0)));
  }
  __syncthreads();
  const float step_size = scales[0];
  const float bc2_sqrt = scales[1];

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = start + k * kThreads;
    float gk = gx[k];
    if (clip) gk = gk / norm * h.max_norm;
    const float d = h.weight_decay != 0.0f ? gk + h.weight_decay * px[k] : gk;
    // lerp(m, d, 1 - beta1) as at::lerp takes it
    const float mk = h.lerp_weight < 0.5f ? mx[k] + h.lerp_weight * (d - mx[k])
                                          : d - (d - mx[k]) * (1.0f - h.lerp_weight);
    // v * beta2 is its own kernel in PyTorch's Adam: rounded before the add
    const float vk = __fmul_rn(vx[k], h.beta2) + h.one_minus_beta2 * (d * d);
    const float wk = (wx[k] > vk || wx[k] != wx[k]) ? wx[k] : vk;  // NaN-propagating max
    const float den = (sqrtf(wk) / bc2_sqrt + h.eps) / step_size;
    if (i < n) {
      if (clip) g[i] = gk;
      m[i] = mk;
      v[i] = vk;
      vmax[i] = wk;
      p[i] = px[k] + mk / den;
    }
  }
}

// Fills `L` from the host table: n_leaves rows of (p, g, exp_avg, exp_avg_sq,
// max_exp_avg_sq, step, numel) as int64. False if a leaf is empty or too long.
bool fill(Leaves& L, const int64_t* table, int n_leaves) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return false;
  L.count = n_leaves;
  int64_t blocks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const int64_t* row = table + 7 * i;
    L.p[i] = reinterpret_cast<float*>(row[0]);
    L.g[i] = reinterpret_cast<float*>(row[1]);
    L.m[i] = reinterpret_cast<float*>(row[2]);
    L.v[i] = reinterpret_cast<float*>(row[3]);
    L.vmax[i] = reinterpret_cast<float*>(row[4]);
    L.step[i] = reinterpret_cast<double*>(row[5]);
    if (row[6] < 1 || row[6] > INT32_MAX - kTile) return false;
    L.n[i] = static_cast<int>(row[6]);
    L.first_block[i] = static_cast<int>(blocks);
    blocks += (row[6] + kTile - 1) / kTile;
    if (blocks > INT32_MAX) return false;
  }
  L.first_block[n_leaves] = static_cast<int>(blocks);
  return true;
}

}  // namespace

// table: host int64 (n_leaves, 7) as `fill` reads it; partials: float32, one
// slot a tile of every leaf; norm: float32 (), written with the global norm;
// lr: float32 (), the rate. max_norm <= 0 for no clip. Launches the partials
// kernel for each group of kMaxLeaves leaves, then the update kernel for each.
// Returns the first CUDA error.
extern "C" int dicl_clip_adam(const void* table, void* partials, void* norm, const void* lr,
                              int n_leaves, double max_norm, double weight_decay, double beta1,
                              double beta2, double eps, void* stream) {
  if (n_leaves < 1) return cudaErrorInvalidValue;
  const int64_t* rows = static_cast<const int64_t*>(table);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Leaves L;
  int64_t slots = 0;
  for (int g = 0; g < n_leaves; g += kMaxLeaves) {
    const int n = n_leaves - g < kMaxLeaves ? n_leaves - g : kMaxLeaves;
    if (!fill(L, rows + 7 * static_cast<int64_t>(g), n) || slots > INT32_MAX - L.first_block[n])
      return cudaErrorInvalidValue;
    optim_partials_kernel<<<L.first_block[n], kThreads, 0, s>>>(
        L, static_cast<float*>(partials), static_cast<int>(slots));
    if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
    slots += L.first_block[n];
  }
  // the float32 scalars as PyTorch's kernels take the Python floats
  const Hyper h{static_cast<float>(max_norm), static_cast<float>(weight_decay),
                static_cast<float>(1.0 - beta1), static_cast<float>(beta2),
                static_cast<float>(1.0 - beta2), static_cast<float>(eps), beta1, beta2};
  for (int g = 0; g < n_leaves; g += kMaxLeaves) {
    const int n = n_leaves - g < kMaxLeaves ? n_leaves - g : kMaxLeaves;
    fill(L, rows + 7 * static_cast<int64_t>(g), n);
    optim_update_kernel<<<L.first_block[n], kThreads, 0, s>>>(
        L, static_cast<const float*>(partials), static_cast<int>(slots),
        static_cast<float*>(norm), static_cast<const float*>(lr), h);
    if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  }
  return 0;
}
