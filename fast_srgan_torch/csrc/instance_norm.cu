// Fused instance norm + single-slope PReLU for Hopper (sm_90a).
//
// Replaces the TPU kernels of fast_srgan_tpu/kernels/instance_norm.py:
// `_kernel` (one sample resident in VMEM, grid over the batch) and
// `_make_chunked_kernel` (two double-buffered DMA passes over one sample).
// Both compute, per (sample, channel) of a channels_last activation x:
//
//   mean = sum(x) / HW,  ex2 = sum(x^2) / HW          (fp32)
//   var  = max(ex2 - mean^2, 0)                        (one pass, clamped)
//   y    = (x - mean) * rsqrt(var + eps)
//   out  = y >= 0 ? y : alpha * y                      (stored in x's dtype, RNE)
//
// The kernel is bandwidth-bound: it does a few FLOPs per element and moves
// x twice in (statistics, then normalize) and once out. The TPU grid ran one
// sample per step on one core; on Hopper a grid over the batch would fill 8
// of 132 SMs at the serving batch, so the pixels of each sample are split
// into tiles of `tile_px` pixels and the grid is (tiles, batch):
//
//   kernel A (in_stats_kernel): per tile, per-channel fp32 sum and sum of
//     squares, reduced in shared memory and written to partial[b][tile][2][C].
//     No atomics, so results are deterministic.
//   kernel B (in_prelu_apply_kernel): every block first sums the tile
//     partials of its sample (in a fixed order, so all tiles agree), then
//     normalizes its own tile, applies the PReLU and stores.
//
// Each thread moves 16 bytes per load/store (8 bf16 or 4 fp32 values of one
// pixel's contiguous channels); neighbouring threads take neighbouring
// channel groups, then neighbouring pixels, so a warp reads contiguous
// memory. The slope is read through its device pointer, so the host never
// synchronizes. Both kernels launch on the caller's stream.
//
// The wrapper (fast_srgan_torch/kernels/instance_norm.py) guarantees:
// C % (16 / sizeof(T)) == 0, C / (16 / sizeof(T)) <= 256, contiguous
// channels_last x and out aligned to 16 bytes, alpha a device fp32 scalar,
// partial of B * tiles * 2 * C floats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = t;
  }
};

// Thread layout shared by both kernels: thread t owns channel group
// t % groups (N channels) and walks the tile's pixels starting at
// t / groups with a stride of rows = blockDim.x / groups.

template <typename T>
__global__ void __launch_bounds__(kThreads)
    in_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                    int hw, int c, int tile_px) {
  using P = Pack<T>;
  constexpr int N = P::N;
  extern __shared__ float smem[];  // sums [rows][c], then squares [rows][c]
  const int groups = c / N;
  const int rows = blockDim.x / groups;
  const int g = threadIdx.x % groups;
  const int r = threadIdx.x / groups;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int p_end = min((tile + 1) * tile_px, hw);

  const T* xb = x + (size_t)b * hw * c + g * N;
  float s[N], q[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = 0.f;
    q[i] = 0.f;
  }
  for (int p = tile * tile_px + r; p < p_end; p += rows) {
    float v[N];
    P::load(xb + (size_t)p * c, v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s[i] += v[i];
      q[i] += v[i] * v[i];
    }
  }
  float* s_sh = smem;
  float* q_sh = smem + rows * c;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s_sh[r * c + g * N + i] = s[i];
    q_sh[r * c + g * N + i] = q[i];
  }
  __syncthreads();

  float* out = partial + ((size_t)b * gridDim.x + tile) * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float a = 0.f, a2 = 0.f;
    for (int k = 0; k < rows; ++k) {
      a += s_sh[k * c + ch];
      a2 += q_sh[k * c + ch];
    }
    out[ch] = a;
    out[c + ch] = a2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    in_prelu_apply_kernel(const T* __restrict__ x,
                          const float* __restrict__ partial,
                          const float* __restrict__ alpha, T* __restrict__ out,
                          int hw, int c, int tile_px, float eps) {
  using P = Pack<T>;
  constexpr int N = P::N;
  extern __shared__ float smem[];  // mean [c], then 1/sqrt(var + eps) [c]
  const int groups = c / N;
  const int rows = blockDim.x / groups;
  const int g = threadIdx.x % groups;
  const int r = threadIdx.x / groups;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int b = blockIdx.y;

  const float* pb = partial + (size_t)b * n_tiles * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int k = 0; k < n_tiles; ++k) {
      s += pb[(size_t)k * 2 * c + ch];
      q += pb[(size_t)k * 2 * c + c + ch];
    }
    const float mean = s / (float)hw;
    const float var = fmaxf(q / (float)hw - mean * mean, 0.f);
    smem[ch] = mean;
    smem[c + ch] = 1.0f / sqrtf(var + eps);
  }
  __syncthreads();

  float m[N], rs[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    m[i] = smem[g * N + i];
    rs[i] = smem[c + g * N + i];
  }
  const float a = __ldg(alpha);
  const size_t base = (size_t)b * hw * c + g * N;
  const int p_end = min((tile + 1) * tile_px, hw);
  for (int p = tile * tile_px + r; p < p_end; p += rows) {
    float v[N];
    P::load(x + base + (size_t)p * c, v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float y = (v[i] - m[i]) * rs[i];
      v[i] = y >= 0.f ? y : a * y;
    }
    P::store(out + base + (size_t)p * c, v);
  }
}

template <typename T>
int launch(const void* x, const void* alpha, void* out, void* partial, int b,
           int hw, int c, int tile_px, float eps, void* stream) {
  constexpr int N = Pack<T>::N;
  const int groups = c / N;
  const int rows = groups >= kThreads ? 1 : kThreads / groups;
  const int threads = rows * groups;
  const dim3 grid((hw + tile_px - 1) / tile_px, b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  in_stats_kernel<T><<<grid, threads, 2 * (size_t)rows * c * sizeof(float),
                       s>>>(static_cast<const T*>(x),
                            static_cast<float*>(partial), hw, c, tile_px);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  in_prelu_apply_kernel<T><<<grid, threads, 2 * (size_t)c * sizeof(float),
                             s>>>(
      static_cast<const T*>(x), static_cast<const float*>(partial),
      static_cast<const float*>(alpha), static_cast<T*>(out), hw, c, tile_px,
      eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes). Each returns cudaGetLastError() of its
// launches: 0 on success.
extern "C" int fsr_instance_norm_prelu_bf16(const void* x, const void* alpha,
                                            void* out, void* partial, int b,
                                            int hw, int c, int tile_px,
                                            float eps, void* stream) {
  return launch<__nv_bfloat16>(x, alpha, out, partial, b, hw, c, tile_px, eps,
                               stream);
}

extern "C" int fsr_instance_norm_prelu_f32(const void* x, const void* alpha,
                                           void* out, void* partial, int b,
                                           int hw, int c, int tile_px,
                                           float eps, void* stream) {
  return launch<float>(x, alpha, out, partial, b, hw, c, tile_px, eps, stream);
}
