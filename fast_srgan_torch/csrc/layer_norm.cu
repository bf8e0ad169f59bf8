// LayerNorm over the last dimension of token rows, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no SwinIR or HAT. It takes
// the place of PyTorch's LayerNorm kernel (`vectorized_layer_norm_kernel`) in
// every LayerNorm of SwinIR and HAT (models/swinir.py `LayerNorm`): the patch
// embedding's, two a Swin layer or HAB, two an OCAB, and the body's last. On
// x [rows, C] (the [B, H, W, C] tokens, rows dense), with fp32 statistics of
// each row:
//
//   mean = sum(x) / C,  var = sum((x - mean)^2) / C,  rstd = rsqrt(var + eps)
//   out = (x - mean) * rstd * gamma + beta        rounded once to x's type
//
// What bounds it: device-memory bandwidth. x is read once and out written
// once (SwinIR-M's [8, 184, 320, 180] in bf16: 339 MB a call, 0.101 ms at
// 3.35 TB/s). PyTorch's kernel gives each row one 128-thread block: a row of
// 180 bf16 channels is 45 four-element vectors, so 83 of the 128 threads load
// nothing, and each row pays block-wide reductions through shared memory. This
// kernel's design:
//
// * One warp a row, its values in vectors of VB bytes, 16 where they divide
//   the row's bytes and else 8, so that every row starts on a vector (C = 180
//   or 60 bf16: 360 or 120 bytes, vectors of 8 bytes; C = 144 or 240 bf16 and
//   every fp32 C a multiple of 4: 16 bytes). Vector lane + 32 k of a row is the
//   lane's slot k, the same channels in every row: each lane loads its gamma
//   and beta once and keeps them in registers while its warp walks the rows.
// * kRows rows at a time: every lane issues all its loads of the kRows rows
//   before it reduces, so those bytes are in flight together. A persistent
//   grid (as many blocks as fit the SMs) walks the rows; offsets are 64-bit.
// * The row stays in registers. The mean, then the sum of squared deviations
//   (two passes over registers, fp32), each a warp reduction by shuffles: no
//   shared memory and no __syncthreads.
// * The output is computed in fp32 and rounded once, as F.layer_norm does.
//
// The wrapper (fast_srgan_torch/kernels/layer_norm.py) guarantees: x and out
// contiguous, of one type (bf16 or fp32), 16-byte aligned; C * the type's
// size a multiple of 8 (C a multiple of 4 in bf16, even in fp32) and at most
// 32 * kMaxVecs vectors; gamma and beta [C] of x's type; rows >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// rows a warp loads before it reduces
constexpr int kRows = 4;
// vectors a lane holds of a row, at most (every published SwinIR and HAT
// embed_dim needs 2 at most: C = 240 in fp32, 60 vectors)
constexpr int kMaxVecs = 2;

template <int VB>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

// VB bytes of consecutive values of type T.
template <typename T, int VB>
struct Vec {
  static constexpr int kN = VB / sizeof(T);
  using R = typename Raw<VB>::type;
  R raw;
  __device__ __forceinline__ void load(const T* p) { raw = __ldg(reinterpret_cast<const R*>(p)); }
  __device__ __forceinline__ void store(T* p) const { *reinterpret_cast<R*>(p) = raw; }
  __device__ __forceinline__ void get(float (&v)[kN]) const {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kN; ++j) v[j] = to_float(e[j]);
  }
  __device__ __forceinline__ void set(const float (&v)[kN]) {
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kN; ++j) e[j] = from_float<T>(v[j]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int VB, int NV>
__global__ void __launch_bounds__(kThreads)
    layer_norm_rows_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                           const T* __restrict__ beta, T* __restrict__ out, long long rows,
                           int C, float eps) {
  using V = Vec<T, VB>;
  constexpr int E = V::kN;
  const int lane = threadIdx.x & 31;
  const int nvec = C / E;  // vectors a row
  const float inv_c = 1.f / (float)C;

  // each slot: whether the lane holds a vector there, and its gamma and beta
  bool has[NV];
  V g[NV], b[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c0 = (lane + 32 * k) * E;
    has[k] = lane + 32 * k < nvec;
    float gf[E], bf[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      gf[j] = has[k] ? to_float(gamma[c0 + j]) : 0.f;
      bf[j] = has[k] ? to_float(beta[c0 + j]) : 0.f;
    }
    g[k].set(gf);  // exact: each value is of type T already
    b[k].set(bf);
  }

  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps * kRows;
  for (long long r0 = warp * kRows; r0 < rows; r0 += stride) {
    V xv[kRows][NV];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const T* row = x + (r0 + u) * C;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (has[k] && r0 + u < rows)
          xv[u][k].load(row + (lane + 32 * k) * E);
        else
          xv[u][k].raw = {};
      }
    }

#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      float f[NV][E], sum = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        xv[u][k].get(f[k]);
#pragma unroll
        for (int j = 0; j < E; ++j) sum += f[k][j];
      }
      const float mean = warp_sum(sum) * inv_c;
      float sq = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (!has[k]) continue;  // its zeros are not the row's values
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float d = f[k][j] - mean;
          sq += d * d;
        }
      }
      const float rstd = rsqrtf(warp_sum(sq) * inv_c + eps);
      if (r0 + u >= rows) continue;
      T* row = out + (r0 + u) * C;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (!has[k]) continue;
        float gf[E], bf[E];
        g[k].get(gf);
        b[k].get(bf);
#pragma unroll
        for (int j = 0; j < E; ++j) f[k][j] = (f[k][j] - mean) * rstd * gf[j] + bf[j];
        V y;
        y.set(f[k]);
        y.store(row + (lane + 32 * k) * E);
      }
    }
  }
}

template <typename T, int VB, int NV>
int run(const void* x, const void* gamma, const void* beta, void* out, long long rows, int C,
        float eps, cudaStream_t stream) {
  auto kernel = layer_norm_rows_kernel<T, VB, NV>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long needed = (rows + kWarps * kRows - 1) / (kWarps * kRows);
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(needed < most ? needed : most);
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(gamma),
                                        static_cast<const T*>(beta), static_cast<T*>(out), rows,
                                        C, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VB>
int run_vb(int nv, const void* x, const void* gamma, const void* beta, void* out, long long rows,
           int C, float eps, cudaStream_t stream) {
  if (nv == 1) return run<T, VB, 1>(x, gamma, beta, out, rows, C, eps, stream);
  return run<T, VB, 2>(x, gamma, beta, out, rows, C, eps, stream);
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* out, long long rows, int C,
           float eps, void* stream) {
  const int row_bytes = C * (int)sizeof(T);
  const int vb = row_bytes % 16 == 0 ? 16 : 8;
  const int nv = (row_bytes / vb + 31) / 32;
  if (C < 1 || row_bytes % 8 || nv > kMaxVecs || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vb == 16) return run_vb<T, 16>(nv, x, gamma, beta, out, rows, C, eps, s);
  return run_vb<T, 8>(nv, x, gamma, beta, out, rows, C, eps, s);
}

}  // namespace

// C entry points (bound with ctypes): x and out [rows, C] contiguous, gamma
// and beta [C], all of one type; eps the module's. Each returns the launch's
// cudaError_t.
extern "C" int fsr_layer_norm_bf16(const void* x, const void* gamma, const void* beta, void* out,
                                   long long rows, int C, float eps, void* stream) {
  return launch<bf16>(x, gamma, beta, out, rows, C, eps, stream);
}

extern "C" int fsr_layer_norm_f32(const void* x, const void* gamma, const void* beta, void* out,
                                  long long rows, int C, float eps, void* stream) {
  return launch<float>(x, gamma, beta, out, rows, C, eps, stream);
}
