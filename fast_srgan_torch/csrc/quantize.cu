// Activation quantization, bf16 or fp32 -> int8, for Hopper (sm_90a).
//
// Replaces what XLA lowered for fast_srgan_tpu/quant.py `_quantize_act`:
//
//   q = clip(round(float(x) * (127 / s)), -127, 127) as int8
//
// with the reciprocal formed first and then the product, as quant.py does,
// and round half to even (rintf, which is what jnp.round and torch.round
// do). `127.0f / s` is IEEE-rounded division (the build has no fast-math),
// and the product uses __fmul_rn, so the result is bitwise the plain
// version's. It runs before every int8 convolution of the tier: twice a
// forward in the 4x `ups` mode (stage 1's input, and stage 2's, which the
// four phases share).
//
// What bounds it: device-memory bandwidth, one read of the activation and a
// write of a quarter (bf16) or an eighth (fp32) of its bytes. Each thread
// converts 8 values per step: one 16-byte load (bf16) or two (fp32) and one
// 8-byte store, neighbouring threads on neighbouring addresses. The layout
// is irrelevant: the op is elementwise over the flat buffer, so the output
// keeps the input's memory order. A ragged end is converted one value at a
// time.
//
// The wrapper (fast_srgan_torch/kernels/quantize.py) guarantees: x and out
// dense buffers of n elements, 16-byte aligned; scale one fp32 value on the
// device; n >= 1. n and every offset are 64-bit: the 4x int8 head's input,
// the 1024-channel phase concat, passes 2^31 elements at batch 37 of
// 180x320, and the grid-stride loop takes any n with a grid of at most 132 x
// 32 blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

__device__ __forceinline__ int8_t quantize_one(float v, float r) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, r)), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(q));
}

__device__ __forceinline__ void load8(const float* x, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(x);
  const float4 b = *reinterpret_cast<const float4*>(x + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* x, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(x);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(p[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    int8_t* __restrict__ out, long long n) {
  const float r = 127.0f / __ldg(scale);
  const long long stride = (long long)gridDim.x * kThreads * 8;
  for (long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * 8;
       i < n; i += stride) {
    if (i + 8 <= n) {
      float v[8];
      load8(x + i, v);
      union {
        uint2 u;
        int8_t q[8];
      } packed;
#pragma unroll
      for (int e = 0; e < 8; ++e) packed.q[e] = quantize_one(v[e], r);
      *reinterpret_cast<uint2*>(out + i) = packed.u;
    } else {
      for (long long k = i; k < n; ++k) out[k] = quantize_one(to_float(x[k]), r);
    }
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* out, long long n,
           void* stream) {
  const long long blocks = (n + kThreads * 8 - 1) / (kThreads * 8);
  const int grid = (int)(blocks < 132LL * 32 ? blocks : 132LL * 32);
  quantize_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<int8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes): x [n] bf16 or fp32, scale one fp32
// value on the device, out [n] int8. Each returns cudaGetLastError().
extern "C" int fsr_quantize_bf16(const void* x, const void* scale, void* out,
                                 long long n, void* stream) {
  return launch<bf16>(x, scale, out, n, stream);
}

extern "C" int fsr_quantize_f32(const void* x, const void* scale, void* out,
                                long long n, void* stream) {
  return launch<float>(x, scale, out, n, stream);
}
