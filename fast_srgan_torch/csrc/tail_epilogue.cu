// The LR tail's epilogue: bias, PReLU and window in one pass, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: on the TPU, XLA fused the bias add, the PReLU
// and the phase window of fast_srgan_tpu/ops/lr_tail.py into the conv's
// consumers. On the card, cuDNN's conv adds no bias of its own, so PyTorch
// ran each of the LR tail's five upsampling outputs (stage 1 and the four
// stage-2 phases, each [B, 4F, H, W]) through three passes: the bias `add_`
// over the whole conv output, `F.prelu` over a strided window of it (a
// generic, unvectorised kernel), and for stage 1 the zero pad's fill and
// copy. This kernel is one pass:
//
//   out[b, c, i, j] = act(round(x[b, c, p + i, q + j] + bias[c]))
//   act(z) = z > 0 ? z : round(slope * z)      (no act when slope is null)
//
// computed in fp32 and rounded to the working type after the add and after
// the product, as `add_` then `F.prelu` round: the output is bitwise theirs
// in bf16 and in fp32 (__fadd_rn and __fmul_rn keep the compiler from
// contracting either). With `border` > 0 the output is [B, C, H + 2 border,
// W + 2 border] with the window in its interior and a zero border written by
// the same launch: stage 1 then feeds the four phase convs with no pad.
//
// What bounds it: device-memory bandwidth, one read of the window and one
// write of the output. Both tensors are channels_last, so a window row is
// W * C contiguous values in the input (columns q .. q + W - 1 of one row)
// and in the output: the kernel is a row-by-row streaming copy with
// arithmetic. Each thread moves 8 channels of a pixel a step (one 16-byte
// load and store in bf16, two in fp32); a block walks one piece of one
// output row, kUnroll steps of `used` threads, all loads issued before the
// stores. `used` is a multiple of C / 8, so a thread's 8 channels are fixed
// for the launch and their bias (and the one slope) sit in registers.
// A block's unit (a row and a piece of it) costs one 64-bit division; the
// steps none. The batch is not a grid axis: units are walked by a
// grid-stride loop with 64-bit offsets, so any batch is taken.
//
// The wrapper (fast_srgan_torch/kernels/tail_epilogue.py) guarantees: x
// [B, C, Hin, Win] and out channels_last and dense, 16-byte aligned; C a
// multiple of 8 and at most 8 * kThreads; bias [C] and slope (one value or
// null) in x's type on x's device; the window inside x; H, W >= 1,
// border >= 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kMaxGrid = 1LL << 24;

// 8 consecutive channels of one pixel.
template <typename T>
struct Pack;

template <>
struct Pack<bf16> {
  uint4 raw;
  __device__ __forceinline__ void load(const bf16* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void store(bf16* p) const {
    *reinterpret_cast<uint4*>(p) = raw;
  }
  __device__ __forceinline__ void zero() { raw = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void get(float (&v)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  }
  // exact: every value is already a bf16 value
  __device__ __forceinline__ void set(const float (&v)[8]) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  }
};

template <>
struct Pack<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p) {
    lo = __ldg(reinterpret_cast<const float4*>(p));
    hi = __ldg(reinterpret_cast<const float4*>(p + 4));
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = lo;
    *reinterpret_cast<float4*>(p + 4) = hi;
  }
  __device__ __forceinline__ void zero() {
    lo = make_float4(0.f, 0.f, 0.f, 0.f);
    hi = lo;
  }
  __device__ __forceinline__ void get(float (&v)[8]) const {
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  }
  __device__ __forceinline__ void set(const float (&v)[8]) {
    lo = make_float4(v[0], v[1], v[2], v[3]);
    hi = make_float4(v[4], v[5], v[6], v[7]);
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// v rounded to T, back in fp32
template <typename T>
__device__ __forceinline__ float rounded(float v);
template <>
__device__ __forceinline__ float rounded<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rounded<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ void epilogue(Pack<T>& pk, const float (&b)[8], float a,
                                         bool act) {
  float v[8];
  pk.get(v);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float z = rounded<T>(__fadd_rn(v[e], b[e]));
    v[e] = (!act || z > 0.f) ? z : rounded<T>(__fmul_rn(a, z));
  }
  pk.set(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tail_epilogue_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                         const T* __restrict__ slope, T* __restrict__ out, int Hin,
                         int Win, int C, int H, int W, int p, int q, int border,
                         long long rows, int pieces) {
  const int cpv = C / 8;  // 8-channel vectors a pixel
  const int used = (kThreads / cpv) * cpv;
  const int tid = threadIdx.x;
  if (tid >= used) return;
  const int c0 = (tid % cpv) * 8;
  float b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) b[e] = to_float(bias[c0 + e]);
  const bool act = slope != nullptr;
  const float a = act ? to_float(*slope) : 0.f;
  const int Ho = H + 2 * border;
  const int row_vecs = (W + 2 * border) * cpv;
  const int lo = border * cpv, hi = (border + W) * cpv;  // the window's vectors
  const long long units = rows * pieces;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long row = u / pieces;  // of the output, b * Ho + ho
    const int piece = (int)(u - row * pieces);
    const long long img = row / Ho;
    const int i = (int)(row - img * Ho) - border;  // the window's row
    const bool inside = i >= 0 && i < H;
    const T* src = x + ((img * Hin + (inside ? i + p : 0)) * Win + q) * C;
    T* dst = out + row * row_vecs * 8;
    const int v0 = piece * used * kUnroll + tid;
    Pack<T> pk[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int v = v0 + k * used;
      if (inside && v >= lo && v < hi)
        pk[k].load(src + (long long)(v - lo) * 8);
      else
        pk[k].zero();
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int v = v0 + k * used;
      if (v >= row_vecs) continue;
      if (inside && v >= lo && v < hi) epilogue(pk[k], b, a, act);
      pk[k].store(dst + (long long)v * 8);
    }
  }
}

template <typename T>
int launch(const void* x, const void* bias, const void* slope, void* out, int B,
           int Hin, int Win, int C, int H, int W, int p, int q, int border,
           void* stream) {
  const int cpv = C / 8;
  const int used = (kThreads / cpv) * cpv;
  const long long rows = (long long)B * (H + 2 * border);
  const long long row_vecs = (long long)(W + 2 * border) * cpv;
  const int pieces = (int)((row_vecs + used * kUnroll - 1) / (used * kUnroll));
  const long long units = rows * pieces;
  const int grid = (int)(units < kMaxGrid ? units : kMaxGrid);
  tail_epilogue_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias),
      static_cast<const T*>(slope), static_cast<T*>(out), Hin, Win, C, H, W, p, q,
      border, rows, pieces);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes): x [B, C, Hin, Win] channels_last, bias
// [C], slope one value or null (no activation), all in one type; out
// [B, C, H + 2 border, W + 2 border] channels_last; the window at (p, q) of
// H x W. Each returns cudaGetLastError().
extern "C" int fsr_tail_epilogue_bf16(const void* x, const void* bias, const void* slope,
                                      void* out, int B, int Hin, int Win, int C, int H,
                                      int W, int p, int q, int border, void* stream) {
  return launch<bf16>(x, bias, slope, out, B, Hin, Win, C, H, W, p, q, border, stream);
}

extern "C" int fsr_tail_epilogue_f32(const void* x, const void* bias, const void* slope,
                                     void* out, int B, int Hin, int Win, int C, int H,
                                     int W, int p, int q, int border, void* stream) {
  return launch<float>(x, bias, slope, out, B, Hin, Win, C, H, W, p, q, border, stream);
}
