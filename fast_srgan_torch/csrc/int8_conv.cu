// int8 x int8 -> int32 convolution with a dequantize + bias + PReLU epilogue,
// for Hopper (sm_90a).
//
// Replaces what XLA lowered for fast_srgan_tpu/quant.py `_Exec.conv_q`
// (lax.conv_general_dilated on int8 NHWC x int8 HWIO with
// preferred_element_type=int32, then `(acc.astype(f32) * (wscale * s/127))
// .astype(glue)`), and the `+ bias` and `_prelu` that follow it in
// `_stage_conv` and `_tail_4x`. It is not a Pallas port: the TPU got its
// int8 convolution from XLA, and stock PyTorch has none on CUDA.
//
// The conv is an implicit GEMM: M = B*H*W output pixels, N = Cout, K = taps
// x Cin. Every conv of the int8 tier is "same"-sized (the output is H x W):
// 3x3 with padding 1 (stage 1, the trunk, the int8 heads), and 2x2 with
// padding ((1-p, p), (1-q, q)) for the four stage-2 phases (p, q). The
// phases are four launches, one per phase, so a forward of the 4x `ups`
// tier launches this kernel five times. Padding is read, not stored: the
// block's zero-filled input halo is the one pad of ops/lr_tail.py's
// one-pad-then-window form, and phase (p, q) is the window at (p, q).
//
//   * A block owns an 8x16-pixel tile of one sample (M tile 128) and 64
//     output channels (N tile 64). It loops over K in chunks of 64 input
//     channels: it stages the chunk's input halo ((8+KH-1) x (16+KW-1)
//     pixels) and every tap's [64 n x 64 k] weight slice in shared memory,
//     zero outside the image and past Cin, and then runs the taps; every
//     tap's A operand is the halo shifted by (dy, dx). No im2col buffer.
//   * Tensor cores through `mma.sync.m16n8k32.s32.s8.s8.s32`: 8 warps each
//     own 32 pixels (two tile rows) x 32 channels, 2 x 4 fragments of int32
//     accumulators held in registers. Shared rows are 80 bytes (64 + 16) so
//     the 32-bit fragment loads of a warp hit 32 distinct banks.
//   * The int32 sums never reach device memory: the epilogue runs on the
//     accumulator registers and stores pairs of channels.
//
// Numerics, in the order of quant.py, each step one rounding:
//   v = glue(float(acc) * m[n]),  m = wscale * (s / 127) (fp32, made by the
//   wrapper); then optionally v = glue(v + bias[n]); then optionally
//   v = v >= 0 ? v : glue(alpha * v). The products and sums use __fmul_rn /
//   __fadd_rn, which the compiler never contracts into an FMA, so the result
//   is bitwise the plain version's.
//
// What bounds it: arithmetic. At batch 8 of 180x320 the four stage-2
// phases are ~0.97 T int8 ops and stage 1 ~0.14 T, against 1,979 TOP/s of
// dense int8 on the H100 (which only wgmma reaches). This first kernel uses
// mma.sync with synchronous loads and a __syncthreads per K chunk, so it
// reaches a small share of that; wgmma, TMA and a pipelined K loop are the
// redesign.
//
// The wrapper (fast_srgan_torch/kernels/int8_conv.py) guarantees: x int8
// [B, H, W, Cin] contiguous, 16-byte aligned, Cin % 16 == 0; weight int8
// [Npad, KH, KW, Cin] contiguous with Npad a multiple of 64 (zero rows past
// Cout); mult fp32 [Cout]; bias and alpha fp32 (already rounded to the glue
// dtype) or null; out [B, H, W, Cout] contiguous, Cout even; B <= 65535;
// every index below 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kTileN = 64;
constexpr int kChunk = 64;  // input channels staged per K step
constexpr int kPitch = 80;  // bytes per shared row: kChunk + 16
constexpr int kThreads = 256;

template <int KH, int KW>
struct Geometry {
  static constexpr int kTaps = KH * KW;
  static constexpr int kHaloW = kTileW + KW - 1;
  static constexpr int kHaloPx = (kTileH + KH - 1) * kHaloW;
  static constexpr size_t kSmem = (size_t)(kHaloPx + kTaps * kTileN) * kPitch;
};

// v rounded to the glue dtype T, held as a float.
template <typename T>
__device__ __forceinline__ float to_glue(float v);
template <>
__device__ __forceinline__ float to_glue<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_glue<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__device__ __forceinline__ float epilogue(int acc, float m, const float* bias,
                                          const float* alpha, int n) {
  float v = to_glue<T>(__fmul_rn(__int2float_rn(acc), m));
  if (bias != nullptr) v = to_glue<T>(__fadd_rn(v, bias[n]));
  if (alpha != nullptr && !(v >= 0.f)) v = to_glue<T>(__fmul_rn(*alpha, v));
  return v;
}

template <typename T, int KH, int KW>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ weight,
                     const float* __restrict__ mult,
                     const float* __restrict__ bias,
                     const float* __restrict__ alpha, T* __restrict__ out,
                     int h, int w, int cin, int cout, int pad_top,
                     int pad_left) {
  using G = Geometry<KH, KW>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* halo = smem;
  unsigned char* ws = smem + G::kHaloPx * kPitch;

  const int tiles_w = (w + kTileW - 1) / kTileW;
  const int h0 = (blockIdx.x / tiles_w) * kTileH;
  const int w0 = (blockIdx.x % tiles_w) * kTileW;
  const int n0 = blockIdx.y * kTileN;
  const int b = blockIdx.z;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int r0 = 2 * (warp % 4);  // this warp's two tile rows
  const int wn = 32 * (warp / 4);  // and its 32 channels of the N tile

  int acc[2][4][4];
#pragma unroll
  for (int f = 0; f < 2; ++f) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0;
    }
  }

  for (int c0 = 0; c0 < cin; c0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    for (int idx = threadIdx.x; idx < G::kHaloPx * 4; idx += kThreads) {
      const int p = idx >> 2;
      const int c = c0 + (idx & 3) * 16;
      const int hh = h0 - pad_top + p / G::kHaloW;
      const int ww = w0 - pad_left + p % G::kHaloW;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (hh >= 0 && hh < h && ww >= 0 && ww < w && c < cin) {
        v = *reinterpret_cast<const uint4*>(
            x + (((size_t)b * h + hh) * w + ww) * cin + c);
      }
      *reinterpret_cast<uint4*>(halo + p * kPitch + (idx & 3) * 16) = v;
    }
    for (int idx = threadIdx.x; idx < G::kTaps * kTileN * 4; idx += kThreads) {
      const int row = idx >> 2;  // tap * kTileN + n
      const int c = c0 + (idx & 3) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c < cin) {
        v = *reinterpret_cast<const uint4*>(
            weight + ((size_t)(n0 + row % kTileN) * G::kTaps + row / kTileN) *
                         cin + c);
      }
      *reinterpret_cast<uint4*>(ws + row * kPitch + (idx & 3) * 16) = v;
    }
    __syncthreads();

    for (int tap = 0; tap < G::kTaps; ++tap) {
      const int ty = tap / KW;
      const int tx = tap % KW;
#pragma unroll
      for (int ks = 0; ks < kChunk; ks += 32) {
        uint32_t a[2][4];
        uint32_t bm[4][2];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          // rows g and g+8 of the fragment: pixels g, g+8 of tile row r0+f
          const unsigned char* p =
              halo + ((r0 + f + ty) * G::kHaloW + tx + g) * kPitch + ks + t * 4;
          a[f][0] = lds32(p);
          a[f][1] = lds32(p + 8 * kPitch);
          a[f][2] = lds32(p + 16);
          a[f][3] = lds32(p + 8 * kPitch + 16);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned char* p =
              ws + (tap * kTileN + wn + 8 * j + g) * kPitch + ks + t * 4;
          bm[j][0] = lds32(p);
          bm[j][1] = lds32(p + 16);
        }
#pragma unroll
        for (int f = 0; f < 2; ++f) {
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(acc[f][j], a[f], bm[j]);
        }
      }
    }
  }

  // Epilogue from the registers: accumulator e of fragment (f, j) is pixel
  // g + 8 * (e / 2) of tile row r0 + f, channel wn + 8j + 2t + e % 2.
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int y = h0 + r0 + f;
    if (y >= h) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn + 8 * j + 2 * t;
      if (n >= cout) continue;
      const float m0 = mult[n];
      const float m1 = mult[n + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int xx = w0 + g + 8 * half;
        if (xx >= w) continue;
        const float v0 =
            epilogue<T>(acc[f][j][2 * half], m0, bias, alpha, n);
        const float v1 =
            epilogue<T>(acc[f][j][2 * half + 1], m1, bias, alpha, n + 1);
        store_pair(out + (((size_t)b * h + y) * w + xx) * cout + n, v0, v1);
      }
    }
  }
}

template <typename T, int KH, int KW>
int launch(const void* x, const void* weight, const void* mult,
           const void* bias, const void* alpha, void* out, int b, int h,
           int w, int cin, int cout, int pad_top, int pad_left, void* stream) {
  using G = Geometry<KH, KW>;
  auto kernel = int8_conv_kernel<T, KH, KW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((h + kTileH - 1) / kTileH) * ((w + kTileW - 1) / kTileW);
  const dim3 grid(tiles, (cout + kTileN - 1) / kTileN, b);
  kernel<<<grid, kThreads, G::kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(weight),
      static_cast<const float*>(mult), static_cast<const float*>(bias),
      static_cast<const float*>(alpha), static_cast<T*>(out), h, w, cin, cout,
      pad_top, pad_left);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* weight, const void* mult,
             const void* bias, const void* alpha, void* out, int b, int h,
             int w, int cin, int cout, int kh, int kw, int pad_top,
             int pad_left, void* stream) {
  if (kh == 3 && kw == 3) {
    return launch<T, 3, 3>(x, weight, mult, bias, alpha, out, b, h, w, cin,
                           cout, pad_top, pad_left, stream);
  }
  if (kh == 2 && kw == 2) {
    return launch<T, 2, 2>(x, weight, mult, bias, alpha, out, b, h, w, cin,
                           cout, pad_top, pad_left, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry points (bound with ctypes). x int8 [B, H, W, Cin], weight int8
// [Npad, KH, KW, Cin], mult fp32 [Cout], bias / alpha fp32 or null, out
// [B, H, W, Cout] in the glue dtype. KH x KW is 3x3 or 2x2; the output is
// H x W, input pixel (y + dy - pad_top, x + dx - pad_left) feeding tap
// (dy, dx) of output (y, x). Each returns cudaGetLastError() of its launch.
extern "C" int fsr_int8_conv_bf16(const void* x, const void* weight,
                                  const void* mult, const void* bias,
                                  const void* alpha, void* out, int b, int h,
                                  int w, int cin, int cout, int kh, int kw,
                                  int pad_top, int pad_left, void* stream) {
  return dispatch<bf16>(x, weight, mult, bias, alpha, out, b, h, w, cin, cout,
                        kh, kw, pad_top, pad_left, stream);
}

extern "C" int fsr_int8_conv_f32(const void* x, const void* weight,
                                 const void* mult, const void* bias,
                                 const void* alpha, void* out, int b, int h,
                                 int w, int cin, int cout, int kh, int kw,
                                 int pad_top, int pad_left, void* stream) {
  return dispatch<float>(x, weight, mult, bias, alpha, out, b, h, w, cin,
                         cout, kh, kw, pad_top, pad_left, stream);
}
