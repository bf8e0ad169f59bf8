// Fused upsample stage for Hopper (sm_90a): 3x3 conv 64 -> 4C (pad 1) +
// bias -> PixelShuffle(2) -> single-slope PReLU, in one kernel.
//
// Replaces the TPU kernels of fast_srgan_tpu/kernels/fused_upsample.py:
// `_make_kernel` (v1, one input row per step), `_make_kernel_v2` (R-row
// blocks) and `_make_kernel_v3` (pre-shifted input copies). The three are
// tilings of one function, forced by VMEM size and sublane alignment; here
// one kernel takes every H and W.
//
// The conv is an implicit GEMM: M = B*H*W pre-shuffle pixels, N = 4C output
// channels, K = 9 taps x 64 input channels, accumulated in fp32. At the
// training widths it is bound by arithmetic (stage 2 at batch 24: 16 GFLOP
// against 3.5 + 28 MB moved), so the design keeps every operand reuse on
// chip and writes the 4x-larger output exactly once:
//
//   * A block owns an 8x16-pixel tile of one sample (M tile 128) and 64 of
//     the 4C channels (N tile 64). It stages the tile's input halo
//     (10x18 pixels x 64 channels, zero outside the image: the conv's
//     padding) in shared memory once, and loops over the 9 taps, staging
//     that tap's [64 x 64] weight slice. Every tap's A operand is the halo
//     shifted by (dy, dx): no im2col buffer in device memory.
//   * bf16: WMMA 16x16x16 bf16 tensor-core products with fp32 accumulators;
//     8 warps each own 32 pixels x 32 channels. fp32: CUDA-core FMAs, each
//     thread 8 pixels x 4 channels (TF32 would not hold fp32's contract).
//   * The weight's N axis arrives phase-major (n' = (2i+j)*C + c, the
//     layout algebra of fast_srgan_tpu/kernels/pixel_shuffle.py), so each
//     (i, j) phase is C contiguous channels. The epilogue adds the bias,
//     applies the PReLU and stores 16-byte vectors straight to the shuffled
//     channels_last address out[b, 2h+i, 2w+j, c]: the [B, 4C, H, W]
//     intermediate never exists.
//
// Numerics: fp32 accumulation over the taps in order, the bias (rounded to
// the activation dtype by the wrapper) added in fp32, the slope rounded to
// the activation dtype, one rounding to the output dtype at the store. The
// plain version rounds after the conv and again after the bias.
//
// The wrapper (fast_srgan_torch/kernels/fused_upsample.py) guarantees: x
// channels_last contiguous [B, 64, H, W] (NHWC memory), 16-byte aligned;
// weight [9][64][4C] contiguous in x's dtype, phase-major along 4C; bias fp32
// [4C] phase-major; alpha one fp32 value on the device (both rounded to x's
// dtype first, as the plain version casts them); C % 16 == 0 (so 4C is
// a multiple of the 64-channel N tile); out [B, 2H, 2W, C] contiguous;
// B <= 65535.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kCin = 64;
constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kTileN = 64;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloPx = (kTileH + 2) * kHaloW;
constexpr int kThreads = 256;

// Shared-memory row pitches in elements. bf16: 80 (160 bytes, a multiple of
// the 32 bytes WMMA needs, and not of the 128 of a bank cycle); fp32 halo:
// 68, so the two tile rows a warp reads at once land on different banks.
template <typename T>
struct Pitch;
template <>
struct Pitch<float> {
  static constexpr int kHalo = 68;
  static constexpr int kW = 64;
};
template <>
struct Pitch<bf16> {
  static constexpr int kHalo = 80;
  static constexpr int kW = 80;
};
constexpr int kStagePitch = 68;  // fp32 accumulator staging (bf16 path)

template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)(kHaloPx * Pitch<T>::kHalo + kCin * Pitch<T>::kW) * sizeof(T);
}
static_assert(smem_bytes<bf16>() >= kTileH * kTileW * kStagePitch * 4,
              "the bf16 staging tile aliases the halo and weight buffers");

// The tile's input halo, rows h0-1 .. h0+8, columns w0-1 .. w0+16, zero
// outside the image, in 16-byte vectors.
template <typename T>
__device__ __forceinline__ void load_halo(const T* __restrict__ x, T* halo,
                                          int b, int h, int w, int h0,
                                          int w0) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerPx = kCin / kVec;
  for (int idx = threadIdx.x; idx < kHaloPx * kPerPx; idx += kThreads) {
    const int p = idx / kPerPx;
    const int v = idx % kPerPx;
    const int hh = h0 - 1 + p / kHaloW;
    const int ww = w0 - 1 + p % kHaloW;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (hh >= 0 && hh < h && ww >= 0 && ww < w) {
      val = *reinterpret_cast<const uint4*>(
          x + (((size_t)b * h + hh) * w + ww) * kCin + v * kVec);
    }
    *reinterpret_cast<uint4*>(halo + p * Pitch<T>::kHalo + v * kVec) = val;
  }
}

// One tap's weight slice: ws[k][n] = weight[tap][k][n0 + n], k < 64, n < 64.
template <typename T>
__device__ __forceinline__ void load_tap_weights(const T* __restrict__ weight,
                                                 T* ws, int tap, int n0,
                                                 int n4) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kTileN / kVec;
  for (int idx = threadIdx.x; idx < kCin * kPerRow; idx += kThreads) {
    const int k = idx / kPerRow;
    const int v = idx % kPerRow;
    *reinterpret_cast<uint4*>(ws + k * Pitch<T>::kW + v * kVec) =
        *reinterpret_cast<const uint4*>(
            weight + ((size_t)tap * kCin + k) * n4 + n0 + v * kVec);
  }
}

// The shuffled address of channel n' (phase-major) of pre-shuffle pixel
// (b, y, x): out[b, 2y+i, 2x+j, c] with 2i+j = n' / C, c = n' % C.
__device__ __forceinline__ size_t shuffled_offset(int b, int y, int x, int n,
                                                  int h, int w, int c) {
  const int phase = n / c;
  return (((size_t)b * 2 * h + 2 * y + (phase >> 1)) * 2 * w + 2 * x +
          (phase & 1)) * c + n % c;
}

__global__ void __launch_bounds__(kThreads)
    fused_upsample_f32_kernel(const float* __restrict__ x,
                              const float* __restrict__ weight,
                              const float* __restrict__ bias,
                              const float* __restrict__ alpha,
                              float* __restrict__ out, int h, int w, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* halo = reinterpret_cast<float*>(smem);
  float* ws = halo + kHaloPx * Pitch<float>::kHalo;
  const int tiles_w = (w + kTileW - 1) / kTileW;
  const int h0 = (blockIdx.x / tiles_w) * kTileH;
  const int w0 = (blockIdx.x % tiles_w) * kTileW;
  const int n0 = blockIdx.y * kTileN;
  const int b = blockIdx.z;

  load_halo<float>(x, halo, b, h, w, h0, w0);

  // thread: 4 channels (tn) x 8 pixels of tile row r, columns c0 .. c0+7
  const int tn = threadIdx.x % 16;
  const int tm = threadIdx.x / 16;
  const int r = tm % kTileH;
  const int c0 = (tm / kTileH) * 8;
  float acc[8][4];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  }

  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // the previous tap's weights are consumed
    load_tap_weights<float>(weight, ws, tap, n0, 4 * c);
    __syncthreads();
    const float* a_base = halo + ((r + tap / 3) * kHaloW + c0 + tap % 3) *
                                     Pitch<float>::kHalo;
#pragma unroll 4
    for (int k = 0; k < kCin; ++k) {
      const float4 wv =
          *reinterpret_cast<const float4*>(ws + k * Pitch<float>::kW + tn * 4);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float a = a_base[q * Pitch<float>::kHalo + k];
        acc[q][0] = fmaf(a, wv.x, acc[q][0]);
        acc[q][1] = fmaf(a, wv.y, acc[q][1]);
        acc[q][2] = fmaf(a, wv.z, acc[q][2]);
        acc[q][3] = fmaf(a, wv.w, acc[q][3]);
      }
    }
  }

  const int n = n0 + tn * 4;
  const float4 bv = *reinterpret_cast<const float4*>(bias + n);
  const float slope = __ldg(alpha);
  const int y = h0 + r;
  if (y >= h) return;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int xx = w0 + c0 + q;
    if (xx < w) {
      float v[4] = {acc[q][0] + bv.x, acc[q][1] + bv.y, acc[q][2] + bv.z,
                    acc[q][3] + bv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = v[e] >= 0.f ? v[e] : slope * v[e];
      *reinterpret_cast<float4*>(out + shuffled_offset(b, y, xx, n, h, w, c)) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    fused_upsample_bf16_kernel(const bf16* __restrict__ x,
                               const bf16* __restrict__ weight,
                               const float* __restrict__ bias,
                               const float* __restrict__ alpha,
                               bf16* __restrict__ out, int h, int w, int c) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);
  bf16* ws = halo + kHaloPx * Pitch<bf16>::kHalo;
  float* stage = reinterpret_cast<float*>(smem);  // after the main loop
  const int tiles_w = (w + kTileW - 1) / kTileW;
  const int h0 = (blockIdx.x / tiles_w) * kTileH;
  const int w0 = (blockIdx.x % tiles_w) * kTileW;
  const int n0 = blockIdx.y * kTileN;
  const int b = blockIdx.z;

  load_halo<bf16>(x, halo, b, h, w, h0, w0);

  // warp: tile rows 2*wm, 2*wm+1 (16 pixels each) x channels 32*wn .. +31
  const int warp = threadIdx.x / 32;
  const int wm = warp % 4;
  const int wn = warp / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int f = 0; f < 2; ++f) {
#pragma unroll
    for (int g = 0; g < 2; ++g) wmma::fill_fragment(acc[f][g], 0.f);
  }

  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();
    load_tap_weights<bf16>(weight, ws, tap, n0, 4 * c);
    __syncthreads();
    const int ty = tap / 3;
    const int tx = tap % 3;
#pragma unroll
    for (int k0 = 0; k0 < kCin; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm[2];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        // 16 pixels of tile row r: consecutive halo pixels, pitch kHalo
        const int r = 2 * wm + f;
        wmma::load_matrix_sync(
            a[f], halo + ((r + ty) * kHaloW + tx) * Pitch<bf16>::kHalo + k0,
            Pitch<bf16>::kHalo);
      }
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        wmma::load_matrix_sync(bm[g],
                               ws + k0 * Pitch<bf16>::kW + 32 * wn + 16 * g,
                               Pitch<bf16>::kW);
      }
#pragma unroll
      for (int f = 0; f < 2; ++f) {
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          wmma::mma_sync(acc[f][g], a[f], bm[g], acc[f][g]);
        }
      }
    }
  }

  __syncthreads();  // halo and weights are dead: stage the fp32 tile there
#pragma unroll
  for (int f = 0; f < 2; ++f) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      wmma::store_matrix_sync(
          stage + (2 * wm + f) * 16 * kStagePitch + 32 * wn + 16 * g,
          acc[f][g], kStagePitch, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // epilogue: 128 pixels x 8 groups of 8 channels, one 16-byte store each
  const float slope = __ldg(alpha);
  for (int idx = threadIdx.x; idx < kTileH * kTileW * 8; idx += kThreads) {
    const int m = idx / 8;
    const int grp = idx % 8;
    const int y = h0 + m / kTileW;
    const int xx = w0 + m % kTileW;
    if (y >= h || xx >= w) continue;
    const int n = n0 + grp * 8;
    const float* s = stage + m * kStagePitch + grp * 8;
    uint4 packed;
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v0 = s[2 * e] + bias[n + 2 * e];
      float v1 = s[2 * e + 1] + bias[n + 2 * e + 1];
      v0 = v0 >= 0.f ? v0 : slope * v0;
      v1 = v1 >= 0.f ? v1 : slope * v1;
      p2[e] = __floats2bfloat162_rn(v0, v1);
    }
    *reinterpret_cast<uint4*>(out + shuffled_offset(b, y, xx, n, h, w, c)) =
        packed;
  }
}

template <typename T, typename Kernel>
int launch(Kernel kernel, const void* x, const void* weight, const void* bias,
           const void* alpha, void* out, int b, int h, int w, int c,
           void* stream) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles =
      ((h + kTileH - 1) / kTileH) * ((w + kTileW - 1) / kTileW);
  const dim3 grid(tiles, 4 * c / kTileN, b);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(weight),
      static_cast<const float*>(bias), static_cast<const float*>(alpha),
      static_cast<T*>(out), h, w, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes). x [B, H, W, 64], weight [9, 64, 4C]
// phase-major in x's dtype, bias [4C] fp32 phase-major, alpha one fp32
// value, out [B, 2H, 2W, C]. Each returns cudaGetLastError() of its launch.
extern "C" int fsr_fused_upsample_bf16(const void* x, const void* weight,
                                       const void* bias, const void* alpha,
                                       void* out, int b, int h, int w, int c,
                                       void* stream) {
  return launch<bf16>(fused_upsample_bf16_kernel, x, weight, bias, alpha, out,
                      b, h, w, c, stream);
}

extern "C" int fsr_fused_upsample_f32(const void* x, const void* weight,
                                      const void* bias, const void* alpha,
                                      void* out, int b, int h, int w, int c,
                                      void* stream) {
  return launch<float>(fused_upsample_f32_kernel, x, weight, bias, alpha, out,
                       b, h, w, c, stream);
}
