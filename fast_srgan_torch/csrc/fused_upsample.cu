// Fused upsample stage for Hopper (sm_90a): 3x3 conv 64 -> 4C (pad 1) +
// bias -> PixelShuffle(2) -> single-slope PReLU, in one kernel; or, for the
// backward, the same without the PReLU (the pre-activation z).
//
// Replaces the TPU kernels of fast_srgan_tpu/kernels/fused_upsample.py:
// `_make_kernel` (v1, one input row per step), `_make_kernel_v2` (R-row
// blocks) and `_make_kernel_v3` (pre-shifted input copies). The three are
// tilings of one function, forced by VMEM size and sublane alignment; here
// one kernel takes every H and W.
//
// What bounds it. The conv is an implicit GEMM: M = B*H*W pre-shuffle
// pixels, N = 4C, K = 9 taps x 64 channels. At batch 24 of 48x48 (training
// stage 2) that is 16.3 GFLOP (0.0165 ms at 989 TFLOP/s bf16) against 35 MB
// moved (0.0106 ms at 3.35 TB/s): arithmetic, so only wgmma reaches the
// bound, and it has to be fed without stalls. At batch 8 of 180x320 it is
// 136 GFLOP (0.137 ms) against 295 MB (0.088 ms): arithmetic again, with the
// 4x-larger output the largest byte cost.
//
// What the bf16 design does about it:
//   * Weight-stationary, persistent: one block an SM holds its N tile of
//     the weight (NT = 128 output channels: 9 x 64 x 128 bf16 = 147 KB) in
//     shared memory for all its pixel tiles, so the weight is read from L2
//     once a block, not once a tile. 4C = 256 takes two N tiles (half the
//     SMs each); NT = 64 where 4C is not a multiple of 128 (C = 16).
//   * Two warpgroups a block, each with its own double-buffered halo, deal
//     the pixel tiles of the block's contiguous range between them, so one
//     warpgroup's epilogue and stores can run under the other's wgmmas. A
//     warpgroup's tile is 8x8 pixels (one m64), its halo 10x10 pixels x 64
//     channels, zero outside the image (the conv's padding), filled by
//     cp.async one tile ahead, so the next tile's loads are in flight under
//     this tile's wgmmas. The address arithmetic a tile needs (halo
//     offsets, the shuffled output offsets of a thread's channels) is
//     32-bit or made once per thread.
//   * Both operands by descriptor (wgmma's SS form, no swizzle, K-major).
//     The halo is stored as 8 planes of 8 channels, pixel after pixel
//     (16 bytes a pixel). Then 8 consecutive pixels of a halo row are one
//     128-byte core matrix, and the A operand of tap (dy, dx) is the halo
//     shifted by dy rows and dx pixels: a descriptor whose start moves by
//     16 bytes a pixel, core matrices a halo row apart (SBO) and a plane
//     apart along K (LBO). No im2col, no ldmatrix, no register A. The
//     weight is stored by the wrapper in the core-matrix layout, (tap,
//     16-channel step) slice after slice.
//   * One batch of 36 wgmma m64nNTk16 (9 taps x 4 steps) a tile, fp32
//     accumulators, then the epilogue on the registers: bias, PReLU, one
//     rounding to bf16. The wrapper's tiling orders the N axis so that each
//     thread holds 8 consecutive phase-major channels of a pixel, which is
//     one 16-byte store to the shuffled address out[b, 2y+i, 2x+j, c]:
//     with NT = 2C those are phases (i, 0) and (i, 1), so a pixel's 128
//     channels are 256 contiguous bytes of output row 2y+i. The stores are
//     streaming (st.global.cs). The [B, 4C, H, W] conv output never exists.
//
// What holds it back (PERF.md section 6): the instructions around the
// wgmmas, the epilogue's and the halo copies'. In one-off probes (not
// kept), leaving out the output stores or the halo copies made it markedly
// faster, while storing every tile to one fixed place or a 128B-swizzled
// weight layout did not change it: neither DRAM writes nor bank conflicts
// are the limit. Not faster in those probes, at one shape or more: three
// warpgroups, warpgroups taking strict turns at the tensor cores,
// double-buffered accumulators, stores deferred past the next tile's
// wgmmas, the weight waited for tap by tap, two accumulator chains.
//
// fp32 keeps a CUDA-core kernel (TF32 would not hold fp32's 5e-5
// contract): a block owns an 8x16-pixel tile and 64 of the 4C channels,
// stages the halo once and each tap's weight slice, each thread 8 pixels x
// 4 channels.
//
// Numerics: fp32 accumulation, the bias (in the activation dtype, as the
// plain version casts it) added in fp32, the slope in the activation dtype,
// one rounding to the output dtype at the store. The plain version rounds
// after the conv and again after the bias.
//
// The wrapper (fast_srgan_torch/kernels/fused_upsample.py) guarantees: x
// channels_last contiguous [B, 64, H, W] (NHWC memory), 16-byte aligned;
// weight in x's dtype, bf16: tiled [4C / NT][9][4][2][NT][8] (tile_weights),
// fp32: [9][64][4C] phase-major; bias [4C] in torch channel order and alpha
// one value, both in x's dtype on the device; C % 16 == 0; out
// [B, 2H, 2W, C] contiguous; every index below 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kCin = 64;

// ---- bf16: wgmma --------------------------------------------------------

constexpr int kGroups = 2;  // warpgroups a block
constexpr int kBf16Threads = 128 * kGroups;
constexpr int kTile = 8;  // a warpgroup's tile: 8x8 pixels, one m64
constexpr int kHaloSide = kTile + 2;
constexpr int kHaloPx = kHaloSide * kHaloSide;
// One plane: 8 channels of every halo pixel, 16 bytes each, + 16 bytes so
// the 8 planes of one pixel land on distinct banks.
constexpr int kPlane = kHaloPx * 16 + 16;
constexpr int kHaloBytes = 8 * kPlane;
constexpr int kHaloCopies = (kHaloPx * 8 + 127) / 128;  // cp.async a thread

template <int NT>
struct Geometry {
  static constexpr int kSliceBytes = 2 * NT * 16;  // a (tap, 16-channel step)
  static constexpr int kWeightBytes = 36 * kSliceBytes;
  static constexpr int kSmem = kWeightBytes + kGroups * 2 * kHaloBytes;
  static constexpr int kAcc = NT / 2;  // fp32 accumulators a thread
};
static_assert(Geometry<128>::kSmem <= 232448, "the weight tile and halos fit");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when src_size is 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_size) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_size)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// This thread's shared-memory writes, visible to wgmma's (async-proxy) reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier of one warpgroup (ids 1.. ; 0 is __syncthreads).
__device__ __forceinline__ void group_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// 16 bytes to global memory, streaming: evicted first (read once, later).
__device__ __forceinline__ void store16_cs(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// No swizzle, K-major: core matrices of 8 rows x 16 bytes; LBO steps to the
// next 16 bytes of K, SBO to the next 8 rows.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// wgmma m64nNk16, bf16 x bf16 -> fp32, both operands by descriptor;
// D = A * B + (scale_d ? D : 0).
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

struct TileOrigin {
  int b, y0, x0;
};

__device__ __forceinline__ TileOrigin tile_origin(int tile, int tiles_h,
                                                  int tiles_w) {
  const int tx = tile % tiles_w;
  const int rest = tile / tiles_w;
  return {rest / tiles_h, (rest % tiles_h) * kTile, tx * kTile};
}

// One warpgroup's halo of tile `tile` into `dst` (8 planes, see above):
// cp.async, 16 bytes a copy, consecutive threads on one pixel's 128 bytes.
__device__ __forceinline__ void load_halo(uint32_t dst,
                                          const bf16* __restrict__ x, int tile,
                                          int tiles_h, int tiles_w, int h,
                                          int w, int tid) {
  const TileOrigin o = tile_origin(tile, tiles_h, tiles_w);
  const bf16* img = x + (size_t)o.b * h * w * kCin;
#pragma unroll
  for (int m = 0; m < kHaloCopies; ++m) {
    const int i = tid + 128 * m;
    if (i < kHaloPx * 8) {
      const int p = i >> 3, k = i & 7;
      const int yy = o.y0 - 1 + p / kHaloSide;
      const int xx = o.x0 - 1 + p % kHaloSide;
      const bool in = (unsigned)yy < (unsigned)h && (unsigned)xx < (unsigned)w;
      const bf16* src = in ? img + (yy * w + xx) * kCin + k * 8 : x;
      cp_async16(dst + k * kPlane + p * 16, src, in ? 16 : 0);
    }
  }
}

// Bias of phase-major channel n = (2i + j) C + ch: torch channel ch * 4 + 2i + j.
template <typename T>
__device__ __forceinline__ float bias_at(const T* __restrict__ bias, int n,
                                         int c) {
  const int phase = n / c;
  return static_cast<float>(bias[(n - phase * c) * 4 + phase]);
}

// One tap's 4 wgmmas (16 input channels each) on the halo in `buf`.
template <int NT>
__device__ __forceinline__ void mma_tap(float (&acc)[NT / 2], uint32_t buf,
                                        uint32_t wts, int tap) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t a =
        desc(buf + ((tap / 3) * kHaloSide + tap % 3) * 16 + 2 * ks * kPlane,
             kPlane, kHaloSide * 16);
    const uint64_t b =
        desc(wts + (tap * 4 + ks) * Geometry<NT>::kSliceBytes, NT * 16, 128);
    wgmma(acc, a, b, tap | ks);
  }
}

template <int NT, bool kPrelu>
__global__ void __launch_bounds__(kBf16Threads, 1)
    fused_upsample_bf16_kernel(const bf16* __restrict__ x,
                               const bf16* __restrict__ weight,
                               const bf16* __restrict__ bias,
                               const bf16* __restrict__ alpha,
                               bf16* __restrict__ out, int n_img, int h, int w,
                               int c, int blocks_per_n) {
  using G = Geometry<NT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t wts = smem_u32(smem);
  const int group = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const uint32_t halo = wts + G::kWeightBytes + group * 2 * kHaloBytes;

  const int n_tiles = 4 * c / NT;
  const int nt = blockIdx.x % n_tiles;
  const int n0 = nt * NT;
  const int tiles_w = (w + kTile - 1) / kTile;
  const int tiles_h = (h + kTile - 1) / kTile;
  const int tiles = n_img * tiles_h * tiles_w;
  // The block's contiguous range of pixel tiles, dealt to its warpgroups
  // in turn.
  const int bi = blockIdx.x / n_tiles;
  const int begin = (int)((long long)tiles * bi / blocks_per_n);
  const int end = (int)((long long)tiles * (bi + 1) / blocks_per_n);
  int tile = begin + group;

  // The block's weight tile, resident for all its pixel tiles, and each
  // warpgroup's first halo.
  if (tile < end) load_halo(halo, x, tile, tiles_h, tiles_w, h, w, tid);
  const unsigned char* wsrc =
      reinterpret_cast<const unsigned char*>(weight) + (size_t)nt * G::kWeightBytes;
  for (int i = threadIdx.x; i < G::kWeightBytes / 16; i += kBf16Threads) {
    cp_async16(wts + i * 16, wsrc + (size_t)i * 16, 16);
  }
  cp_async_commit();
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  const float slope = kPrelu ? static_cast<float>(alpha[0]) : 0.f;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, t = lane & 3;
  // This thread's 8 channels of each 32, n = n0 + 32 jq + 8t + e: their
  // bias, and where they land in a pixel's 2x2 output block (phase-major
  // n = (2i + j) C + ch -> output row 2y + i, column 2x + j, channel ch).
  float bv[NT / 32][8];
  int chan_off[NT / 32];
#pragma unroll
  for (int jq = 0; jq < NT / 32; ++jq) {
    const int n = n0 + 32 * jq + 8 * t;
    const int phase = n / c;
    chan_off[jq] = ((phase >> 1) * 2 * w + (phase & 1)) * c + n - phase * c;
#pragma unroll
    for (int e = 0; e < 8; ++e) bv[jq][e] = bias_at(bias, n + e, c);
  }
  float acc[G::kAcc];

  for (int r = 0; tile < end; ++r, tile += kGroups) {
    const uint32_t buf = halo + (r & 1) * kHaloBytes;
    cp_async_wait_all();  // this thread's copies of this tile's halo
    fence_proxy_async();
    // Everyone's copies landed, and the group is done with the previous
    // tile, so its buffer can take the next tile's halo.
    group_barrier(1 + group);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) mma_tap<NT>(acc, buf, wts, tap);
    wgmma_commit();
    // the next tile's halo, in flight under this tile's wgmmas
    if (tile + kGroups < end) {
      load_halo(halo + ((r + 1) & 1) * kHaloBytes, x, tile + kGroups, tiles_h,
                tiles_w, h, w, tid);
    }
    cp_async_commit();
    wgmma_wait_all();

    // Accumulator 4j + 2hf + e is pixel (row 2 warp + hf, column g) of the
    // tile and tile column 8j + 2t + e, which the wrapper's tiling made
    // phase-major channel n0 + 32 (j / 4) + 8t + 2 (j % 4) + e.
    const TileOrigin o = tile_origin(tile, tiles_h, tiles_w);
    const int xx = o.x0 + g;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int yy = o.y0 + 2 * warp + hf;
      if (yy >= h || xx >= w) continue;
      bf16* px = out + (((size_t)o.b * 2 * h + 2 * yy) * 2 * w + 2 * xx) * c;
#pragma unroll
      for (int jq = 0; jq < NT / 32; ++jq) {
        uint4 packed;
        uint32_t* words = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * jq + jj;
          float v0 = acc[4 * j + 2 * hf] + bv[jq][2 * jj];
          float v1 = acc[4 * j + 2 * hf + 1] + bv[jq][2 * jj + 1];
          if (kPrelu) {
            v0 = v0 >= 0.f ? v0 : slope * v0;
            v1 = v1 >= 0.f ? v1 : slope * v1;
          }
          const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
          words[jj] = *reinterpret_cast<const uint32_t*>(&pair);
        }
        store16_cs(px + chan_off[jq], packed);
      }
    }
  }
}

template <int NT, bool kPrelu>
int launch_bf16(const void* x, const void* weight, const void* bias,
                const void* alpha, void* out, int b, int h, int w, int c,
                void* stream) {
  using G = Geometry<NT>;
  auto kernel = fused_upsample_bf16_kernel<NT, kPrelu>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = 4 * c / NT;
  const int tiles = b * ((h + kTile - 1) / kTile) * ((w + kTile - 1) / kTile);
  int per_n = sms / n_tiles > 0 ? sms / n_tiles : 1;
  const int needed = (tiles + kGroups - 1) / kGroups;
  per_n = per_n < needed ? per_n : needed;
  kernel<<<per_n * n_tiles, kBf16Threads, G::kSmem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(weight),
      static_cast<const bf16*>(bias), static_cast<const bf16*>(alpha),
      static_cast<bf16*>(out), b, h, w, c, per_n);
  return static_cast<int>(cudaGetLastError());
}

// ---- fp32: CUDA cores ---------------------------------------------------

constexpr int kF32TileH = 8;
constexpr int kF32TileW = 16;
constexpr int kF32TileN = 64;
constexpr int kF32HaloW = kF32TileW + 2;
constexpr int kF32HaloPx = (kF32TileH + 2) * kF32HaloW;
constexpr int kF32Threads = 256;
// Halo pitch 68 floats: the two tile rows a warp reads at once land on
// different banks.
constexpr int kF32HaloPitch = 68;
constexpr int kF32WPitch = 64;
constexpr size_t kF32Smem =
    (size_t)(kF32HaloPx * kF32HaloPitch + kCin * kF32WPitch) * sizeof(float);

__global__ void __launch_bounds__(kF32Threads)
    fused_upsample_f32_kernel(const float* __restrict__ x,
                              const float* __restrict__ weight,
                              const float* __restrict__ bias,
                              const float* __restrict__ alpha,
                              float* __restrict__ out, int h, int w, int c,
                              int prelu) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* halo = reinterpret_cast<float*>(smem);
  float* ws = halo + kF32HaloPx * kF32HaloPitch;
  const int tiles_w = (w + kF32TileW - 1) / kF32TileW;
  const int h0 = (blockIdx.x / tiles_w) * kF32TileH;
  const int w0 = (blockIdx.x % tiles_w) * kF32TileW;
  const int n0 = blockIdx.y * kF32TileN;
  const int b = blockIdx.z;
  const int n4 = 4 * c;

  // the tile's input halo, zero outside the image, in 16-byte vectors
  for (int idx = threadIdx.x; idx < kF32HaloPx * 16; idx += kF32Threads) {
    const int p = idx / 16, v = idx % 16;
    const int hh = h0 - 1 + p / kF32HaloW;
    const int ww = w0 - 1 + p % kF32HaloW;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (hh >= 0 && hh < h && ww >= 0 && ww < w) {
      val = *reinterpret_cast<const float4*>(
          x + (((size_t)b * h + hh) * w + ww) * kCin + v * 4);
    }
    *reinterpret_cast<float4*>(halo + p * kF32HaloPitch + v * 4) = val;
  }

  // thread: 4 channels (tn) x 8 pixels of tile row r, columns c0 .. c0+7
  const int tn = threadIdx.x % 16;
  const int tm = threadIdx.x / 16;
  const int r = tm % kF32TileH;
  const int c0 = (tm / kF32TileH) * 8;
  float acc[8][4];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  }

  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // the previous tap's weights are consumed
    for (int idx = threadIdx.x; idx < kCin * 16; idx += kF32Threads) {
      const int k = idx / 16, v = idx % 16;
      *reinterpret_cast<float4*>(ws + k * kF32WPitch + v * 4) =
          *reinterpret_cast<const float4*>(
              weight + ((size_t)tap * kCin + k) * n4 + n0 + v * 4);
    }
    __syncthreads();
    const float* a_base =
        halo + ((r + tap / 3) * kF32HaloW + c0 + tap % 3) * kF32HaloPitch;
#pragma unroll 4
    for (int k = 0; k < kCin; ++k) {
      const float4 wv =
          *reinterpret_cast<const float4*>(ws + k * kF32WPitch + tn * 4);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float a = a_base[q * kF32HaloPitch + k];
        acc[q][0] = fmaf(a, wv.x, acc[q][0]);
        acc[q][1] = fmaf(a, wv.y, acc[q][1]);
        acc[q][2] = fmaf(a, wv.z, acc[q][2]);
        acc[q][3] = fmaf(a, wv.w, acc[q][3]);
      }
    }
  }

  const int n = n0 + tn * 4;
  const float bv[4] = {bias_at(bias, n, c), bias_at(bias, n + 1, c),
                       bias_at(bias, n + 2, c), bias_at(bias, n + 3, c)};
  const float slope = prelu ? __ldg(alpha) : 0.f;
  const int y = h0 + r;
  if (y >= h) return;
  const int phase = n / c;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int xx = w0 + c0 + q;
    if (xx < w) {
      float v[4] = {acc[q][0] + bv[0], acc[q][1] + bv[1], acc[q][2] + bv[2],
                    acc[q][3] + bv[3]};
      if (prelu) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = v[e] >= 0.f ? v[e] : slope * v[e];
      }
      const size_t off = (((size_t)b * 2 * h + 2 * y + (phase >> 1)) * 2 * w +
                          2 * xx + (phase & 1)) * c + (n - phase * c);
      *reinterpret_cast<float4*>(out + off) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

}  // namespace

// C entry points (bound with ctypes). x [B, H, W, 64]; weight in x's dtype,
// bf16 tiled (NT = 128 if 4C % 128 == 0, else 64), fp32 [9, 64, 4C]
// phase-major; bias [4C] (torch order) and alpha (one value, read only when
// prelu != 0) in x's dtype; out [B, 2H, 2W, C]: PReLU(shuffle(conv + bias)) when
// prelu != 0, else the pre-activation shuffle(conv + bias). Each returns
// cudaGetLastError() of its launch.
extern "C" int fsr_fused_upsample_bf16(const void* x, const void* weight,
                                       const void* bias, const void* alpha,
                                       void* out, int b, int h, int w, int c,
                                       int prelu, void* stream) {
  const bool wide = (4 * c) % 128 == 0;
  if (prelu) {
    return wide ? launch_bf16<128, true>(x, weight, bias, alpha, out, b, h, w, c, stream)
                : launch_bf16<64, true>(x, weight, bias, alpha, out, b, h, w, c, stream);
  }
  return wide ? launch_bf16<128, false>(x, weight, bias, alpha, out, b, h, w, c, stream)
              : launch_bf16<64, false>(x, weight, bias, alpha, out, b, h, w, c, stream);
}

extern "C" int fsr_fused_upsample_f32(const void* x, const void* weight,
                                      const void* bias, const void* alpha,
                                      void* out, int b, int h, int w, int c,
                                      int prelu, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_upsample_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kF32Smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((h + kF32TileH - 1) / kF32TileH) *
                    ((w + kF32TileW - 1) / kF32TileW);
  const dim3 grid(tiles, 4 * c / kF32TileN, b);
  fused_upsample_f32_kernel<<<grid, kF32Threads, kF32Smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<const float*>(alpha),
      static_cast<float*>(out), h, w, c, prelu);
  return static_cast<int>(cudaGetLastError());
}
