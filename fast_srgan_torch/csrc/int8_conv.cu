// int8 x int8 -> int32 convolution with a dequantize + bias + PReLU epilogue
// and an optional requantize, for Hopper (sm_90a): wgmma fed by a cp.async
// ring.
//
// Replaces what XLA lowered for fast_srgan_tpu/quant.py `_Exec.conv_q`
// (lax.conv_general_dilated on int8 NHWC x int8 HWIO with
// preferred_element_type=int32, then `(acc.astype(f32) * (wscale * s/127))
// .astype(glue)`), the `+ bias` and `_prelu` that follow it in `_stage_conv`
// and `_tail_4x`, and, fused, the `_quantize_act` of the next conv's input.
// It is not a Pallas port: the TPU got its int8 convolution from XLA, and
// stock PyTorch has none on CUDA.
//
// Two entry points, one kernel template:
//   * a single conv: 3x3 with padding 1 (stage 1, the trunk, the int8 heads)
//     or 2x2 with padding (1-p, 1-q) top and left (one stage-2 phase), whose
//     output is the glue dtype or, given r = 127 / s_next, int8
//     q = clip(rint(v * r), -127, 127): the next conv's input;
//   * the four stage-2 phases in one launch: phase (p, q)'s tap (gi, gj)
//     reads the one-padded input window at shift (gi + p, gj + q), so all
//     four are shifts of ONE zero-filled halo (ops/lr_tail.py's
//     one-pad-then-window form); a block stages it once and computes the
//     four, writing out[4][B][H][W][Cout].
// Both take the left and right zero columns apart (0 or 1 each; the output
// is narrower than the input where they are 0): the width-sharded forward's
// halo form (fast_srgan_torch/parallel/spatial.py), whose input carries its
// neighbours' columns. It replaces the JAX package's convs of the
// halo-extended shard (fast_srgan_tpu/parallel/spatial.py `_halo_exec_conv`,
// padding ((1, 1), (0, 0)); `_sharded_q_tail_4x`'s phase windows
// xxq[:, :, q:q+w+1] at ((1-p, p), (0, 0))), which XLA lowered on the TPU.
// The halo's columns start at the output tile's less the left padding, so
// the form costs nothing but the columns it reads.
//
// What bounds it, at batch 8 of 180x320 (the serving shape), against the
// H100's 1,979 TOP/s of dense int8 and 3.35 TB/s:
//   * the four phases: 0.966 T ops (0.488 ms) against 1.06 GB moved (118 MB
//     in, 944 MB of bf16 out: 0.317 ms): arithmetic;
//   * stage 1 with the requantize: 1.36e11 ops (0.069 ms) against 148 MB
//     (0.044 ms): arithmetic. Without it, the 236 MB bf16 write makes it
//     memory-bound (0.079 ms).
// Only wgmma reaches the int8 rate, and it has to be fed:
//   * A (pixels x K) comes from registers (wgmma's RS form): a tap's A tile
//     is the halo shifted by whole pixels, which a shared-memory descriptor
//     cannot address in this tile shape (a one-pixel shift is not a
//     multiple of its 8-row core matrix). Each warp fills its fragments with
//     one ldmatrix.x4 a shift; the halo's 48-byte pixel pitch puts the 8 row
//     addresses of each 8x16-byte matrix on distinct banks. The four phases
//     read 9 distinct shifts for their 16 (phase, tap) products, so 9
//     fragments feed 16 wgmmas. (Both operands from shared memory, on 8x8-
//     pixel tiles that a descriptor can address, ran slower in a one-off
//     sweep: no swizzle is possible at a one-pixel shift.)
//   * B (weights, K-major) comes from shared memory by descriptor, in the
//     no-swizzle core-matrix layout [kcol 2][n][16 B]. The wrapper stores
//     the weights in global memory already in this layout, chunk by chunk,
//     so a stage's weights are one linear copy.
//   * K runs in chunks of 32 input channels through a ring of up to 4
//     stages (halo + every slot's weights) filled by cp.async (16 bytes a
//     thread, zero-fill outside the image and past Cin): the copies of
//     chunks k+1.. are in flight while chunk k's wgmmas run.
//   * Two blocks an SM, so one block's barrier, fragment loads and epilogue
//     overlap the other's wgmmas. That caps the accumulators at 64
//     registers a thread: N tiles of 128 for a single conv of 128 or more
//     outputs (stage 1: two N tiles), 64 otherwise, and 32 for the four
//     phases (four m64n32 accumulators). On the card these beat N tiles of
//     256 (stage 1) and 64 (phases) at one block an SM, and 4-warpgroup
//     blocks, in one-off sweeps.
//   * The epilogue runs on the accumulator registers (dequantize, bias,
//     PReLU, optional requantize), stages the tile in shared memory and
//     writes 16-byte vectors, neighbouring threads on neighbouring addresses.
// What still holds it back (PERF.md section 6): feeding, not the tensor
// cores. At M = 128 pixels a block every block re-reads its weight slice
// from L2: the four-phase launch copies 3.9 GB of weights and 1.4 GB of
// halo from L2 into shared memory at batch 8 of 180x320 (counted from the
// shapes), about 1.6 ms at 3.35 TB/s, and more than its 0.488 ms bound at
// any L2 rate below 11 TB/s. Then a barrier and a wgmma drain every 32
// channels (ptxas serializes a register-A pipeline that refills fragments
// while wgmmas are in flight). Weights held in shared memory across the
// tiles of a persistent block cut the first, but in a one-off sweep its
// epilogue, no longer overlapped by a second block, cost more than that
// saved: an epilogue that overlaps the next tile's K loop comes first.
//
// A block is two warpgroups (256 threads) on an 8x16-pixel tile (M 128),
// warpgroup w on tile rows 4w..4w+3 (one m64 tile), one N tile, one sample.
// Every shape of the int8 tier takes this kernel: the full-int8 neck's
// Cin=3 arrives zero-padded to 16 and is zero-filled to the 32-channel
// chunk; Cout 12 and 48 (the int8 heads) use a zero-padded 64-row weight.
//
// Numerics, in the order of quant.py, each step one rounding:
//   v = glue(float(acc) * m[n]),  m = wscale * (s / 127) (fp32, made by the
//   wrapper); then optionally v = glue(v + bias[n]); then optionally
//   v = v >= 0 ? v : glue(alpha * v); then optionally q = int8(clip(rint(
//   v * r), -127, 127)). Integer sums are exact in any order; the products
//   and sums use __fmul_rn / __fadd_rn, which the compiler never contracts
//   into an FMA, so the result is bitwise the plain version's.
//
// The wrapper (fast_srgan_torch/kernels/int8_conv.py) guarantees: x int8
// [B, H, W, Cin] contiguous, 16-byte aligned, Cin % 16 == 0; the tiled
// weight int8 [Npad / NT][ceil(Cin / 32)][slots][2][NT][16]; mult fp32
// [Cout]; bias and alpha fp32 (already rounded to the glue dtype) or null;
// rscale one fp32 value or null; out [(4,) B, H, W, Cout] contiguous, 16-byte
// aligned, Cout even; B <= 65535 (gridDim.z), N tiles <= 65535 (gridDim.y),
// (H / 8) x (W / 16) tiles below 2^31 (gridDim.x). Tensors may pass 2^31
// elements (the 4x int8 head's 1024-channel input does at batch 37 of
// 180x320): every offset into x, out and the weights is formed in 64 bits
// (the halo source and the weight chunks as size_t, the output store and
// the phase stride as long long); what stays 32-bit indexes one sample's
// rows and columns, one tile or shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTileH = 8;   // tile rows: 4 for each warpgroup
constexpr int kTileW = 16;  // tile columns: one warp's 16 A rows
constexpr int kTilePx = kTileH * kTileW;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloPx = (kTileH + 2) * kHaloW;  // the one-padded window
constexpr int kChunk = 32;                      // input channels a K step
constexpr int kPitch = 48;                      // halo bytes a pixel: 32 + 16
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2;
constexpr int kSmemBudget = 110 * 1024;  // of the SM's 228 KB, a block

// P phases (1 or 4) of KH x KH taps each; NT output channels a block.
template <int P, int KH, int NT>
struct Geometry {
  static constexpr int kSlots = P * KH * KH;  // (phase, tap) weight slices
  static constexpr int kSliceBytes = 2 * NT * 16;
  static constexpr int kHaloBytes = kHaloPx * kPitch;
  static constexpr int kWeightBytes = kSlots * kSliceBytes;
  static constexpr int kStageBytes = kHaloBytes + kWeightBytes;
  static constexpr int kAcc = NT / 2;  // s32 accumulators a thread, a phase
  // Two blocks an SM: at most 64 accumulators and 128 registers a thread,
  // and half the shared memory each.
  static constexpr int kStages =
      kSmemBudget / kStageBytes < 4 ? kSmemBudget / kStageBytes : 4;
  static_assert(P * kAcc <= 64, "two blocks an SM need <= 64 accumulators");
  static constexpr int kShifts = P == 4 ? 9 : KH * KH;
  static_assert(kStages >= 2, "a ring needs two stages");
};

template <int P, int KH, int NT, typename O>
constexpr size_t smem_bytes() {
  using G = Geometry<P, KH, NT>;
  const size_t ring = (size_t)G::kStages * G::kStageBytes;
  const size_t staging = (size_t)P * kTilePx * (NT * sizeof(O) + 16);
  return ring > staging ? ring : staging;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past src_size (0 or 16) are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_size) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_size)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's shared-memory writes visible to wgmma's (async-proxy)
// reads of the same buffers.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
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

// K-major, no swizzle: core matrices of 8 rows x 16 bytes, 128 contiguous
// bytes each; LBO steps to the next 16 bytes of K (the slice's second
// column), SBO to the next 8 rows of N.
template <int NT>
__device__ __forceinline__ uint64_t weight_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((NT * 16) >> 4) << 16;
  d |= (uint64_t)(128 >> 4) << 32;
  return d;
}

// wgmma m64nNk32, s8 x s8 -> s32, A (4 registers) from registers, B from
// shared memory by descriptor, D += A * B.
__device__ __forceinline__ void wgmma_s8(int (&d)[16], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

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

template <typename T>
__device__ __forceinline__ float epilogue(int acc, int n, const float* mult,
                                          const float* bias,
                                          const float* alpha) {
  float v = to_glue<T>(__fmul_rn(__int2float_rn(acc), __ldg(mult + n)));
  if (bias != nullptr) v = to_glue<T>(__fadd_rn(v, __ldg(bias + n)));
  if (alpha != nullptr && !(v >= 0.f)) v = to_glue<T>(__fmul_rn(__ldg(alpha), v));
  return v;
}

__device__ __forceinline__ int8_t quantize_one(float v, float r) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, r)), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(q));
}

__device__ __forceinline__ void store_pair(float* p, float v0, float v1, float) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1, float) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store_pair(int8_t* p, float v0, float v1,
                                           float r) {
  p[0] = quantize_one(v0, r);
  p[1] = quantize_one(v1, r);
}

// One K chunk of the halo and of every slot's weights into ring stage
// `base`: cp.async, 16 bytes a copy, zero outside the image and past Cin.
// The halo window starts at input row y0 - 1 and column x0 - hx; in_w is the
// input's width (the output's plus the columns the padding adds or drops).
template <int P, int KH, int NT>
__device__ __forceinline__ void load_chunk(unsigned char* base,
                                           const int8_t* __restrict__ x,
                                           const int8_t* __restrict__ wchunk,
                                           int b, int h, int in_w, int hx,
                                           int cin, int y0, int x0, int c0) {
  using G = Geometry<P, KH, NT>;
  const uint32_t halo = smem_u32(base);
  for (int i = threadIdx.x; i < kHaloPx * 2; i += kThreads) {
    const int p = i >> 1;
    const int c = c0 + (i & 1) * 16;
    const int hh = y0 - 1 + p / kHaloW;
    const int ww = x0 - hx + p % kHaloW;
    const bool in = hh >= 0 && hh < h && ww >= 0 && ww < in_w && c < cin;
    const int8_t* src =
        in ? x + (((size_t)b * h + hh) * in_w + ww) * cin + c : x;
    cp_async16(halo + p * kPitch + (i & 1) * 16, src, in ? 16 : 0);
  }
  const uint32_t wdst = halo + G::kHaloBytes;
  for (int i = threadIdx.x; i < G::kWeightBytes / 16; i += kThreads) {
    cp_async16(wdst + i * 16, wchunk + (size_t)i * 16, 16);
  }
}

// One K chunk's wgmmas for this warpgroup: the A fragments of every shift
// first (distinct registers, so no wgmma in flight reads a register being
// refilled), then every (phase, tap) product, then wait.
template <int P, int KH, int NT>
__device__ __forceinline__ void mma_chunk(
    int (&acc)[P][Geometry<P, KH, NT>::kAcc], const unsigned char* base,
    uint32_t a_lane, int oy, int ox) {
  using G = Geometry<P, KH, NT>;
  const uint32_t halo = smem_u32(base);
  const uint32_t wts = halo + G::kHaloBytes;
  uint32_t a[G::kShifts][4];
  if constexpr (P == 4) {
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      ldmatrix_x4(a[s], halo + a_lane + ((s / 3) * kHaloW + s % 3) * kPitch);
    }
  } else {
#pragma unroll
    for (int t = 0; t < KH * KH; ++t) {
      const int sy = t / KH + oy, sx = t % KH + ox;
      ldmatrix_x4(a[t], halo + a_lane + (sy * kHaloW + sx) * kPitch);
    }
  }
  wgmma_fence();
  if constexpr (P == 4) {
#pragma unroll
    for (int s = 0; s < 9; ++s) {
#pragma unroll
      for (int ph = 0; ph < 4; ++ph) {
        const int gi = s / 3 - ph / 2, gj = s % 3 - ph % 2;
        if (gi >= 0 && gi < 2 && gj >= 0 && gj < 2) {
          const int slot = ph * 4 + gi * 2 + gj;
          wgmma_s8(acc[ph], a[s],
                   weight_desc<NT>(wts + slot * G::kSliceBytes));
        }
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < KH * KH; ++t) {
      wgmma_s8(acc[0], a[t], weight_desc<NT>(wts + t * G::kSliceBytes));
    }
  }
  wgmma_commit();
  wgmma_wait_all();
}

// T: the glue dtype; O: the output element (T, or int8_t with rscale).
// oy, ox: the single conv's window origin in the halo; hx: the halo's first
// column, left of the output tile's (see dispatch_single); w: the output's
// width, in_w the input's.
template <typename T, typename O, int P, int KH, int NT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    int8_conv_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ weight,
                     const float* __restrict__ mult,
                     const float* __restrict__ bias,
                     const float* __restrict__ alpha,
                     const float* __restrict__ rscale, O* __restrict__ out,
                     int h, int in_w, int w, int cin, int cout, int oy,
                     int ox, int hx, long long phase_stride) {
  using G = Geometry<P, KH, NT>;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tiles_w = (w + kTileW - 1) / kTileW;
  const int y0 = (blockIdx.x / tiles_w) * kTileH;
  const int x0 = (blockIdx.x % tiles_w) * kTileW;
  const int n0 = blockIdx.y * NT;
  const int b = blockIdx.z;
  const int nchunks = (cin + kChunk - 1) / kChunk;
  const int8_t* wtile = weight + (size_t)blockIdx.y * nchunks * G::kWeightBytes;

  const int lane = threadIdx.x % 32;
  const int trow = threadIdx.x / 32;  // warp w of warpgroup g: tile row 4g+w
  // ldmatrix.x4: lanes 0-7 / 8-15 address pixels 0-7 / 8-15 of the warp's
  // tile row at K bytes 0-15, lanes 16-31 the same pixels at bytes 16-31
  const uint32_t a_lane =
      (trow * kHaloW + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch +
      (lane >> 4) * 16;

  int acc[P][G::kAcc];
#pragma unroll
  for (int ph = 0; ph < P; ++ph) {
#pragma unroll
    for (int e = 0; e < G::kAcc; ++e) acc[ph][e] = 0;
  }

#pragma unroll
  for (int s = 0; s < G::kStages - 1; ++s) {
    if (s < nchunks) {
      load_chunk<P, KH, NT>(smem + s * G::kStageBytes, x,
                            wtile + (size_t)s * G::kWeightBytes, b, h, in_w,
                            hx, cin, y0, x0, s * kChunk);
    }
    cp_async_commit();
  }
  for (int kc = 0; kc < nchunks; ++kc) {
    cp_async_wait<G::kStages - 2>();  // this thread's copies of chunk kc
    fence_proxy_async();
    __syncthreads();  // everyone's copies landed; chunk kc-1 is consumed
    const int next = kc + G::kStages - 1;
    if (next < nchunks) {
      load_chunk<P, KH, NT>(smem + (next % G::kStages) * G::kStageBytes, x,
                            wtile + (size_t)next * G::kWeightBytes, b, h,
                            in_w, hx, cin, y0, x0, next * kChunk);
    }
    cp_async_commit();
    mma_chunk<P, KH, NT>(acc, smem + (kc % G::kStages) * G::kStageBytes,
                         a_lane, oy, ox);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the output staging tile

  // Epilogue on the registers. Accumulator 4j + 2hf + e of a phase is
  // pixel g + 8 hf of the warp's tile row, channel 8j + 2t + e.
  constexpr int kRow = NT * (int)sizeof(O) + 16;  // staging bytes a pixel
  const float r = rscale != nullptr ? __ldg(rscale) : 0.f;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ph = 0; ph < P; ++ph) {
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int n = 8 * j + 2 * t;
      if (n0 + n >= cout) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int px = trow * kTileW + g + 8 * hf;
        const float v0 = epilogue<T>(acc[ph][4 * j + 2 * hf], n0 + n, mult,
                                     bias, alpha);
        const float v1 = epilogue<T>(acc[ph][4 * j + 2 * hf + 1], n0 + n + 1,
                                     mult, bias, alpha);
        store_pair(reinterpret_cast<O*>(smem + (ph * kTilePx + px) * kRow) + n,
                   v0, v1, r);
      }
    }
  }
  __syncthreads();

  // The staged tile out in 16-byte vectors (bytewise where a row of Cout
  // is not a multiple of 16 bytes: the 2x int8 head's 12 channels).
  constexpr int kPieces = NT * (int)sizeof(O) / 16;
  const int valid = (cout - n0 < NT ? cout - n0 : NT) * (int)sizeof(O);
  const bool vec = (cout * sizeof(O)) % 16 == 0;
  unsigned char* dst0 = reinterpret_cast<unsigned char*>(out);
  for (int i = threadIdx.x; i < P * kTilePx * kPieces; i += kThreads) {
    const int off = (i % kPieces) * 16;
    const int px = (i / kPieces) % kTilePx;
    const int ph = i / (kPieces * kTilePx);
    const int y = y0 + px / kTileW, xx = x0 + px % kTileW;
    if (y >= h || xx >= w || off >= valid) continue;
    const unsigned char* src = smem + (ph * kTilePx + px) * kRow + off;
    unsigned char* dst =
        dst0 + (ph * phase_stride +
                (((long long)b * h + y) * w + xx) * cout + n0) *
                   (long long)sizeof(O) +
        off;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const int n = valid - off < 16 ? valid - off : 16;
      for (int k = 0; k < n; ++k) dst[k] = src[k];
    }
  }
}

template <typename T, typename O, int P, int KH, int NT>
int launch(const void* x, const void* weight, const void* mult,
           const void* bias, const void* alpha, const void* rscale, void* out,
           int b, int h, int in_w, int w, int cin, int cout, int oy, int ox,
           int hx, void* stream) {
  constexpr size_t smem = smem_bytes<P, KH, NT, O>();
  auto kernel = int8_conv_kernel<T, O, P, KH, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((h + kTileH - 1) / kTileH) * ((w + kTileW - 1) / kTileW);
  const dim3 grid(tiles, (cout + NT - 1) / NT, b);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(weight),
      static_cast<const float*>(mult), static_cast<const float*>(bias),
      static_cast<const float*>(alpha), static_cast<const float*>(rscale),
      static_cast<O*>(out), h, in_w, w, cin, cout, oy, ox, hx,
      (long long)b * h * w * cout);
  return static_cast<int>(cudaGetLastError());
}

// Output width w = in_w + pad_left + pad_right - kh + 1. A 3x3 conv (top
// padding 1) loads its halo from column x0 - pad_left, so its taps start
// at halo column 0 (ox = 0) and reach column 17 of the 18; a 2x2 one loads
// from x0 - 1 and starts at ox = 1 - pad_left.
template <typename T, typename O>
int dispatch_single(const void* x, const void* weight, const void* mult,
                    const void* bias, const void* alpha, const void* rscale,
                    void* out, int b, int h, int in_w, int cin, int cout,
                    int n_tile, int kh, int pad_top, int pad_left,
                    int pad_right, void* stream) {
  const int w = in_w + pad_left + pad_right - kh + 1;
  const bool pads = pad_left >= 0 && pad_left <= 1 && pad_right >= 0 &&
                    pad_right <= 1 && w >= 1;
  if (!pads) return static_cast<int>(cudaErrorInvalidValue);
  if (kh == 3 && pad_top == 1) {
    if (n_tile == 128) {
      return launch<T, O, 1, 3, 128>(x, weight, mult, bias, alpha, rscale, out,
                                     b, h, in_w, w, cin, cout, 0, 0, pad_left,
                                     stream);
    }
    if (n_tile == 64) {
      return launch<T, O, 1, 3, 64>(x, weight, mult, bias, alpha, rscale, out,
                                    b, h, in_w, w, cin, cout, 0, 0, pad_left,
                                    stream);
    }
  }
  if (kh == 2 && n_tile == 64 && (pad_top == 0 || pad_top == 1)) {
    return launch<T, O, 1, 2, 64>(x, weight, mult, bias, alpha, rscale, out, b,
                                  h, in_w, w, cin, cout, 1 - pad_top,
                                  1 - pad_left, 1, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The four phases over the window padded by pad_left / pad_right columns:
// phase (p, q) tap (gi, gj) of output column x reads input column
// x - pad_left + q + gj, so w = in_w + pad_left + pad_right - 2, and the halo
// is loaded from column x0 - pad_left.
template <typename T>
int dispatch_phases(const void* x, const void* weight, const void* mult,
                    const void* bias, const void* alpha, void* out, int b,
                    int h, int in_w, int cin, int cout, int n_tile,
                    int pad_left, int pad_right, void* stream) {
  const int w = in_w + pad_left + pad_right - 2;
  if (n_tile != 32 || pad_left < 0 || pad_left > 1 || pad_right < 0 ||
      pad_right > 1 || w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<T, T, 4, 2, 32>(x, weight, mult, bias, alpha, nullptr, out, b,
                                h, in_w, w, cin, cout, 0, 0, pad_left, stream);
}

}  // namespace

// C entry points (bound with ctypes). Single conv: x int8 [B, H, W_in, Cin],
// output width W_in + pad_left + pad_right - KH + 1, weight tiled with n_tile
// output channels a tile, KH x KH = 3x3 (top padding 1, n_tile 128 or 64)
// or 2x2 (top padding 0 or 1, n_tile 64), left and right padding 0 or 1;
// mult fp32 [Cout], bias / alpha fp32 or null; rscale (127 / s_next, fp32)
// null for an output [B, H, W, Cout] in the glue dtype, or given for int8.
// Each returns cudaGetLastError() of its launch.
extern "C" int fsr_int8_conv_bf16(const void* x, const void* weight,
                                  const void* mult, const void* bias,
                                  const void* alpha, const void* rscale,
                                  void* out, int b, int h, int in_w, int cin,
                                  int cout, int n_tile, int kh, int pad_top,
                                  int pad_left, int pad_right, void* stream) {
  if (rscale != nullptr) {
    return dispatch_single<bf16, int8_t>(x, weight, mult, bias, alpha, rscale,
                                         out, b, h, in_w, cin, cout, n_tile,
                                         kh, pad_top, pad_left, pad_right,
                                         stream);
  }
  return dispatch_single<bf16, bf16>(x, weight, mult, bias, alpha, rscale, out,
                                     b, h, in_w, cin, cout, n_tile, kh,
                                     pad_top, pad_left, pad_right, stream);
}

extern "C" int fsr_int8_conv_f32(const void* x, const void* weight,
                                 const void* mult, const void* bias,
                                 const void* alpha, const void* rscale,
                                 void* out, int b, int h, int in_w, int cin,
                                 int cout, int n_tile, int kh, int pad_top,
                                 int pad_left, int pad_right, void* stream) {
  if (rscale != nullptr) {
    return dispatch_single<float, int8_t>(x, weight, mult, bias, alpha, rscale,
                                          out, b, h, in_w, cin, cout, n_tile,
                                          kh, pad_top, pad_left, pad_right,
                                          stream);
  }
  return dispatch_single<float, float>(x, weight, mult, bias, alpha, rscale,
                                       out, b, h, in_w, cin, cout, n_tile, kh,
                                       pad_top, pad_left, pad_right, stream);
}

// The four stage-2 phases: x int8 [B, H, W_in, Cin]; weight the four phase
// kernels tiled together (slot (2p + q) * 4 + 2 gi + gj, n_tile = 32
// output channels a tile); out [4][B, H, W, Cout] in the glue dtype, phase
// (p, q) at index 2p + q, W = W_in + pad_left + pad_right - 2 (1 and 1:
// "same"; 0 and 0: a halo-extended input).
extern "C" int fsr_int8_conv_phases_bf16(const void* x, const void* weight,
                                         const void* mult, const void* bias,
                                         const void* alpha, void* out, int b,
                                         int h, int in_w, int cin, int cout,
                                         int n_tile, int pad_left,
                                         int pad_right, void* stream) {
  return dispatch_phases<bf16>(x, weight, mult, bias, alpha, out, b, h, in_w,
                               cin, cout, n_tile, pad_left, pad_right, stream);
}

extern "C" int fsr_int8_conv_phases_f32(const void* x, const void* weight,
                                        const void* mult, const void* bias,
                                        const void* alpha, void* out, int b,
                                        int h, int in_w, int cin, int cout,
                                        int n_tile, int pad_left,
                                        int pad_right, void* stream) {
  return dispatch_phases<float>(x, weight, mult, bias, alpha, out, b, h, in_w,
                                cin, cout, n_tile, pad_left, pad_right,
                                stream);
}
