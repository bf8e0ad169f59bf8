// One SS2D's four-direction selective scan, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no MambaIR. It is the scan
// of MambaIR's SS2D (models/mambair.py), which the published model runs as
// mamba_ssm's selective_scan_fn on a stack of the four scan orders that it
// builds by flips and transposes of the [B, D, H, W] map. Here the orders are
// addresses. On u [B, H, W, D] (the tokens after the depthwise conv and SiLU)
// and xdbl [B, H, W, 4, R + 2N] (each token's x projection for each order:
// dt [R], B [N], C [N]), L = H W, order k visits the tokens
//
//   k = 0: t = s (row-major)             k = 2: the reverse of k = 0
//   k = 1: t = (s mod H) W + s div H     k = 3: the reverse of k = 1
//
// and, for each channel d, in fp32:
//
//   delta = softplus(dt_w[k, d] . dt + dt_b[k, d])
//   h_s = exp(delta A[k, d, :]) * h_{s-1} + delta u_s B_s      (16 states)
//   y_k(t) = <C_s, h_s> + ds[k, d] u_s
//   out = ((y_0 + y_1) + y_2) + y_3     rounded once to u's type
//
// What bounds it: the special-function unit, in the end. Each state update
// costs one exponential (ex2.approx, A pre-scaled by log2(e)) and four other
// instructions (delta A, delta u B, the state's FMA, C h's FMA); at the
// published size (8 x 180 x 320 tokens, D = 360) that is 1.06e10 exponentials
// a call, 2.54 ms at the MUFU's 16 a clock an SM, against 0.5 GB of u, xdbl and
// y. Short of it, what the walk pays for is the load/store unit: every shared
// memory load, shuffle, global copy and store of a warp takes its cycles, 4
// for a warp's 16-byte load and one per 128-byte line a global access
// touches, and an SM's ~11 warps wait on them more than on their arithmetic
// (the ablations below). The state carries along L, so each channel's walk
// is sequential in s. The design:
//
// * One block (4 warps) a frame and 8 channels, one warp an order, four lanes a
//   channel (lane = 4 c + q holds states 4q .. 4q + 3 of channel c, with their
//   A * log2(e)): B D / 8 blocks of 4 warps (1440 warps, ~11 an SM, at the
//   published size), each walking all L steps of its order.
// * Chunks of kChunk = 32 steps, one a lane: lane j keeps the token of step j
//   (advanced by 32 steps a chunk with no division). The chunk's xdbl rows of
//   this order are copied into the warp's shared memory by cp.async in pieces
//   of four values, the 32 lanes on 32 consecutive pieces, so that a copy
//   touches a few lines and not 32; lane j copies its token's u of the
//   block's 8 channels. Two chunks in flight: chunk c + 1 lands while chunk c
//   is walked. A staged row keeps xdbl's type, its B and C interleaved by
//   lane (a lane's 4 B and 4 C of a step: one 16-byte load in bf16, unpacked
//   by one shift or mask a value), then dt, padded against bank conflicts.
// * A chunk's deltas first, softplus(dt_w . dt + dt_b) with a softplus of one
//   exponential and a degree-8 polynomial for log1p, into shared memory with
//   delta u, a row a channel. In bf16 the projection runs on the tensor
//   cores (mma m16n8k16, steps x dt slots x channels: dt is exact in bf16,
//   dt_w is split in three bf16 parts, the sum in fp32 from the bias); in
//   fp32 lane q of a channel computes steps q, q + 4, ..., q + 28 by FMAs
//   over the R slots (R a template argument, 4 to 16).
// * Then the chunk's 32 steps, unrolled, in groups of four: a lane reads each
//   group's four deltas and four delta u of its channel as two 16-byte loads
//   and each step's B and C as one (bf16) or two (fp32), updates its 4 states
//   and keeps its partial sum <C, h> of each step; the quad joins them by a
//   reduce-scatter (3 shuffles a group), after which lane q holds step q's
//   <C, h>, adds ds u and stores it.
// * Two flags plant faults for the benchmark's controls, never the served
//   path: kNoCarry resets the state at each 32-step chunk, kBf16State rounds
//   it to bf16 after each update (a template argument: the served kernel has
//   no branch).
// * Each order's y goes to its own plane of part (fp32, B H W 4 D values laid
//   out as [frame, group of 8 channels, order, token, channel]: each block's
//   own contiguous region, each order's stores a stream of 32-byte records;
//   the row-major orders' four of a group fill a line). When the block's four
//   warps are done, the block streams its region, sums each token's four
//   orders in the fixed order above and writes out: deterministic, with no
//   atomics and no second launch.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; bf16 at the published size, ms a
// call, a median where runs alternated; each line one change to the line
// above unless it says otherwise):
//   bf16 rows unpacked by every lane at every step, y [token, order]   10.0-10.3 (fp32 12.35)
//   rows widened to fp32 once a chunk (B and C two 16-byte loads)      11.3
//   bf16 rows kept, copies on consecutive pieces, no division a chunk   7.96 (of 4)
//   deltas on the tensor cores                                          7.85-7.91
//   a plane an order in part                                            7.27-7.43 (fp32 11.0)
//   (instead) mirrored orders adding into one slot at a second visit    8.27
//   (instead) each token summed at its last visit, a barrier a chunk    8.74
//   (instead) single-warp blocks in clusters of four                   12.3
//   (instead) three chunks in flight; with the next chunk's deltas      7.39; 7.53
// The last design against itself with one part undone (medians of 10
// alternating runs, two calls): the deltas by FMAs 7.83, 7.84 against 7.38,
// 7.43 (fp32, FMAs in both, unmoved); each step's token computed from the
// step (a division a lane and chunk) 7.59 against 7.43. Less one part (ms it
// saves, readings only): the final pass 0.93, the deltas 0.84, the B and C
// loads 0.53, the xdbl copies 0.28, the reduce-scatter 0.20, the
// exponentials 0.07.
//
// The wrapper (fast_srgan_torch/kernels/selective_scan.py) guarantees: u, xdbl
// and out of one type (bf16 or fp32), contiguous, 16-byte aligned; D a
// multiple of 8; N = 16; R one of 4, 8, 12, 16; H W < 2^28; dt_w [4, D, R],
// dt_b, ds [4, D], A [4, D, N] fp32; part of B H W 4 D fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kOrders = 4;
constexpr int kWarps = kOrders;  // one warp an order
constexpr int kThreads = 32 * kWarps;
constexpr int kN = 16;                   // states
constexpr int kQuad = 4;                 // lanes a channel
constexpr int kSub = kN / kQuad;         // states a lane
constexpr int kChannels = 32 / kQuad;    // channels a warp (a block)
constexpr int kChunk = 32;               // steps a chunk: one token a lane
constexpr int kGroups = kChunk / kQuad;  // groups of four steps a chunk
constexpr int kStepPad = kChunk + 4;     // a channel's row of deltas, padded
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kAll = 0xffffffffu;
// flags
constexpr int kNoCarry = 1;
constexpr int kBf16State = 2;
static_assert(kQuad == 4, "the reduce-scatter and the group of steps are four lanes");

// A staged step's row in shared memory, in T: its B and C interleaved by
// lane, [B 4q .. 4q + 3, C 4q .. 4q + 3] for q = 0 .. 3 (a lane's eight
// values of a step, one 16-byte load in bf16), then dt [R], padded to a
// stride that starts rows 4g .. 4g + 3 (the delta phase's four lanes of a
// channel) in different banks: 4 modulo 8 floats in fp32, a multiple of 8
// bf16 values in bf16 (16-byte aligned, 20 or 24 words).
template <typename T, int R>
constexpr int kRowStride = sizeof(T) == 2 ? (2 * kN + R + 7) / 8 * 8
                                          : ((2 * kN + R) % 8 == 4 ? 2 * kN + R : 2 * kN + R + 4);

// One warp's shared memory: two staging buffers (kChunk rows of xdbl, then
// kChunk x 8 of u, in T), then the deltas and delta u (8 rows of kStepPad
// fp32 each).
template <typename T, int R>
struct WarpSmem {
  static constexpr int kRow = kRowStride<T, R>;                // T values a staged row
  static constexpr int kStage = kChunk * (kRow + kChannels);   // T values a buffer
  static constexpr int kDeltaOffset = 2 * kStage * (int)sizeof(T);  // bytes
  static constexpr int kBytes = kDeltaOffset + 2 * kChannels * kStepPad * 4;
  static_assert(kRow * sizeof(T) % 16 == 0 && kDeltaOffset % 16 == 0, "16-byte rows");
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// four bf16 (two words) as fp32: a bf16 is the high half of its fp32, one
// shift or one mask a value
__device__ __forceinline__ float4 unpack(unsigned lo, unsigned hi) {
  return make_float4(__uint_as_float(lo << 16), __uint_as_float(lo & 0xffff0000u),
                     __uint_as_float(hi << 16), __uint_as_float(hi & 0xffff0000u));
}

// lane q's B and C of a staged step (its row)
__device__ __forceinline__ void load_bc(const float* row, int q, float4& b, float4& c) {
  b = load4(row + 8 * q);
  c = load4(row + 8 * q + 4);
}
__device__ __forceinline__ void load_bc(const bf16* row, int q, float4& b, float4& c) {
  const uint4 raw = *reinterpret_cast<const uint4*>(row + 8 * q);
  b = unpack(raw.x, raw.y);
  c = unpack(raw.z, raw.w);
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// softplus(v) = max(v, 0) + log1p(e), e = exp(-|v|) in (0, 1]: log1p(e) = e
// P(e), P a degree-8 fit of log1p(e) / e on [0, 1] (relative error 3e-8;
// the exponential's own, 2 ulp, dominates). For v > 20 it returns v, as
// log1p(exp(v)) rounded does.
__device__ __forceinline__ float softplus(float v) {
  const float e = ex2(-fabsf(v) * kLog2e);
  float p = 0.0052315969951450825f;
  p = fmaf(p, e, -0.029500838369131088f);
  p = fmaf(p, e, 0.07821878045797348f);
  p = fmaf(p, e, -0.13662636280059814f);
  p = fmaf(p, e, 0.1910572052001953f);
  p = fmaf(p, e, -0.2484290897846222f);
  p = fmaf(p, e, 0.3331908881664276f);
  p = fmaf(p, e, -0.4999949336051941f);
  p = fmaf(p, e, 0.9999999403953552f);
  return fmaf(e, p, fmaxf(v, 0.f));
}

template <typename T>
struct Out4;
template <>
struct Out4<float> {
  __device__ __forceinline__ static void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};
template <>
struct Out4<bf16> {
  __device__ __forceinline__ static void store(bf16* p, float4 v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    raw.x = *reinterpret_cast<unsigned*>(&lo);
    raw.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The token of this lane's step in the chunk it stages next, advanced 32
// steps a chunk: p is the step's place in its order's scanning index
// (row-major for even k, column-major for odd k; counted from the end for
// k >= 2) and, for odd k, (pr, pc) = (p mod H, p div H). Only read while the
// step is on the map.
struct Cursor {
  int s, p, pr, pc;

  __device__ __forceinline__ Cursor(int lane, int k, int H, int L) : s(lane) {
    p = k >= 2 ? L - 1 - lane : lane;
    pr = (k & 1) && s < L ? p % H : 0;
    pc = (k & 1) && s < L ? p / H : 0;
  }
  __device__ __forceinline__ int token(int k, int W) const { return (k & 1) ? pr * W + pc : p; }
  __device__ __forceinline__ void advance(int k, int H, int dq, int dr) {
    s += kChunk;
    if (k >= 2) {
      p -= kChunk;
      pr -= dr;
      pc -= dq;
      if (pr < 0) {
        pr += H;
        --pc;
      }
    } else {
      p += kChunk;
      pr += dr;
      pc += dq;
      if (pr >= H) {
        pr -= H;
        ++pc;
      }
    }
  }
};

// A chunk's copies into buffer buf. Its xdbl rows (R + 2N values of order k
// a step) go in pieces of four values (8 bytes in bf16, 16 in fp32), the
// warp's 32 lanes on 32 consecutive pieces of the chunk, so that each copy
// touches a few rows and not 32 (token t, held by the lane of its step, comes
// by shuffle); each piece lands at its place in the staged row. Then lane j
// copies its step's token's u of channels d0 .. d0 + 7 (16-byte pieces).
// Rows past the map's end (the last chunk) are zeroed instead: finite values
// for the steps walked there, whose outputs are not stored and after which no
// step follows.
template <typename T, int R>
__device__ __forceinline__ void stage(T* buf, const T* __restrict__ u,
                                      const T* __restrict__ xdbl, int lane, int k, int t,
                                      int rows, long long tok0, int D, int d0) {
  constexpr int kRW = R + 2 * kN;
  constexpr int kPieces = kRW / 4;  // a row's pieces: dt, then B, then C
  constexpr int kRow = kRowStride<T, R>;
#pragma unroll
  for (int n = 0; n < kPieces; ++n) {
    const int i = lane + 32 * n;
    const int row = i / kPieces, p = i - row * kPieces;
    const int tr = __shfl_sync(kAll, t, row);
    const int at = p < R / 4 ? 2 * kN + 4 * p : p < R / 4 + 4 ? 8 * (p - R / 4)
                                                               : 8 * (p - R / 4 - 4) + 4;
    T* dst = buf + row * kRow + at;
    if (row < rows) {
      const T* src = xdbl + ((tok0 + tr) * kOrders + k) * kRW + 4 * p;
      if (sizeof(T) == 2)
        cp_async8(dst, src);
      else
        cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = T(0.f);
    }
  }
  T* ub = buf + kChunk * kRow + lane * kChannels;
  if (lane < rows) {
    const T* us = u + (tok0 + t) * D + d0;
#pragma unroll
    for (int e = 0; e < kChannels; e += 16 / sizeof(T)) cp_async16(ub + e, us + e);
  } else {
#pragma unroll
    for (int e = 0; e < kChannels; ++e) ub[e] = T(0.f);
  }
}

// A chunk's deltas, softplus(dt_w . dt + dt_b) for its 32 steps and the
// block's 8 channels, with delta u, into dl and dul ([channel][step], rows
// of kStepPad).
template <typename T, int R>
struct Deltas;

// fp32: lane q of channel c computes those of steps q, q + 4, ..., q + 28 by
// FMAs over the R slots of their staged rows.
template <int R>
struct Deltas<float, R> {
  float wr[R], bias;

  __device__ __forceinline__ Deltas(const float* __restrict__ dt_w,
                                    const float* __restrict__ dt_b, int k, int D, int d0,
                                    int lane) {
    const long long kd = (long long)k * D + d0 + lane / kQuad;
#pragma unroll
    for (int r = 0; r < R; ++r) wr[r] = dt_w[kd * R + r];
    bias = dt_b[kd];
  }

  __device__ __forceinline__ void run(const float* rows, const float* ub, float* dl, float* dul,
                                      int lane) const {
    constexpr int kS = kRowStride<float, R>;
    const int ch = lane / kQuad, q = lane % kQuad;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int j = kQuad * g + q;
      const float* row = rows + j * kS + 2 * kN;
      float v0 = bias, v1 = 0.f;
#pragma unroll
      for (int r = 0; r < R; r += 4) {
        const float4 x = load4(row + r);
        v0 = fmaf(wr[r], x.x, v0);
        v1 = fmaf(wr[r + 1], x.y, v1);
        v0 = fmaf(wr[r + 2], x.z, v0);
        v1 = fmaf(wr[r + 3], x.w, v1);
      }
      const float delta = softplus(v0 + v1);
      dl[ch * kStepPad + j] = delta;
      dul[ch * kStepPad + j] = delta * ub[j * kChannels + ch];
    }
  }
};

// bf16: the projection on the tensor cores, mma m16n8k16 (steps x dt slots,
// dt slots x channels), the bf16 dt exact, dt_w in three bf16 parts that sum
// to it within 2^-24, accumulated in fp32 from the bias: two tiles of 16
// steps, three products each. Lane (g, i) = (lane / 4, lane % 4) gets steps
// g, g + 8, g + 16, g + 24 of channels 2i and 2i + 1.
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int R>
struct Deltas<bf16, R> {
  unsigned w[3][2];  // B fragments of dt_w's three parts, largest first
  float b0, b1;      // the bias of channels 2i, 2i + 1

  __device__ __forceinline__ Deltas(const float* __restrict__ dt_w,
                                    const float* __restrict__ dt_b, int k, int D, int d0,
                                    int lane) {
    const int i = lane % 4;
    const long long kn = (long long)k * D + d0 + lane / 4;  // B's column: channel g
    float v[4];  // slots 2i, 2i + 1, 2i + 8, 2i + 9
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 2 * i + (e & 1) + 8 * (e >> 1);
      v[e] = r < R ? dt_w[kn * R + r] : 0.f;
    }
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      float hi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = __bfloat162float(__float2bfloat16_rn(v[e]));
        v[e] -= hi[e];
      }
      w[part][0] = bf16x2(hi[0], hi[1]);
      w[part][1] = bf16x2(hi[2], hi[3]);
    }
    const long long kd = (long long)k * D + d0 + 2 * i;
    b0 = dt_b[kd];
    b1 = dt_b[kd + 1];
  }

  __device__ __forceinline__ void run(const bf16* rows, const bf16* ub, float* dl, float* dul,
                                      int lane) const {
    constexpr int kS = kRowStride<bf16, R>;
    const int g = lane / 4, i = lane % 4;
#pragma unroll
    for (int mt = 0; mt < kChunk / 16; ++mt) {
      const int s0 = 16 * mt + g;  // and s0 + 8
      const bf16* r0 = rows + s0 * kS + 2 * kN + 2 * i;
      const bf16* r8 = r0 + 8 * kS;
      unsigned a[4];
      a[0] = 2 * i < R ? *reinterpret_cast<const unsigned*>(r0) : 0u;
      a[1] = 2 * i < R ? *reinterpret_cast<const unsigned*>(r8) : 0u;
      a[2] = 2 * i + 8 < R ? *reinterpret_cast<const unsigned*>(r0 + 8) : 0u;
      a[3] = 2 * i + 8 < R ? *reinterpret_cast<const unsigned*>(r8 + 8) : 0u;
      float v[4] = {b0, b1, b0, b1};
      mma_bf16(v, a, w[2]);
      mma_bf16(v, a, w[1]);
      mma_bf16(v, a, w[0]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = s0 + 8 * half;
        const unsigned uu = *reinterpret_cast<const unsigned*>(ub + s * kChannels + 2 * i);
        const float u0 = __uint_as_float(uu << 16), u1 = __uint_as_float(uu & 0xffff0000u);
        const float d0v = softplus(v[2 * half]), d1v = softplus(v[2 * half + 1]);
        dl[(2 * i) * kStepPad + s] = d0v;
        dl[(2 * i + 1) * kStepPad + s] = d1v;
        dul[(2 * i) * kStepPad + s] = d0v * u0;
        dul[(2 * i + 1) * kStepPad + s] = d1v * u1;
      }
    }
  }
};

template <typename T, int R, bool kRoundState>
__global__ void __launch_bounds__(kThreads, 3)
    selective_scan_kernel(const T* __restrict__ u, const T* __restrict__ xdbl,
                          const float* __restrict__ dt_w, const float* __restrict__ dt_b,
                          const float* __restrict__ A, const float* __restrict__ Ds,
                          float* part, T* __restrict__ out, int H, int W, int D, int flags) {
  using S = WarpSmem<T, R>;
  constexpr int kS = S::kRow;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int k = threadIdx.x >> 5;
  unsigned char* wsm = smem + k * S::kBytes;
  T* bufs = reinterpret_cast<T*>(wsm);
  float* dl = reinterpret_cast<float*>(wsm + S::kDeltaOffset);  // [8][kStepPad] delta
  float* dul = dl + kChannels * kStepPad;                             // [8][kStepPad] delta u

  const int ch = lane / kQuad;  // this lane's channel of the block's 8
  const int q = lane % kQuad;   // its states: kSub q .. kSub q + kSub - 1
  const int groups = D / kChannels;
  const int b = blockIdx.x / groups;
  const int d0 = (blockIdx.x % groups) * kChannels;
  const int d = d0 + ch;
  const int L = H * W;
  const long long tok0 = (long long)b * L;
  // this block's partial sums: [4, L, 8] fp32 (a plane an order), one
  // contiguous region
  float* pb = part + (long long)blockIdx.x * L * kOrders * kChannels;

  // this lane's channel of this order and its states
  float a2[kSub], h[kSub];
  const long long kd = (long long)k * D + d;
#pragma unroll
  for (int m = 0; m < kSub; ++m) {
    a2[m] = A[kd * kN + kSub * q + m] * kLog2e;
    h[m] = 0.f;
  }
  const Deltas<T, R> deltas(dt_w, dt_b, k, D, d0, lane);
  const float dd = Ds[kd];

  const int nchunks = (L + kChunk - 1) / kChunk;
  const int dq = kChunk / H, dr = kChunk % H;
  Cursor cur(lane, k, H, L);
  int t_next = cur.s < L ? cur.token(k, W) : 0;
  stage<T, R>(bufs, u, xdbl, lane, k, t_next, min(kChunk, L), tok0, D, d0);
  cp_async_commit();
  cur.advance(k, H, dq, dr);
  for (int c = 0; c < nchunks; ++c) {
    const int t_cur = t_next;
    const int steps = min(kChunk, L - c * kChunk);
    const T* rows = bufs + (c & 1) * S::kStage;
    if (c + 1 < nchunks) {
      t_next = cur.s < L ? cur.token(k, W) : 0;
      stage<T, R>(bufs + ((c + 1) & 1) * S::kStage, u, xdbl, lane, k, t_next,
                  min(kChunk, L - (c + 1) * kChunk), tok0, D, d0);
      cp_async_commit();
      cur.advance(k, H, dq, dr);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const T* ub = rows + kChunk * kS;
    if (flags & kNoCarry) {
#pragma unroll
      for (int m = 0; m < kSub; ++m) h[m] = 0.f;
    }

    // every step's delta first
    deltas.run(rows, ub, dl, dul, lane);
    __syncwarp();

#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const float4 d4 = load4(dl + ch * kStepPad + kQuad * g);
      const float4 u4 = load4(dul + ch * kStepPad + kQuad * g);
      const float dv[kQuad] = {d4.x, d4.y, d4.z, d4.w};
      const float duv[kQuad] = {u4.x, u4.y, u4.z, u4.w};
      float yp[kQuad];
#pragma unroll
      for (int jj = 0; jj < kQuad; ++jj) {
        float4 bq, cq;
        load_bc(rows + (kQuad * g + jj) * kS, q, bq, cq);
        const float bb[kSub] = {bq.x, bq.y, bq.z, bq.w}, cc[kSub] = {cq.x, cq.y, cq.z, cq.w};
        float y = 0.f;
#pragma unroll
        for (int m = 0; m < kSub; ++m) {
          h[m] = fmaf(ex2(dv[jj] * a2[m]), h[m], duv[jj] * bb[m]);
          if (kRoundState) h[m] = __bfloat162float(__float2bfloat16_rn(h[m]));
          y = fmaf(cc[m], h[m], y);
        }
        yp[jj] = y;
      }
      // reduce-scatter over the quad: lane q ends with step 4 g + q's sum
#pragma unroll
      for (int half = kQuad / 2; half >= 1; half /= 2) {
#pragma unroll
        for (int i = 0; i < half; ++i) {
          const float send = (q & half) ? yp[i] : yp[i + half];
          const float keep = (q & half) ? yp[i + half] : yp[i];
          yp[i] = keep + __shfl_xor_sync(kAll, send, half);
        }
      }
      const int mine = kQuad * g + q;
      const int tj = __shfl_sync(kAll, t_cur, mine);
      if (mine < steps)
        pb[((long long)k * L + tj) * kChannels + ch] =
            fmaf(dd, to_float(ub[mine * kChannels + ch]), yp[0]);
    }
    __syncwarp();  // this chunk's buffers are read before the next chunk's copies
  }

  // every order of this frame and these channels is in pb: each token's
  // four planes summed in order, rounded once
  __syncthreads();
  constexpr int kVecs = kChannels / 4;  // float4s a token's channels
  const int total = L * kVecs;
  for (int i0 = threadIdx.x; i0 < total; i0 += 4 * kThreads) {
    float4 acc[4] = {};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = i0 + p * kThreads;
      if (i < total) {
        const float* src = pb + 4 * i;
        const long long plane = (long long)L * kChannels;
        const float4 y0 = load4(src);
        const float4 y1 = load4(src + plane);
        const float4 y2 = load4(src + 2 * plane);
        const float4 y3 = load4(src + 3 * plane);
        acc[p] = add4(add4(add4(y0, y1), y2), y3);
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = i0 + p * kThreads;
      if (i < total) Out4<T>::store(out + (tok0 + i / kVecs) * D + d0 + 4 * (i % kVecs), acc[p]);
    }
  }
}

template <typename T, int R>
int launch_rank(const void* u, const void* xdbl, const void* dt_w, const void* dt_b,
                const void* A, const void* Ds, void* part, void* out, unsigned grid, int H, int W,
                int D, int flags, cudaStream_t stream) {
  auto kernel = (flags & kBf16State) ? selective_scan_kernel<T, R, true>
                                      : selective_scan_kernel<T, R, false>;
  constexpr int smem = kWarps * WarpSmem<T, R>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(xdbl), static_cast<const float*>(dt_w),
      static_cast<const float*>(dt_b), static_cast<const float*>(A),
      static_cast<const float*>(Ds), static_cast<float*>(part), static_cast<T*>(out), H, W, D,
      flags);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* xdbl, const void* dt_w, const void* dt_b, const void* A,
           const void* Ds, void* part, void* out, int B, int H, int W, int D, int R, int flags,
           void* stream) {
  if (B < 1 || H < 1 || W < 1 || D < kChannels || D % kChannels ||
      (long long)H * W >= (1LL << 28))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (long long)B * (D / kChannels);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid);
  switch (R) {
    case 4:
      return launch_rank<T, 4>(u, xdbl, dt_w, dt_b, A, Ds, part, out, g, H, W, D, flags, s);
    case 8:
      return launch_rank<T, 8>(u, xdbl, dt_w, dt_b, A, Ds, part, out, g, H, W, D, flags, s);
    case 12:
      return launch_rank<T, 12>(u, xdbl, dt_w, dt_b, A, Ds, part, out, g, H, W, D, flags, s);
    case 16:
      return launch_rank<T, 16>(u, xdbl, dt_w, dt_b, A, Ds, part, out, g, H, W, D, flags, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry points (bound with ctypes): u, out [B, H, W, D] and xdbl
// [B, H, W, 4, R + 32] of one type; dt_w [4, D, R], dt_b, Ds [4, D], A [4, D, 16]
// fp32; part fp32 scratch of B H W 4 D values; flags 0 (kNoCarry, kBf16State:
// planted faults). Each returns the launch's cudaError_t.
extern "C" int fsr_selective_scan_bf16(const void* u, const void* xdbl, const void* dt_w,
                                       const void* dt_b, const void* A, const void* Ds,
                                       void* part, void* out, int B, int H, int W, int D, int R,
                                       int flags, void* stream) {
  return launch<bf16>(u, xdbl, dt_w, dt_b, A, Ds, part, out, B, H, W, D, R, flags, stream);
}

extern "C" int fsr_selective_scan_f32(const void* u, const void* xdbl, const void* dt_w,
                                      const void* dt_b, const void* A, const void* Ds,
                                      void* part, void* out, int B, int H, int W, int D, int R,
                                      int flags, void* stream) {
  return launch<float>(u, xdbl, dt_w, dt_b, A, Ds, part, out, B, H, W, D, R, flags, stream);
}
