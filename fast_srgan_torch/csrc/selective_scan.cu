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
// What bounds it: the special-function unit. Each state update costs one
// exponential (ex2.approx, A pre-scaled by log2(e)) and three FMAs; at the
// published size (8 x 180 x 320 tokens, D = 360) that is 1.06e10 exponentials
// a call, 2.54 ms at the MUFU's 16 a clock an SM, against 0.5 GB of u, xdbl and
// y. The state carries along L, so each channel's walk is sequential in s, and
// the walk's dependency chains (the state, delta's dot product and softplus,
// the exponentials) want many warps an SM to hide them. The design:
//
// * One block (4 warps) a frame and 8 channels, one warp an order, four lanes a
//   channel (lane = 4 c + q holds states 4q .. 4q + 3 of channel c, with their
//   A * log2(e)): B D / 8 blocks of 4 warps (1440 warps, ~11 an SM, at the
//   published size), each walking all L steps of its order.
// * A chunk's deltas first: lane q of a channel computes those of steps q,
//   q + 4, ..., q + 28 (the dt dot product over all 16 slots, zero weights
//   past R, and the softplus), eight independent chains. Then its 32 steps,
//   unrolled, in groups of four: the quad's lanes read each step's delta by
//   shuffle, each updates its 4 states and keeps its partial sum <C, h> of
//   each step, and the quad joins them by a reduce-scatter (3 shuffles a
//   group), after which lane q holds step q's y and stores it. (Each of these
//   came from measuring: one lane a channel with 16 states in registers,
//   96 blocks, read 46 ms a call; register prefetch of the next chunk spilled
//   and doubled the time.)
// * Chunks of kChunk = 32 steps, one a lane: lane j computes the token of step
//   j (one division a chunk) and copies that token's xdbl row of this order
//   and its u of the block's 8 channels into the warp's shared memory by
//   cp.async (8- and 16-byte pieces: no registers, no shuffles), two chunks
//   in flight: chunk c + 1 lands while chunk c is walked. A step's B and C are
//   then read as one 8-byte broadcast a lane and converted to fp32 there. The
//   state is carried across chunks in registers. Two flags plant faults for
//   the benchmark's controls, never the served path: kNoCarry resets the
//   state at each chunk, kBf16State rounds it to bf16 after each update (a
//   template argument: the served kernel has no branch).
// * Each order's y goes to part (fp32, B H W 4 D values laid out as [frame,
//   group of 8 channels, token, order, channel]: each block's own contiguous
//   region). When the block's four warps are done, the block streams its
//   region, sums each token's four slots in the fixed order above and writes
//   out: deterministic, with no atomics and no second launch.
//
// The wrapper (fast_srgan_torch/kernels/selective_scan.py) guarantees: u, xdbl
// and out of one type (bf16 or fp32), contiguous, 16-byte aligned; D a
// multiple of 8; N = 16; R a multiple of 4, 4 to 16; H W < 2^28; dt_w
// [4, D, R], dt_b, ds [4, D], A [4, D, N] fp32; part of B H W 4 D fp32.

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
constexpr int kMaxR = 16;                // dt rank at most
constexpr int kChunk = 32;               // steps a chunk: one token a lane
// a staged step in shared memory: its xdbl row (dt, B, C), R + 2N <= kRow
constexpr int kRow = kMaxR + 2 * kN;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kAll = 0xffffffffu;
// flags
constexpr int kNoCarry = 1;
constexpr int kBf16State = 2;
static_assert(kQuad == 4, "the reduce-scatter and the group of steps are four lanes");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// four consecutive values as fp32: 16 bytes of fp32 or 8 of bf16
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  // a bf16 is the high half of its fp32: one shift or one mask a value
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
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

__device__ __forceinline__ float softplus(float v) {
  return v <= 20.f ? log1pf(__expf(v)) : v;
}

// token of step s of order k on an H x W map of L = H W tokens
__device__ __forceinline__ int token_of(int k, int s, int H, int W, int L) {
  if (k >= 2) s = L - 1 - s;
  if (k & 1) return (s % H) * W + s / H;
  return s;
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

// Chunk c's copies into its buffer: lane j takes step j, its token (returned)
// and that token's xdbl row of order k (RW values: rows of a multiple of 8
// bytes, pieces of 8 in bf16 and 16 in fp32) and its u of channels d0 ..
// d0 + 7 (16 bytes a piece). Past the map's end (the last chunk) the lane
// zeroes its row and u instead: finite values for the steps walked there,
// whose outputs are not stored and after which no step follows.
template <typename T>
__device__ __forceinline__ int stage(T* xb, T* ub, const T* __restrict__ u,
                                     const T* __restrict__ xdbl, int c, int k, int lane, int d0,
                                     long long tok0, int H, int W, int D, int RW) {
  constexpr int kPiece = sizeof(T) == 2 ? 8 : 16;  // bytes
  constexpr int kPer = kPiece / sizeof(T);         // values a piece: 4
  const int L = H * W;
  const int s = c * kChunk + lane;
  if (s >= L) {
    for (int e = 0; e < kRow; ++e) xb[lane * kRow + e] = T(0.f);
    for (int e = 0; e < kChannels; ++e) ub[lane * kChannels + e] = T(0.f);
    return 0;
  }
  const int t = token_of(k, s, H, W, L);
  const T* row = xdbl + ((tok0 + t) * kOrders + k) * RW;
  T* dst = xb + lane * kRow;
  for (int e = 0; e < RW; e += kPer) {
    if (kPiece == 8)
      cp_async8(dst + e, row + e);
    else
      cp_async16(dst + e, row + e);
  }
  const T* us = u + (tok0 + t) * D + d0;
#pragma unroll
  for (int e = 0; e < kChannels; e += 16 / sizeof(T)) cp_async16(ub + lane * kChannels + e, us + e);
  return t;
}

// delta of a step from its staged row: softplus(dt_w . dt + dt_b), over all
// kMaxR slots (the weights past R are zero; the row's values there are its
// B, finite)
template <typename T>
__device__ __forceinline__ float delta_of(const T* row, const float (&wr)[kMaxR], float bias) {
  float v0 = bias, v1 = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxR / 4; ++q) {
    const float4 x = load4(row + 4 * q);
    v0 = fmaf(wr[4 * q], x.x, v0);
    v1 = fmaf(wr[4 * q + 1], x.y, v1);
    v0 = fmaf(wr[4 * q + 2], x.z, v0);
    v1 = fmaf(wr[4 * q + 3], x.w, v1);
  }
  return softplus(v0 + v1);
}

template <typename T, bool kRoundState>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const T* __restrict__ u, const T* __restrict__ xdbl,
                          const float* __restrict__ dt_w, const float* __restrict__ dt_b,
                          const float* __restrict__ A, const float* __restrict__ Ds,
                          float* part, T* __restrict__ out, int H, int W, int D, int R,
                          int flags) {
  // each warp's two buffers: kChunk rows of xdbl, then kChunk x 8 of u
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kBuf = kChunk * (kRow + kChannels);  // values a buffer
  const int lane = threadIdx.x & 31;
  const int k = threadIdx.x >> 5;
  T* bufs = reinterpret_cast<T*>(smem) + k * 2 * kBuf;

  const int ch = lane / kQuad;  // this lane's channel of the block's 8
  const int q = lane % kQuad;   // its states: kSub q .. kSub q + kSub - 1
  const int groups = D / kChannels;
  const int b = blockIdx.x / groups;
  const int d0 = (blockIdx.x % groups) * kChannels;
  const int d = d0 + ch;
  const int L = H * W;
  const int RW = R + 2 * kN;  // xdbl values of one order a token
  const long long tok0 = (long long)b * L;
  // this block's partial sums: [L, 4, 8] fp32, one contiguous region
  float* pb = part + (long long)blockIdx.x * L * kOrders * kChannels;

  // this lane's channel of this order and its states
  float a2[kSub], h[kSub], wr[kMaxR];
  const long long kd = (long long)k * D + d;
#pragma unroll
  for (int m = 0; m < kSub; ++m) {
    a2[m] = A[kd * kN + kSub * q + m] * kLog2e;
    h[m] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) wr[r] = r < R ? dt_w[kd * R + r] : 0.f;
  const float bias = dt_b[kd], dd = Ds[kd];

  const int nchunks = (L + kChunk - 1) / kChunk;
  int t_next = stage<T>(bufs, bufs + kChunk * kRow, u, xdbl, 0, k, lane, d0, tok0, H, W, D, RW);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int t_cur = t_next;
    const int steps = min(kChunk, L - c * kChunk);
    T* xb = bufs + (c & 1) * kBuf;
    T* ub = xb + kChunk * kRow;
    if (c + 1 < nchunks) {
      T* xn = bufs + ((c + 1) & 1) * kBuf;
      t_next = stage<T>(xn, xn + kChunk * kRow, u, xdbl, c + 1, k, lane, d0, tok0, H, W, D, RW);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    if (flags & kNoCarry) {
#pragma unroll
      for (int m = 0; m < kSub; ++m) h[m] = 0.f;
    }

    // every step's delta first: lane q of a channel computes those of steps
    // q, q + 4, ..., q + 28, eight independent chains
    float dm[kChunk / kQuad];
#pragma unroll
    for (int g = 0; g < kChunk / kQuad; ++g) dm[g] = delta_of(xb + (kQuad * g + q) * kRow, wr, bias);
#pragma unroll
    for (int g = 0; g < kChunk / kQuad; ++g) {
      float yp[kQuad];
#pragma unroll
      for (int jj = 0; jj < kQuad; ++jj) {
        const int j = kQuad * g + jj;
        const float delta = __shfl_sync(kAll, dm[g], (lane & ~(kQuad - 1)) | jj);
        const float uu = to_float(ub[j * kChannels + ch]);
        const float du = delta * uu;
        const T* row = xb + j * kRow + R + kSub * q;
        const float4 bq = load4(row), cq = load4(row + kN);
        const float bb[kSub] = {bq.x, bq.y, bq.z, bq.w}, cc[kSub] = {cq.x, cq.y, cq.z, cq.w};
        float y = q == jj ? dd * uu : 0.f;
#pragma unroll
        for (int m = 0; m < kSub; ++m) {
          h[m] = fmaf(ex2(delta * a2[m]), h[m], du * bb[m]);
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
      if (mine < steps) pb[((long long)tj * kOrders + k) * kChannels + ch] = yp[0];
    }
    __syncwarp();  // this buffer's reads are done before the next chunk's copies
  }

  // every order of this frame and these channels is in pb: the four slots
  // of each token summed in order, rounded once
  __syncthreads();
  constexpr int kVecs = kChannels / 4;  // float4s a token's channels
  const int total = L * kVecs;
  for (int i0 = threadIdx.x; i0 < total; i0 += 4 * kThreads) {
    float4 acc[4] = {};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = i0 + p * kThreads;
      if (i < total) {
        const float* src = pb + (long long)(i / kVecs) * kOrders * kChannels + 4 * (i % kVecs);
        const float4 y0 = *reinterpret_cast<const float4*>(src);
        const float4 y1 = *reinterpret_cast<const float4*>(src + kChannels);
        const float4 y2 = *reinterpret_cast<const float4*>(src + 2 * kChannels);
        const float4 y3 = *reinterpret_cast<const float4*>(src + 3 * kChannels);
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

template <typename T>
int launch(const void* u, const void* xdbl, const void* dt_w, const void* dt_b, const void* A,
           const void* Ds, void* part, void* out, int B, int H, int W, int D, int R, int flags,
           void* stream) {
  if (B < 1 || H < 1 || W < 1 || D < kChannels || D % kChannels || R < 4 || R > kMaxR || R % 4 ||
      (long long)H * W >= (1LL << 28))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (long long)B * (D / kChannels);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = (flags & kBf16State) ? selective_scan_kernel<T, true>
                                      : selective_scan_kernel<T, false>;
  const int smem = kWarps * 2 * kChunk * (kRow + kChannels) * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(unsigned)grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(xdbl), static_cast<const float*>(dt_w),
      static_cast<const float*>(dt_b), static_cast<const float*>(A),
      static_cast<const float*>(Ds), static_cast<float*>(part), static_cast<T*>(out), H, W, D, R,
      flags);
  return static_cast<int>(cudaGetLastError());
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
