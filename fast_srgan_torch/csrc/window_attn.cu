// One Swin layer's shifted-window attention, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no SwinIR. It takes the place
// of the chain SwinIR's layer ran on the card in stock PyTorch (roll, window
// partition by mask class, head padded 30 -> 32, one library SDPA call a
// class, the output's transpose, reverse, roll back), which moved each token
// five times around one attention. On the qkv linear's output in token layout,
// [B, H, W, 3C] (a token's q, k and v, each heads x hd in head order), with s
// the layer's shift (0 or 4):
//
//   token (i, j) of window (wr, wc) is qkv[b, (8 wr + i + s) mod H,
//                                             (8 wc + j + s) mod W]
//   o = softmax(q k^T * scale + masks[class, head]) v      each window, head
//   class = s ? 2 [wr is the last window row] + [wc is the last column] : 0
//
// and o is written to out [B, H, W, C] at the token's own place: the forward
// roll, the partition, the reverse and the backward roll are one address,
// used for the load and for the store. masks is [K, heads, 64, 64] (K = 1
// unshifted: the relative-position bias; K = 4 shifted: the bias plus each
// class's shift mask), the class the window's place in the map, as
// window_regions (kernels/window_attn.py) partitions it. One launch a call.
//
// Numerics. bf16: logits and softmax in fp32 with the mask added; the
// unnormalised probabilities rounded to bf16 for P V, whose sums are fp32 and
// divided by the fp32 row sum; bf16 out. fp32: every product and sum in fp32
// on the CUDA cores (no tensor core, no TF32), as the plain version computes
// it in another order.
//
// What bounds it (bf16, the served form): device-memory bandwidth. A window
// reads 64 x 3C values of qkv and writes 64 x C (92 KB at C = 180), against
// 64 x 64 x hd x 2 x 2 operations a head (~32 FLOP a byte, far under the
// card's 295), so the design is about moving each byte once:
//
// * One block (4 warps) a window, window after window by a grid-stride loop
//   (64-bit offsets; the grid is capped, never the batch). Each window row is
//   one contiguous run of 8 tokens (two at a shifted map's wrap), brought into
//   shared memory by cp.async in 16-byte pieces. A bf16 block holds one window
//   (69 KB at C = 180), three blocks an SM: one loads while the others compute.
// * Shared memory keeps the token layout, with 8 values of padding after
//   every 16 tokens, so that the B fragments of S (keys 16 (g >> 1) + 2 j +
//   (g & 1), below) and of V fall on distinct banks at C = 180.
// * bf16: warp w takes queries 16 w .. 16 w + 15 through every head, on
//   mma.sync m16n8k16 (bf16 in, fp32 sums): S = Q K^T at head size hd zero
//   padded to 32 in registers (never in memory), its 16 x 64 logits held in
//   registers, the softmax on them, then P V with P straight from S's
//   accumulators. The columns of S are ordered so that lane (g, q4) holds
//   keys 16 q4 .. 16 q4 + 15 of its two query rows: its mask values are two
//   16-byte loads a row (masks stay L2-resident: 48 KB a class at 6 heads).
// * fp32: two threads a query, each over 32 keys, the pair joined by shuffles.
// * A head's output overwrites that head's q in shared memory (only the
//   threads of its query read those values); after the last head the block
//   stores the window's outputs, token runs again, 4 values a piece.
//
// The wrapper (fast_srgan_torch/kernels/window_attn.py) guarantees: qkv
// [B, H, W, 3C] and out [B, H, W, C] of one type, contiguous, 16-byte aligned;
// H, W multiples of 8; masks [K, heads, 64, 64] of that type, contiguous,
// 16-byte aligned, K = 1 at s = 0 and 4 at s = 4; hd = C / heads even and
// <= 32, C a multiple of 4; the window's 192 C + 32 values within one block's
// shared memory.
//
// Window 16 (HAT), bf16 only: the same contract (the roll, the partition and
// the class in the addressing; masks [K, heads, 256, 256]; one launch a call),
// another design, because a 16 x 16 window's qkv (256 x 3C values, 276 KB in
// bf16 at C = 180) is more than one block's shared memory, and its 256 x 256
// logits a head are more than a warp's registers:
//
// * One block (4 warps) a (window, head), the heads of a window in adjacent
//   blocks, so that the window's token rows come from device memory once and
//   from L2 for its other heads. The block brings the head's q, k and v of
//   the 256 tokens into shared memory by 4-byte cp.async (a token's head is hd
//   values at an offset of h hd, 4-byte aligned since hd is even), each row
//   zero-padded to 32 values: 49 KB, four blocks an SM.
// * Rows are 64 bytes, with 16 bytes of padding after every 16 rows, so that
//   the 8 rows one ldmatrix reads, keys {k, k + 1, k + 16, k + 17, k + 32,
//   k + 33, k + 48, k + 49} (the column order of S below), fall on distinct
//   16-byte bank groups.
// * Warp w takes the query tiles 16 m .. 16 m + 15 for m = w, w + 4, ...; for
//   each, the keys in four chunks of 64 with an online softmax (fp32 row max
//   and sum, the output's fp32 sums rescaled when the max grows): S = Q K^T on
//   mma.sync m16n8k16 from ldmatrix fragments, with the window-8 column order,
//   so that a lane's mask values are two 16-byte loads a row and a chunk; then
//   P V with P from S's accumulators and V by ldmatrix.trans in the same key
//   order. The output goes from registers to out, 4 bytes a pair of values.
//
// What bounds it: the masks. Each (window, head) reads its class's 256 x 256
// mask values (128 KB) from L2, 786 KB a window at 6 heads, against the
// window's 373 KB of qkv and output in device memory; q, k and v move once.
// The exponentials (256 x 256 a window and head) come next: MUFU does 16 a
// clock on an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWindow = 8;
constexpr int kTokens = kWindow * kWindow;
constexpr int kWarps = kTokens / 16;  // a bf16 warp's 16 query rows
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHead = 32;
constexpr int kBlocksPerSm = 3;
constexpr long long kMaxGrid = 1LL << 24;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kAll = 0xffffffffu;

// Element offset of window token t (row-major in the window) in shared
// memory: 3C values a token, 8 values of padding after every 16 tokens.
__device__ __forceinline__ int slot(int t, int c3) { return t * c3 + (t >> 4) * 8; }

// The window's 8 rows of qkv into shared memory, 16 bytes a piece. Row r is
// image row y0 + r (mod H), columns x0 .. x0 + 7 (mod W): one run of 8
// tokens, or, at a shifted map's last column, the W - x0 = 4 tokens from x0
// and the rest from column 0. A run starts at a token index that is a
// multiple of 4, so at a multiple of 12 C values: 16 bytes divide it.
template <typename T>
__device__ __forceinline__ void load_window(T* s, const T* qkv, long long row0, int H, int W,
                                            int c3, int y0, int x0) {
  const int tok_bytes = c3 * static_cast<int>(sizeof(T));
  const int per_row = kWindow * tok_bytes / 16;
  // the first run's bytes (a whole row where the row does not wrap)
  const int split = (W - x0 < kWindow ? W - x0 : kWindow) * tok_bytes;
  const char* src0 = reinterpret_cast<const char*>(qkv);
  char* dst0 = reinterpret_cast<char*>(s);
  for (int i = threadIdx.x; i < kWindow * per_row; i += kThreads) {
    const int r = i / per_row;
    const int off = (i - r * per_row) * 16;
    int y = y0 + r;
    if (y >= H) y -= H;
    const long long line = (row0 + y) * W;  // the image row's first token
    const char* src = off < split ? src0 + (line + x0) * tok_bytes + off
                                  : src0 + line * tok_bytes + (off - split);
    char* dst = dst0 + sizeof(T) * slot(kWindow * r, c3) + off;
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Four values, the store's piece: 8 bytes in bf16, 16 in fp32.
template <typename T>
struct Four;
template <>
struct Four<bf16> { using V = uint2; };
template <>
struct Four<float> { using V = uint4; };

// The window's outputs (each token's C values at the start of its slot) to
// their tokens' places in out, 4 values a piece (C is a multiple of 4).
template <typename T>
__device__ __forceinline__ void store_window(T* out, const T* s, long long row0, int H, int W,
                                             int c, int c3, int y0, int x0) {
  using V = typename Four<T>::V;
  const int per_tok = c / 4;
  for (int i = threadIdx.x; i < kTokens * per_tok; i += kThreads) {
    const int t = i / per_tok;
    const int off = (i - t * per_tok) * 4;
    int y = y0 + (t >> 3), x = x0 + (t & 7);
    if (y >= H) y -= H;
    if (x >= W) x -= W;
    *reinterpret_cast<V*>(out + ((row0 + y) * W + x) * c + off) =
        *reinterpret_cast<const V*>(s + slot(t, c3) + off);
  }
}

__device__ __forceinline__ uint32_t bits(bf16 v) { return __bfloat16_as_ushort(v); }

// Values d and d + 1 (d even) of the head's vector at element `at`, 0 past
// hd, as a bf16 pair (d in the low half): hd is even, so the pair is one
// aligned word, whole or past hd.
__device__ __forceinline__ uint32_t pair(const bf16* s, int at, int d, int hd) {
  return d < hd ? *reinterpret_cast<const uint32_t*>(s + at + d) : 0u;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float lo_of(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_of(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16: every head of the window in shared memory, for this warp's 16
// queries; each head's output replaces its q.
__device__ __forceinline__ void attend(bf16* s, const bf16* __restrict__ mask, int heads, int hd,
                                       int c, float scale) {
  constexpr int kK = kMaxHead / 16;  // k-steps of S
  constexpr int kN = kMaxHead / 8;   // n-tiles of O
  const int c3 = 3 * c;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g, r1 = r0 + 8;  // this lane's query rows
  const int s0 = slot(r0, c3), s1 = slot(r1, c3);
  // S's n-tile j, column g is key 16 (g >> 1) + 2 j + (g & 1), so that its
  // accumulator (row, 2 q4 + e) is key 16 q4 + 2 j + e; all in one 16-token
  // group, so key + 2 j is slot + 2 j c3.
  const int kslot = slot(16 * (g >> 1) + (g & 1), c3);
  // P V's k-step kk reads keys 16 q4 + 4 kk + 0..3 (its A fragment is S's
  // accumulators of n-tiles 2 kk and 2 kk + 1)
  const int vslot = slot(16 * q4, c3);
  for (int h = 0; h < heads; ++h) {
    const bf16* m = mask + (size_t)h * kTokens * kTokens + 16 * q4;
    const uint4 m0a = __ldg(reinterpret_cast<const uint4*>(m + r0 * kTokens));
    const uint4 m0b = __ldg(reinterpret_cast<const uint4*>(m + r0 * kTokens + 8));
    const uint4 m1a = __ldg(reinterpret_cast<const uint4*>(m + r1 * kTokens));
    const uint4 m1b = __ldg(reinterpret_cast<const uint4*>(m + r1 * kTokens + 8));
    const int qo = h * hd, ko = c + h * hd, vo = 2 * c + h * hd;

    uint32_t qa[kK][4];
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const int d = 16 * kk + 2 * q4;
      qa[kk][0] = pair(s, s0 + qo, d, hd);
      qa[kk][1] = pair(s, s1 + qo, d, hd);
      qa[kk][2] = pair(s, s0 + qo, d + 8, hd);
      qa[kk][3] = pair(s, s1 + qo, d + 8, hd);
    }
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      const int at = kslot + 2 * j * c3 + ko;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        const int d = 16 * kk + 2 * q4;
        mma(acc[j], qa[kk], pair(s, at, d, hd), pair(s, at, d + 8, hd));
      }
    }

    // logits (fp32, the mask added), row maxima over the quad
    float mx0 = __int_as_float(0xff800000), mx1 = mx0;  // -inf
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t w0 = word(j < 4 ? m0a : m0b, j & 3), w1 = word(j < 4 ? m1a : m1b, j & 3);
      acc[j][0] = fmaf(acc[j][0], scale, lo_of(w0));
      acc[j][1] = fmaf(acc[j][1], scale, hi_of(w0));
      acc[j][2] = fmaf(acc[j][2], scale, lo_of(w1));
      acc[j][3] = fmaf(acc[j][3], scale, hi_of(w1));
      mx0 = fmaxf(mx0, fmaxf(acc[j][0], acc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(acc[j][2], acc[j][3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kAll, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kAll, mx1, x));
    }
    const float b0 = mx0 * kLog2e, b1 = mx1 * kLog2e;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] = ex2(fmaf(acc[j][0], kLog2e, -b0));
      acc[j][1] = ex2(fmaf(acc[j][1], kLog2e, -b0));
      acc[j][2] = ex2(fmaf(acc[j][2], kLog2e, -b1));
      acc[j][3] = ex2(fmaf(acc[j][3], kLog2e, -b1));
      l0 += acc[j][0] + acc[j][1];
      l1 += acc[j][2] + acc[j][3];
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      l0 += __shfl_xor_sync(kAll, l0, x);
      l1 += __shfl_xor_sync(kAll, l1, x);
    }

    float o[kN][4];
#pragma unroll
    for (int nd = 0; nd < kN; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack(acc[2 * kk][0], acc[2 * kk][1]),
                              pack(acc[2 * kk][2], acc[2 * kk][3]),
                              pack(acc[2 * kk + 1][0], acc[2 * kk + 1][1]),
                              pack(acc[2 * kk + 1][2], acc[2 * kk + 1][3])};
      const int at = vslot + 4 * kk * c3 + vo;
#pragma unroll
      for (int nd = 0; nd < kN; ++nd) {
        const int d = 8 * nd + g;
        uint32_t v0 = 0u, v1 = 0u;
        if (d < hd) {
          v0 = bits(s[at + d]) | (bits(s[at + c3 + d]) << 16);
          v1 = bits(s[at + 2 * c3 + d]) | (bits(s[at + 3 * c3 + d]) << 16);
        }
        mma(o[nd], pa, v0, v1);
      }
    }
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    __syncwarp();
#pragma unroll
    for (int nd = 0; nd < kN; ++nd) {
      const int d = 8 * nd + 2 * q4;
      if (d < hd) {
        *reinterpret_cast<__nv_bfloat162*>(s + s0 + qo + d) =
            __floats2bfloat162_rn(o[nd][0] * i0, o[nd][1] * i0);
        *reinterpret_cast<__nv_bfloat162*>(s + s1 + qo + d) =
            __floats2bfloat162_rn(o[nd][2] * i1, o[nd][3] * i1);
      }
    }
  }
}

// fp32: every head of the window, thread pair (2 r, 2 r + 1) for query r,
// each thread over keys 32 half .. 32 half + 31; each head's output replaces
// its q. Values are read two at a time (hd and every head's offset even).
__device__ __forceinline__ void attend(float* s, const float* __restrict__ mask, int heads, int hd,
                                       int c, float scale) {
  const int c3 = 3 * c;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int sr = slot(r, c3), keys = slot(32 * half, c3);  // key 32 half + j: keys + j c3 + ..
  for (int h = 0; h < heads; ++h) {
    const int qo = h * hd, ko = c + h * hd, vo = 2 * c + h * hd;
    float q[kMaxHead];
#pragma unroll
    for (int d = 0; d < kMaxHead; d += 2) {
      const float2 v = d < hd ? *reinterpret_cast<const float2*>(s + sr + qo + d) : float2{};
      q[d] = v.x * scale;
      q[d + 1] = v.y * scale;
    }
    float p[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) p[j] = 0.f;
#pragma unroll
    for (int d = 0; d < kMaxHead; d += 2) {
      if (d < hd) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float2 k = *reinterpret_cast<const float2*>(s + keys + j * c3 + (j >> 4) * 8 + ko + d);
          p[j] = fmaf(q[d + 1], k.y, fmaf(q[d], k.x, p[j]));
        }
      }
    }
    const float4* m = reinterpret_cast<const float4*>(mask + ((size_t)h * kTokens + r) * kTokens +
                                                      32 * half);
    float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int j = 0; j < 32; j += 4) {
      const float4 mv = __ldg(m + j / 4);
      p[j] += mv.x;
      p[j + 1] += mv.y;
      p[j + 2] += mv.z;
      p[j + 3] += mv.w;
      mx = fmaxf(mx, fmaxf(fmaxf(p[j], p[j + 1]), fmaxf(p[j + 2], p[j + 3])));
    }
    mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, 1));
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      p[j] = expf(p[j] - mx);
      l += p[j];
    }
    l += __shfl_xor_sync(kAll, l, 1);
    float o[kMaxHead];
#pragma unroll
    for (int d = 0; d < kMaxHead; ++d) o[d] = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float* v = s + keys + j * c3 + (j >> 4) * 8 + vo;
#pragma unroll
      for (int d = 0; d < kMaxHead; d += 2) {
        if (d < hd) {
          const float2 w = *reinterpret_cast<const float2*>(v + d);
          o[d] = fmaf(p[j], w.x, o[d]);
          o[d + 1] = fmaf(p[j], w.y, o[d + 1]);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < kMaxHead; d += 2) {
      if (d < hd) {  // hd is the block's: the pair's shuffles stay converged
        o[d] += __shfl_xor_sync(kAll, o[d], 1);
        o[d + 1] += __shfl_xor_sync(kAll, o[d + 1], 1);
        if ((d >> 1 & 1) == half) {
          *reinterpret_cast<float2*>(s + sr + qo + d) = make_float2(o[d] / l, o[d + 1] / l);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    window_attn_kernel(const T* __restrict__ qkv, const T* __restrict__ masks, T* __restrict__ out,
                       int H, int W, int C, int heads, int shift, float scale, long long windows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int hd = C / heads, c3 = 3 * C;
  const int nwr = H / kWindow, nwc = W / kWindow;
  const long long per_image = (long long)nwr * nwc;
  for (long long win = blockIdx.x; win < windows; win += gridDim.x) {
    const long long b = win / per_image;
    const int rem = (int)(win - b * per_image);
    const int wr = rem / nwc, wc = rem - wr * nwc;
    const int y0 = wr * kWindow + shift, x0 = wc * kWindow + shift;  // < H, < W: s < 8
    const long long row0 = b * H;
    load_window(s, qkv, row0, H, W, c3, y0, x0);
    __syncthreads();
    const int cls = shift ? 2 * (wr == nwr - 1) + (wc == nwc - 1) : 0;
    attend(s, masks + (size_t)cls * heads * kTokens * kTokens, heads, hd, C, scale);
    __syncthreads();
    store_window(out, s, row0, H, W, C, c3, y0, x0);
    __syncthreads();  // the slots are the next window's
  }
}

template <typename T>
int launch(const void* qkv, const void* masks, void* out, int B, int H, int W, int C, int heads,
           int shift, float scale, void* stream) {
  auto kernel = window_attn_kernel<T>;
  const int smem = static_cast<int>(sizeof(T)) * (kTokens * 3 * C + (kTokens / 16) * 8);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long windows = (long long)B * (H / kWindow) * (W / kWindow);
  const int grid = (int)(windows < kMaxGrid ? windows : kMaxGrid);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(masks), static_cast<T*>(out), H, W, C,
      heads, shift, scale, windows);
  return static_cast<int>(cudaGetLastError());
}

// ---- window 16, bf16: one block a (window, head) --------------------------

constexpr int kWindow16 = 16;
constexpr int kTokens16 = kWindow16 * kWindow16;
constexpr int kThreads16 = 128;
constexpr int kBlocksPerSm16 = 4;
constexpr int kChunk16 = 64;  // keys a step of the online softmax
// values of one matrix (q, k or v of the head) in shared memory: 32 a row,
// 8 more after every 16 rows
constexpr int kMatrix16 = 32 * kTokens16 + 8 * (kTokens16 / 16);

__device__ __forceinline__ int slot16(int t) { return 32 * t + 8 * (t >> 4); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Image offset (in tokens) of window token t: row y0 + (t >> 4), column
// x0 + (t & 15), each mod the map's size (the roll).
__device__ __forceinline__ long long token16(int t, long long row0, int H, int W, int y0,
                                             int x0) {
  int y = y0 + (t >> 4), x = x0 + (t & 15);
  if (y >= H) y -= H;
  if (x >= W) x -= W;
  return (row0 + y) * W + x;
}

__global__ void __launch_bounds__(kThreads16, kBlocksPerSm16)
    window_attn16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ masks,
                         bf16* __restrict__ out, int H, int W, int C, int heads, int shift,
                         float scale, long long tasks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s = reinterpret_cast<bf16*>(smem_raw);  // q, k, v: kMatrix16 values each
  const int hd = C / heads, c3 = 3 * C, words = hd / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int nwr = H / kWindow16, nwc = W / kWindow16;
  const long long per_image = (long long)nwr * nwc;

  // the padding of every row (values hd .. 31) is zero, once: the loads
  // write values < hd only
  for (int i = threadIdx.x; i < 3 * kTokens16; i += kThreads16) {
    bf16* row = s + (i / kTokens16) * kMatrix16 + slot16(i % kTokens16);
    for (int d = hd; d < 32; ++d) row[d] = __float2bfloat16(0.f);
  }
  // this lane's two 4-byte pieces of a token: word j of 3 hd / 2 (q, k, v
  // in turn), at qkv offset part C + d and shared offset part kMatrix16 + d
  int src_off[2], dst_off[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int j = lane + 32 * p;
    const int part = j / words, d = 2 * (j - part * words);
    src_off[p] = j < 3 * words ? part * C + d : -1;
    dst_off[p] = part * kMatrix16 + d;
  }

  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long win = task / heads;
    const int h = (int)(task - win * heads);
    const long long b = win / per_image;
    const int rem = (int)(win - b * per_image);
    const int wr = rem / nwc, wc = rem - wr * nwc;
    const int y0 = wr * kWindow16 + shift, x0 = wc * kWindow16 + shift;
    const long long row0 = b * H;
    __syncthreads();  // the last task's reads of shared memory are done
    for (int t = warp; t < kTokens16; t += kThreads16 / 32) {
      const bf16* src = qkv + token16(t, row0, H, W, y0, x0) * c3 + h * hd;
      bf16* dst = s + slot16(t);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (src_off[p] >= 0) {
          const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + dst_off[p]));
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                       "l"(src + src_off[p])
                       : "memory");
        }
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    const int cls = shift ? 2 * (wr == nwr - 1) + (wc == nwc - 1) : 0;
    const bf16* mask = masks + ((size_t)cls * heads + h) * kTokens16 * kTokens16 + 16 * q4;
    const bf16* sq = s;
    const bf16* sk = s + kMatrix16;
    const bf16* sv = s + 2 * kMatrix16;
    // ldmatrix rows this lane gives: matrix lane >> 3, row lane & 7
    const int r8 = lane & 7, mat = lane >> 3;
    for (int m = warp; m < kTokens16 / 16; m += kThreads16 / 32) {
      const int r0 = 16 * m + g, r1 = r0 + 8;
      uint32_t qa[2][4];  // A fragments of Q, head dims 0-15 and 16-31
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        ldsm_x4(qa[kk], sq + slot16(16 * m + r8 + 8 * (mat & 1)) + 8 * (mat >> 1) + 16 * kk);
      }
      float o[4][4];
#pragma unroll
      for (int nd = 0; nd < 4; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
      float mx0 = __int_as_float(0xff800000), mx1 = mx0;  // -inf
      float l0 = 0.f, l1 = 0.f;  // this lane's part of the row sums
      for (int c = 0; c < kTokens16; c += kChunk16) {
        // S's n-tile j, column n is key c + 16 (n >> 1) + 2 j + (n & 1): the
        // accumulator (row, 2 q4 + e) is key c + 16 q4 + 2 j + e
        float acc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t kb[4];
          ldsm_x4(kb, sk + slot16(c + 16 * (r8 >> 1) + 2 * j + (r8 & 1)) + 8 * mat);
          acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
          mma(acc[j], qa[0], kb[0], kb[1]);
          mma(acc[j], qa[1], kb[2], kb[3]);
        }
        const uint4 m0a = __ldg(reinterpret_cast<const uint4*>(mask + r0 * kTokens16 + c));
        const uint4 m0b = __ldg(reinterpret_cast<const uint4*>(mask + r0 * kTokens16 + c + 8));
        const uint4 m1a = __ldg(reinterpret_cast<const uint4*>(mask + r1 * kTokens16 + c));
        const uint4 m1b = __ldg(reinterpret_cast<const uint4*>(mask + r1 * kTokens16 + c + 8));
        float c0 = __int_as_float(0xff800000), c1 = c0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t w0 = word(j < 4 ? m0a : m0b, j & 3), w1 = word(j < 4 ? m1a : m1b, j & 3);
          acc[j][0] = fmaf(acc[j][0], scale, lo_of(w0));
          acc[j][1] = fmaf(acc[j][1], scale, hi_of(w0));
          acc[j][2] = fmaf(acc[j][2], scale, lo_of(w1));
          acc[j][3] = fmaf(acc[j][3], scale, hi_of(w1));
          c0 = fmaxf(c0, fmaxf(acc[j][0], acc[j][1]));
          c1 = fmaxf(c1, fmaxf(acc[j][2], acc[j][3]));
        }
#pragma unroll
        for (int x = 1; x < 4; x <<= 1) {
          c0 = fmaxf(c0, __shfl_xor_sync(kAll, c0, x));
          c1 = fmaxf(c1, __shfl_xor_sync(kAll, c1, x));
        }
        const float n0 = fmaxf(mx0, c0), n1 = fmaxf(mx1, c1);
        const float a0 = ex2((mx0 - n0) * kLog2e), a1 = ex2((mx1 - n1) * kLog2e);
        mx0 = n0;
        mx1 = n1;
        const float b0 = n0 * kLog2e, b1 = n1 * kLog2e;
        l0 *= a0;
        l1 *= a1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][0] = ex2(fmaf(acc[j][0], kLog2e, -b0));
          acc[j][1] = ex2(fmaf(acc[j][1], kLog2e, -b0));
          acc[j][2] = ex2(fmaf(acc[j][2], kLog2e, -b1));
          acc[j][3] = ex2(fmaf(acc[j][3], kLog2e, -b1));
          l0 += acc[j][0] + acc[j][1];
          l1 += acc[j][2] + acc[j][3];
        }
#pragma unroll
        for (int nd = 0; nd < 4; ++nd) {
          o[nd][0] *= a0;
          o[nd][1] *= a0;
          o[nd][2] *= a1;
          o[nd][3] *= a1;
        }
        // P V: k-step kk's index i is key c + 16 (i >> 1) + 4 kk + (i & 1)
        // (i < 8) or that + 2 (i >= 8), as S's n-tiles 2 kk and 2 kk + 1 hold
        // them; V's fragments by ldmatrix.trans of those key rows
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t pa[4] = {pack(acc[2 * kk][0], acc[2 * kk][1]),
                                  pack(acc[2 * kk][2], acc[2 * kk][3]),
                                  pack(acc[2 * kk + 1][0], acc[2 * kk + 1][1]),
                                  pack(acc[2 * kk + 1][2], acc[2 * kk + 1][3])};
          const bf16* vrow =
              sv + slot16(c + 16 * (r8 >> 1) + 4 * kk + 2 * (mat & 1) + (r8 & 1)) + 8 * (mat >> 1);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t vb[4];
            ldsm_x4_trans(vb, vrow + 16 * half);
            mma(o[2 * half], pa, vb[0], vb[1]);
            mma(o[2 * half + 1], pa, vb[2], vb[3]);
          }
        }
      }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        l0 += __shfl_xor_sync(kAll, l0, x);
        l1 += __shfl_xor_sync(kAll, l1, x);
      }
      const float i0 = 1.f / l0, i1 = 1.f / l1;
      bf16* o0 = out + token16(r0, row0, H, W, y0, x0) * C + h * hd;
      bf16* o1 = out + token16(r1, row0, H, W, y0, x0) * C + h * hd;
#pragma unroll
      for (int nd = 0; nd < 4; ++nd) {
        const int d = 8 * nd + 2 * q4;
        if (d < hd) {
          *reinterpret_cast<__nv_bfloat162*>(o0 + d) =
              __floats2bfloat162_rn(o[nd][0] * i0, o[nd][1] * i0);
          *reinterpret_cast<__nv_bfloat162*>(o1 + d) =
              __floats2bfloat162_rn(o[nd][2] * i1, o[nd][3] * i1);
        }
      }
    }
  }
}

int launch16(const void* qkv, const void* masks, void* out, int B, int H, int W, int C,
             int heads, int shift, float scale, void* stream) {
  const int smem = static_cast<int>(sizeof(bf16)) * 3 * kMatrix16;
  cudaError_t err = cudaFuncSetAttribute(window_attn16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(window_attn16_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tasks = (long long)B * (H / kWindow16) * (W / kWindow16) * heads;
  const int grid = (int)(tasks < kMaxGrid ? tasks : kMaxGrid);
  window_attn16_kernel<<<grid, kThreads16, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(masks), static_cast<bf16*>(out), H,
      W, C, heads, shift, scale, tasks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes): qkv [B, H, W, 3C], masks [K, heads, 64,
// 64], out [B, H, W, C], all of the entry's type; shift 0 or 4; scale the true
// head size's hd^-0.5. Each returns cudaGetLastError().
extern "C" int fsr_window_attn_bf16(const void* qkv, const void* masks, void* out, int B, int H,
                                    int W, int C, int heads, int shift, float scale,
                                    void* stream) {
  return launch<bf16>(qkv, masks, out, B, H, W, C, heads, shift, scale, stream);
}

extern "C" int fsr_window_attn_f32(const void* qkv, const void* masks, void* out, int B, int H,
                                   int W, int C, int heads, int shift, float scale, void* stream) {
  return launch<float>(qkv, masks, out, B, H, W, C, heads, shift, scale, stream);
}

// Window 16, bf16: masks [K, heads, 256, 256], shift 0 or 8; otherwise as
// fsr_window_attn_bf16.
extern "C" int fsr_window_attn16_bf16(const void* qkv, const void* masks, void* out, int B,
                                      int H, int W, int C, int heads, int shift, float scale,
                                      void* stream) {
  return launch16(qkv, masks, out, B, H, W, C, heads, shift, scale, stream);
}
