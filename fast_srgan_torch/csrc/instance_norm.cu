// Instance norm with a PReLU or a residual-add epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernels of fast_srgan_tpu/kernels/instance_norm.py:
// `_kernel` (one sample resident in VMEM, grid over the batch) and
// `_make_chunked_kernel` (two double-buffered DMA passes over one sample),
// and runs the generator's other norm, `instance_norm_nhwc(y) + x`
// (fast_srgan_tpu/ops/norm.py, models/generator.py), through the same
// kernel with another epilogue. Per (sample, channel) of a channels_last x:
//
//   mean = sum(x) / HW,  ex2 = sum(x^2) / HW          (fp32)
//   var  = max(ex2 - mean^2, 0)                        (one pass, clamped)
//   y    = (x - mean) * rsqrt(var + eps)
//   PReLU: out = y >= 0 ? y : alpha * y                (stored in x's dtype, RNE)
//   add:   out = T(float(T(y)) + skip)                 (y rounded to x's dtype
//                                                       first, as the plain
//                                                       composition rounds)
//
// The function is bandwidth-bound (a few flops an element): its least
// traffic is one read of x (and of skip) and one write of out. Two forms:
//
//   Resident (in_resident_kernel): one cooperative launch of at most one
//   block an SM, each keeping its tile on chip from the statistics to the
//   store, so x crosses HBM once. The batch is walked in waves of
//   `per_wave` samples; each sample of a wave is cut into gridDim.x /
//   per_wave tiles of `tile_px` contiguous pixels (one contiguous span of
//   memory in channels_last), one tile a block. A sample's statistics need
//   every block of its wave, and each hop between SMs costs an L2 round
//   trip that full HBM traffic stretches to ~1 us. So the exchange runs
//   through tagged words (a 64-bit word holds an fp32 value and a 1 above
//   it, is written with one relaxed store and polled until its tag shows:
//   no fence waits behind the stream of stores), and it is pipelined two
//   waves deep. Iteration w:
//     C1. sums wave w's tile (in a ring of three shared-memory tiles,
//         copied in by cp.async two iterations before) and writes its fp32
//         partial sums;
//     C2. reduces the block's share of wave w - 1's totals (statistic j
//         belongs to tile j mod tiles) over every tile's partial, one warp a
//         statistic in one fixed order, and publishes them;
//     A.  normalizes wave w - 2's tile, held in registers, with the totals
//         published during the iteration before, and stores it (the
//         residual form's skip vectors are loaded at the top of the
//         iteration);
//     R.  moves wave w - 1's tile from its ring slot into registers and
//         copies wave w + 2's tile into the slot.
//   Results are deterministic, and every block reads the same totals. The
//   words are zeroed by a memset ahead of the launch in the same stream
//   (under CUDA-graph replay a host-side epoch would repeat), and the
//   cooperative launch guarantees that blocks which wait on each other are
//   co-resident, or fails. Each thread copies, sums and holds only its own
//   16-byte vectors (vector v = t + k * blockDim.x, and blockDim.x is a
//   multiple of C / N; at most kHeld of them), so cp.async.wait_group alone
//   makes its data visible.
//
//   Two launches (in_stats_kernel, in_apply_kernel): where a tile does not
//   fit in shared memory (a sample too large for the SMs' shared memory:
//   bf16 [1,64,540,960], fp32 at the serving shape). The grid is [tiles, B]
//   of 256-thread blocks, tiles = kTwoLaunchBlocks x the SMs (fewer for a
//   small sample) whatever B is, so a sample's sums come out the same bits
//   alone, in a batch and as one shard of the split form. The blocks of a
//   sample sweep it as one front, a chunk each at a time, and a thread
//   loads its kBatch 16-byte vectors of a chunk before it uses any (64 KB
//   an SM in flight). The statistics pass writes each block's partial
//   sums; the last block of a sample to arrive (a counter under
//   __threadfence + atomicAdd, zeroed by a memset in the stream, so
//   CUDA-graph replay stays right) sums the sample's partials in block
//   order into its fp32 totals: the same bits
//   whichever block arrives last. An apply block then reads O(C) totals,
//   not every partial. The apply sweeps the batch backwards, so what the
//   statistics pass read last, still in the 50 MB L2, is re-read first,
//   and stores out evict-first (.cs), so that out does not push out the x
//   still to be re-read. Bound: bytes (x read once, out written once); on
//   an H100 the statistics pass reads x as fast as torch.sum does and the
//   apply moves its bytes about as fast as a copy (PERF.md, section 6).
//
// Split form (the width-sharded forward, fast_srgan_torch/parallel/
// spatial.py): the two passes as their own entry points. It replaces
// `_dist_instance_norm` (fast_srgan_tpu/parallel/spatial.py), which XLA
// lowered on the TPU: per-shard fp32 sums and sums of squares, psum'd over
// the shards, count = H x the whole frame's width. Here each shard's
// statistics pass writes its totals (the psum's per-shard term); the caller
// gathers every shard's, in shard order, to every shard; each shard's apply
// pass adds those few rows in row order over the global count, so every
// shard normalizes with bitwise the same statistics. Bound: bytes, as above.
//
// Masked forms (M = true, the bucketed forward): x is a zero-padded frame of
// width W, and sample b's valid region is y < vh[b], x < vw[b]. They replace
// `instance_norm_masked_nhwc` (fast_srgan_tpu/ops/norm.py), which XLA
// lowered on the TPU:
//
//   sums over the valid pixels only; mean = sum(x) / (vh * vw), ex2 likewise
//   out = epilogue(y) at a valid pixel; PReLU: 0, add: skip at padding
//
// Neither form reads x at a padded pixel, and both write out everywhere (0
// or skip). The two launches predicate each load (one 16-byte vector is one
// pixel's channels): each thread finds its first pixel's (row, column) once
// and steps it by its pixel stride, with no division a vector. The resident
// form is latency-bound, so it keeps the mask off its critical path: when a
// wave's copy is issued (two iterations before its sums), each block works
// out once whether its tile holds a valid pixel at all and each thread which
// of its vectors do (a TileMask, carried with the tile to the normalize; the
// valid sizes it needs are loaded earlier in that iteration, behind C2's
// wait). A valid vector is copied; a padded one is zero-filled in shared
// memory by a cp.async of source size 0, which reads nothing. Zeros add
// nothing to either sum, so C1 sums the tile with no validity test, exactly
// as the unmasked form does, and A sends the padding to 0 or skip by the
// mask. A tile wholly in padding takes the short road: no copy, zero
// partial sums written without the block's reduction, no wait for the
// totals in A, and zeros (PReLU) or skip (add) stored evict-first. A fully
// valid batch takes the unmasked form's copies, sums and order: bitwise its
// results. The unmasked instantiation (M = false) compiles none of this.
//
// The wrapper (fast_srgan_torch/kernels/instance_norm.py) chooses the form
// and the grid by shape, and guarantees: C % N == 0 with N = 16 / sizeof(T),
// C / N <= 256, contiguous channels_last x, skip and out aligned to 16
// bytes, alpha a device fp32 scalar; for the two launches scratch of
// B * (tiles a sample + 1) * 2 * C + B floats; for the resident form
// gridDim.x = per_wave * (tiles a sample) <= the SMs, shared memory for
// min(waves, 3) tiles, and 8 * B * (tiles + 1) * 2 * C bytes of scratch for
// the tagged words.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // two-launch form
constexpr int kTwoLaunchBlocks = 2;    // its blocks a sample an SM
constexpr int kBatch = 8;   // 16-byte vectors a two-launch thread loads at once
constexpr int kRowBatch = 16;  // rows of statistics a thread loads at once
constexpr int kResidentThreads = 512;  // resident form, at most
constexpr int kPrelu = 0;
constexpr int kAdd = 1;
constexpr int kHeld = 8;  // 16-byte vectors a resident thread holds
constexpr int kColumn = 8;  // tagged words a lane has in flight

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& t, float (&v)[4]) {
    v[0] = __uint_as_float(t.x);
    v[1] = __uint_as_float(t.y);
    v[2] = __uint_as_float(t.z);
    v[3] = __uint_as_float(t.w);
  }
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    unpack(*reinterpret_cast<const uint4*>(p), v);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<uint4*>(p) = pack(v);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& t, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    unpack(*reinterpret_cast<const uint4*>(p), v);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[8]) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    return t;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    *reinterpret_cast<uint4*>(p) = pack(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// cp_async16 where fetch, else 16 zero bytes into smem, reading nothing (a
// source size of 0).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool fetch) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(fetch ? 16 : 0)
               : "memory");
}

// An int of read-only memory, loaded where the call stands: as asm volatile
// the compiler keeps it in order with the kernel's other asm and cannot sink
// it to its use, past the stages that hide its latency.
__device__ __forceinline__ int ld_early(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// A tagged word: an fp32 value below, 1 above; zero until written.
__device__ __forceinline__ unsigned long long tagged(float v) {
  return (1ull << 32) | __float_as_uint(v);
}

__device__ __forceinline__ void st_word(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The value of a tagged word, once it is written.
__device__ __forceinline__ float wait_word(const unsigned long long* p) {
  unsigned long long v = ld_word(p);
  while ((v >> 32) == 0ull) v = ld_word(p);
  return __uint_as_float(static_cast<unsigned>(v));
}

// The sum of n tagged words col[k * pitch], k in [0, n), by one warp in one
// fixed order (lane l takes k = l, l + 32, ...; then a shuffle tree); the
// total is lane 0's.
__device__ float warp_column_sum(const unsigned long long* col, int n,
                                 int pitch, int lane) {
  float a = 0.f;
  for (int k0 = 0; k0 < n; k0 += 32 * kColumn) {
    unsigned long long v[kColumn];
#pragma unroll
    for (int i = 0; i < kColumn; ++i) {
      const int k = k0 + lane + 32 * i;
      v[i] = k < n ? ld_word(col + (size_t)k * pitch) : tagged(0.f);
    }
#pragma unroll
    for (int i = 0; i < kColumn; ++i) {
      const int k = k0 + lane + 32 * i;
      while ((v[i] >> 32) == 0ull) v[i] = ld_word(col + (size_t)k * pitch);
      a += __uint_as_float(static_cast<unsigned>(v[i]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
  }
  return a;
}

// The epilogue on one vector: v holds the normalized values in, out values
// out; sk is skip's vector (kAdd only).
template <typename T, int E, int N>
__device__ __forceinline__ void epilogue(float (&v)[N], const float (&sk)[N],
                                         float a) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (E == kPrelu) {
      v[i] = v[i] >= 0.f ? v[i] : a * v[i];
    } else {
      v[i] = Pack<T>::round(v[i]) + sk[i];
    }
  }
}

// Sums each thread's per-channel s[N] and q[N] over the block, in a fixed
// order, and hands statistic j of [0, 2c) (sums, then sums of squares) to
// out(j, value). The thread owns channel group g = t % groups and row
// t / groups. Where groups divides 32, the lanes of a warp that share a
// channel group are folded first by shuffles, and a row is a warp. red holds
// 2c * (rows + 1) floats (one padded row a statistic, so a warp's stores
// fall in distinct banks), red2 max(blockDim.x, 2c). Every thread of the
// block must call it.
template <int N, typename Out>
__device__ void block_sums(float (&s)[N], float (&q)[N], float* red,
                           float* red2, int groups, int c, Out out) {
  const int c2 = 2 * c;
  const int t = threadIdx.x;
  const int g = t % groups;
  int r = t / groups;
  int rows = blockDim.x / groups;
  bool writes = true;
  if (32 % groups == 0) {  // blockDim.x is then a multiple of 32
    for (int off = 16; off >= groups; off >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        s[i] += __shfl_down_sync(0xffffffffu, s[i], off);
        q[i] += __shfl_down_sync(0xffffffffu, q[i], off);
      }
    }
    r = t / 32;
    rows = blockDim.x / 32;
    writes = t % 32 < groups;
  }
  const int pitch = rows + 1;
  if (writes) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      red[(g * N + i) * pitch + r] = s[i];
      red[(c + g * N + i) * pitch + r] = q[i];
    }
  }
  __syncthreads();
  const int parts = max(1, static_cast<int>(blockDim.x) / c2);
  for (int j = t; j < parts * c2; j += blockDim.x) {
    const float* row = red + (j % c2) * pitch;
    float a = 0.f;
    for (int k = j / c2; k < rows; k += parts) a += row[k];
    red2[j] = a;
  }
  __syncthreads();
  for (int stat = t; stat < c2; stat += blockDim.x) {
    float a = 0.f;
    for (int p = 0; p < parts; ++p) a += red2[p * c2 + stat];
    out(stat, a);
  }
}

// a += v, compensated (Kahan): e carries the low bits a lost, so a long
// run of adds is as accurate as a tree.
__device__ __forceinline__ void kahan_add(float& a, float& e, float v) {
  const float y = v - e;
  const float t = a + y;
  e = (t - a) - y;
  a = t;
}

// The sums of n rows of 2c floats (rows[k][0, 2c)) into out[0, 2c), in one
// fixed order for a given n, c and blockDim.x, whichever block runs it: a
// thread sums one 16-byte quad of statistics over the rows k = j / quads,
// j / quads + parts, ... (kRowBatch loads issued before their adds,
// compensated: with one part a thread adds every row, up to 2 x the SMs,
// and the one-pass variance would pass on a plain running sum's error),
// then the parts are added in order. red2 holds max(4 * blockDim.x, 2c)
// floats. Every thread of the block must call it.
__device__ void sum_rows(const float* rows, int n, int c2, float* red2,
                         float* out) {
  const int quads = c2 / 4;
  const int parts = max(1, static_cast<int>(blockDim.x) / quads);
  for (int j = threadIdx.x; j < parts * quads; j += blockDim.x) {
    const float4* col = reinterpret_cast<const float4*>(rows) + j % quads;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = j / quads; k0 < n; k0 += kRowBatch * parts) {
      float4 v[kRowBatch];
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        const int k = k0 + i * parts;
        v[i] = k < n ? __ldcg(col + (size_t)k * quads)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        kahan_add(a.x, e.x, v[i].x);
        kahan_add(a.y, e.y, v[i].y);
        kahan_add(a.z, e.z, v[i].z);
        kahan_add(a.w, e.w, v[i].w);
      }
    }
    reinterpret_cast<float4*>(red2)[j] = a;  // red2[part][2c]
  }
  __syncthreads();
  for (int stat = threadIdx.x; stat < c2; stat += blockDim.x) {
    float a = 0.f;
    for (int p = 0; p < parts; ++p) a += red2[p * c2 + stat];
    out[stat] = a;
  }
}

// A thread's pixels p, p + stride, p + 2 * stride, ... of a W-wide frame,
// walked in (row, column) without a division a pixel.
struct PixelWalk {
  int y, x, dy, dx, w;
  __device__ __forceinline__ PixelWalk(int p, int stride, int width)
      : y(p / width), x(p % width), dy(stride / width), dx(stride % width),
        w(width) {}
  __device__ __forceinline__ bool inside(int vh, int vw) const {
    return y < vh && x < vw;
  }
  __device__ __forceinline__ void next() {
    x += dx;
    y += dy;
    if (x >= w) {
      x -= w;
      ++y;
    }
  }
};

// ---------------------------------------------------------------- resident

// masked: a TileMask's bit that the tile holds a valid pixel at all (bits 0
// .. kHeld - 1: which of the thread's vectors do); a block carries the masks
// of four waves in one 64-bit word, 16 bits each.
constexpr unsigned kAny = 1u << 15;

template <typename T, int E, bool M>
__global__ void __launch_bounds__(kResidentThreads, 1)
    in_resident_kernel(const T* __restrict__ x, const T* __restrict__ skip,
                       const float* __restrict__ alpha,
                       const int* __restrict__ vh, const int* __restrict__ vw,
                       T* __restrict__ out,
                       unsigned long long* __restrict__ words, int batch,
                       int hw, int width, int c, int per_wave, int tile_px,
                       float eps) {
  using P = Pack<T>;
  constexpr int N = P::N;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int threads = blockDim.x;  // rows * groups
  const int lane = t % 32;
  const int warp = t / 32;
  const int warps = threads / 32;  // whole warps
  const int groups = c / N;
  const int g = t % groups;
  const int c2 = 2 * c;
  const int tiles = gridDim.x / per_wave;  // tiles a sample
  const int slot = blockIdx.x / tiles;     // sample of the wave
  const int tile = blockIdx.x % tiles;
  const int waves = (batch + per_wave - 1) / per_wave;
  // masked: the valid sizes of waves 0 and 1 (0 past the batch), loaded
  // first so that the set-up below hides their latency
  const bool has1 = per_wave + slot < batch;
  const int h0 = M && slot < batch ? ld_early(vh + slot) : 0;
  const int w0 = M && slot < batch ? ld_early(vw + slot) : 0;
  const int h1 = M && has1 ? ld_early(vh + per_wave + slot) : 0;
  const int w1 = M && has1 ? ld_early(vw + per_wave + slot) : 0;
  const int nbuf = min(waves, 3);
  const int p0 = min(tile * tile_px, hw);
  const int nvec = (min(p0 + tile_px, hw) - p0) * groups;  // 16-byte vectors
  const size_t tile_elems = (size_t)tile_px * c;
  // masked: the tile's first pixel (ya, xa) and its last one's row yb. It
  // holds a valid pixel where its first one is, or where it reaches a
  // second row that is valid (its column 0 is). The thread's vector k = t +
  // k * threads is pixel p0 + t / groups + k * rows. All are the same in
  // every wave: found once.
  const int ya = M ? p0 / width : 0, xa = M ? p0 % width : 0;
  const int yb = M ? max(p0, p0 + nvec / groups - 1) / width : 0;
  const PixelWalk walk0(M ? p0 + t / groups : 0, threads / groups, M ? width : 1);
  auto tile_mask = [&](int hb, int wb) -> unsigned {  // 0: all padding
    if (!(nvec > 0 && ((ya < hb && xa < wb) || (yb > ya && ya + 1 < hb)))) {
      return 0u;
    }
    PixelWalk px = walk0;
    unsigned mask = kAny;
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (px.inside(hb, wb)) mask |= 1u << k;
      px.next();
    }
    return mask;
  };

  T* xbuf = reinterpret_cast<T*>(smem);  // a ring of nbuf tiles of x
  float* red = reinterpret_cast<float*>(xbuf + nbuf * tile_elems);
  float* red2 = red + c2 * (threads / groups + 1);
  float* stat = red2 + max(4 * threads, c2);  // mean [c], 1/sqrt [c]
  float* tot = stat + c2;                      // the sample's sums [2c]

  // tagged words: every tile's partial sums [batch][tiles][2c], then each
  // sample's totals [batch][2c]
  unsigned long long* part = words;
  unsigned long long* sums = words + (size_t)batch * tiles * c2;

  // wave w's tile into its ring slot (masked: its valid vectors, the others
  // zero-filled; nothing for a tile all padding)
  auto copy_tile = [&](int w, unsigned mask) {
    const int b = w * per_wave + slot;
    if (w >= waves || b >= batch) return;
    const T* from = x + ((size_t)b * hw + p0) * c;
    T* to = xbuf + (w % nbuf) * tile_elems;
    if (!M) {
      for (int v = t; v < nvec; v += threads) {
        cp_async16(to + (size_t)v * N, from + (size_t)v * N);
      }
      return;
    }
    if (!(mask & kAny)) return;
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      const int v = t + k * threads;
      if (v < nvec) {
        cp_async16_zfill(to + (size_t)v * N, from + (size_t)v * N,
                         (mask >> k) & 1u);
      }
    }
  };
  // masked: the TileMasks of waves w - 2, w - 1, w and w + 1 at the top of
  // iteration w (wave w - 2 + i at bit 16 i)
  const unsigned m0 = h0 > 0 ? tile_mask(h0, w0) : 0u;
  const unsigned m1 = h1 > 0 ? tile_mask(h1, w1) : 0u;
  unsigned long long masks =
      ((unsigned long long)m0 << 32) | ((unsigned long long)m1 << 48);

  const float a = E == kPrelu ? __ldg(alpha) : 0.f;
  copy_tile(0, m0);
  cp_async_commit();
  copy_tile(1, m1);
  cp_async_commit();

  uint4 held[kHeld];  // wave w - 2's tile, moved out of shared memory
  uint4 skr[kHeld];   // its skip vectors (kAdd)
  for (int w = 0; w < waves + 2; ++w) {
    // samples of the three stages (block-uniform, as every condition)
    const int b = w * per_wave + slot;
    const int b1 = b - per_wave;
    const int b2 = b1 - per_wave;
    const bool sums_now = w < waves && b < batch;
    const bool totals_now = w >= 1 && b1 < batch;
    const bool norm_now = w >= 2 && b2 < batch;
    const unsigned m_norm = static_cast<unsigned>(masks);  // (low 16 bits)
    const unsigned m_held = static_cast<unsigned>(masks >> 16);
    const unsigned m_sum = static_cast<unsigned>(masks >> 32);
    if (E == kAdd && norm_now) {
      const uint4* sk =
          reinterpret_cast<const uint4*>(skip + ((size_t)b2 * hw + p0) * c);
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        const int v = t + k * threads;
        if (v < nvec) skr[k] = __ldg(sk + v);
      }
    }

    // C1. wave w's partial sums (masked: its padding is zeros)
    if (sums_now && (!M || (m_sum & kAny))) {
      const T* cur = xbuf + (w % nbuf) * tile_elems;
      cp_async_wait<1>();  // pending: tiles w and w + 1
      float s[N], q[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        s[i] = 0.f;
        q[i] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        const int v = t + k * threads;
        if (v < nvec) {
          float e[N];
          P::load(cur + (size_t)v * N, e);
#pragma unroll
          for (int i = 0; i < N; ++i) {
            s[i] += e[i];
            q[i] += e[i] * e[i];
          }
        }
      }
      unsigned long long* row = part + ((size_t)b * tiles + tile) * c2;
      block_sums<N>(s, q, red, red2, groups, c,
                    [&](int j, float v) { st_word(row + j, tagged(v)); });
    } else if (M && sums_now) {  // all padding: its sums are 0
      unsigned long long* row = part + ((size_t)b * tiles + tile) * c2;
      for (int j = t; j < c2; j += threads) st_word(row + j, tagged(0.f));
    }

    // masked: wave w + 2's valid size for its copy at the bottom and wave
    // w - 2's for A's count, loaded after C1 (where registers are scarcest)
    // and ahead of C2's wait, which hides them
    const int bn = b + 2 * per_wave;
    const bool copy_next = M && w + 2 < waves && bn < batch;
    const int hn = copy_next ? ld_early(vh + bn) : 0;
    const int wn = copy_next ? ld_early(vw + bn) : 0;
    const int h2 = (M && norm_now) ? ld_early(vh + b2) : 0;
    const int w2 = (M && norm_now) ? ld_early(vw + b2) : 0;

    // C2. this block's share of wave w - 1's totals: statistic j of tile
    // j mod tiles, over every tile's partial (written an iteration ago)
    if (totals_now && warp < warps) {
      const unsigned long long* pb = part + (size_t)b1 * tiles * c2;
      for (int j = tile + warp * tiles; j < c2; j += warps * tiles) {
        const float v = warp_column_sum(pb + j, tiles, c2, lane);
        if (lane == 0) st_word(sums + (size_t)b1 * c2 + j, tagged(v));
      }
    }

    // masked: wave w + 2's TileMask and wave w - 2's count, now that C2's
    // wait has hidden their loads (fewer registers through A)
    const unsigned m_new = copy_next ? tile_mask(hn, wn) : 0u;
    const float valid_count = M ? (float)(h2 * w2) : 0.f;

    // A. normalize wave w - 2 (totals published an iteration ago)
    if (norm_now && (!M || (m_norm & kAny))) {
      for (int j = t; j < c2; j += threads) {
        tot[j] = wait_word(sums + (size_t)b2 * c2 + j);
      }
      __syncthreads();
      const float count = M ? valid_count : (float)hw;
      for (int ch = t; ch < c; ch += threads) {
        const float mean = tot[ch] / count;
        const float var = fmaxf(tot[c + ch] / count - mean * mean, 0.f);
        stat[ch] = mean;
        stat[c + ch] = 1.0f / sqrtf(var + eps);
      }
      __syncthreads();
      float m[N], rs[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        m[i] = stat[g * N + i];
        rs[i] = stat[c + g * N + i];
      }
      T* o = out + ((size_t)b2 * hw + p0) * c;
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        const int v = t + k * threads;
        if (v < nvec) {
          float e[N], f[N];
          P::unpack(held[k], e);
          if (E == kAdd) P::unpack(skr[k], f);
          // masked padding: 0 into the add's epilogue (out = skip); the
          // PReLU's 0 is stored whole (one select a vector, not a value)
          const bool in = !M || ((m_norm >> k) & 1u);
#pragma unroll
          for (int i = 0; i < N; ++i) {
            e[i] = E == kAdd && !in ? 0.f : (e[i] - m[i]) * rs[i];
          }
          epilogue<T, E, N>(e, f, a);
          if (E == kPrelu && !in) {
            *reinterpret_cast<uint4*>(o + (size_t)v * N) = make_uint4(0u, 0u, 0u, 0u);
          } else {
            P::store(o + (size_t)v * N, e);
          }
        }
      }
    } else if (M && norm_now) {  // all padding: 0 or skip, no statistics
      uint4* o = reinterpret_cast<uint4*>(out + ((size_t)b2 * hw + p0) * c);
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        const int v = t + k * threads;
        if (v < nvec) __stcs(o + v, E == kAdd ? skr[k] : make_uint4(0u, 0u, 0u, 0u));
      }
    }

    // R. wave w - 1's tile into registers; wave w + 2's into its slot
    if (totals_now && (!M || (m_held & kAny))) {
      const uint4* from =
          reinterpret_cast<const uint4*>(xbuf + ((w - 1) % nbuf) * tile_elems);
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        const int v = t + k * threads;
        if (v < nvec) held[k] = from[v];
      }
    }
    copy_tile(w + 2, m_new);
    cp_async_commit();
    masks = (masks >> 16) | ((unsigned long long)m_new << 48);
  }
  cp_async_wait<0>();
}

template <typename T, int E, bool M>
int launch_resident(const T* x, const T* skip, const float* alpha,
                    const int* vh, const int* vw, T* out,
                    unsigned long long* words, int b, int hw, int w, int c,
                    int grid, int per_wave, int tile_px, float eps,
                    cudaStream_t stream) {
  constexpr int N = Pack<T>::N;
  const int groups = c / N;
  const int threads = (kResidentThreads / groups) * groups;
  const int rows = threads / groups;
  const int waves = (b + per_wave - 1) / per_wave;
  const size_t tile_bytes = (size_t)tile_px * c * sizeof(T);
  const size_t smem =
      min(waves, 3) * tile_bytes +
      ((size_t)2 * c * (rows + 1) + max(4 * threads, 2 * c) + 4 * c) *
          sizeof(float) +
      16;
  auto kernel = in_resident_kernel<T, E, M>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(words, 0, sizeof(*words) * b * (grid / per_wave + 1) * 2 * c,
                        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {(void*)&x,     (void*)&skip,    (void*)&alpha,
                  (void*)&vh,    (void*)&vw,      (void*)&out,
                  (void*)&words, (void*)&b,       (void*)&hw,
                  (void*)&w,     (void*)&c,       (void*)&per_wave,
                  (void*)&tile_px, (void*)&eps};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(threads), args, smem,
                                    stream);
  return static_cast<int>(err);
}

// -------------------------------------------------------------- two launches
//
// A [tiles, B] grid: the blocks of sample b sweep it together, a chunk of
// kBatch * rows pixels a block at a time (chunk j to block j mod tiles),
// so the pixels in flight are one front that moves through the sample.
// `tiles` depends on the sample's size only, so a sample's statistics are
// the same bits alone, in a batch, and as one shard of the split form.
// Thread t owns channel group g = t % groups (N channels) and pixel row
// r = t / groups of rows = blockDim.x / groups, and loads its kBatch
// vectors of a chunk (pixels rows apart) before it uses any of them.

// The statistics pass: each block's partial sums into partial[b][block][2c];
// the last block of a sample to arrive (arrived[b], zeroed ahead of the
// launch) sums the sample's partials in block order into totals[b][2c].
template <typename T, bool M>
__global__ void __launch_bounds__(kThreads, kTwoLaunchBlocks)
    in_stats_kernel(const T* __restrict__ x, const int* __restrict__ vh,
                    const int* __restrict__ vw, float* __restrict__ partial,
                    float* __restrict__ totals,
                    unsigned* __restrict__ arrived, int hw, int w, int c) {
  using P = Pack<T>;
  constexpr int N = P::N;
  extern __shared__ float smem_f[];  // red [2c][rows + 1], red2
  __shared__ bool last;
  const int groups = c / N;
  const int rows = blockDim.x / groups;
  const int g = threadIdx.x % groups;
  const int r = threadIdx.x / groups;
  const int c2 = 2 * c;
  const int tiles = gridDim.x;
  const int b = blockIdx.y;
  const int chunk = kBatch * rows;

  const T* xb = x + (size_t)b * hw * c + g * N;
  float s[N], q[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = 0.f;
    q[i] = 0.f;
  }
  const int hb = M ? __ldg(vh + b) : 0, wb = M ? __ldg(vw + b) : 0;
  for (int p = blockIdx.x * chunk + r; p < hw; p += tiles * chunk) {
    PixelWalk px(p, rows, M ? w : 1);  // w is 0 unmasked
    uint4 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int pk = p + k * rows;
      const bool ok = pk < hw && (!M || px.inside(hb, wb));
      if (M) px.next();
      v[k] = ok ? __ldg(reinterpret_cast<const uint4*>(xb + (size_t)pk * c))
                : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      float e[N];
      P::unpack(v[k], e);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        s[i] += e[i];
        q[i] += e[i] * e[i];
      }
    }
  }
  float* red = smem_f;
  float* red2 = red + c2 * (rows + 1);
  float* mine = partial + ((size_t)b * tiles + blockIdx.x) * c2;
  block_sums<N>(s, q, red, red2, groups, c,
                [&](int j, float v) { mine[j] = v; });
  // publish the partial, then count the block in: the last one sums
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(arrived + b, 1u) == static_cast<unsigned>(tiles - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_rows(partial + (size_t)b * tiles * c2, tiles, c2, red2,
           totals + (size_t)b * c2);
}

// The normalize pass. totals[b][n_parts][2c] holds the sample's sums in
// n_parts rows (1, or one a shard of a sharded frame), added here in row
// order over count pixels (the masked form counts vh[b] * vw[b]). The
// blocks sweep the batch backwards, the reverse of the statistics pass,
// so what that pass read last, still in L2, is read first; out is stored
// evict-first (st.global.cs): it is not read again here, and it would
// push out the x still to be re-read.
template <typename T, int E, bool M>
__global__ void __launch_bounds__(kThreads, kTwoLaunchBlocks)
    in_apply_kernel(const T* __restrict__ x, const T* __restrict__ skip,
                    const float* __restrict__ totals,
                    const float* __restrict__ alpha,
                    const int* __restrict__ vh, const int* __restrict__ vw,
                    T* __restrict__ out, int hw, int w, int c, int n_parts,
                    int count, float eps) {
  using P = Pack<T>;
  constexpr int N = P::N;
  // vectors a thread loads at once: x's (and skip's)
  constexpr int kB = E == kAdd ? kBatch / 2 : kBatch;
  extern __shared__ float smem_f[];  // mean [c], 1/sqrt [c]
  const int groups = c / N;
  const int rows = blockDim.x / groups;
  const int g = threadIdx.x % groups;
  const int r = threadIdx.x / groups;
  const int b = gridDim.y - 1 - blockIdx.y;  // the last sample read first
  const int tiles = gridDim.x;
  const int chunk = kB * rows;
  const int chunks = (hw + chunk - 1) / chunk;
  const size_t base = (size_t)b * hw * c + g * N;
  const int hb = M ? __ldg(vh + b) : 0, wb = M ? __ldg(vw + b) : 0;

  uint4 xv[kB], sv[kB];
  unsigned in = 0u;  // bit k: vector k of the chunk is a valid pixel
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto load = [&](int p) {  // pixels p, p + rows, ...
    PixelWalk px(p, rows, M ? w : 1);  // w is 0 unmasked
    in = 0u;
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      const int pk = p + k * rows;
      const bool here = pk < hw;
      const bool ok = here && (!M || px.inside(hb, wb));
      if (M) px.next();
      in |= ok ? 1u << k : 0u;
      const size_t at = base + (size_t)(here ? pk : 0) * c;
      xv[k] = ok ? __ldg(reinterpret_cast<const uint4*>(x + at)) : zero;
      if (E == kAdd) {
        sv[k] = here ? __ldg(reinterpret_cast<const uint4*>(skip + at)) : zero;
      }
    }
  };
  // this block's chunks blockIdx.x + m * tiles, the last one first; its
  // loads are in flight while the statistics are read
  const int top = blockIdx.x < chunks
                      ? blockIdx.x + (chunks - 1 - blockIdx.x) / tiles * tiles
                      : -1;
  if (top >= 0) load(top * chunk + r);

  float* stat = smem_f;
  const float n = M ? (float)(hb * wb) : (float)count;
  const float* tb = totals + (size_t)b * n_parts * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int k = 0; k < n_parts; ++k) {
      s += __ldcg(tb + (size_t)k * 2 * c + ch);
      q += __ldcg(tb + (size_t)k * 2 * c + c + ch);
    }
    const float mean = s / n;
    const float var = fmaxf(q / n - mean * mean, 0.f);
    stat[ch] = mean;
    stat[c + ch] = 1.0f / sqrtf(var + eps);
  }
  __syncthreads();
  float m[N], rs[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    m[i] = stat[g * N + i];
    rs[i] = stat[c + g * N + i];
  }
  const float a = E == kPrelu ? __ldg(alpha) : 0.f;
  for (int j = top; j >= 0; j -= tiles) {
    const int p = j * chunk + r;
    if (j != top) load(p);
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      const int pk = p + k * rows;
      if (pk < hw) {
        float e[N], f[N];
        P::unpack(xv[k], e);
        if (E == kAdd) P::unpack(sv[k], f);
        const bool ok = (in >> k) & 1u;  // padding: 0 into the epilogue
#pragma unroll
        for (int i = 0; i < N; ++i) e[i] = ok ? (e[i] - m[i]) * rs[i] : 0.f;
        epilogue<T, E, N>(e, f, a);
        __stcs(reinterpret_cast<uint4*>(out + base + (size_t)pk * c),
               P::pack(e));
      }
    }
  }
}

// The two-launch form's block: rows * groups threads.
template <typename T>
int two_launch_threads(int c) {
  const int groups = c / Pack<T>::N;
  return (groups >= kThreads ? 1 : kThreads / groups) * groups;
}

// The statistics pass on `tiles` blocks a sample: partial[b][block][2c]
// (scratch), totals[b][2c], arrived[b] (zeroed here).
template <typename T, bool M>
int launch_stats(const T* x, const int* vh, const int* vw, float* partial,
                 float* totals, unsigned* arrived, int b, int hw, int w, int c,
                 int tiles, cudaStream_t s) {
  const int threads = two_launch_threads<T>(c);
  const int rows = threads / (c / Pack<T>::N);
  const size_t smem =
      ((size_t)2 * c * (rows + 1) + max(4 * threads, 2 * c)) * sizeof(float);
  auto kernel = in_stats_kernel<T, M>;
  cudaError_t err;
  if (smem > 40 * 1024) {  // the widest C: 48 KB with the static flag
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaMemsetAsync(arrived, 0, sizeof(unsigned) * b, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(tiles, b), threads, smem, s>>>(x, vh, vw, partial, totals,
                                               arrived, hw, w, c);
  return static_cast<int>(cudaGetLastError());
}

// The normalize pass on `tiles` blocks a sample, with a sample's n_parts
// rows of totals (over count pixels).
template <typename T, int E, bool M>
int launch_apply(const T* x, const T* skip, const float* alpha, const int* vh,
                 const int* vw, T* out, const float* totals, int b, int hw,
                 int w, int c, int tiles, int n_parts, int count, float eps,
                 cudaStream_t s) {
  in_apply_kernel<T, E, M>
      <<<dim3(tiles, b), two_launch_threads<T>(c), 2 * c * sizeof(float), s>>>(
          x, skip, totals, alpha, vh, vw, out, hw, w, c, n_parts, count, eps);
  return static_cast<int>(cudaGetLastError());
}

// scratch: partial [b][tiles][2c], then totals [b][2c], then arrived [b].
template <typename T, int E, bool M>
int launch_two(const T* x, const T* skip, const float* alpha, const int* vh,
               const int* vw, T* out, float* scratch, int b, int hw, int w,
               int c, int tiles, float eps, cudaStream_t s) {
  float* totals = scratch + (size_t)b * tiles * 2 * c;
  unsigned* arrived = reinterpret_cast<unsigned*>(totals + (size_t)b * 2 * c);
  const int err = launch_stats<T, M>(x, vh, vw, scratch, totals, arrived, b,
                                     hw, w, c, tiles, s);
  if (err != 0) return err;
  return launch_apply<T, E, M>(x, skip, alpha, vh, vw, out, totals, b, hw, w,
                               c, tiles, 1, hw, eps, s);
}

// grid > 0: the resident form with that many blocks, per_wave samples a
// wave and tiles of `tile` pixels; grid == 0: two launches of `tile` blocks
// a sample. M: the masked form (vh, vw: int [b] on the device; w: the
// frame's width).
template <typename T, int E, bool M>
int launch(const void* x, const void* skip, const void* alpha, const void* vh,
           const void* vw, void* out, void* partial, int b, int hw, int w,
           int c, int grid, int per_wave, int tile, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid > 0) {
    return launch_resident<T, E, M>(
        static_cast<const T*>(x), static_cast<const T*>(skip),
        static_cast<const float*>(alpha), static_cast<const int*>(vh),
        static_cast<const int*>(vw), static_cast<T*>(out),
        static_cast<unsigned long long*>(partial), b, hw, w, c, grid,
        per_wave, tile, eps, s);
  }
  return launch_two<T, E, M>(
      static_cast<const T*>(x), static_cast<const T*>(skip),
      static_cast<const float*>(alpha), static_cast<const int*>(vh),
      static_cast<const int*>(vw), static_cast<T*>(out),
      static_cast<float*>(partial), b, hw, w, c, tile, eps, s);
}

// scratch: partial [b][tiles][2c], then arrived [b].
template <typename T>
int stats(const void* x, void* totals, void* scratch, int b, int hw, int c,
          int tiles, void* stream) {
  float* partial = static_cast<float*>(scratch);
  return launch_stats<T, false>(
      static_cast<const T*>(x), nullptr, nullptr, partial,
      static_cast<float*>(totals),
      reinterpret_cast<unsigned*>(partial + (size_t)b * tiles * 2 * c), b, hw,
      0, c, tiles, static_cast<cudaStream_t>(stream));
}

template <typename T, int E>
int from_stats(const void* x, const void* other, const void* totals, void* out,
               int b, int hw, int c, int n_parts, int count, int tiles,
               float eps, void* stream) {
  const T* skip = E == kAdd ? static_cast<const T*>(other) : nullptr;
  const float* alpha = E == kPrelu ? static_cast<const float*>(other) : nullptr;
  return launch_apply<T, E, false>(
      static_cast<const T*>(x), skip, alpha, nullptr, nullptr,
      static_cast<T*>(out), static_cast<const float*>(totals), b, hw, 0, c,
      tiles, n_parts, count, eps, static_cast<cudaStream_t>(stream));
}

}  // namespace

// C entry points (bound with ctypes). Each returns the cudaError_t of its
// launches: 0 on success. grid > 0 takes the resident form (grid blocks,
// per_wave samples a wave, tiles of `tile` pixels); grid == 0 the two
// launches on `tile` blocks a sample. The _masked ones take each sample's
// valid height and width (int [b] on the device) and the frame's width w.
extern "C" int fsr_instance_norm_prelu_bf16(const void* x, const void* alpha,
                                            void* out, void* partial, int b,
                                            int hw, int c, int grid,
                                            int per_wave, int tile,
                                            float eps, void* stream) {
  return launch<__nv_bfloat16, kPrelu, false>(
      x, nullptr, alpha, nullptr, nullptr, out, partial, b, hw, 0, c, grid,
      per_wave, tile, eps, stream);
}

extern "C" int fsr_instance_norm_prelu_f32(const void* x, const void* alpha,
                                           void* out, void* partial, int b,
                                           int hw, int c, int grid,
                                           int per_wave, int tile,
                                           float eps, void* stream) {
  return launch<float, kPrelu, false>(x, nullptr, alpha, nullptr, nullptr,
                                      out, partial, b, hw, 0, c, grid,
                                      per_wave, tile, eps, stream);
}

extern "C" int fsr_instance_norm_add_bf16(const void* x, const void* skip,
                                          void* out, void* partial, int b,
                                          int hw, int c, int grid,
                                          int per_wave, int tile, float eps,
                                          void* stream) {
  return launch<__nv_bfloat16, kAdd, false>(
      x, skip, nullptr, nullptr, nullptr, out, partial, b, hw, 0, c, grid,
      per_wave, tile, eps, stream);
}

extern "C" int fsr_instance_norm_add_f32(const void* x, const void* skip,
                                         void* out, void* partial, int b,
                                         int hw, int c, int grid, int per_wave,
                                         int tile, float eps,
                                         void* stream) {
  return launch<float, kAdd, false>(x, skip, nullptr, nullptr, nullptr, out,
                                    partial, b, hw, 0, c, grid, per_wave,
                                    tile, eps, stream);
}

extern "C" int fsr_instance_norm_prelu_masked_bf16(
    const void* x, const void* alpha, const void* vh, const void* vw,
    void* out, void* partial, int b, int hw, int w, int c, int grid,
    int per_wave, int tile, float eps, void* stream) {
  return launch<__nv_bfloat16, kPrelu, true>(x, nullptr, alpha, vh, vw, out,
                                             partial, b, hw, w, c, grid,
                                             per_wave, tile, eps, stream);
}

extern "C" int fsr_instance_norm_prelu_masked_f32(
    const void* x, const void* alpha, const void* vh, const void* vw,
    void* out, void* partial, int b, int hw, int w, int c, int grid,
    int per_wave, int tile, float eps, void* stream) {
  return launch<float, kPrelu, true>(x, nullptr, alpha, vh, vw, out, partial,
                                     b, hw, w, c, grid, per_wave, tile, eps,
                                     stream);
}

extern "C" int fsr_instance_norm_add_masked_bf16(
    const void* x, const void* skip, const void* vh, const void* vw,
    void* out, void* partial, int b, int hw, int w, int c, int grid,
    int per_wave, int tile, float eps, void* stream) {
  return launch<__nv_bfloat16, kAdd, true>(x, skip, nullptr, vh, vw, out,
                                           partial, b, hw, w, c, grid,
                                           per_wave, tile, eps, stream);
}

extern "C" int fsr_instance_norm_add_masked_f32(
    const void* x, const void* skip, const void* vh, const void* vw,
    void* out, void* partial, int b, int hw, int w, int c, int grid,
    int per_wave, int tile, float eps, void* stream) {
  return launch<float, kAdd, true>(x, skip, nullptr, vh, vw, out, partial, b,
                                   hw, w, c, grid, per_wave, tile, eps,
                                   stream);
}

// The split form (a frame's width sharded across devices, its statistics
// summed over every shard's): the two passes as separate entry points.
// Both run on `tiles` blocks a sample. _stats writes totals [b][2c] (fp32
// sums and sums of squares of each sample of this shard) through scratch
// (partial [b][tiles][2c], then arrived [b]: tiles * 2c + 1 floats a
// sample); _from_stats normalizes x with the sum of n_parts rows of totals
// a sample (totals [b][n_parts][2c]: every shard's, in one order, so each
// shard computes the same statistics) over count pixels.
extern "C" int fsr_instance_norm_stats_bf16(const void* x, void* totals,
                                            void* scratch, int b, int hw,
                                            int c, int tiles, void* stream) {
  return stats<__nv_bfloat16>(x, totals, scratch, b, hw, c, tiles, stream);
}

extern "C" int fsr_instance_norm_stats_f32(const void* x, void* totals,
                                           void* scratch, int b, int hw, int c,
                                           int tiles, void* stream) {
  return stats<float>(x, totals, scratch, b, hw, c, tiles, stream);
}

extern "C" int fsr_instance_norm_prelu_from_stats_bf16(
    const void* x, const void* alpha, const void* totals, void* out, int b,
    int hw, int c, int n_parts, int count, int tiles, float eps,
    void* stream) {
  return from_stats<__nv_bfloat16, kPrelu>(x, alpha, totals, out, b, hw, c,
                                           n_parts, count, tiles, eps,
                                           stream);
}

extern "C" int fsr_instance_norm_prelu_from_stats_f32(
    const void* x, const void* alpha, const void* totals, void* out, int b,
    int hw, int c, int n_parts, int count, int tiles, float eps,
    void* stream) {
  return from_stats<float, kPrelu>(x, alpha, totals, out, b, hw, c, n_parts,
                                   count, tiles, eps, stream);
}

extern "C" int fsr_instance_norm_add_from_stats_bf16(
    const void* x, const void* skip, const void* totals, void* out, int b,
    int hw, int c, int n_parts, int count, int tiles, float eps,
    void* stream) {
  return from_stats<__nv_bfloat16, kAdd>(x, skip, totals, out, b, hw, c,
                                         n_parts, count, tiles, eps, stream);
}

extern "C" int fsr_instance_norm_add_from_stats_f32(
    const void* x, const void* skip, const void* totals, void* out, int b,
    int hw, int c, int n_parts, int count, int tiles, float eps,
    void* stream) {
  return from_stats<float, kAdd>(x, skip, totals, out, b, hw, c, n_parts,
                                 count, tiles, eps, stream);
}
