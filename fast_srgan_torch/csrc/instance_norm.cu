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
//   fit in shared memory (a sample too large for the SMs' shared memory).
//   The apply pass walks the tiles and samples in reverse of the statistics
//   pass, so the tiles read last, still in the 50 MB L2, are re-read first.
//
// Split form (the width-sharded forward, fast_srgan_torch/parallel/
// spatial.py): the two passes as their own entry points. It replaces
// `_dist_instance_norm` (fast_srgan_tpu/parallel/spatial.py), which XLA
// lowered on the TPU: per-shard fp32 sums and sums of squares, psum'd over
// the shards, count = H x the whole frame's width. Here each shard's
// statistics pass writes its tiles' partials; the caller gathers every
// shard's partials, in one order, to every shard; each shard's apply pass
// sums all of them (n_parts, not its own grid) over the global count. The
// sum runs in one fixed order for a given n_parts and C, so every shard
// normalizes with bitwise the same statistics. Bound: bytes, as above.
//
// Masked forms (M = true, the bucketed forward): x is a zero-padded frame of
// width W, and sample b's valid region is y < vh[b], x < vw[b]. They replace
// `instance_norm_masked_nhwc` (fast_srgan_tpu/ops/norm.py), which XLA
// lowered on the TPU:
//
//   sums over the valid pixels only; mean = sum(x) / (vh * vw), ex2 likewise
//   out = epilogue(y) at a valid pixel; PReLU: 0, add: skip at padding
//
// They read and write the same bytes as the unmasked forms at the padded
// shape (x at padded pixels is fetched with its tile and left out of the
// sums). The predicate is one per 16-byte vector (a vector is one pixel's
// channels): each thread finds its first pixel's (row, column) once and
// steps it by its pixel stride, with no division a vector. The resident
// form is latency-bound, so the predicate's instructions show in its time:
// each iteration reads its samples' valid sizes and builds both bit masks
// at its top, ahead of the stages that wait on them.
//
// The wrapper (fast_srgan_torch/kernels/instance_norm.py) chooses the form
// by shape, and guarantees: C % N == 0 with N = 16 / sizeof(T), C / N <=
// 256, contiguous channels_last x, skip and out aligned to 16 bytes, alpha
// a device fp32 scalar; for the two launches partial of B * (tiles a
// sample) * 2 * C floats; for the resident form gridDim.x = per_wave *
// (tiles a sample) <= the SMs, shared memory for min(waves, 3) tiles, and
// 8 * B * (tiles + 1) * 2 * C bytes of scratch for the tagged words.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // two-launch form
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
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = t;
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

// Mean and 1/sqrt(var + eps) of one sample from its n partials
// (partial[k][0, 2c)), summed in one fixed order, into stat[0, c) and
// stat[c, 2c). A thread sums one 16-byte quad of statistics over a strided
// share of the partials. red2 holds max(4 * blockDim.x, 2c) floats. Every
// thread of the block must call it.
__device__ void sample_stats(const float* partial, int n, int c, int count,
                             float eps, float* red2, float* stat) {
  const int c2 = 2 * c;
  const int quads = c2 / 4;
  const int parts = max(1, static_cast<int>(blockDim.x) / quads);
  for (int j = threadIdx.x; j < parts * quads; j += blockDim.x) {
    const float4* col = reinterpret_cast<const float4*>(partial) + j % quads;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int k = j / quads; k < n; k += parts) {
      const float4 v = __ldcg(col + (size_t)k * quads);
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    reinterpret_cast<float4*>(red2)[j] = a;  // red2[part][2c]
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int p = 0; p < parts; ++p) {
      s += red2[p * c2 + ch];
      q += red2[p * c2 + c + ch];
    }
    const float mean = s / (float)count;
    const float var = fmaxf(q / (float)count - mean * mean, 0.f);
    stat[ch] = mean;
    stat[c + ch] = 1.0f / sqrtf(var + eps);
  }
  __syncthreads();
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
  const int nbuf = min(waves, 3);
  const int p0 = min(tile * tile_px, hw);
  const int nvec = (min(p0 + tile_px, hw) - p0) * groups;  // 16-byte vectors
  const size_t tile_elems = (size_t)tile_px * c;
  // masked: bit k set where the thread's vector t + k * threads lies in
  // sample b's valid region (its pixel is p0 + t / groups + k * rows). The
  // walk's start is the same in every wave: found once.
  const PixelWalk walk0(M ? p0 + t / groups : 0, threads / groups, M ? width : 1);
  auto valid_bits = [&](int b) -> unsigned {
    if (!M) return ~0u;
    const int hb = __ldg(vh + b), wb = __ldg(vw + b);
    PixelWalk px = walk0;
    unsigned bits = 0u;
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (px.inside(hb, wb)) bits |= 1u << k;
      px.next();
    }
    return bits;
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

  auto copy_tile = [&](int w) {  // wave w's tile into its ring slot
    const int b = w * per_wave + slot;
    if (w >= waves || b >= batch) return;
    const T* from = x + ((size_t)b * hw + p0) * c;
    T* to = xbuf + (w % nbuf) * tile_elems;
    for (int v = t; v < nvec; v += threads) {
      cp_async16(to + (size_t)v * N, from + (size_t)v * N);
    }
  };

  const float a = E == kPrelu ? __ldg(alpha) : 0.f;
  copy_tile(0);
  cp_async_commit();
  copy_tile(1);
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
    // masked: the samples' valid sizes read once, ahead of the stages
    const unsigned ok_sums = sums_now ? valid_bits(b) : 0u;
    const unsigned ok_norm = norm_now ? valid_bits(b2) : 0u;
    const float count =
        (M && norm_now) ? (float)(__ldg(vh + b2) * __ldg(vw + b2)) : (float)hw;
    if (E == kAdd && norm_now) {
      const uint4* sk =
          reinterpret_cast<const uint4*>(skip + ((size_t)b2 * hw + p0) * c);
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        const int v = t + k * threads;
        if (v < nvec) skr[k] = __ldg(sk + v);
      }
    }

    // C1. wave w's partial sums
    if (sums_now) {
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
        if (v < nvec && ((ok_sums >> k) & 1u)) {
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
    }

    // C2. this block's share of wave w - 1's totals: statistic j of tile
    // j mod tiles, over every tile's partial (written an iteration ago)
    if (totals_now && warp < warps) {
      const unsigned long long* pb = part + (size_t)b1 * tiles * c2;
      for (int j = tile + warp * tiles; j < c2; j += warps * tiles) {
        const float v = warp_column_sum(pb + j, tiles, c2, lane);
        if (lane == 0) st_word(sums + (size_t)b1 * c2 + j, tagged(v));
      }
    }

    // A. normalize wave w - 2 (totals published an iteration ago)
    if (norm_now) {
      for (int j = t; j < c2; j += threads) {
        tot[j] = wait_word(sums + (size_t)b2 * c2 + j);
      }
      __syncthreads();
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
          const bool in = (ok_norm >> k) & 1u;  // padding: 0 into the epilogue
#pragma unroll
          for (int i = 0; i < N; ++i) e[i] = in ? (e[i] - m[i]) * rs[i] : 0.f;
          epilogue<T, E, N>(e, f, a);
          P::store(o + (size_t)v * N, e);
        }
      }
    }

    // R. wave w - 1's tile into registers; wave w + 2's into its slot
    if (totals_now) {
      const uint4* from =
          reinterpret_cast<const uint4*>(xbuf + ((w - 1) % nbuf) * tile_elems);
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        const int v = t + k * threads;
        if (v < nvec) held[k] = from[v];
      }
    }
    copy_tile(w + 2);
    cp_async_commit();
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
// Thread layout: thread t owns channel group t % groups (N channels) and
// walks the tile's pixels from t / groups with a stride of rows =
// blockDim.x / groups.

template <typename T, bool M>
__global__ void __launch_bounds__(kThreads)
    in_stats_kernel(const T* __restrict__ x, const int* __restrict__ vh,
                    const int* __restrict__ vw, float* __restrict__ partial,
                    int hw, int w, int c, int tile_px) {
  using P = Pack<T>;
  constexpr int N = P::N;
  extern __shared__ float smem_f[];  // red [2c][rows + 1], red2
  const int groups = c / N;
  const int rows = blockDim.x / groups;
  const int g = threadIdx.x % groups;
  const int r = threadIdx.x / groups;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int p_end = min((tile + 1) * tile_px, hw);

  const T* xb = x + (size_t)b * hw * c + g * N;
  float s[N], q[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = 0.f;
    q[i] = 0.f;
  }
  const int hb = M ? __ldg(vh + b) : 0, wb = M ? __ldg(vw + b) : 0;
  PixelWalk px(tile * tile_px + r, rows, M ? w : 1);  // w is 0 unmasked
  for (int p = tile * tile_px + r; p < p_end; p += rows, px.next()) {
    if (M && !px.inside(hb, wb)) continue;
    float v[N];
    P::load(xb + (size_t)p * c, v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s[i] += v[i];
      q[i] += v[i] * v[i];
    }
  }
  float* red = smem_f;
  float* red2 = red + 2 * c * (rows + 1);
  float* mine = partial + ((size_t)b * gridDim.x + tile) * 2 * c;
  block_sums<N>(s, q, red, red2, groups, c,
                [&](int j, float v) { mine[j] = v; });
}

// n_parts: the partials a sample has (partial[b][n_parts][2c]); count: the
// pixels they sum over (unmasked; the masked form counts vh[b] * vw[b]).
template <typename T, int E, bool M>
__global__ void __launch_bounds__(kThreads)
    in_apply_kernel(const T* __restrict__ x, const T* __restrict__ skip,
                    const float* __restrict__ partial,
                    const float* __restrict__ alpha,
                    const int* __restrict__ vh, const int* __restrict__ vw,
                    T* __restrict__ out, int hw, int w, int c, int tile_px,
                    int n_parts, int count, float eps) {
  using P = Pack<T>;
  constexpr int N = P::N;
  extern __shared__ float smem_f[];  // red2, then mean [c], 1/sqrt [c]
  const int groups = c / N;
  const int rows = blockDim.x / groups;
  const int g = threadIdx.x % groups;
  const int r = threadIdx.x / groups;
  const int n_tiles = gridDim.x;
  // reverse of the statistics pass: its last tiles are still in L2
  const int tile = n_tiles - 1 - blockIdx.x;
  const int b = gridDim.y - 1 - blockIdx.y;

  float* red2 = smem_f;
  float* stat = red2 + max(4 * static_cast<int>(blockDim.x), 2 * c);
  const int hb = M ? __ldg(vh + b) : 0, wb = M ? __ldg(vw + b) : 0;
  sample_stats(partial + (size_t)b * n_parts * 2 * c, n_parts, c,
               M ? hb * wb : count, eps, red2, stat);
  float m[N], rs[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    m[i] = stat[g * N + i];
    rs[i] = stat[c + g * N + i];
  }
  const float a = E == kPrelu ? __ldg(alpha) : 0.f;
  const size_t base = (size_t)b * hw * c + g * N;
  const int p_end = min((tile + 1) * tile_px, hw);
  PixelWalk px(tile * tile_px + r, rows, M ? w : 1);  // w is 0 unmasked
  for (int p = tile * tile_px + r; p < p_end; p += rows, px.next()) {
    float v[N], sk[N];
    P::load(x + base + (size_t)p * c, v);
    if (E == kAdd) {
      P::load(skip + base + (size_t)p * c, sk);
    }
    const bool in = !M || px.inside(hb, wb);  // padding: 0 into the epilogue
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = in ? (v[i] - m[i]) * rs[i] : 0.f;
    epilogue<T, E, N>(v, sk, a);
    P::store(out + base + (size_t)p * c, v);
  }
}

// The two-launch form's block: rows * groups threads.
template <typename T>
int two_launch_threads(int c) {
  const int groups = c / Pack<T>::N;
  return (groups >= kThreads ? 1 : kThreads / groups) * groups;
}

// The statistics pass: partial[b][tile][2c] over tiles of tile_px pixels.
template <typename T, bool M>
int launch_stats(const T* x, const int* vh, const int* vw, float* partial,
                 int b, int hw, int w, int c, int tile_px, cudaStream_t s) {
  const int threads = two_launch_threads<T>(c);
  const int rows = threads / (c / Pack<T>::N);
  const dim3 grid((hw + tile_px - 1) / tile_px, b);
  const size_t red2 = max(4 * threads, 2 * c);
  in_stats_kernel<T, M><<<grid, threads,
                          ((size_t)2 * c * (rows + 1) + red2) * sizeof(float),
                          s>>>(x, vh, vw, partial, hw, w, c, tile_px);
  return static_cast<int>(cudaGetLastError());
}

// The normalize pass over tiles of tile_px pixels, each block reducing a
// sample's n_parts partials (over count pixels) first.
template <typename T, int E, bool M>
int launch_apply(const T* x, const T* skip, const float* alpha, const int* vh,
                 const int* vw, T* out, const float* partial, int b, int hw,
                 int w, int c, int tile_px, int n_parts, int count, float eps,
                 cudaStream_t s) {
  const int threads = two_launch_threads<T>(c);
  const dim3 grid((hw + tile_px - 1) / tile_px, b);
  const size_t red2 = max(4 * threads, 2 * c);
  in_apply_kernel<T, E, M>
      <<<grid, threads, (red2 + 2 * c) * sizeof(float), s>>>(
          x, skip, partial, alpha, vh, vw, out, hw, w, c, tile_px, n_parts,
          count, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E, bool M>
int launch_two(const T* x, const T* skip, const float* alpha, const int* vh,
               const int* vw, T* out, float* partial, int b, int hw, int w,
               int c, int tile_px, float eps, cudaStream_t s) {
  const int err = launch_stats<T, M>(x, vh, vw, partial, b, hw, w, c, tile_px, s);
  if (err != 0) return err;
  return launch_apply<T, E, M>(x, skip, alpha, vh, vw, out, partial, b, hw, w,
                               c, tile_px, (hw + tile_px - 1) / tile_px, hw,
                               eps, s);
}

// grid > 0: the resident form with that many blocks; grid == 0: two launches.
// M: the masked form (vh, vw: int [b] on the device; w: the frame's width).
template <typename T, int E, bool M>
int launch(const void* x, const void* skip, const void* alpha, const void* vh,
           const void* vw, void* out, void* partial, int b, int hw, int w,
           int c, int grid, int per_wave, int tile_px, float eps,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid > 0) {
    return launch_resident<T, E, M>(
        static_cast<const T*>(x), static_cast<const T*>(skip),
        static_cast<const float*>(alpha), static_cast<const int*>(vh),
        static_cast<const int*>(vw), static_cast<T*>(out),
        static_cast<unsigned long long*>(partial), b, hw, w, c, grid,
        per_wave, tile_px, eps, s);
  }
  return launch_two<T, E, M>(
      static_cast<const T*>(x), static_cast<const T*>(skip),
      static_cast<const float*>(alpha), static_cast<const int*>(vh),
      static_cast<const int*>(vw), static_cast<T*>(out),
      static_cast<float*>(partial), b, hw, w, c, tile_px, eps, s);
}

template <typename T, int E>
int from_stats(const void* x, const void* other, const void* partial, void* out,
               int b, int hw, int c, int n_parts, int count, int tile_px,
               float eps, void* stream) {
  const T* skip = E == kAdd ? static_cast<const T*>(other) : nullptr;
  const float* alpha = E == kPrelu ? static_cast<const float*>(other) : nullptr;
  return launch_apply<T, E, false>(
      static_cast<const T*>(x), skip, alpha, nullptr, nullptr,
      static_cast<T*>(out), static_cast<const float*>(partial), b, hw, 0, c,
      tile_px, n_parts, count, eps, static_cast<cudaStream_t>(stream));
}

}  // namespace

// C entry points (bound with ctypes). Each returns the cudaError_t of its
// launches: 0 on success. grid > 0 takes the resident form (grid blocks,
// per_wave samples a wave, tiles of tile_px pixels); grid == 0 the two
// launches over tiles of tile_px pixels. The _masked ones take each sample's
// valid height and width (int [b] on the device) and the frame's width w.
extern "C" int fsr_instance_norm_prelu_bf16(const void* x, const void* alpha,
                                            void* out, void* partial, int b,
                                            int hw, int c, int grid,
                                            int per_wave, int tile_px,
                                            float eps, void* stream) {
  return launch<__nv_bfloat16, kPrelu, false>(
      x, nullptr, alpha, nullptr, nullptr, out, partial, b, hw, 0, c, grid,
      per_wave, tile_px, eps, stream);
}

extern "C" int fsr_instance_norm_prelu_f32(const void* x, const void* alpha,
                                           void* out, void* partial, int b,
                                           int hw, int c, int grid,
                                           int per_wave, int tile_px,
                                           float eps, void* stream) {
  return launch<float, kPrelu, false>(x, nullptr, alpha, nullptr, nullptr,
                                      out, partial, b, hw, 0, c, grid,
                                      per_wave, tile_px, eps, stream);
}

extern "C" int fsr_instance_norm_add_bf16(const void* x, const void* skip,
                                          void* out, void* partial, int b,
                                          int hw, int c, int grid,
                                          int per_wave, int tile_px, float eps,
                                          void* stream) {
  return launch<__nv_bfloat16, kAdd, false>(
      x, skip, nullptr, nullptr, nullptr, out, partial, b, hw, 0, c, grid,
      per_wave, tile_px, eps, stream);
}

extern "C" int fsr_instance_norm_add_f32(const void* x, const void* skip,
                                         void* out, void* partial, int b,
                                         int hw, int c, int grid, int per_wave,
                                         int tile_px, float eps,
                                         void* stream) {
  return launch<float, kAdd, false>(x, skip, nullptr, nullptr, nullptr, out,
                                    partial, b, hw, 0, c, grid, per_wave,
                                    tile_px, eps, stream);
}

extern "C" int fsr_instance_norm_prelu_masked_bf16(
    const void* x, const void* alpha, const void* vh, const void* vw,
    void* out, void* partial, int b, int hw, int w, int c, int grid,
    int per_wave, int tile_px, float eps, void* stream) {
  return launch<__nv_bfloat16, kPrelu, true>(x, nullptr, alpha, vh, vw, out,
                                             partial, b, hw, w, c, grid,
                                             per_wave, tile_px, eps, stream);
}

extern "C" int fsr_instance_norm_prelu_masked_f32(
    const void* x, const void* alpha, const void* vh, const void* vw,
    void* out, void* partial, int b, int hw, int w, int c, int grid,
    int per_wave, int tile_px, float eps, void* stream) {
  return launch<float, kPrelu, true>(x, nullptr, alpha, vh, vw, out, partial,
                                     b, hw, w, c, grid, per_wave, tile_px, eps,
                                     stream);
}

extern "C" int fsr_instance_norm_add_masked_bf16(
    const void* x, const void* skip, const void* vh, const void* vw,
    void* out, void* partial, int b, int hw, int w, int c, int grid,
    int per_wave, int tile_px, float eps, void* stream) {
  return launch<__nv_bfloat16, kAdd, true>(x, skip, nullptr, vh, vw, out,
                                           partial, b, hw, w, c, grid,
                                           per_wave, tile_px, eps, stream);
}

extern "C" int fsr_instance_norm_add_masked_f32(
    const void* x, const void* skip, const void* vh, const void* vw,
    void* out, void* partial, int b, int hw, int w, int c, int grid,
    int per_wave, int tile_px, float eps, void* stream) {
  return launch<float, kAdd, true>(x, skip, nullptr, vh, vw, out, partial, b,
                                   hw, w, c, grid, per_wave, tile_px, eps,
                                   stream);
}

// The split form (a frame's width sharded across devices, its statistics
// summed over every shard's partials): the two passes as separate entry
// points. _stats writes partial [b][ceil(hw / tile_px)][2c] (fp32 sums and
// sums of squares of each tile); _from_stats normalizes x with the sums of
// n_parts partials a sample (partial [b][n_parts][2c]: every shard's, in
// one order, so each shard computes the same statistics) over count pixels.
extern "C" int fsr_instance_norm_stats_bf16(const void* x, void* partial,
                                            int b, int hw, int c, int tile_px,
                                            void* stream) {
  return launch_stats<__nv_bfloat16, false>(
      static_cast<const __nv_bfloat16*>(x), nullptr, nullptr,
      static_cast<float*>(partial), b, hw, 0, c, tile_px,
      static_cast<cudaStream_t>(stream));
}

extern "C" int fsr_instance_norm_stats_f32(const void* x, void* partial, int b,
                                           int hw, int c, int tile_px,
                                           void* stream) {
  return launch_stats<float, false>(static_cast<const float*>(x), nullptr,
                                    nullptr, static_cast<float*>(partial), b,
                                    hw, 0, c, tile_px,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int fsr_instance_norm_prelu_from_stats_bf16(
    const void* x, const void* alpha, const void* partial, void* out, int b,
    int hw, int c, int n_parts, int count, int tile_px, float eps,
    void* stream) {
  return from_stats<__nv_bfloat16, kPrelu>(x, alpha, partial, out, b, hw, c,
                                           n_parts, count, tile_px, eps,
                                           stream);
}

extern "C" int fsr_instance_norm_prelu_from_stats_f32(
    const void* x, const void* alpha, const void* partial, void* out, int b,
    int hw, int c, int n_parts, int count, int tile_px, float eps,
    void* stream) {
  return from_stats<float, kPrelu>(x, alpha, partial, out, b, hw, c, n_parts,
                                   count, tile_px, eps, stream);
}

extern "C" int fsr_instance_norm_add_from_stats_bf16(
    const void* x, const void* skip, const void* partial, void* out, int b,
    int hw, int c, int n_parts, int count, int tile_px, float eps,
    void* stream) {
  return from_stats<__nv_bfloat16, kAdd>(x, skip, partial, out, b, hw, c,
                                         n_parts, count, tile_px, eps, stream);
}

extern "C" int fsr_instance_norm_add_from_stats_f32(
    const void* x, const void* skip, const void* partial, void* out, int b,
    int hw, int c, int n_parts, int count, int tile_px, float eps,
    void* stream) {
  return from_stats<float, kAdd>(x, skip, partial, out, b, hw, c, n_parts,
                                 count, tile_px, eps, stream);
}
