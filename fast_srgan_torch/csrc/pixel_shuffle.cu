// PixelShuffle(2) of a phase-major channels_last activation, for Hopper.
//
// Replaces the TPU kernel of fast_srgan_tpu/kernels/pixel_shuffle.py:
// `_make_dma_kernel` (two HBM->HBM row DMAs per input row, pipelined over a
// semaphore window, one grid step per sample). With the 4C channels in
// phase-major order ch' = (2i + j) * C + c, the shuffle is a pure copy:
//
//   out[b, 2h+i, 2w+j, 0:C] = x[b, h, w, (2i+j)*C : (2i+j+1)*C]
//
// on channels_last memory ([B, H, W, 4C] in, [B, 2H, 2W, C] out). It moves
// bytes and computes nothing, so it is bound by device-memory bandwidth: one
// read and one write of the tensor. The TPU needed whole-row DMAs with
// 128-lane-aligned halves; here every thread copies one 16-byte vector of the
// output, and neighbouring threads take neighbouring output addresses, so
// the stores are coalesced and each input channel block is read as one
// contiguous run. The copy is dtype-blind (C is given in bytes), so the
// result is bitwise equal to the plain permute + F.pixel_shuffle.
//
// The wrapper (fast_srgan_torch/kernels/pixel_shuffle.py) guarantees: x and
// out contiguous, 16-byte aligned, C in bytes a multiple of 16, and
// B * 4H * W * C bytes / 16 < 2^31 vectors.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    pixel_shuffle_phase_major_kernel(const uint4* __restrict__ x,
                                     uint4* __restrict__ out, int h, int w,
                                     int c_vec, long long n_vec) {
  for (long long v = blockIdx.x * (long long)kThreads + threadIdx.x; v < n_vec;
       v += (long long)gridDim.x * kThreads) {
    // output vector v = ((b * 2h + oh) * 2w + ow) * c_vec + cv
    const int cv = (int)(v % c_vec);
    long long pix = v / c_vec;
    const int ow = (int)(pix % (2 * w));
    pix /= 2 * w;
    const int oh = (int)(pix % (2 * h));
    const long long b = pix / (2 * h);
    const int phase = 2 * (oh & 1) + (ow & 1);
    const long long src =
        ((b * h + (oh >> 1)) * w + (ow >> 1)) * 4LL * c_vec + phase * c_vec + cv;
    out[v] = x[src];
  }
}

}  // namespace

// C entry point (bound with ctypes): x [B, H, W, 4C] phase-major, out
// [B, 2H, 2W, C], c_bytes = C * sizeof(element). Returns cudaGetLastError().
extern "C" int fsr_pixel_shuffle_phase_major(const void* x, void* out, int b,
                                             int h, int w, int c_bytes,
                                             void* stream) {
  const int c_vec = c_bytes / 16;
  const long long n_vec = (long long)b * 4 * h * w * c_vec;
  const long long blocks = (n_vec + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < 132LL * 64 ? blocks : 132LL * 64);
  pixel_shuffle_phase_major_kernel<<<grid, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), h, w, c_vec,
      n_vec);
  return static_cast<int>(cudaGetLastError());
}
