// MAX-pool backward with Caffe's first-max routing, for Hopper, sm_90a.
//
// Each pooling window's dy goes to the window's FIRST element equal to the
// window's max y, in row-major window order, ties included — the argmax
// Caffe's MaxPoolingLayer records in its forward scan, and the element XLA's
// select-and-scatter picks. Windows are clipped to the real image: window
// (oh, ow) covers rows [oh*stride - pad, oh*stride - pad + kernel) ∩ [0, H)
// and the same for columns, so pad > 0 and Caffe's ceil-mode end windows
// need no padded copy of x.
//
// Replaces the Pallas TPU kernel sparknet_tpu/ops/pallas_pool.py:61
// `_bwd_kernel`, which walked every window of a block of input rows with a
// running `won` mask and accumulated into a VMEM scratch, visiting the
// windows that straddle two blocks from both sides. On Hopper blocks run in
// parallel with nothing carried between them, so the kernel is a gather
// instead: one thread owns one element of dx, visits the at most
// ceil(k/s)^2 windows that cover it in row-major window order, checks for
// each whether it is that window's first element equal to y (by scanning
// the window's earlier positions), and sums the dy of the windows it wins in
// f32, in that order. No atomics, no scratch, one write per element, and the
// result is deterministic; the plain version (ops/pooling.py:
// maxpool_bwd_plain) sums in the same order, so the two agree bit for bit.
//
// Layout: NHWC memory (the channels_last tensors the layers hold), x and dx
// (N, H, W, C), y and dy (N, OH, OW, C). Neighbouring threads own
// neighbouring channels, so every read of x, y and dy is coalesced.
//
// Bound: HBM bytes. x, y and dy are read once and dx is written once; the
// window scans re-read x from L1/L2, and each thread does at most
// ceil(k/s)^2 * k^2 comparisons, far below the card's compute/bandwidth
// balance point.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise. The C entry point returns cudaGetLastError() after the launch
// so a refused launch is reported to the caller.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   const T* __restrict__ dy, T* __restrict__ dx, int N,
                   int H, int W, int C, int OH, int OW, int kernel,
                   int stride, int pad) {
  // 32-bit index arithmetic (the wrapper keeps N*H*W*C below 2^31): a
  // 64-bit division is a long software sequence on the GPU
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= N * H * W * C) return;
  const int c = idx % C;
  int t = idx / C;
  const int w = t % W;
  t /= W;
  const int h = t % H;
  const int n = t / H;

  const T* xn = x + (size_t)n * H * W * C + c;     // x[n, :, :, c]
  const T* yn = y + (size_t)n * OH * OW * C + c;    // y[n, :, :, c]
  const T* dyn = dy + (size_t)n * OH * OW * C + c;  // dy[n, :, :, c]
  const float xv = load_f32(xn + (h * W + w) * C);

  // windows covering (h, w): oh*stride - pad <= h < oh*stride - pad + kernel
  const int th = h + pad - kernel + 1;
  const int oh_lo = th <= 0 ? 0 : (th + stride - 1) / stride;
  const int oh_hi = min((h + pad) / stride, OH - 1);
  const int tw = w + pad - kernel + 1;
  const int ow_lo = tw <= 0 ? 0 : (tw + stride - 1) / stride;
  const int ow_hi = min((w + pad) / stride, OW - 1);

  float acc = 0.0f;
  for (int oh = oh_lo; oh <= oh_hi; ++oh) {
    const int hs = max(oh * stride - pad, 0);
    for (int ow = ow_lo; ow <= ow_hi; ++ow) {
      const int yo = (oh * OW + ow) * C;
      const float yv = load_f32(yn + yo);
      if (xv != yv) continue;
      const int ws = max(ow * stride - pad, 0);
      const int we = min(ow * stride - pad + kernel, W);
      // is an earlier position of the window (row-major) equal to y?
      bool first = true;
      for (int i = hs; i <= h && first; ++i) {
        const int jend = (i < h) ? we : w;
        for (int j = ws; j < jend; ++j) {
          if (load_f32(xn + (i * W + j) * C) == yv) {
            first = false;
            break;
          }
        }
      }
      if (first) acc = __fadd_rn(acc, load_f32(dyn + yo));
    }
  }
  store_f32(dx + idx, acc);
}

template <typename T>
void launch(const void* x, const void* y, const void* dy, void* dx, int N,
            int H, int W, int C, int OH, int OW, int kernel, int stride,
            int pad, cudaStream_t stream) {
  const long long total = (long long)N * H * W * C;
  const long long blocks = (total + kThreads - 1) / kThreads;  // < 2^23
  maxpool_bwd_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(dy), static_cast<T*>(dx), N, H, W, C, OH, OW,
      kernel, stride, pad);
}

}  // namespace

extern "C" const char* maxpool_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. x and dx are contiguous NHWC
// (N, H, W, C); y and dy contiguous (N, OH, OW, C).
extern "C" cudaError_t maxpool_bwd(const void* x, const void* y,
                                   const void* dy, void* dx, int N, int H,
                                   int W, int C, int OH, int OW, int kernel,
                                   int stride, int pad, int dtype,
                                   void* stream) {
  const long long total = (long long)N * H * W * C;
  if (total == 0) return cudaSuccess;
  if (total >= (1LL << 31)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, y, dy, dx, N, H, W, C, OH, OW, kernel, stride, pad, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, y, dy, dx, N, H, W, C, OH, OW, kernel, stride,
                          pad, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
