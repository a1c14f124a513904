// Across-channel LRN forward (Caffe semantics) for Hopper, sm_90a.
//
//   scale[r, c] = k + alpha_n * sum_{c' in [c-half, c+half] ∩ [0, C)} x[r, c']^2
//   y[r, c]     = x[r, c] * scale[r, c] ^ -beta
//
// Replaces both Pallas TPU forward kernels of sparknet_tpu/ops/pallas_lrn.py:
// the row kernel `_fwd_kernel` (line 51, which writes y and the scale its
// backward `_bwd_kernel` reads) and the N-minor kernel `_fwd_kernel3`
// (line 206, y only). The N-minor variant existed only to read the TPU's
// [H*W, C, N] tile layout without a relayout; here the activations are NCHW
// tensors in channels_last memory, so a contiguous (rows, C) view with C
// innermost serves every batch size through this one kernel. The scale is
// written only when the caller passes a scale buffer (the training route
// that saves it); with a null pointer y is computed exactly as before.
//
// Bound: HBM bytes. Each element is read once and written once (twice with
// the scale) and costs about local_size + 6 f32 operations, two orders of
// magnitude below the card's compute/bandwidth balance point. The design
// keeps the one read per element: one warp owns one row, loads it into
// shared memory as f32 (coalesced: lane i reads channel i, i+32, ...), and
// computes every channel's clipped window from shared memory, so no
// neighbour is fetched from device memory twice. Math is f32 for f32 and
// bf16 inputs; y and the scale have the input's dtype. Making it fast
// (vector loads, several rows per warp for small C) is later work.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise. The C entry point returns cudaGetLastError() after the launch
// so a refused launch is reported to the caller.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// scale^-beta, specialised as sparknet_tpu/ops/pallas_lrn.py:_pow_neg_beta:
// beta_mode 1 is beta = 0.75 (rsqrt * sqrt(rsqrt)), 2 is beta = 0.5.
__device__ __forceinline__ float pow_neg_beta(float s, int beta_mode,
                                              float beta) {
  if (beta_mode == 1) {
    const float r = rsqrtf(s);
    return __fmul_rn(r, sqrtf(r));
  }
  if (beta_mode == 2) return rsqrtf(s);
  return expf(-beta * logf(s));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
               T* __restrict__ scale_out, long long rows, int C, int half,
               float alpha_n, float k, float beta, int beta_mode) {
  extern __shared__ float smem[];  // [kWarpsPerBlock][C] f32 copies of x
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s = smem + (size_t)warp * C;
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  for (long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
       row < rows; row += stride) {
    const T* xr = x + row * C;
    T* yr = y + row * C;
    for (int c = lane; c < C; c += 32) s[c] = load_f32(xr + c);
    __syncwarp();
    for (int c = lane; c < C; c += 32) {
      const float v = s[c];
      // the summation order of the plain version (ops/lrn.py:window_sum):
      // centre, then +j and -j for j = 1..half; clipped terms are skipped.
      // The _rn intrinsics keep nvcc from contracting into FMAs, so every
      // product and sum rounds where the plain version's does.
      float acc = __fmul_rn(v, v);
      for (int j = 1; j <= half; ++j) {
        if (c + j < C) acc = __fadd_rn(acc, __fmul_rn(s[c + j], s[c + j]));
        if (c - j >= 0) acc = __fadd_rn(acc, __fmul_rn(s[c - j], s[c - j]));
      }
      const float scale = __fadd_rn(k, __fmul_rn(alpha_n, acc));
      store_f32(yr + c, __fmul_rn(v, pow_neg_beta(scale, beta_mode, beta)));
      if (scale_out != nullptr) store_f32(scale_out + row * C + c, scale);
    }
    __syncwarp();  // the row's reads of s finish before the next row's writes
  }
}

template <typename T>
void launch(const void* x, void* y, void* scale, long long rows, int C,
            int half, float alpha_n, float k, float beta, int beta_mode,
            cudaStream_t stream) {
  long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  const size_t shmem = sizeof(float) * (size_t)kWarpsPerBlock * C;
  lrn_fwd_kernel<T><<<(unsigned)blocks, kThreads, shmem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<T*>(scale),
      rows, C, half, alpha_n, k, beta, beta_mode);
}

}  // namespace

extern "C" const char* lrn_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The widest row the kernel stages in 48 KB of shared memory.
extern "C" int lrn_fwd_max_channels() {
  return (48 * 1024) / (int)(sizeof(float) * kWarpsPerBlock);
}

// dtype: 0 = float32, 1 = bfloat16. x, y and scale (when not null) are
// contiguous (rows, C) of that dtype.
extern "C" cudaError_t lrn_fwd(const void* x, void* y, void* scale,
                               long long rows, int C, int dtype, int half,
                               float alpha_n, float k, float beta,
                               int beta_mode, void* stream) {
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, y, scale, rows, C, half, alpha_n, k, beta, beta_mode, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, y, scale, rows, C, half, alpha_n, k, beta,
                          beta_mode, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
