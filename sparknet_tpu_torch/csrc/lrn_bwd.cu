// Across-channel LRN backward (Caffe's LRNLayer gradient) for Hopper, sm_90a.
//
//   inv_beta = scale ^ -beta
//   ratio    = dy * x * inv_beta / scale
//   dx       = dy * inv_beta - (2 * alpha_n * beta) * x * window_sum(ratio)
//
// Replaces both Pallas TPU backward kernels of sparknet_tpu/ops/pallas_lrn.py:
// `_bwd_kernel` (line 62), which reads the scale the row forward saved, and
// `_bwd_kernel3` (line 216), which recomputes the scale from x and divides by
// it as rsqrt(scale)^2. One kernel serves both: a null `scale` pointer
// selects the recompute form. As in the forward, the activations are NCHW
// tensors in channels_last memory, so every input is a contiguous (rows, C)
// array with C innermost.
//
// Bound: HBM bytes. x and dy (and the saved scale) are read once and dx is
// written once; about 2 * local_size + 12 f32 operations per element, far
// below the card's compute/bandwidth balance point. The design keeps the one
// read per element: one warp owns one row and stages x and dy in shared
// memory as f32 (coalesced: lane i reads channel i, i+32, ...). The first
// pass computes each channel's scale (from the saved one, or from the window
// of x^2 in shared memory), scale^-beta and ratio, and keeps the last two in
// shared memory; the second pass sums each channel's clipped window of ratio
// from shared memory and writes dx. No neighbour is read from device memory
// twice. Math is f32 for f32 and bf16 inputs; dx has the input's dtype.
//
// Bit parity with the plain version (ops/lrn.py:lrn_bwd_plain): the window
// sums keep its order (centre, then +j and -j), and the _rn intrinsics keep
// nvcc from contracting products and sums into FMAs, so every operation
// rounds where the plain version's does.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise. The C entry point returns cudaGetLastError() after the launch
// so a refused launch is reported to the caller.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kArrays = 4;  // x, dy, inv_beta, ratio per warp

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
lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               const T* __restrict__ scale, T* __restrict__ dx,
               long long rows, int C, int half, float alpha_n, float k,
               float beta, int beta_mode, float coef) {
  extern __shared__ float smem[];  // [kWarpsPerBlock][kArrays][C]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sx = smem + (size_t)warp * kArrays * C;
  float* sdy = sx + C;
  float* sib = sdy + C;
  float* sr = sib + C;
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  for (long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
       row < rows; row += stride) {
    const long long base = row * C;
    for (int c = lane; c < C; c += 32) {
      sx[c] = load_f32(x + base + c);
      sdy[c] = load_f32(dy + base + c);
    }
    __syncwarp();
    for (int c = lane; c < C; c += 32) {
      const float v = sx[c];
      float s;
      if (scale != nullptr) {
        s = load_f32(scale + base + c);
      } else {
        // the forward's normalizer, in the forward's order
        float acc = __fmul_rn(v, v);
        for (int j = 1; j <= half; ++j) {
          if (c + j < C) acc = __fadd_rn(acc, __fmul_rn(sx[c + j], sx[c + j]));
          if (c - j >= 0) acc = __fadd_rn(acc, __fmul_rn(sx[c - j], sx[c - j]));
        }
        s = __fadd_rn(k, __fmul_rn(alpha_n, acc));
      }
      const float ib = pow_neg_beta(s, beta_mode, beta);
      const float t = __fmul_rn(__fmul_rn(sdy[c], v), ib);
      float r;
      if (scale != nullptr) {
        r = __fdiv_rn(t, s);                  // _bwd_kernel: / scale
      } else {
        const float is = rsqrtf(s);           // _bwd_kernel3: * rsqrt^2
        r = __fmul_rn(t, __fmul_rn(is, is));
      }
      sib[c] = ib;
      sr[c] = r;
    }
    __syncwarp();
    for (int c = lane; c < C; c += 32) {
      float acc = sr[c];
      for (int j = 1; j <= half; ++j) {
        if (c + j < C) acc = __fadd_rn(acc, sr[c + j]);
        if (c - j >= 0) acc = __fadd_rn(acc, sr[c - j]);
      }
      const float g = __fsub_rn(__fmul_rn(sdy[c], sib[c]),
                                __fmul_rn(__fmul_rn(coef, sx[c]), acc));
      store_f32(dx + base + c, g);
    }
    __syncwarp();  // the row's reads of shared memory finish first
  }
}

template <typename T>
void launch(const void* x, const void* dy, const void* scale, void* dx,
            long long rows, int C, int half, float alpha_n, float k,
            float beta, int beta_mode, float coef, cudaStream_t stream) {
  long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  const size_t shmem = sizeof(float) * (size_t)kWarpsPerBlock * kArrays * C;
  lrn_bwd_kernel<T><<<(unsigned)blocks, kThreads, shmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(scale), static_cast<T*>(dx), rows, C, half,
      alpha_n, k, beta, beta_mode, coef);
}

}  // namespace

extern "C" const char* lrn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The widest row the kernel stages in 48 KB of shared memory.
extern "C" int lrn_bwd_max_channels() {
  return (48 * 1024) / (int)(sizeof(float) * kWarpsPerBlock * kArrays);
}

// dtype: 0 = float32, 1 = bfloat16. x, dy, dx and scale (when not null) are
// contiguous (rows, C) of that dtype. A null scale recomputes it from x.
extern "C" cudaError_t lrn_bwd(const void* x, const void* dy,
                               const void* scale, void* dx, long long rows,
                               int C, int dtype, int half, float alpha_n,
                               float k, float beta, int beta_mode,
                               float coef, void* stream) {
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, dy, scale, dx, rows, C, half, alpha_n, k, beta,
                  beta_mode, coef, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, dy, scale, dx, rows, C, half, alpha_n, k, beta,
                          beta_mode, coef, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
