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
// written once; about 2 * local_size + 12 f32 operations per element, below
// the card's compute/bandwidth balance point but close enough that the
// instruction count matters too. The design:
//   - a block takes a tile of R whole rows, one contiguous run of R * C
//     elements (4 KB of each input: one 16-byte group per thread), and a
//     persistent grid of four blocks per SM walks the tiles;
//   - each thread copies its group of x, dy (and the scale) into shared
//     memory with a 16-byte cp.async, double-buffered, so the next tile's
//     loads are in flight while the current one computes; a tile whose
//     start is not 16-byte aligned (a sliced input, or R * C * itemsize not
//     a multiple of 16) copies one element at a time instead;
//   - pass 1: each thread reads its group and the window's halo (half
//     channels on each side) into registers, squares x once per element,
//     and computes the scale (saved, or the window of x^2), scale^-beta and
//     ratio, ratio to shared memory; pass 2: the window sum of ratio from
//     its group and halo, and dx, stored with one 16-byte store. Every
//     thread is busy whatever C is;
//   - out-of-row neighbours add -0.0, the identity of a round-to-nearest
//     sum: where C is a multiple of the group (every CaffeNet LRN), only the
//     halo can leave the row, so it is masked once per group, not per
//     element;
//   - local_size 5 (every zoo net's) keeps the window in registers; any
//     other odd size reads it from shared memory (the same kernel,
//     HALF == 0).
// No neighbour is read from device memory twice. Math is f32 for f32 and
// bf16 inputs; dx has the input's dtype.
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

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kGroupBytes = 16;                     // one vector per thread
constexpr int kArrayBytes = kThreads * kGroupBytes;  // of each input, a tile
constexpr int kPad = 16;  // bytes around each staged array: window reads
                          // past a tile's ends stay inside the allocation

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
struct Tile {
  static constexpr int G = kGroupBytes / sizeof(T);  // elements per thread
  static constexpr int kElems = kThreads * G;        // at most, per tile
  static constexpr int kStride = kArrayBytes + 2 * kPad;
};

// G elements of a 16-byte aligned array as f32.
template <typename T>
__device__ __forceinline__ void load_group(const T* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      out[i] = __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u)
                                       : (w[i >> 1] << 16));
  }
}

// G f32 values, rounded to T, to a 16-byte aligned array.
template <typename T>
__device__ __forceinline__ void store_group(T* p, const float* v) {
  uint32_t w[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(
                  __float2bfloat16_rn(v[2 * i + 1]))
              << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Start copying this thread's group (elements p0 .. p0 + G) of a tile of
// n elements at g into the staged array d: one 16-byte cp.async where the
// group is whole and g is aligned, else one element at a time.
template <typename T>
__device__ __forceinline__ void stage_group(T* d, const T* g, int p0,
                                            int n) {
  constexpr int G = Tile<T>::G;
  if (p0 + G <= n && aligned16(g)) {
    cp_async16(d + p0, g + p0);
  } else {
    for (int i = p0; i < n && i < p0 + G; ++i) d[i] = g[i];
  }
}

// A window sum over one element's channel neighbours: the centre, then +d
// and -d for d = 1 .. half, the order of ops/lrn.py:window_sum. Neighbours
// outside the element's row add -0.0, the exact identity of a
// round-to-nearest sum, so every sum rounds as the plain version's clipped
// one does. HALF > 0: `get(d)` reads registers; kChecked false when the
// caller has already set the out-of-row registers to -0.0. HALF == 0: any
// window, read through `get` only where it lies in the row.
template <int HALF, bool kChecked>
struct Window {
  template <typename Get>
  static __device__ __forceinline__ float sum(int c, int C, int half,
                                              Get get) {
    float acc = get(0);
    if constexpr (HALF > 0) {
#pragma unroll
      for (int d = 1; d <= HALF; ++d) {
        acc = __fadd_rn(acc, !kChecked || c + d < C ? get(d) : -0.0f);
        acc = __fadd_rn(acc, !kChecked || c - d >= 0 ? get(-d) : -0.0f);
      }
    } else {
      for (int d = 1; d <= half; ++d) {
        if (c + d < C) acc = __fadd_rn(acc, get(d));
        if (c - d >= 0) acc = __fadd_rn(acc, get(-d));
      }
    }
    return acc;
  }
};

// Sets the registers of a group's window (offsets -H .. G + H) that lie
// outside the group's row to -0.0; the group lies in one row (C % G == 0)
// and starts at channel c0.
template <int G, int H>
__device__ __forceinline__ void mask_halo(float* v, int c0, int C) {
#pragma unroll
  for (int d = 1; d <= H; ++d) {
    if (c0 - d < 0) v[H - d] = -0.0f;
    if (c0 + G - 1 + d >= C) v[H + G - 1 + d] = -0.0f;
  }
}

// kSaved: the scale is read (a null `scale` recomputes it). Four blocks an
// SM (at most 64 registers a thread) keep enough tiles in flight.
template <typename T, int HALF, bool kSaved>
__global__ void __launch_bounds__(kThreads, 4)
lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               const T* __restrict__ scale, T* __restrict__ dx,
               long long rows, int C, int R, long long n_tiles, int half,
               float alpha_n, float k, float beta, int beta_mode,
               float coef) {
  using Tl = Tile<T>;
  constexpr int G = Tl::G;
  constexpr int H = HALF > 0 ? HALF : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool saved = kSaved;
  constexpr int n_in = saved ? 3 : 2;
  auto staged = [&](int buf, int a) {  // [2 stages][n_in arrays]
    return reinterpret_cast<T*>(smem + (buf * n_in + a) * Tl::kStride +
                                kPad);
  };
  float* ratio =
      reinterpret_cast<float*>(smem + 2 * n_in * Tl::kStride + kPad);
  const int p0 = threadIdx.x * G;  // this thread's group of every tile
  // tiles start at a row, so the group's first channel is fixed
  const int c0 = p0 % C;
  // groups lie in one row: only the window's halo can leave it
  const bool in_row = C % G == 0;

  auto issue = [&](long long tile, int buf) {
    const long long t0 = tile * R * C;
    const int n = (int)(min((long long)R, rows - tile * R) * C);
    stage_group(staged(buf, 0), x + t0, p0, n);
    stage_group(staged(buf, 1), dy + t0, p0, n);
    if constexpr (saved) stage_group(staged(buf, 2), scale + t0, p0, n);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  long long tile = blockIdx.x;
  if (tile < n_tiles) issue(tile, 0);
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < n_tiles) {
      issue(next, (it + 1) & 1);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);  // keeps the count
    }
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    const long long t0 = tile * R * C;
    const int n = (int)(min((long long)R, rows - tile * R) * C);
    const T* sx = staged(it & 1, 0);
    const T* sdy = staged(it & 1, 1);
    const T* ssc = saved ? staged(it & 1, 2) : nullptr;

    // pass 1: scale, scale^-beta and ratio (to shared memory); the x
    // window, x^2 and dy * scale^-beta stay in registers
    float xv[G + 2 * H], sq[G + 2 * H], g[G], sv[G], dyib[G], r[G];
    load_group(sx + p0, xv + H);
#pragma unroll
    for (int d = 1; d <= H; ++d) {
      xv[H - d] = to_f32(sx[p0 - d]);
      xv[H + G - 1 + d] = to_f32(sx[p0 + G - 1 + d]);
    }
#pragma unroll
    for (int i = 0; i < G + 2 * H; ++i) sq[i] = __fmul_rn(xv[i], xv[i]);
    if (in_row) mask_halo<G, H>(sq, c0, C);
    load_group(sdy + p0, g);
    if constexpr (saved) load_group(ssc + p0, sv);
    auto pass1 = [&](auto checked) {
      int c = c0;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        float s;
        if constexpr (saved) {
          s = sv[i];
        } else {
          // the forward's normalizer, in the forward's order
          const float acc = Window<HALF, decltype(checked)::value>::sum(
              c, C, half, [&](int d) {
                if constexpr (HALF > 0) {
                  return sq[H + i + d];
                } else {
                  const float u = to_f32(sx[p0 + i + d]);
                  return __fmul_rn(u, u);
                }
              });
          s = __fadd_rn(k, __fmul_rn(alpha_n, acc));
        }
        const float ib = pow_neg_beta(s, beta_mode, beta);
        const float t = __fmul_rn(__fmul_rn(g[i], xv[H + i]), ib);
        if constexpr (saved) {
          r[i] = __fdiv_rn(t, s);                  // _bwd_kernel: / scale
        } else {
          const float is = rsqrtf(s);              // _bwd_kernel3: * rsqrt^2
          r[i] = __fmul_rn(t, __fmul_rn(is, is));
        }
        dyib[i] = __fmul_rn(g[i], ib);
        c = c + 1 == C ? 0 : c + 1;
      }
    };
    if (in_row) {
      pass1(std::false_type{});
    } else {
      pass1(std::true_type{});
    }
#pragma unroll
    for (int i = 0; i < G; i += 4)
      *reinterpret_cast<float4*>(ratio + p0 + i) =
          make_float4(r[i], r[i + 1], r[i + 2], r[i + 3]);
    __syncthreads();

    // pass 2: the window sum of ratio, and dx
    float rv[G + 2 * H];
#pragma unroll
    for (int i = 0; i < G; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(ratio + p0 + i);
      rv[H + i] = q.x;
      rv[H + i + 1] = q.y;
      rv[H + i + 2] = q.z;
      rv[H + i + 3] = q.w;
    }
#pragma unroll
    for (int d = 1; d <= H; ++d) {
      rv[H - d] = ratio[p0 - d];
      rv[H + G - 1 + d] = ratio[p0 + G - 1 + d];
    }
    if (in_row) mask_halo<G, H>(rv, c0, C);
    float out[G];
    auto pass2 = [&](auto checked) {
      int c = c0;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float acc = Window<HALF, decltype(checked)::value>::sum(
            c, C, half, [&](int d) {
              if constexpr (HALF > 0) {
                return rv[H + i + d];
              } else {
                return ratio[p0 + i + d];
              }
            });
        out[i] = __fsub_rn(dyib[i],
                           __fmul_rn(__fmul_rn(coef, xv[H + i]), acc));
        c = c + 1 == C ? 0 : c + 1;
      }
    };
    if (in_row) {
      pass2(std::false_type{});
    } else {
      pass2(std::true_type{});
    }
    T* gd = dx + t0;
    if (p0 + G <= n && aligned16(gd)) {
      store_group(gd + p0, out);
    } else {
      for (int i = 0; i < G && p0 + i < n; ++i) from_f32(gd + p0 + i, out[i]);
    }
  }
}

template <typename T, int HALF, bool kSaved>
cudaError_t launch(const void* x, const void* dy, const void* scale,
                   void* dx, long long rows, int C, int half, float alpha_n,
                   float k, float beta, int beta_mode, float coef,
                   cudaStream_t stream) {
  using Tl = Tile<T>;
  const size_t smem = (size_t)Tl::kStride * 2 * (kSaved ? 3 : 2) +
                      sizeof(float) * Tl::kElems + 2 * kPad;
  auto kern = lrn_bwd_kernel<T, HALF, kSaved>;
  // once per kernel: the opt-in above 48 KB and the blocks one SM holds
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int R = Tl::kElems / C;
  const long long n_tiles = (rows + R - 1) / R;
  const long long grid = min(n_tiles, (long long)sms * per_sm);
  kern<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(scale), static_cast<T*>(dx), rows, C, R, n_tiles,
      half, alpha_n, k, beta, beta_mode, coef);
  return cudaGetLastError();
}

// local_size 5 (every zoo net's) keeps the window in registers; any other
// odd size reads it from shared memory.
template <typename T>
cudaError_t dispatch(const void* x, const void* dy, const void* scale,
                     void* dx, long long rows, int C, int half,
                     float alpha_n, float k, float beta, int beta_mode,
                     float coef, cudaStream_t s) {
  const bool saved = scale != nullptr;
  if (half == 2)
    return saved ? launch<T, 2, true>(x, dy, scale, dx, rows, C, half,
                                      alpha_n, k, beta, beta_mode, coef, s)
                 : launch<T, 2, false>(x, dy, scale, dx, rows, C, half,
                                       alpha_n, k, beta, beta_mode, coef, s);
  return saved ? launch<T, 0, true>(x, dy, scale, dx, rows, C, half, alpha_n,
                                    k, beta, beta_mode, coef, s)
               : launch<T, 0, false>(x, dy, scale, dx, rows, C, half,
                                     alpha_n, k, beta, beta_mode, coef, s);
}

}  // namespace

extern "C" const char* lrn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The widest row a tile holds, in either dtype (4 KB of f32).
extern "C" int lrn_bwd_max_channels() { return Tile<float>::kElems; }

// dtype: 0 = float32, 1 = bfloat16. x, dy, dx and scale (when not null) are
// contiguous (rows, C) of that dtype, at any element-aligned address. A null
// scale recomputes it from x.
extern "C" cudaError_t lrn_bwd(const void* x, const void* dy,
                               const void* scale, void* dx, long long rows,
                               int C, int dtype, int half, float alpha_n,
                               float k, float beta, int beta_mode,
                               float coef, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (C < 1 || C > lrn_bwd_max_channels()) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, dy, scale, dx, rows, C, half, alpha_n, k, beta,
                           beta_mode, coef, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dy, scale, dx, rows, C, half, alpha_n,
                                   k, beta, beta_mode, coef, s);
  return cudaErrorInvalidValue;
}
