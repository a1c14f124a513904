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
// that saves it); a null pointer selects a kernel that has no scale stores.
//
// Bound: HBM bytes. x is read once and y written once (and the scale, when
// asked); about local_size + 6 f32 operations per element, far below the
// card's compute/bandwidth balance point, but in bfloat16 a byte carries
// twice the elements, so the instruction count per element matters too.
// The design keeps every byte in registers between its load and its store:
//   - a block of 256 threads takes a tile of R whole rows, one contiguous
//     run of R * C elements: kGroups 16-byte groups per thread (8 KB of x
//     for kGroups 2), the groups of one load instruction side by side, so
//     every warp access is 512 contiguous bytes; R is chosen so that R * C
//     elements fill 16-byte groups where they can, and a block issues all
//     its loads before it computes;
//   - local_size 5 (every zoo net's) takes the window's halo, two channels
//     on each side of a thread's group, from the neighbouring lanes' loaded
//     words with warp shuffles; only lanes 0 and 31 read their outer halo
//     from memory, where the neighbouring warp loads it too (an L1/L2 hit,
//     not a second HBM read). No shared memory, no barrier;
//   - out-of-row neighbours add -0.0, the identity of a round-to-nearest
//     sum: where C is a multiple of the group (every CaffeNet LRN), only
//     the halo can leave the row, so it is masked once per group, not per
//     element;
//   - y (and the scale) leave with one 16-byte store per group;
//   - a group that is cut by the tile's end, or a tile whose x, y or scale
//     start is not 16-byte aligned (a sliced input), moves one element at a
//     time instead; the arithmetic is the same;
//   - any other odd local_size reads its neighbours from memory in the
//     same kernel (HALF == 0).
// Math is f32 for f32 and bf16 inputs; y and the scale have x's dtype.
//
// Bit parity with the plain version (ops/lrn.py:lrn_plain and
// lrn_plain_with_scale): the window sum keeps its order (centre, then +j
// and -j), the _rn intrinsics keep nvcc from contracting products and sums
// into FMAs, and scale^-beta keeps the plain version's three cases, so
// every operation rounds where the plain version's does.
//
// Occupancy: kGroups = 2 16-byte groups of x per thread and tile, and at
// least 8 blocks an SM with the window in registers (a cap of 32
// registers a thread: a full SM of 2048 threads and two 16-byte loads
// each in flight; under that cap ptxas reports 16 bytes of spill stores
// on the bf16 y-only path and 36 with the scale, none on the f32 paths).
// One block takes one tile. Of the variants tried in design runs on an
// H100 80GB HBM3 at 700.00 W (1, 3 or 4 groups; 4 or 6 blocks; a
// persistent grid walking the tiles), none was faster on the b256 bf16
// training shape, and on the f32 shapes they came out about even (PERF.md,
// section 6).
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
constexpr int kGroups = 2;
// blocks an SM must hold with the window in registers
constexpr int kMinBlocks = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Tile {
  static constexpr int G = 16 / sizeof(T);  // elements in a 16-byte group
  static constexpr int kElems = kGroups * kThreads * G;  // at most, a tile
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Element i of a group held as four raw 32-bit words, as f32.
template <typename T>
__device__ __forceinline__ float elem(const uint32_t* w, int i) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[i]);
  } else {
    return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u)
                                   : (w[i >> 1] << 16));
  }
}

// The raw bits of one element, in the low bits of a word.
__device__ __forceinline__ uint32_t bits(const float* p) {
  return __float_as_uint(*p);
}
__device__ __forceinline__ uint32_t bits(const __nv_bfloat16* p) {
  return __bfloat16_as_ushort(*p);
}

// The group of x at elements p .. p + G of a tile of n elements at g, as
// raw words: one 16-byte load where the group is whole and g is aligned,
// else one element at a time (elements at or past n read as 0).
template <typename T>
__device__ __forceinline__ void load_group(const T* g, int p, int n,
                                           bool vec, uint32_t* w) {
  constexpr int G = Tile<T>::G;
  if (vec && p + G <= n) {
    const uint4 u = *reinterpret_cast<const uint4*>(g + p);
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = 0;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (p + i < n) {
        if constexpr (sizeof(T) == 4) {
          w[i] = bits(g + p + i);
        } else {
          w[i >> 1] |= bits(g + p + i) << (16 * (i & 1));
        }
      }
    }
  }
}

// G f32 values, rounded to T, to elements p .. p + G of a tile of n
// elements at g: one 16-byte store where the group is whole and g is
// aligned, else one element at a time.
template <typename T>
__device__ __forceinline__ void store_group(T* g, int p, int n, bool vec,
                                            const float* v) {
  constexpr int G = Tile<T>::G;
  if (vec && p + G <= n) {
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
    *reinterpret_cast<uint4*>(g + p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (p + i < n) from_f32(g + p + i, v[i]);
  }
}

// scale^-beta, specialised as sparknet_tpu/ops/pallas_lrn.py:_pow_neg_beta:
// beta_mode 1 is beta = 0.75 (rsqrt * sqrt(rsqrt)), 2 is beta = 0.5. The
// mode is uniform, so it is tested once per group.
template <int G>
__device__ __forceinline__ void pow_neg_beta(const float* s, float* out,
                                             int beta_mode, float beta) {
  if (beta_mode == 1) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float r = rsqrtf(s[i]);
      out[i] = __fmul_rn(r, sqrtf(r));
    }
  } else if (beta_mode == 2) {
#pragma unroll
    for (int i = 0; i < G; ++i) out[i] = rsqrtf(s[i]);
  } else {
#pragma unroll
    for (int i = 0; i < G; ++i) out[i] = expf(-beta * logf(s[i]));
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

// kScale: the scale is written too (a null `scale_out` selects the kernel
// without it). HALF: the window's half width held in registers, or 0 for
// any window read from memory (which keeps 64 registers a thread: under
// 32 it would spill).
template <typename T, int HALF, bool kScale>
__global__ void __launch_bounds__(kThreads,
                                  HALF > 0 ? kMinBlocks : 4)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
               T* __restrict__ scale_out, long long rows, int C, int R,
               int half, float alpha_n, float k, float beta, int beta_mode) {
  constexpr int G = Tile<T>::G;
  constexpr int H = HALF > 0 ? HALF : 0;
  // the halo of one side in raw words: H elements (H * sizeof(T) bytes)
  constexpr int kHW = H * (int)sizeof(T) / 4;
  static_assert(H * sizeof(T) % 4 == 0, "the halo is whole words");
  static_assert(H <= G, "the halo lies in the neighbouring group");
  const int lane = threadIdx.x & 31;
  // groups lie in one row: only the window's halo can leave it
  const bool in_row = C % G == 0;
  // tiles start at a row, so each group's offset and first channel are
  // the same in every tile
  int p[kGroups], c0[kGroups];
#pragma unroll
  for (int u = 0; u < kGroups; ++u) {
    p[u] = (u * kThreads + (int)threadIdx.x) * G;
    c0[u] = p[u] % C;
  }

  const long long tile = blockIdx.x;
  const long long t0 = tile * R * C;
  const int n = (int)(min((long long)R, rows - tile * R) * C);
  const T* xt = x + t0;
  const bool vx = aligned16(xt);

  // every load of the tile first: the groups, and the outer halo of the
  // warp's edge lanes (elements outside the tile read as 0: they lie
  // outside every row and are masked)
  uint32_t w[kGroups][4];
#pragma unroll
  for (int u = 0; u < kGroups; ++u) load_group(xt, p[u], n, vx, w[u]);
  float edge[kGroups][H > 0 ? H : 1];
  if constexpr (H > 0) {
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
#pragma unroll
      for (int d = 0; d < H; ++d) {
        // lane 0: elements p - H .. p - 1; lane 31: p + G .. p + G + H - 1
        const int q = lane == 0 ? p[u] - H + d : p[u] + G + d;
        edge[u][d] = (lane == 0 || lane == 31) && q >= 0 && q < n
                         ? to_f32(xt[q])
                         : 0.0f;
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kGroups; ++u) {
    // the x window of this group: H halo, G own, H halo
    float xv[G + 2 * H];
#pragma unroll
    for (int i = 0; i < G; ++i) xv[H + i] = elem<T>(w[u], i);
    if constexpr (H > 0) {
      uint32_t lw[kHW], rw[kHW];
#pragma unroll
      for (int j = 0; j < kHW; ++j) {
        lw[j] = __shfl_up_sync(kFull, w[u][4 - kHW + j], 1);
        rw[j] = __shfl_down_sync(kFull, w[u][j], 1);
      }
#pragma unroll
      for (int d = 0; d < H; ++d) {
        xv[d] = lane == 0 ? edge[u][d] : elem<T>(lw, d);
        xv[H + G + d] = lane == 31 ? edge[u][d] : elem<T>(rw, d);
      }
    }
    float sq[G + 2 * H];
#pragma unroll
    for (int i = 0; i < G + 2 * H; ++i) sq[i] = __fmul_rn(xv[i], xv[i]);
    if (H > 0 && in_row) mask_halo<G, H>(sq, c0[u], C);

    float s[G];
    auto scales = [&](auto checked) {
      int c = c0[u];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float acc = Window<HALF, decltype(checked)::value>::sum(
            c, C, half, [&](int d) {
              if constexpr (HALF > 0) {
                return sq[H + i + d];
              } else {
                if (d == 0) return sq[i];
                // an element at or past the tile's end (its result is
                // never stored) reads nothing: its row lies past the tensor
                if (p[u] + i >= n) return -0.0f;
                const float v = to_f32(xt[p[u] + i + d]);
                return __fmul_rn(v, v);
              }
            });
        s[i] = __fadd_rn(k, __fmul_rn(alpha_n, acc));
        c = c + 1 == C ? 0 : c + 1;
      }
    };
    if (HALF > 0 && in_row) {
      scales(std::false_type{});
    } else {
      scales(std::true_type{});
    }
    float out[G];
    pow_neg_beta<G>(s, out, beta_mode, beta);
#pragma unroll
    for (int i = 0; i < G; ++i) out[i] = __fmul_rn(xv[H + i], out[i]);
    T* yt = y + t0;
    store_group(yt, p[u], n, aligned16(yt), out);
    if constexpr (kScale) {
      T* st = scale_out + t0;
      store_group(st, p[u], n, aligned16(st), s);
    }
  }
}

template <typename T, int HALF, bool kScale>
cudaError_t launch(const void* x, void* y, void* scale, long long rows,
                   int C, int half, float alpha_n, float k, float beta,
                   int beta_mode, cudaStream_t stream) {
  constexpr int kElems = Tile<T>::kElems;
  // the most whole rows a tile holds; fewer (at most 7 fewer) where that
  // makes the tile a whole number of 16-byte groups, so every tile of an
  // aligned tensor starts aligned
  int R = kElems / C;
  for (int r = R; r >= 1 && r > R - 8; --r) {
    if ((long long)r * C * sizeof(T) % 16 == 0) {
      R = r;
      break;
    }
  }
  const long long n_tiles = (rows + R - 1) / R;
  // one block a tile: a grid holds at most 2^31 - 1 blocks
  if (n_tiles > INT32_MAX) return cudaErrorInvalidValue;
  lrn_fwd_kernel<T, HALF, kScale><<<(unsigned)n_tiles, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<T*>(scale),
      rows, C, R, half, alpha_n, k, beta, beta_mode);
  return cudaGetLastError();
}

// local_size 5 (every zoo net's) keeps the window in registers; any other
// odd size reads its neighbours from memory.
template <typename T>
cudaError_t dispatch(const void* x, void* y, void* scale, long long rows,
                     int C, int half, float alpha_n, float k, float beta,
                     int beta_mode, cudaStream_t s) {
  const bool with_scale = scale != nullptr;
  if (half == 2)
    return with_scale
               ? launch<T, 2, true>(x, y, scale, rows, C, half, alpha_n, k,
                                    beta, beta_mode, s)
               : launch<T, 2, false>(x, y, scale, rows, C, half, alpha_n, k,
                                     beta, beta_mode, s);
  return with_scale ? launch<T, 0, true>(x, y, scale, rows, C, half, alpha_n,
                                         k, beta, beta_mode, s)
                    : launch<T, 0, false>(x, y, scale, rows, C, half,
                                          alpha_n, k, beta, beta_mode, s);
}

}  // namespace

extern "C" const char* lrn_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The widest row a tile holds, in either dtype (a tile of f32).
extern "C" int lrn_fwd_max_channels() { return Tile<float>::kElems; }

// dtype: 0 = float32, 1 = bfloat16. x, y and scale (when not null) are
// contiguous (rows, C) of that dtype, at any element-aligned address.
extern "C" cudaError_t lrn_fwd(const void* x, void* y, void* scale,
                               long long rows, int C, int dtype, int half,
                               float alpha_n, float k, float beta,
                               int beta_mode, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (C < 1 || C > lrn_fwd_max_channels()) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, y, scale, rows, C, half, alpha_n, k, beta,
                           beta_mode, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, y, scale, rows, C, half, alpha_n, k,
                                   beta, beta_mode, s);
  return cudaErrorInvalidValue;
}
