// MAX-pool backward with Caffe's first-max routing, for Hopper, sm_90a.
//
// Each pooling window's dy goes to the window's FIRST element equal to the
// window's max y, in row-major window order, ties included — the argmax
// Caffe's MaxPoolingLayer records in its forward scan, and the element XLA's
// select-and-scatter picks. A window whose y is NaN routes nowhere (no
// element equals it); an all -inf window routes to its first element.
// Windows are clipped to the real image: window (oh, ow) covers rows
// [oh*stride - pad, oh*stride - pad + kernel) ∩ [0, H) and the same for
// columns, so pad > 0 and Caffe's ceil-mode end windows need no padded copy
// of x.
//
// Replaces the Pallas TPU kernel sparknet_tpu/ops/pallas_pool.py:61
// `_bwd_kernel`, which walked every window of a block of input rows once
// with a running `won` mask and accumulated into a VMEM scratch, visiting
// the windows that straddle two blocks from both sides.
//
// Bound: HBM bytes — x, y and dy read once, dx written once; the search is
// at most kernel^2 comparisons per window, below the card's
// compute/bandwidth balance point. A plain gather (one thread per dx
// element, rescanning every covering window whose max it equals) re-derives
// each window's first max once per covering element and issues 2- and
// 4-byte loads. This design keeps the TPU kernel's "each window's first
// max is found once" on blocks that run unordered:
//   - a block owns a tile of dx — hb rows, wb columns, cb channels of one
//     image — and stages in shared memory, with 16-byte cp.async copies,
//     the x rows and columns that the windows touching the tile read (the
//     tile plus a halo; windows on a tile's edge are evaluated by both
//     neighbours, as the Pallas kernel does) and those windows' y and dy;
//   - phase 1: one thread per (window, channel vector) compares every
//     position of the window with y, last to first, without a branch on the
//     data (bf16 in pairs), and keeps the first match as a 1- or 2-byte
//     offset ki*kernel + kj (a sentinel when nothing equals y);
//   - phase 2: one thread per (dx element, channel vector) visits the
//     covering windows in ascending (oh, ow) order (unrolled where
//     kernel <= 2 * stride: at most 2 x 2 windows), tests four offsets per
//     SIMD compare, sums in f32 the dy of those that name it, rounds once
//     and writes dx once.
// Global loads and stores are 16 bytes wide where C * itemsize and the
// pointers allow it (C % 8 == 0 in bf16, C % 4 == 0 in f32); otherwise one
// element per thread (LeNet's C = 20 and 50 in bf16). Tile coordinates come
// from blockIdx and per-block tables of covering windows: no division per
// element. No atomics; the result is deterministic. The plain version
// (ops/pooling.py:maxpool_bwd_plain) sums in the same order, so the two
// agree bit for bit.
//
// The tile (hb, wb, cb) is chosen by the wrapper (ops/cuda_pool.py:plan)
// to fit shared memory. Staging is the rule. A geometry that no staged tile
// fits (at stride 1, windows wider than 94 in f32 or 129 in bf16; any
// window wider than 255) keeps nothing there: phase 2 searches each
// covering window itself in device memory, as a plain gather does.
//
// Layout: NHWC memory (the channels_last tensors the layers hold), x and dx
// (N, H, W, C), y and dy (N, OH, OW, C).
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise. The C entry point returns cudaGetLastError() after the launch
// so a refused launch is reported to the caller.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;

// One element of a packed word array as f32, and back.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ float get(const uint32_t* w, int i) {
    return __uint_as_float(w[i]);
  }
  static __device__ __forceinline__ void put(uint32_t* w, int i, float f) {
    w[i] = __float_as_uint(f);
  }
};
template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float get(const uint32_t* w, int i) {
    const uint32_t b = w[i >> 1];
    return __uint_as_float((i & 1) ? (b & 0xffff0000u) : (b << 16));
  }
  static __device__ __forceinline__ void put(uint32_t* w, int i, float f) {
    const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(f));
    w[i >> 1] = (i & 1) ? ((w[i >> 1] & 0xffffu) | (h << 16))
                        : ((w[i >> 1] & 0xffff0000u) | h);
  }
};

// V consecutive channels: one 16-byte vector, or one element when V == 1.
template <typename T, int V>
struct Vec {
  static_assert(V == 1 || V * sizeof(T) == 16, "16 bytes or one element");
  uint32_t w[(V * sizeof(T) + 3) / 4];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (V * sizeof(T) == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    } else if constexpr (sizeof(T) == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w[0] = *reinterpret_cast<const uint16_t*>(p);
    }
  }
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (V * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else {
      *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(w[0]);
    }
  }
  __device__ __forceinline__ float get(int i) const {
    return Elem<T>::get(w, i);
  }
  __device__ __forceinline__ void put(int i, float f) {
    Elem<T>::put(w, i, f);
  }
};

// V window offsets, loaded and stored as one aligned access.
template <typename Off, int V>
struct __align__(sizeof(Off) * V) Offs {
  Off o[V];
};

// Which of V window offsets equal `want`: 4 one-byte or 2 two-byte offsets
// per SIMD compare (0xff.. in each equal field).
template <typename Off, int V>
struct Match {
  static constexpr int kPer = 4 / sizeof(Off);  // offsets per 32-bit word
  static constexpr int kWords = V >= kPer ? V / kPer : 1;
  uint32_t m[kWords];
  __device__ __forceinline__ Match(const Offs<Off, V>& o, int want) {
    if constexpr (V < kPer) {
      m[0] = o.o[0] == want ? 0xffffffffu : 0u;
    } else {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(o.o);
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        m[i] = sizeof(Off) == 1 ? __vcmpeq4(w[i], want * 0x01010101u)
                                : __vcmpeq2(w[i], want * 0x00010001u);
    }
  }
  __device__ __forceinline__ bool any() const {
    uint32_t a = 0;
#pragma unroll
    for (int i = 0; i < kWords; ++i) a |= m[i];
    return a != 0;
  }
  __device__ __forceinline__ bool operator[](int v) const {
    if constexpr (V < kPer) return m[0] != 0;
    return (m[v / kPer] >> ((v % kPer) * 8 * sizeof(Off))) & 1u;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Flat index start + j * step over a grid of `cols` columns, kept as
// (row, col) without a division per step.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ __forceinline__ Walk(int start, int step, int cols_)
      : cols(cols_) {
    r = start / cols;
    c = start - r * cols;
    dr = step / cols;
    dc = step - dr * cols;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

struct Geo {
  int N, H, W, C, OH, OW, k, s, pad;
  int hb, wb, cb;        // the tile: dx rows, dx columns, channels
  int n_ht, n_wt, n_cg;  // tiles per image: row strips, column strips, groups
  int x_bytes, w_bytes;  // shared bytes kept for the x region, and for the
                         // y (and again the dy) of the windows
};

// The first position of the window whose rows [r0, r1) and columns [q0, q1)
// (clipped, in `base` coordinates; the unclipped origin is (hs, ws)) holds
// a value equal to y, per channel, as ki * k + kj; -1 where none does.
// kFull: every position is compared, last to first, without a branch on
// the data (shared memory); else the scan stops once every channel has
// found its first max (device memory, windows of any size).
template <typename T, int V, bool kFull>
__device__ __forceinline__ void first_max(const T* base, int row_stride,
                                          int col_stride, int r0, int r1,
                                          int q0, int q1, int hs, int ws,
                                          int k, const Vec<T, V>& yv,
                                          int (&off)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) off[v] = -1;
  if constexpr (kFull && sizeof(T) == 2 && V == 8) {
    // bf16 pairs: one compare and one bit-select per two channels; 16-bit
    // offsets, 0xffff where none matched yet
    uint32_t op[4] = {~0u, ~0u, ~0u, ~0u};
    for (int r = r1 - 1; r >= r0; --r) {
      for (int q = q1 - 1; q >= q0; --q) {
        Vec<T, V> xv;
        xv.load(base + r * row_stride + q * col_stride);
        const uint32_t pos2 =
            (uint32_t)((r - hs) * k + (q - ws)) * 0x00010001u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t m =
              __heq2_mask(*reinterpret_cast<const __nv_bfloat162*>(&xv.w[i]),
                          *reinterpret_cast<const __nv_bfloat162*>(&yv.w[i]));
          op[i] = (op[i] & ~m) | (pos2 & m);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int f = (op[v >> 1] >> (16 * (v & 1))) & 0xffff;
      off[v] = f == 0xffff ? -1 : f;
    }
    return;
  }
  if constexpr (kFull) {
    for (int r = r1 - 1; r >= r0; --r) {
      for (int q = q1 - 1; q >= q0; --q) {
        Vec<T, V> xv;
        xv.load(base + r * row_stride + q * col_stride);
        const int pos = (r - hs) * k + (q - ws);
#pragma unroll
        for (int v = 0; v < V; ++v)
          off[v] = xv.get(v) == yv.get(v) ? pos : off[v];
      }
    }
  } else {
    unsigned todo = (1u << V) - 1u;
    for (int r = r0; r < r1 && todo; ++r) {
      for (int q = q0; q < q1 && todo; ++q) {
        Vec<T, V> xv;
        xv.load(base + r * row_stride + q * col_stride);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (((todo >> v) & 1u) && xv.get(v) == yv.get(v)) {
            off[v] = (r - hs) * k + (q - ws);
            todo &= ~(1u << v);
          }
        }
      }
    }
  }
}

// Copy V channels from device to shared memory: cp.async for a vector.
template <typename T, int V>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  if constexpr (V * sizeof(T) == 16) {
    cp_async16(dst, src);
  } else {
    *dst = *src;
  }
}

// kStaged: x, y, dy and the window offsets in shared memory; else phase 2
// searches each covering window in device memory. KW > 0: at most KW
// windows cover an element along each axis (kernel <= KW * stride), so the
// covering-window loops unroll; 0: any geometry.
template <typename T, int V, typename Off, bool kStaged, int KW>
__global__ void __launch_bounds__(kThreads)
maxpool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   const T* __restrict__ dy, T* __restrict__ dx, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  // block -> (n, channel group, column strip, row strip); row strips vary
  // fastest, so the blocks sharing a halo row run close together in time
  int b = blockIdx.x;
  const int ht = b % g.n_ht;
  b /= g.n_ht;
  const int wt = b % g.n_wt;
  b /= g.n_wt;
  const int cg = b % g.n_cg;
  const int n = b / g.n_cg;
  const int h0 = ht * g.hb, nh = min(g.hb, g.H - h0);
  const int w0 = wt * g.wb, nw = min(g.wb, g.W - w0);
  const int lane = threadIdx.x * V;            // channel within the group
  const int cl = cg * g.cb + lane;             // this thread's channels
  const int ty = threadIdx.y, nty = blockDim.y;
  const int tid = ty * blockDim.x + threadIdx.x;

  // the windows covering each dx row and column of the tile
  int* row_lo = reinterpret_cast<int*>(smem);
  int* row_hi = row_lo + g.hb;
  int* col_lo = row_hi + g.hb;
  int* col_hi = col_lo + g.wb;
  for (int i = tid; i < nh + nw; i += kThreads) {
    const bool is_row = i < nh;
    const int p = is_row ? h0 + i : w0 + (i - nh);
    const int t = p + g.pad - g.k + 1;
    const int lo = t <= 0 ? 0 : (t + g.s - 1) / g.s;
    const int hi = min((p + g.pad) / g.s, (is_row ? g.OH : g.OW) - 1);
    if (is_row) {
      row_lo[i] = lo;
      row_hi[i] = hi;
    } else {
      col_lo[i - nh] = lo;
      col_hi[i - nh] = hi;
    }
  }
  __syncthreads();

  const T* xn = x + (size_t)n * g.H * g.W * g.C;
  const T* yn = y + (size_t)n * g.OH * g.OW * g.C;
  const T* dyn = dy + (size_t)n * g.OH * g.OW * g.C;
  // the windows touching the tile: [oh_a, oh_a + nwr) x [ow_a, ow_a + nwc)
  const int oh_a = row_lo[0], ow_a = col_lo[0];
  const int nwr = row_hi[nh - 1] - oh_a + 1;
  const int nwc = col_hi[nw - 1] - ow_a + 1;
  const size_t tables = ((size_t)8 * (g.hb + g.wb) + 15) & ~(size_t)15;
  T* sx = reinterpret_cast<T*>(smem + tables);
  T* sy = reinterpret_cast<T*>(smem + tables + g.x_bytes);
  T* sdy = reinterpret_cast<T*>(smem + tables + g.x_bytes + g.w_bytes);
  Off* soff = reinterpret_cast<Off*>(smem + tables + g.x_bytes +
                                     2 * g.w_bytes);
  constexpr Off kNone = static_cast<Off>(~Off(0));

  if constexpr (kStaged) {
    if (nwr > 0 && nwc > 0) {
      // the x rows and columns the windows read, their y and dy
      const int xr0 = max(oh_a * g.s - g.pad, 0);
      const int xr1 = min((oh_a + nwr - 1) * g.s - g.pad + g.k, g.H);
      const int xc0 = max(ow_a * g.s - g.pad, 0);
      const int xc1 = min((ow_a + nwc - 1) * g.s - g.pad + g.k, g.W);
      const int xcols = xc1 - xc0;
      for (Walk it(ty, nty, xcols); it.r < xr1 - xr0; it.next())
        stage<T, V>(sx + (it.r * xcols + it.c) * g.cb + lane,
                    xn + ((size_t)(xr0 + it.r) * g.W + xc0 + it.c) * g.C +
                        cl);
      for (Walk it(ty, nty, nwc); it.r < nwr; it.next()) {
        const int so = (it.r * nwc + it.c) * g.cb + lane;
        const size_t go =
            ((size_t)(oh_a + it.r) * g.OW + ow_a + it.c) * g.C + cl;
        stage<T, V>(sy + so, yn + go);
        stage<T, V>(sdy + so, dyn + go);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();

      // phase 1: each window's first max, once
      for (Walk it(ty, nty, nwc); it.r < nwr; it.next()) {
        const int hs = (oh_a + it.r) * g.s - g.pad;
        const int ws = (ow_a + it.c) * g.s - g.pad;
        const int so = (it.r * nwc + it.c) * g.cb + lane;
        Vec<T, V> yv;
        int off[V];
        yv.load(sy + so);
        first_max<T, V, true>(sx + lane, xcols * g.cb, g.cb,
                              max(hs, 0) - xr0, min(hs + g.k, g.H) - xr0,
                              max(ws, 0) - xc0, min(ws + g.k, g.W) - xc0,
                              hs - xr0, ws - xc0, g.k, yv, off);
        Offs<Off, V> o;
#pragma unroll
        for (int v = 0; v < V; ++v)
          o.o[v] = off[v] < 0 ? kNone : static_cast<Off>(off[v]);
        *reinterpret_cast<Offs<Off, V>*>(soff + so) = o;
      }
      __syncthreads();
    }
  }

  // phase 2: each dx element sums the dy of the windows it wins, in
  // ascending (oh, ow) order, and is written once
  for (Walk it(ty, nty, nw); it.r < nh; it.next()) {
    const int h = h0 + it.r, w = w0 + it.c;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    const int oh_lo = row_lo[it.r], nr = row_hi[it.r] - oh_lo + 1;
    const int ow_lo = col_lo[it.c], nc = col_hi[it.c] - ow_lo + 1;
    // the element's offset ki * k + kj in window (oh_lo, ow_lo)
    const int want0 =
        (h + g.pad - oh_lo * g.s) * g.k + (w + g.pad - ow_lo * g.s);
#pragma unroll
    for (int a = 0; a < (KW > 0 ? KW : nr); ++a) {
      if (KW > 0 && a >= nr) break;
      const int oh = oh_lo + a;
#pragma unroll
      for (int b = 0; b < (KW > 0 ? KW : nc); ++b) {
        if (KW > 0 && b >= nc) break;
        const int ow = ow_lo + b;
        const int want = want0 - (a * g.k + b) * g.s;
        const int so = ((oh - oh_a) * nwc + (ow - ow_a)) * g.cb + lane;
        const size_t go = ((size_t)oh * g.OW + ow) * g.C + cl;
        bool mine[V];
        bool any;
        if constexpr (kStaged) {
          const Match<Off, V> m(
              *reinterpret_cast<const Offs<Off, V>*>(soff + so), want);
          any = m.any();
#pragma unroll
          for (int v = 0; v < V; ++v) mine[v] = m[v];
        } else {
          const int hs = oh * g.s - g.pad, ws = ow * g.s - g.pad;
          Vec<T, V> yv;
          yv.load(yn + go);
          int off[V];
          first_max<T, V, false>(xn + cl, g.W * g.C, g.C, max(hs, 0),
                                 min(hs + g.k, g.H), max(ws, 0),
                                 min(ws + g.k, g.W), hs, ws, g.k, yv, off);
          any = false;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            mine[v] = off[v] == want;
            any |= mine[v];
          }
        }
        if (any) {
          Vec<T, V> d;
          if constexpr (kStaged) {
            d.load(sdy + so);
          } else {
            d.load(dyn + go);
          }
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (mine[v]) acc[v] = __fadd_rn(acc[v], d.get(v));
        }
      }
    }
    Vec<T, V> out = {};
#pragma unroll
    for (int v = 0; v < V; ++v) out.put(v, acc[v]);
    out.store(dx + ((size_t)n * g.H * g.W + (size_t)h * g.W + w) * g.C + cl);
  }
}

size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// Windows touching `tile` consecutive rows (at most), and the input rows
// they read.
void extent(int tile, int n_in, int n_out, int k, int s, int* nwin,
            int* nrows) {
  *nwin = n_out < (tile + k - 2) / s + 1 ? n_out : (tile + k - 2) / s + 1;
  const int r = (*nwin - 1) * s + k;
  *nrows = r < n_in ? r : n_in;
}

template <typename T, int V, typename Off, bool kStaged, int KW = 0>
cudaError_t launch(const void* x, const void* y, const void* dy, void* dx,
                   const Geo& g, size_t smem, cudaStream_t stream) {
  auto kern = maxpool_bwd_kernel<T, V, Off, kStaged, KW>;
  static size_t opted = 48 * 1024;  // per instantiation
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  const int lanes = g.cb / V;
  const dim3 block(lanes, kThreads / lanes);
  const long long blocks = (long long)g.N * g.n_cg * g.n_wt * g.n_ht;
  kern<<<(unsigned)blocks, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(dy), static_cast<T*>(dx), g);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t dispatch_tile(const void* x, const void* y, const void* dy,
                          void* dx, const Geo& g, bool staged, size_t smem,
                          cudaStream_t s) {
  if (!staged) return launch<T, V, uint8_t, false>(x, y, dy, dx, g, smem, s);
  if (g.k * g.k >= 255)  // offsets take 2 bytes
    return launch<T, V, uint16_t, true>(x, y, dy, dx, g, smem, s);
  if (g.k <= 2 * g.s)  // CaffeNet's, cifar10_quick's and LeNet's pools
    return launch<T, V, uint8_t, true, 2>(x, y, dy, dx, g, smem, s);
  return launch<T, V, uint8_t, true>(x, y, dy, dx, g, smem, s);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* y, const void* dy, void* dx,
                     const Geo& g, bool vec, bool staged, size_t smem,
                     cudaStream_t s) {
  if (vec)
    return dispatch_tile<T, 16 / sizeof(T)>(x, y, dy, dx, g, staged, smem, s);
  return dispatch_tile<T, 1>(x, y, dy, dx, g, staged, smem, s);
}

// Shared memory a launch with this tile takes (ops/cuda_pool.py:smem_bytes
// computes the same): the covering-window tables; when staged, also the x
// region, the windows' y and dy, and one offset per (window, channel) of
// the windows touching the tile.
long long smem_bytes(int H, int W, int OH, int OW, int kernel, int stride,
                     int itemsize, int hb, int wb, int cb, bool staged) {
  size_t bytes = align16((size_t)8 * (hb + wb));
  if (!staged) return (long long)bytes;
  int nwr, xr, nwc, xc;
  extent(hb, H, OH, kernel, stride, &nwr, &xr);
  extent(wb, W, OW, kernel, stride, &nwc, &xc);
  const size_t windows = (size_t)nwr * nwc * cb;
  bytes += align16((size_t)xr * xc * cb * itemsize) +
           2 * align16(windows * itemsize);
  return (long long)(bytes + windows * (kernel * kernel >= 255 ? 2 : 1));
}

}  // namespace

extern "C" const char* maxpool_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. x and dx are contiguous NHWC
// (N, H, W, C); y and dy contiguous (N, OH, OW, C). The tile (hb rows, wb
// columns, cb channels), the 16-byte path (vec) and staging (1: x, y, dy
// and the window offsets in shared memory; 0: each covering window
// searched again per element) come from the wrapper's plan; anything the
// kernel cannot run returns cudaErrorInvalidValue without a launch.
extern "C" cudaError_t maxpool_bwd(const void* x, const void* y,
                                   const void* dy, void* dx, int N, int H,
                                   int W, int C, int OH, int OW, int kernel,
                                   int stride, int pad, int dtype, int hb,
                                   int wb, int cb, int vec, int staged,
                                   void* stream) {
  const long long total = (long long)N * H * W * C;
  if (total == 0) return cudaSuccess;
  if (total >= (1LL << 31) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int itemsize = dtype == 0 ? 4 : 2;
  const int v = vec ? 16 / itemsize : 1;
  const int lanes = cb / v;
  if (hb < 1 || wb < 1 || cb < 1 || cb % v != 0 || C % cb != 0 ||
      lanes > 32 || kThreads % lanes != 0 || (staged && kernel > 255))
    return cudaErrorInvalidValue;
  if (vec && ((reinterpret_cast<uintptr_t>(x) |
               reinterpret_cast<uintptr_t>(y) |
               reinterpret_cast<uintptr_t>(dy) |
               reinterpret_cast<uintptr_t>(dx)) & 15) != 0)
    return cudaErrorInvalidValue;
  const long long smem = smem_bytes(H, W, OH, OW, kernel, stride, itemsize,
                                    hb, wb, cb, staged != 0);
  if (smem > (long long)kMaxSmem) return cudaErrorInvalidValue;
  Geo g;
  g.N = N; g.H = H; g.W = W; g.C = C; g.OH = OH; g.OW = OW;
  g.k = kernel; g.s = stride; g.pad = pad;
  g.hb = hb; g.wb = wb; g.cb = cb;
  g.n_ht = (H + hb - 1) / hb;
  g.n_wt = (W + wb - 1) / wb;
  g.n_cg = C / cb;
  int nwr, xr, nwc, xc;
  extent(hb, H, OH, kernel, stride, &nwr, &xr);
  extent(wb, W, OW, kernel, stride, &nwc, &xc);
  g.x_bytes = staged ? (int)align16((size_t)xr * xc * cb * itemsize) : 0;
  g.w_bytes = staged ? (int)align16((size_t)nwr * nwc * cb * itemsize) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, y, dy, dx, g, vec, staged != 0, (size_t)smem,
                           s);
  return dispatch<__nv_bfloat16>(x, y, dy, dx, g, vec, staged != 0,
                                 (size_t)smem, s);
}
