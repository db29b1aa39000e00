// RMSNorm over the last axis: y = cast(x * rsqrt(mean(x^2) + eps)) * w.
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm (_rmsnorm_kernel), the TPU
// kernel that fuses the fp32 round trip of the residual stream.
//
// Bound on this card: bytes.  Per row it reads D values of x once and writes
// D values once (w is 2*D bytes shared by every row and stays in L2); the
// arithmetic is ~4 flops per element, far below the ~295 flop/byte ridge.
// At the decode shape (4 rows of 2048) the bytes take ~0.01 us, so what is
// left is latency: one load round trip, one reduction, one store.
//
// Design: one warp per row, several rows per block (prefill's 256 rows
// fill 64 blocks), no block barrier.  Three routes, chosen by the wrapper
// from the row width and alignment before the launch:
//   * registers (row_kernel<T, D>): the widths of the repo's configs (512,
//     the MLA latent; 1024; 1536; 2048; 3072, mamba2's gated norm; 3584) are
//     template parameters.  Each lane loads its share of the row once, in
//     16-byte vectors (8 bf16 or 4 fp32, D / 256 or D / 128 of them, all
//     issued before the first use), keeps it in registers, reduces the
//     fp32 sum of squares with warp shuffles, and writes the result from
//     the same registers: one trip to memory each way;
//   * vectors (vec_kernel<T>): any other width that is a whole number of
//     16-byte vectors loops over the row in vectors, and re-reads it (from
//     L1) for the second pass;
//   * scalar (scalar_kernel<T>): any other width, element by element.
// The backward (bwd_kernel, below) follows the same rounding.
//
// Rounding follows the model path (repro/models/layers.py:41-45): normalize
// in fp32, cast to x's dtype, then multiply by the scale in that dtype --
// the Pallas kernel multiplies in fp32 and casts once, which differs in
// bf16.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // rows per block
constexpr int kThreads = 32 * kWarps;

// 16 bytes of T, loaded and stored as one uint4
template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

template <typename T>
__device__ __forceinline__ Vec<T> load_vec(const T* p) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  Vec<T> a;
  memcpy(&a, &r, sizeof(r));
  return a;
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const Vec<T>& a) {
  uint4 r;
  memcpy(&r, &a, sizeof(r));
  *reinterpret_cast<uint4*>(p) = r;
}

template <typename T>
__device__ __forceinline__ float sum_squares(const Vec<T>& a) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < Vec<T>::kN; ++e) {
    const float f = to_f32(a.v[e]);
    s += f * f;
  }
  return s;
}

// out = cast(x * inv) * w, elementwise over one vector
template <typename T>
__device__ __forceinline__ Vec<T> normalize(const Vec<T>& a, const Vec<T>& w, float inv) {
  Vec<T> o;
#pragma unroll
  for (int e = 0; e < Vec<T>::kN; ++e)
    o.v[e] = from_f32<T>(to_f32(from_f32<T>(to_f32(a.v[e]) * inv)) * to_f32(w.v[e]));
  return o;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
row_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int rows,
           float eps) {
  constexpr int kVecs = D / (32 * Vec<T>::kN);  // vectors per lane
  static_assert(kVecs * 32 * Vec<T>::kN == D, "D must be a whole number of warp-wide vectors");
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  constexpr int kN = Vec<T>::kN;
  const T* xr = x + row * D;
  Vec<T> a[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) a[i] = load_vec(xr + (i * 32 + lane) * kN);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) ss += sum_squares(a[i]);
  const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(D) + eps);
  T* orow = out + row * D;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int off = (i * 32 + lane) * kN;
    store_vec(orow + off, normalize(a[i], load_vec(w + off), inv));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
vec_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int rows,
           int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  constexpr int kN = Vec<T>::kN;
  const T* xr = x + row * d;
  float ss = 0.f;
  for (int i = lane * kN; i < d; i += 32 * kN) ss += sum_squares(load_vec(xr + i));
  const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
  T* orow = out + row * d;
  for (int i = lane * kN; i < d; i += 32 * kN)
    store_vec(orow + i, normalize(load_vec(xr + i), load_vec(w + i), inv));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scalar_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int rows,
              int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
  for (int i = lane; i < d; i += 32)
    orow[i] = from_f32<T>(to_f32(from_f32<T>(to_f32(xr[i]) * inv)) * to_f32(w[i]));
}

// route codes shared with repro_torch/kernels/rmsnorm.py
enum Route : int { kScalar = 0, kVectors = 1, kRegisters = 2 };

template <typename T>
int launch(const void* xp, const void* wp, void* op, int rows, int d, float eps, int route,
           cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wp);
  T* out = static_cast<T*>(op);
  const int blocks = (rows + kWarps - 1) / kWarps;
  if (route == kRegisters) {
#define REPRO_RMSNORM_ROW(D)                                            \
  if (d == D) {                                                         \
    row_kernel<T, D><<<blocks, kThreads, 0, s>>>(x, w, out, rows, eps); \
    return static_cast<int>(cudaGetLastError());                        \
  }
    REPRO_RMSNORM_ROW(512)
    REPRO_RMSNORM_ROW(1024)
    REPRO_RMSNORM_ROW(1536)
    REPRO_RMSNORM_ROW(2048)
    REPRO_RMSNORM_ROW(3072)
    REPRO_RMSNORM_ROW(3584)
#undef REPRO_RMSNORM_ROW
    return static_cast<int>(cudaErrorInvalidValue);  // no instantiation for d
  }
  if (route == kVectors) {
    if (d % Vec<T>::kN) return static_cast<int>(cudaErrorInvalidValue);
    vec_kernel<T><<<blocks, kThreads, 0, s>>>(x, w, out, rows, d, eps);
  } else if (route == kScalar) {
    scalar_kernel<T><<<blocks, kThreads, 0, s>>>(x, w, out, rows, d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// backward: dx and dw
// ---------------------------------------------------------------------------
//
// With r = rsqrt(mean(x^2) + eps) in fp32, n = cast(x * r) and y = n * w,
// the gradient treats the cast as the identity (as autograd does):
//   dw = sum over rows of dy * n,
//   dx = r * (g - x * r^2 * mean(g * x)),  g = dy * w in fp32.
// Bound: bytes (x and dy read, dx written; ~10 flops an element).  One
// warp per row for dx, by the forward's three routes; each block takes a
// run of rows, and each warp adds dy * n of its rows into its own fp32 row
// of dw partial sums in shared memory (a lane owns its columns, so no two
// threads write one sum).  The block then writes the sum of its warps'
// rows to partial[block], and dw_reduce_kernel sums the blocks' rows in
// order: no float atomics, so every run gives the same bits.

// dx of one element and its dw term, from the row's r and mean(g * x)
template <typename T>
__device__ __forceinline__ float grad_x(float xv, float dyv, float wv, float r, float mgx,
                                        float* dw_term) {
  *dw_term = dyv * to_f32(from_f32<T>(xv * r));
  return r * (dyv * wv - xv * r * r * mgx);
}

// one row: D > 0 holds the row in registers (16-byte vectors, D a whole
// number of warp-wide vectors); D == 0 loops over 16-byte vectors of a
// runtime width d.
template <typename T, int D>
__device__ __forceinline__ void bwd_row_vec(const T* xr, const T* __restrict__ w, const T* dyr,
                                            T* dxr, float* acc, int d, float eps, int lane) {
  constexpr int kN = Vec<T>::kN;
  float ss = 0.f, gx = 0.f;
  if constexpr (D > 0) {
    constexpr int kVecs = D / (32 * kN);
    static_assert(kVecs * 32 * kN == D, "D must be a whole number of warp-wide vectors");
    Vec<T> a[kVecs], g[kVecs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      a[i] = load_vec(xr + (i * 32 + lane) * kN);
      g[i] = load_vec(dyr + (i * 32 + lane) * kN);
    }
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const Vec<T> wv = load_vec(w + (i * 32 + lane) * kN);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float xv = to_f32(a[i].v[e]);
        ss += xv * xv;
        gx += to_f32(g[i].v[e]) * to_f32(wv.v[e]) * xv;
      }
    }
    const float r = rsqrtf(warp_sum(ss) / static_cast<float>(D) + eps);
    const float mgx = warp_sum(gx) / static_cast<float>(D);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int off = (i * 32 + lane) * kN;
      const Vec<T> wv = load_vec(w + off);
      Vec<T> o;
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        float t;
        o.v[e] = from_f32<T>(grad_x<T>(to_f32(a[i].v[e]), to_f32(g[i].v[e]), to_f32(wv.v[e]),
                                       r, mgx, &t));
        acc[off + e] += t;
      }
      store_vec(dxr + off, o);
    }
  } else {
    for (int i = lane * kN; i < d; i += 32 * kN) {
      const Vec<T> a = load_vec(xr + i), g = load_vec(dyr + i), wv = load_vec(w + i);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float xv = to_f32(a.v[e]);
        ss += xv * xv;
        gx += to_f32(g.v[e]) * to_f32(wv.v[e]) * xv;
      }
    }
    const float r = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
    const float mgx = warp_sum(gx) / static_cast<float>(d);
    for (int i = lane * kN; i < d; i += 32 * kN) {
      const Vec<T> a = load_vec(xr + i), g = load_vec(dyr + i), wv = load_vec(w + i);
      Vec<T> o;
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        float t;
        o.v[e] = from_f32<T>(grad_x<T>(to_f32(a.v[e]), to_f32(g.v[e]), to_f32(wv.v[e]), r, mgx,
                                       &t));
        acc[i + e] += t;
      }
      store_vec(dxr + i, o);
    }
  }
}

template <typename T>
__device__ __forceinline__ void bwd_row_scalar(const T* xr, const T* __restrict__ w,
                                               const T* dyr, T* dxr, float* acc, int d,
                                               float eps, int lane) {
  float ss = 0.f, gx = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float xv = to_f32(xr[i]);
    ss += xv * xv;
    gx += to_f32(dyr[i]) * to_f32(w[i]) * xv;
  }
  const float r = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
  const float mgx = warp_sum(gx) / static_cast<float>(d);
  for (int i = lane; i < d; i += 32) {
    float t;
    dxr[i] = from_f32<T>(grad_x<T>(to_f32(xr[i]), to_f32(dyr[i]), to_f32(w[i]), r, mgx, &t));
    acc[i] += t;
  }
}

// D > 0: the register route at width D; D == 0: the vector loop; D < 0:
// the scalar loop.  Block b takes rows [b * per_block, (b+1) * per_block).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
           T* __restrict__ dx, float* __restrict__ partial, int rows, int d, int per_block,
           float eps) {
  extern __shared__ float sacc[];  // (kWarps, d): each warp's dw partial sums
  for (int i = threadIdx.x; i < kWarps * d; i += kThreads) sacc[i] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* acc = sacc + warp * d;
  const long long first = static_cast<long long>(blockIdx.x) * per_block;
  const long long end = min(static_cast<long long>(rows), first + per_block);
  for (long long row = first + warp; row < end; row += kWarps) {
    const T* xr = x + row * d;
    const T* dyr = dy + row * d;
    T* dxr = dx + row * d;
    if constexpr (D >= 0)
      bwd_row_vec<T, D>(xr, w, dyr, dxr, acc, d, eps, lane);
    else
      bwd_row_scalar<T>(xr, w, dyr, dxr, acc, d, eps, lane);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += sacc[k * d + i];
    partial[static_cast<long long>(blockIdx.x) * d + i] = s;
  }
}

// dw[c] = sum over blocks of partial[block, c], in block order
template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dw, int blocks, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<long long>(b) * d + c];
  dw[c] = from_f32<T>(s);
}

template <typename T, int D>
int launch_bwd_kernel(const T* x, const T* w, const T* dy, T* dx, float* partial, int rows,
                      int d, int blocks, int per_block, float eps, cudaStream_t s) {
  const size_t bytes = sizeof(float) * kWarps * d;
  const cudaError_t err = allow_shared_bytes(bwd_kernel<T, D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_kernel<T, D><<<blocks, kThreads, bytes, s>>>(x, w, dy, dx, partial, rows, d, per_block,
                                                   eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* xp, const void* wp, const void* dyp, void* dxp, void* dwp,
               void* partialp, int rows, int d, int blocks, float eps, int route,
               cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wp);
  const T* dy = static_cast<const T*>(dyp);
  T* dx = static_cast<T*>(dxp);
  float* partial = static_cast<float*>(partialp);
  const int per_block = (rows + blocks - 1) / blocks;
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (route == kRegisters) {
#define REPRO_RMSNORM_BWD_ROW(D)                                                           \
  if (d == D)                                                                              \
    err = launch_bwd_kernel<T, D>(x, w, dy, dx, partial, rows, d, blocks, per_block, eps, s);
    REPRO_RMSNORM_BWD_ROW(512)
    REPRO_RMSNORM_BWD_ROW(1024)
    REPRO_RMSNORM_BWD_ROW(1536)
    REPRO_RMSNORM_BWD_ROW(2048)
    REPRO_RMSNORM_BWD_ROW(3072)
    REPRO_RMSNORM_BWD_ROW(3584)
#undef REPRO_RMSNORM_BWD_ROW
  } else if (route == kVectors) {
    if (d % Vec<T>::kN == 0)
      err = launch_bwd_kernel<T, 0>(x, w, dy, dx, partial, rows, d, blocks, per_block, eps, s);
  } else if (route == kScalar) {
    err = launch_bwd_kernel<T, -1>(x, w, dy, dx, partial, rows, d, blocks, per_block, eps, s);
  }
  if (err != 0) return err;
  dw_reduce_kernel<T><<<(d + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, static_cast<T*>(dwp), blocks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (rows, d) contiguous, w (d,); the vector and register routes need
// 16-byte aligned x, w and out (the wrapper checks).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int rows, int d,
                              float eps, int dtype, int route, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(x, w, out, rows, d, eps, route, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(x, w, out, rows, d, eps, route, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, dy, dx (rows, d) contiguous, w, dw (d,), partial fp32 (blocks, d)
// scratch, blocks >= 1; the routes as rmsnorm_launch's.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w, const void* dy, void* dx,
                                  void* dw, void* partial, int rows, int d, int blocks,
                                  float eps, int dtype, int route, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return launch_bwd<float>(x, w, dy, dx, dw, partial, rows, d, blocks, eps, route, s);
  if (dtype == kBFloat16)
    return launch_bwd<__nv_bfloat16>(x, w, dy, dx, dw, partial, rows, d, blocks, eps, route, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
