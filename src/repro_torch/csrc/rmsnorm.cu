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

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
