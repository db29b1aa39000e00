// RMSNorm over the last axis: y = cast(x * rsqrt(mean(x^2) + eps)) * w.
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm (_rmsnorm_kernel), the TPU
// kernel that fuses the fp32 round trip of the residual stream.
//
// Bound on this card: bytes.  Per row it reads D values of x once and writes
// D values once (w is 2*D bytes shared by every row and stays in L2); the
// arithmetic is ~3 flops per element, far below the ~295 flop/byte ridge.
//
// Design: one block per row (D = 2048 on the main path), 256 threads
// striding the row with neighbouring threads on neighbouring addresses so
// every load is coalesced.  The fp32 sum of squares is reduced with warp
// shuffles and one shared-memory hop across the 8 warps; the second pass
// re-reads the row, which is still in L1/L2.  Rounding follows the model
// path (repro/models/layers.py:41-45): normalize in fp32, cast to x's dtype,
// then multiply by the scale in that dtype -- the Pallas kernel multiplies
// in fp32 and casts once, which differs in bf16.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ float block_sum(float v) {
  __shared__ float partial[kThreads / 32];
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = lane < kThreads / 32 ? partial[lane] : 0.f;
  return warp_sum(v);  // every warp reduces the partials: all threads agree
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               int d, float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = block_sum(ss);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const T y = from_f32<T>(to_f32(xr[i]) * inv);
    orow[i] = from_f32<T>(to_f32(y) * to_f32(w[i]));
  }
}

}  // namespace

extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int rows, int d,
                              float eps, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    rmsnorm_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), d, eps);
  } else if (dtype == kBFloat16) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
