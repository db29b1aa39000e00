// Dense decode attention: one query token per row against a contiguous KV
// cache, with per-row lengths.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention
// (_decode_kernel), the TPU kernel that streams the cache once per query
// head.  Here it serves the dense decode of the unbatched generate path.
//
// Bound on this card: bytes.  A step reads each row's live K and V once
// (2 * length * Nkv * H elements) for ~4 * length * Nq * H flops: about one
// flop per byte in bf16, two orders of magnitude under the ridge.
//
// Design: one block per (row, kv head) serves all g = Nq/Nkv query heads of
// that kv head, so each KV tile crosses the memory bus once (the Pallas
// grid re-reads it per query head).  A sequential loop over KV tiles of
// `block_k` positions replaces the Pallas grid's sequential axis; tiles at
// or past the row's length are never loaded.  The cache keeps the model's
// (B, Smax, Nkv, H) layout and is addressed through its strides.  With
// block_k equal to the paged kernel's block size, both decode kernels do the
// same arithmetic per row (decode_sweep in online_softmax.cuh).
#include "online_softmax.cuh"

namespace {

struct DenseTile {
  long long base;  // offset of (row, position 0, kv head)
  long long ss;    // stride between positions
  int bk;
  __device__ __forceinline__ long long operator()(int j, int t) const {
    return base + static_cast<long long>(j * bk + t) * ss;
  }
};

template <typename T>
__global__ void __launch_bounds__(kDecodeThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ lengths, T* __restrict__ out, int nq, int nkv, int h,
              int smax, long long sb, long long ss, long long sn, int bk, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y, g = nq / nkv;
  const int length = max(0, min(lengths[b], smax));
  const int ntiles = (length + bk - 1) / bk;
  const long long qo = (static_cast<long long>(b) * nq + kvh * g) * h;
  decode_sweep(smem, q + qo, k, v, out + qo, g, h, bk, length, ntiles, scale,
               DenseTile{b * sb + kvh * sn, ss, bk});
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
           int b, int nq, int nkv, int h, int smax, long long sb, long long ss,
           long long sn, int bk, float scale, cudaStream_t s) {
  const size_t bytes = sizeof(float) * decode_smem_floats(nq / nkv, h, bk);
  cudaError_t err = allow_shared_bytes(decode_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel<T><<<dim3(nkv, b), kDecodeThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(out), nq, nkv, h, smax, sb, ss, sn, bk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, int b, int nq,
                                       int nkv, int h, int smax, long long sb, long long ss,
                                       long long sn, int bk, float scale, int dtype,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == kFloat32)
    return launch<float>(q, k, v, len, out, b, nq, nkv, h, smax, sb, ss, sn, bk, scale, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, len, out, b, nq, nkv, h, smax, sb, ss, sn, bk,
                                 scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
