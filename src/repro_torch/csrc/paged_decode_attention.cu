// Paged decode attention: one query token per row against a KV block pool
// addressed through a block table (vLLM-style paging).
//
// Replaces: src/repro/kernels/paged_decode_attention.py,
// paged_decode_attention (_paged_kernel), where the block table rides as a
// scalar-prefetch operand of the Pallas grid.  Here it is the batched decode
// kernel of every layer on the serving engine's main path.
//
// Bound on this card: bytes.  A step reads each row's live blocks of K and V
// once; the arithmetic is ~1 flop per byte in bf16.
//
// Design: one block per (row, kv head) serves all g = Nq/Nkv query heads,
// so each pool block is read once (the Pallas grid re-reads it per query
// head).  The block walks its row of `tables` itself -- the gather is the
// addressing, nothing is materialized -- in a sequential loop over pool
// blocks that stops at the row's length (never past the table width), so the
// sweep cost tracks each row's true cache length.  The online-softmax
// arithmetic is decode_sweep in online_softmax.cuh, shared with the dense
// decode kernel.
#include "online_softmax.cuh"

namespace {

struct PagedTile {
  const int* table_row;  // this row's block table
  long long pb;          // pool stride between blocks
  long long pt;          // pool stride between positions in a block
  long long base;        // offset of the kv head
  __device__ __forceinline__ long long operator()(int j, int t) const {
    return static_cast<long long>(table_row[j]) * pb + t * pt + base;
  }
};

template <typename T>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out, int nq, int nkv,
                    int h, int bs, int w, long long pb, long long pt, long long pn,
                    float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y, g = nq / nkv;
  const int length = max(0, min(lengths[b], w * bs));
  const int ntiles = (length + bs - 1) / bs;
  const long long qo = (static_cast<long long>(b) * nq + kvh * g) * h;
  decode_sweep(smem, q + qo, k_pool, v_pool, out + qo, g, h, bs, length, ntiles, scale,
               PagedTile{tables + static_cast<long long>(b) * w, pb, pt, kvh * pn});
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* lengths, void* out, int b, int nq, int nkv, int h, int bs, int w,
           long long pb, long long pt, long long pn, float scale, cudaStream_t s) {
  const size_t bytes = sizeof(float) * decode_smem_floats(nq / nkv, h, bs);
  cudaError_t err = allow_shared_bytes(paged_decode_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_kernel<T><<<dim3(nkv, b), kDecodeThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), tables,
      lengths, static_cast<T*>(out), nq, nkv, h, bs, w, pb, pt, pn, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_decode_attention_launch(const void* q, const void* k_pool,
                                             const void* v_pool, const void* tables,
                                             const void* lengths, void* out, int b, int nq,
                                             int nkv, int h, int bs, int w, long long pb,
                                             long long pt, long long pn, float scale,
                                             int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == kFloat32)
    return launch<float>(q, k_pool, v_pool, tab, len, out, b, nq, nkv, h, bs, w, pb, pt, pn,
                         scale, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tab, len, out, b, nq, nkv, h, bs, w, pb,
                                 pt, pn, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
