// Absorbed MLA paged decode attention: one query token per (row, head)
// against latent block pools addressed through a block table.
//
// Replaces: src/repro/kernels/paged_decode_attention.py,
// paged_mla_decode_attention (_paged_mla_kernel), whose Pallas grid
// (B, Nq, W) re-reads every latent block once per query head.  Here it is
// the attention kernel of every MLA decode step, batched (block pools) and
// unbatched (the dense cache viewed as a block pool with an identity
// table).
//
// What it computes: per position the key is concat(c_kv (R), k_rope (PR))
// and the value is c_kv itself; the query is concat(q_lat, q_rope).  It
// returns the latent output o_lat (B, Nq, R); the caller applies w_uv.
//
// Bound on this card: bytes.  A step reads each row's live positions of
// the pools once, (R + PR) elements each, and does 2 * Nq * (2R + PR)
// flops per position: ~30 flops per bf16 byte at Nq = 16, below the ridge.
//
// Design: the pools have no head axis, so one thread block serves a group
// of `g` heads of one row (a launch parameter; the model uses all Nq) and
// reads each tile from device memory once for the whole group.  The tile
// is staged as two shared arrays, ckv (BS, R) and krope (BS, PR): a score
// is q_lat . ckv + q_rope . krope, and the ckv array is then the value tile
// with row stride R, so the online-softmax device functions of
// online_softmax.cuh run unchanged.  The block walks its row of `tables`
// itself and stops at the row's length (never past the table width), so
// the sweep cost tracks each row's true cache length and lanes past the
// live blocks are never read.  Every head's arithmetic is independent of
// `g` (one warp per score, one row per softmax update, one thread per
// accumulator element), so the group size changes no bit of the output.
// At R 512, PR 64, g 16 and BS 16 the block holds ~108 KB of shared
// memory (the dynamic-smem opt-in); at 4 rows the grid is 4 blocks, so the
// kernel is latency-bound: splitting the KV sweep is later work.
#include "online_softmax.cuh"

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline int mla_smem_floats(int g, int r, int pr, int bs) {
  return g * (r + pr) + bs * (r + pr) + g * bs + softmax_state_floats(g, r);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_mla_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                 const T* __restrict__ ckv, const T* __restrict__ krope,
                 const int* __restrict__ tables, const int* __restrict__ lengths,
                 T* __restrict__ out, int nq, int g, int r, int pr, int bs, int w,
                 long long cb, long long ct, long long kb, long long kt, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, h0 = blockIdx.x * g;
  const int length = max(0, min(lengths[b], w * bs));
  const int ntiles = (length + bs - 1) / bs;
  float* sql = smem;           // (g, r)   latent queries
  float* sqr = sql + g * r;    // (g, pr)  rope queries
  float* sc = sqr + g * pr;    // (bs, r)  c_kv tile: key part and value
  float* skr = sc + bs * r;    // (bs, pr) k_rope tile
  float* ss = skr + bs * pr;   // (g, bs)  scores, then probabilities
  SoftmaxState st;
  carve_softmax_state(ss + g * bs, g, r, &st);

  const long long row0 = static_cast<long long>(b) * nq + h0;  // first head's row
  for (int i = threadIdx.x; i < g * r; i += blockDim.x) sql[i] = to_f32(q_lat[row0 * r + i]);
  for (int i = threadIdx.x; i < g * pr; i += blockDim.x) sqr[i] = to_f32(q_rope[row0 * pr + i]);
  online_softmax_init(st, g, r);
  __syncthreads();

  const int* table = tables + static_cast<long long>(b) * w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int j = 0; j < ntiles; ++j) {
    const int col0 = j * bs;
    const long long blk = table[j];
    // positions at or past the length load as 0 (their scores are masked;
    // a zero value keeps 0 * garbage out of the accumulator)
    for (int i = threadIdx.x; i < bs * r; i += blockDim.x) {
      const int t = i / r, d = i - t * r;
      sc[i] = col0 + t < length ? to_f32(ckv[blk * cb + t * ct + d]) : 0.f;
    }
    for (int i = threadIdx.x; i < bs * pr; i += blockDim.x) {
      const int t = i / pr, d = i - t * pr;
      skr[i] = col0 + t < length ? to_f32(krope[blk * kb + t * kt + d]) : 0.f;
    }
    __syncthreads();
    // one warp per (head, position): lanes split the latent and rope dims
    for (int p = warp; p < g * bs; p += nwarps) {
      const int gi = p / bs, t = p - gi * bs;
      float a = 0.f;
      for (int d = lane; d < r; d += 32) a += sql[gi * r + d] * sc[t * r + d];
      for (int d = lane; d < pr; d += 32) a += sqr[gi * pr + d] * skr[t * pr + d];
      a = warp_sum(a);
      if (lane == 0) ss[p] = col0 + t < length ? a * scale : kNegInf;
    }
    __syncthreads();
    online_softmax_block(st, ss, sc, g, bs, r);
  }
  for (int i = threadIdx.x; i < g * r; i += blockDim.x)
    out[row0 * r + i] = from_f32<T>(online_softmax_finalize(st, i, r));
}

template <typename T>
int launch(const void* q_lat, const void* q_rope, const void* ckv, const void* krope,
           const int* tables, const int* lengths, void* out, int b, int nq, int g, int r,
           int pr, int bs, int w, long long cb, long long ct, long long kb, long long kt,
           float scale, cudaStream_t s) {
  const size_t bytes = sizeof(float) * mla_smem_floats(g, r, pr, bs);
  cudaError_t err = allow_shared_bytes(paged_mla_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_mla_kernel<T><<<dim3(nq / g, b), kThreads, bytes, s>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope), static_cast<const T*>(ckv),
      static_cast<const T*>(krope), tables, lengths, static_cast<T*>(out), nq, g, r, pr, bs, w,
      cb, ct, kb, kt, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_lat (B, Nq, R) and q_rope (B, Nq, PR) contiguous; pools ckv (NB, BS, R)
// and k_rope (NB, BS, PR) given by their block and position strides (the
// last axis unit-stride); tables (B, W) and lengths (B,) int32; out
// (B, Nq, R) contiguous.  g heads per thread block, g dividing Nq.
extern "C" int paged_mla_decode_attention_launch(
    const void* q_lat, const void* q_rope, const void* ckv_pool, const void* krope_pool,
    const void* tables, const void* lengths, void* out, int b, int nq, int g, int r, int pr,
    int bs, int w, long long cb, long long ct, long long kb, long long kt, float scale,
    int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  if (g < 1 || nq % g) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return launch<float>(q_lat, q_rope, ckv_pool, krope_pool, tab, len, out, b, nq, g, r, pr,
                         bs, w, cb, ct, kb, kt, scale, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q_lat, q_rope, ckv_pool, krope_pool, tab, len, out, b, nq, g,
                                 r, pr, bs, w, cb, ct, kb, kt, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
