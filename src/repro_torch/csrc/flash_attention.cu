// Causal (or full) GQA attention for prefill, flash style, with a value
// width Hv that may differ from the query/key width H (MLA prefill: H 192,
// Hv 128).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention
// (_flash_kernel), the TPU kernel with a (B, Nq, S/bq, S/bk) grid whose KV
// axis runs sequentially with the online softmax in VMEM scratch.
//
// Bound on this card: operations.  Causal prefill does ~2 * S^2 * Nq * H
// flops (QK^T and PV, halved by the mask) on 2 * S * (Nq + Nkv) * H elements
// read or written, i.e. ~S/2 flops per byte -- above the bf16 ridge from a
// few hundred tokens on.  This first version computes on the CUDA cores in
// fp32 from shared memory, not on the tensor cores (wgmma comes later), so
// it runs far from that bound; what it keeps is the flash structure: the
// S x S score matrix never touches device memory.
//
// Design: one block per (query tile of 16 rows, query head, batch row).  A
// sequential loop over KV tiles of 32 positions replaces the Pallas grid's
// KV axis and stops at the diagonal, so tiles above it are never loaded.
// Q, K and V are read in the model's (B, S, N, H) layout through their
// own strides (no transpose), and any S is accepted: rows and columns past S are
// masked, so pow2 prefill buckets smaller than a tile (8, 16) work as is.
// The key tile is stored with a row stride of H+1 floats so the 32 lanes of
// a warp, which read 32 different keys at the same head dim, hit 32
// different shared-memory banks.  p stays fp32 through the PV product (the
// plain version rounds probabilities to the value dtype, as the model's
// _sdpa does, so bf16 results agree to bf16 tolerance only).
#include "online_softmax.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 16;  // query rows per block
constexpr int kBK = 32;  // key positions per tile

int flash_smem_floats(int h, int hv) {
  return kBQ * h + kBK * (h + 1) + kBK * hv + kBQ * kBK + softmax_state_floats(kBQ, hv);
}

struct Strides {
  long long b, s, n;  // batch, position and head strides (the head dim is unit-stride)
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int seq, int nq, int nkv, int h, int hv, Strides qs,
             Strides ks, Strides vs, Strides os, int causal, float scale) {
  extern __shared__ float smem[];
  const int i0 = blockIdx.x * kBQ, n = blockIdx.y, b = blockIdx.z;
  const int kvh = n / (nq / nkv);
  float* sq = smem;               // (BQ, h)
  float* sk = sq + kBQ * h;       // (BK, h+1)
  float* sv = sk + kBK * (h + 1); // (BK, hv)
  float* ss = sv + kBK * hv;      // (BQ, BK)
  SoftmaxState st;
  carve_softmax_state(ss + kBQ * kBK, kBQ, hv, &st);

  const T* qb = q + b * qs.b + n * qs.n;
  const T* kb = k + b * ks.b + kvh * ks.n;
  const T* vb = v + b * vs.b + kvh * vs.n;
  for (int i = threadIdx.x; i < kBQ * h; i += kThreads) {
    const int r = i / h, d = i - r * h;
    sq[i] = i0 + r < seq ? to_f32(qb[static_cast<long long>(i0 + r) * qs.s + d]) : 0.f;
  }
  online_softmax_init(st, kBQ, hv);
  __syncthreads();

  const int last_row = min(i0 + kBQ, seq) - 1;
  const int kv_end = causal ? last_row + 1 : seq;  // exclusive
  for (int j0 = 0; j0 < kv_end; j0 += kBK) {
    for (int i = threadIdx.x; i < kBK * h; i += kThreads) {
      const int c = i / h, d = i - c * h;
      sk[c * (h + 1) + d] =
          j0 + c < seq ? to_f32(kb[static_cast<long long>(j0 + c) * ks.s + d]) : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * hv; i += kThreads) {
      const int c = i / hv, d = i - c * hv;
      sv[i] = j0 + c < seq ? to_f32(vb[static_cast<long long>(j0 + c) * vs.s + d]) : 0.f;
    }
    __syncthreads();
    // one thread per score; a warp covers one query row and the tile's 32 keys
    for (int i = threadIdx.x; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, c = i - r * kBK;
      const float* qr = sq + r * h;
      const float* kr = sk + c * (h + 1);
      float a = 0.f;
      for (int d = 0; d < h; ++d) a += qr[d] * kr[d];
      const int row = i0 + r, col = j0 + c;
      const bool ok = col < seq && (!causal || col <= row);
      ss[i] = ok ? a * scale : kNegInf;
    }
    __syncthreads();
    online_softmax_block(st, ss, sv, kBQ, kBK, hv);
  }

  T* ob = out + b * os.b + n * os.n;
  for (int i = threadIdx.x; i < kBQ * hv; i += kThreads) {
    const int r = i / hv, d = i - r * hv;
    if (i0 + r < seq)
      ob[static_cast<long long>(i0 + r) * os.s + d] = from_f32<T>(online_softmax_finalize(st, i, hv));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b, int seq, int nq,
           int nkv, int h, int hv, Strides qs, Strides ks, Strides vs, Strides os, int causal,
           float scale, cudaStream_t s) {
  const size_t bytes = sizeof(float) * flash_smem_floats(h, hv);
  cudaError_t err = allow_shared_bytes(flash_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kBQ - 1) / kBQ, nq, b);
  flash_kernel<T><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), seq, nq, nkv, h, hv, qs, ks, vs, os, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, Nq, H), k (B, S, Nkv, H), v (B, S, Nkv, Hv), out (B, S, Nq, Hv);
// each given by its batch/position/head strides, head dim unit-stride.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int b, int seq, int nq, int nkv, int h, int hv,
                                      long long q_sb, long long q_ss, long long q_sn,
                                      long long k_sb, long long k_ss, long long k_sn,
                                      long long v_sb, long long v_ss, long long v_sn,
                                      long long o_sb, long long o_ss, long long o_sn,
                                      int causal, float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sn}, ks{k_sb, k_ss, k_sn}, vs{v_sb, v_ss, v_sn},
      os{o_sb, o_ss, o_sn};
  if (dtype == kFloat32)
    return launch<float>(q, k, v, out, b, seq, nq, nkv, h, hv, qs, ks, vs, os, causal, scale,
                         s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, out, b, seq, nq, nkv, h, hv, qs, ks, vs, os, causal,
                                 scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
