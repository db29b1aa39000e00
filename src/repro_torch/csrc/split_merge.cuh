// Merge pass of the split KV sweeps (flash-decoding) of every decode kernel:
// paged_mla_decode_attention.cu and the GQA decode pair (decode_split.cuh).
//
// A split kernel runs one block per (KV split, group of query heads, row);
// split s of a row covers the row's tiles [s*T, (s+1)*T).  Each block leaves
// its partial softmax state in fp32 scratch -- the running max m, the
// denominator l and the unnormalised accumulator over (heads, R) -- and the
// merge below combines the live splits of each (row, head) in split order,
// so the result depends on tile indices and T alone, never on the grid.
#pragma once

#include "common.cuh"

// Kernel definitions are per source file: each .cu instantiates its own.
namespace {

// Where a split block's partial state goes: acc (B, NS, Nq, R) and stats
// (B, NS, Nq, 2) = (m, l), both fp32.
struct Partials {
  float* acc;
  float* stats;
  int ns;  // splits per row in the scratch
};

constexpr int kMergeThreads = 128;

// One block per (head, row); one warp weighs the row's live splits, then
// every thread merges its value columns (R of them), adding the splits in
// split order.  A row holds min(lengths[b], cap) positions in tiles of
// `bs`; the split kernels keep m in the base of their exponent (e, or 2
// when kBase2), so the merge uses the same.  A row with no live split
// writes 0.
template <typename T, bool kBase2>
__global__ void __launch_bounds__(kMergeThreads)
split_merge_kernel(const float* __restrict__ acc, const float* __restrict__ stats,
                   const int* __restrict__ lengths, T* __restrict__ out, int nq, int r, int bs,
                   int cap, int tps, int ns) {
  extern __shared__ float weight[];  // (ns,) exp(m_s - m)
  __shared__ float denom;
  const int h = blockIdx.x, b = blockIdx.y;
  const int length = max(0, min(lengths[b], cap));
  const int ntiles = (length + bs - 1) / bs;
  const int live = min(ns, (ntiles + tps - 1) / tps);
  const long long base = static_cast<long long>(b) * ns * nq + h;  // split 0's row
  if (threadIdx.x < 32) {  // one warp: a lane per split, a fixed reduction tree
    const int lane = threadIdx.x;
    float mx = kNegInf;
    for (int s = lane; s < live; s += 32) mx = fmaxf(mx, stats[(base + s * nq) * 2]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = lane; s < live; s += 32) {
      const float d = stats[(base + s * nq) * 2] - mx;
      const float e = kBase2 ? exp2f(d) : expf(d);
      weight[s] = e;
      l += stats[(base + s * nq) * 2 + 1] * e;
    }
    l = warp_sum(l);
    if (lane == 0) denom = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  T* o = out + (static_cast<long long>(b) * nq + h) * r;
  for (int d = threadIdx.x; d < r; d += kMergeThreads) {
    float a = 0.f;  // the splits in split order
#pragma unroll 4
    for (int s = 0; s < live; ++s) a += acc[(base + s * nq) * r + d] * weight[s];
    o[d] = from_f32<T>(a / denom);
  }
}

// Merges `part` into out (B, Nq, R) contiguous.
template <typename T, bool kBase2>
int launch_split_merge(const Partials& part, const int* lengths, void* out, int b, int nq, int r,
                       int bs, int cap, int tps, cudaStream_t s) {
  const size_t bytes = sizeof(float) * (part.ns > 0 ? part.ns : 1);
  cudaError_t err = allow_shared_bytes(split_merge_kernel<T, kBase2>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  split_merge_kernel<T, kBase2><<<dim3(nq, b), kMergeThreads, bytes, s>>>(
      part.acc, part.stats, lengths, static_cast<T*>(out), nq, r, bs, cap, tps, part.ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
