// Online-softmax recurrence of the CUDA-core attention kernels, in shared
// memory: the fp32 paths of flash_attention.cu, paged_mla_decode_attention.cu
// and the GQA decode pair (decode_split.cuh).  Their bf16 paths run on the
// tensor cores and keep the same recurrence in registers (flash_tc_kernel,
// mla_tc_kernel, decode_tc_kernel).
//
// Counterpart of online_softmax_init / _block / _finalize in
// src/repro/kernels/decode_attention.py:38-63.  Its users sweep KV one
// tile at a time and differ only in how a tile is addressed, so they keep
// the same per-row arithmetic: a running max m, a denominator l and an
// fp32 accumulator acc per query row, masking with -1e30 and dividing by
// max(l, 1e-30) at the end (a row that saw no tile finalizes to 0, not NaN).
//
// State lives in shared memory, `rows` query rows by `h` head dims; the
// caller computes the tile's scaled, masked scores into `s` (rows x bk) and
// stages the tile's values in `v` (bk x h, row stride h).
#pragma once

#include "common.cuh"

struct SoftmaxState {
  float* m;      // (rows,)   running max
  float* l;      // (rows,)   running denominator
  float* alpha;  // (rows,)   rescale factor of the current tile
  float* acc;    // (rows, h) running numerator
};

// Carves the state out of `base` and returns the first float past it.
__device__ __forceinline__ float* carve_softmax_state(float* base, int rows, int h,
                                                      SoftmaxState* st) {
  st->m = base;
  st->l = base + rows;
  st->alpha = base + 2 * rows;
  st->acc = base + 3 * rows;
  return st->acc + rows * h;
}

__host__ __device__ inline int softmax_state_floats(int rows, int h) {
  return 3 * rows + rows * h;
}

__device__ __forceinline__ void online_softmax_init(const SoftmaxState& st, int rows, int h) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    st.m[i] = kNegInf;
    st.l[i] = 0.f;
  }
  for (int i = threadIdx.x; i < rows * h; i += blockDim.x) st.acc[i] = 0.f;
}

// Folds one tile into the recurrence.  `s` holds the tile's scores (masked
// entries already -1e30) and is overwritten with the probabilities.  Must be
// called by every thread of the block (blockDim a multiple of 32); ends
// with a barrier, so the caller may restage its tile right after.
__device__ __forceinline__ void online_softmax_block(const SoftmaxState& st, float* s,
                                                     const float* v, int rows, int bk,
                                                     int h) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nwarps) {
    const float m_prev = st.m[r];
    float local = kNegInf;
    for (int c = lane; c < bk; c += 32) local = fmaxf(local, s[r * bk + c]);
    const float m_new = fmaxf(m_prev, warp_max(local));
    float sum = 0.f;
    for (int c = lane; c < bk; c += 32) {
      const float p = expf(s[r * bk + c] - m_new);
      s[r * bk + c] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float a = expf(m_prev - m_new);
      st.alpha[r] = a;
      st.l[r] = st.l[r] * a + sum;
      st.m[r] = m_new;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * h; i += blockDim.x) {
    const int r = i / h, d = i - r * h;
    const float* pr = s + r * bk;
    float a = st.acc[i] * st.alpha[r];
    for (int c = 0; c < bk; ++c) a += pr[c] * v[c * h + d];
    st.acc[i] = a;
  }
  __syncthreads();
}

__device__ __forceinline__ float online_softmax_finalize(const SoftmaxState& st, int i,
                                                         int h) {
  return st.acc[i] / fmaxf(st.l[i / h], 1e-30f);
}
