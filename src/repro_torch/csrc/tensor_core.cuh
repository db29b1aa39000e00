// Warp-level tensor-core and async-copy building blocks (inline PTX) for
// the bf16 tensor-core kernels: flash_attention.cu, the decode kernels and
// ssd_intra.cu.
//
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) fragment layout, with
// lane = 4 * group + quad (group = lane >> 2, quad = lane & 3):
//   A 16x16 (row-major): a0 (row group,   cols 2quad..+1)
//                        a1 (row group+8, cols 2quad..+1)
//                        a2 (row group,   cols 2quad+8..+9)
//                        a3 (row group+8, cols 2quad+8..+9)
//   B 16x8 (k x n):      b0 (k 2quad..+1, col group), b1 (k 2quad+8..+9)
//   C 16x8 fp32:         c0, c1 (row group,   cols 2quad, 2quad+1)
//                        c2, c3 (row group+8, cols 2quad, 2quad+1)
// Each 32-bit register holds two bf16, the lower column in the low half.
// ldmatrix.x4 loads four 8x8 bf16 matrices: lanes 8i..8i+7 give the row
// addresses of matrix i, and register i of every lane receives that
// lane's pair of matrix i (transposed with .trans).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses L1; with valid == false the
// 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Copies rows [r0, r0 + ROWS) of a (rows, W) bf16 operand with row stride
// `gs` (elements) into shared memory (row stride `ss`), 16 bytes per
// cp.async over the block's THREADS threads; rows at or past `rows` are
// zero-filled.
template <int ROWS, int W, int THREADS>
__device__ __forceinline__ void copy_rows_async(__nv_bfloat16* dst, int ss,
                                                const __nv_bfloat16* src, long long gs, int r0,
                                                int rows) {
  constexpr int kChunks = W / 8;
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int it = 0; it < (kTotal + THREADS - 1) / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (kTotal % THREADS != 0 && i >= kTotal) break;
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = r0 + r < rows;
    const __nv_bfloat16* p = ok ? src + static_cast<long long>(r0 + r) * gs + c * 8 : src;
    cp_async_16(dst + r * ss + c * 8, p, ok);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b on one m16n8k16 tile
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even) in one A/B register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// max over the 4 lanes of a quad (the lanes that share a C-fragment row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
