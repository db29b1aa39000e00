// Backward of causal GQA flash attention: dq, dk, dv from q, k, v, the
// forward's output o and row log-sum-exp lse, and the output gradient do.
//
// Replaces: the gradient XLA takes of the reference's jnp attention
// (src/repro/models/layers.py::_sdpa under jax.value_and_grad); the TPU
// forward kernel, src/repro/kernels/flash_attention.py::flash_attention,
// has no backward of its own.
//
// Bound on this card: operations.  Causal attention over S positions
// does five S x S products of width H per query head (QK^T and dO V^T
// recomputed, dV = P^T dO, dK = dS^T Q, dQ = dS K), ~5 * S^2 * Nq * H
// flops over ~S * (4 Nq + 4 Nkv) * H elements read or written: at the
// training shape (S 1024, H 128) ~700 flops a byte, above the ridge.
//
// Design: FlashAttention-2's recompute backward, in three kernels and no
// float atomics, so every run gives the same bits:
//   * delta_kernel: D = rowsum(dO * O) in fp32, one warp per (b, i, n) row;
//   * dkdv: one block per (key tile, kv head, batch row).  K and
//     V of the tile stay in shared memory; the block walks the g = Nq/Nkv
//     query heads of its kv head and, for each, the query tiles the causal
//     mask lets see the tile, recomputing P = exp(scale * QK^T - lse) and
//     dS = P * (dO V^T - D), and sums dV += P^T dO and dK += dS^T Q in
//     registers: the grouped heads are summed in the block, not by atomics;
//   * dq: one block per (query tile, query head, batch row); it
//     walks the key tiles up to the diagonal, recomputes P and dS the same
//     way and sums dQ += dS K in registers.
// Two versions of the dk/dv and dq kernels, chosen by dtype:
//   * bf16 at H 128, tensor cores (dkdv_tc_kernel, dq_tc_kernel): 64-row
//     tiles, 4 warps of 16 rows, operand tiles copied with cp.async into
//     shared memory padded by 16 bytes a row, every product an
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate) fed by ldmatrix -- S =
//     QK^T and dP = dO V^T (or their transposes in dkdv) from row-major
//     tiles, P and dS kept in registers and rounded to bf16 as the A
//     operand of the next product, as the forward rounds P; one tile of
//     each operand at a time, no pipeline;
//   * fp32 at H 16, 32 or 128, CUDA cores (dkdv_kernel, dq_kernel): 32-row
//     tiles staged in shared memory, rows padded to H + 1 floats so the 32
//     lanes reading 32 keys at one head dim hit 32 banks.
// Outputs are in q's dtype.
//
// Takes what the GQA decoder's training needs: causal, Sk = S, H = Hv at
// the widths instantiated below (internlm2's 128, and the reduced
// configs' 16 and 32 in fp32); q, k, v, o, do contiguous (B, S, N, H),
// 16-byte aligned in bf16.  The wrapper refuses anything else before any
// launch.
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kB = 32;            // query rows per tile = keys per tile
constexpr int kOwn = kB / kWarps;  // keys (dkdv) or rows (dq) a warp owns
constexpr int kPS = kB + 1;       // row stride of the P and dS tiles

template <int H>
struct BwdLayout {
  static constexpr int kS = H + 1;  // padded row stride of an operand tile (floats)
  static constexpr int kFloats = kB * kS;  // floats of one operand tile
  static constexpr int kDims = (H + 31) / 32;  // head dims per lane
  // four operand tiles, P and dS, and the tile's lse and D rows
  static constexpr size_t kBytes = sizeof(float) * (4 * kFloats + 2 * kB * kPS + 2 * kB);
};

// rows [r0, r0 + kB) of head n of an operand (B, S, N, H), widened to fp32,
// zeros past S
template <typename T, int H>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int b, int r0,
                                          int n, int heads, int seq) {
  for (int i = threadIdx.x; i < kB * H; i += kThreads) {
    const int r = i / H, d = i - r * H;
    const int row = r0 + r;
    dst[r * BwdLayout<H>::kS + d] =
        row < seq ? to_f32(src[((static_cast<long long>(b) * seq + row) * heads + n) * H + d])
                  : 0.f;
  }
}

// lse and D of rows [i0, i0 + kB) of head n, zeros past S
__device__ __forceinline__ void load_rows(float* slse, float* sdelta, const float* lse,
                                          const float* delta, int b, int n, int nq, int i0,
                                          int seq) {
  for (int r = threadIdx.x; r < kB; r += kThreads) {
    const long long at = (static_cast<long long>(b) * nq + n) * seq + i0 + r;
    const bool ok = i0 + r < seq;
    slse[r] = ok ? lse[at] : 0.f;
    sdelta[r] = ok ? delta[at] : 0.f;
  }
}

// P and dS of one (query tile i0, key tile j0) pair: a warp covers one
// query row and the tile's 32 keys; masked pairs (a key past the row, a
// row past S) give P = dS = 0.  Ends before any barrier: callers sync.
template <int H>
__device__ __forceinline__ void probs(const float* sq, const float* sk, const float* sdo,
                                      const float* sv, const float* slse, const float* sdelta,
                                      float* sp, float* sds, int i0, int j0, int seq,
                                      float scale) {
  constexpr int kS = BwdLayout<H>::kS;
  const int c = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kB; r += kWarps) {
    const float* qr = sq + r * kS;
    const float* dor = sdo + r * kS;
    const float* kr = sk + c * kS;
    const float* vr = sv + c * kS;
    float s = 0.f, dp = 0.f;
#pragma unroll 8
    for (int d = 0; d < H; ++d) {
      s += qr[d] * kr[d];
      dp += dor[d] * vr[d];
    }
    const int row = i0 + r, col = j0 + c;
    const float p = row < seq && col <= row ? expf(s * scale - slse[r]) : 0.f;
    sp[r * kPS + c] = p;
    sds[r * kPS + c] = p * (dp - sdelta[r]);
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int rows, int seq, int nq) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* orow = o + w * H;
  const T* drow = dout + w * H;
  float acc = 0.f;
  for (int d = lane; d < H; d += 32) acc += to_f32(orow[d]) * to_f32(drow[d]);
  acc = warp_sum(acc);
  if (lane == 0) {  // row w = (b * S + i) * Nq + n -> delta (b, n, i)
    const long long bi = w / nq;
    const int n = static_cast<int>(w - bi * nq);
    const long long b = bi / seq;
    const int i = static_cast<int>(bi - b * seq);
    delta[(b * nq + n) * seq + i] = acc;
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int seq,
            int nq, int nkv, float scale) {
  using L = BwdLayout<H>;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + L::kFloats;
  float* sq = sv + L::kFloats;
  float* sdo = sq + L::kFloats;
  float* sp = sdo + L::kFloats;
  float* sds = sp + kB * kPS;
  float* slse = sds + kB * kPS;
  float* sdelta = slse + kB;

  const int j0 = blockIdx.x * kB;  // the first key tiles see the most query tiles: first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int g = nq / nkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_tile<T, H>(sk, k, b, j0, kvh, nkv, seq);
  load_tile<T, H>(sv, v, b, j0, kvh, nkv, seq);

  float acc_k[kOwn][L::kDims], acc_v[kOwn][L::kDims];
#pragma unroll
  for (int c = 0; c < kOwn; ++c)
#pragma unroll
    for (int t = 0; t < L::kDims; ++t) acc_k[c][t] = acc_v[c][t] = 0.f;

  for (int gi = 0; gi < g; ++gi) {
    const int n = kvh * g + gi;
    for (int i0 = j0; i0 < seq; i0 += kB) {  // causal: the query tiles at or past the keys
      __syncthreads();  // the previous tile's readers are done (and K, V landed)
      load_tile<T, H>(sq, q, b, i0, n, nq, seq);
      load_tile<T, H>(sdo, dout, b, i0, n, nq, seq);
      load_rows(slse, sdelta, lse, delta, b, n, nq, i0, seq);
      __syncthreads();
      probs<H>(sq, sk, sdo, sv, slse, sdelta, sp, sds, i0, j0, seq, scale);
      __syncthreads();
      for (int r = 0; r < kB; ++r) {
        float dor[L::kDims], qr[L::kDims];
#pragma unroll
        for (int t = 0; t < L::kDims; ++t) {
          const int d = lane + 32 * t;
          dor[t] = d < H ? sdo[r * L::kS + d] : 0.f;
          qr[t] = d < H ? sq[r * L::kS + d] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < kOwn; ++c) {
          const int col = warp * kOwn + c;
          const float p = sp[r * kPS + col], ds = sds[r * kPS + col];
#pragma unroll
          for (int t = 0; t < L::kDims; ++t) {
            acc_v[c][t] += p * dor[t];
            acc_k[c][t] += ds * qr[t];
          }
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kOwn; ++c) {
    const int key = j0 + warp * kOwn + c;
    if (key >= seq) continue;
    const long long at = ((static_cast<long long>(b) * seq + key) * nkv + kvh) * H;
#pragma unroll
    for (int t = 0; t < L::kDims; ++t) {
      const int d = lane + 32 * t;
      if (d < H) {
        dk[at + d] = from_f32<T>(acc_k[c][t] * scale);
        dv[at + d] = from_f32<T>(acc_v[c][t]);
      }
    }
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int seq, int nq, int nkv,
          float scale) {
  using L = BwdLayout<H>;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + L::kFloats;
  float* sk = sdo + L::kFloats;
  float* sv = sk + L::kFloats;
  float* sp = sv + L::kFloats;
  float* sds = sp + kB * kPS;
  float* slse = sds + kB * kPS;
  float* sdelta = slse + kB;

  const int i0 = (gridDim.x - 1 - blockIdx.x) * kB;  // the longest causal sweeps first
  const int n = blockIdx.y, b = blockIdx.z;
  const int kvh = n / (nq / nkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_tile<T, H>(sq, q, b, i0, n, nq, seq);
  load_tile<T, H>(sdo, dout, b, i0, n, nq, seq);
  load_rows(slse, sdelta, lse, delta, b, n, nq, i0, seq);

  float acc[kOwn][L::kDims];
#pragma unroll
  for (int r = 0; r < kOwn; ++r)
#pragma unroll
    for (int t = 0; t < L::kDims; ++t) acc[r][t] = 0.f;

  for (int j0 = 0; j0 <= i0; j0 += kB) {  // causal: up to the diagonal tile
    __syncthreads();
    load_tile<T, H>(sk, k, b, j0, kvh, nkv, seq);
    load_tile<T, H>(sv, v, b, j0, kvh, nkv, seq);
    __syncthreads();
    probs<H>(sq, sk, sdo, sv, slse, sdelta, sp, sds, i0, j0, seq, scale);
    __syncthreads();
    for (int c = 0; c < kB; ++c) {
      float kr[L::kDims];
#pragma unroll
      for (int t = 0; t < L::kDims; ++t) {
        const int d = lane + 32 * t;
        kr[t] = d < H ? sk[c * L::kS + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kOwn; ++r) {
        const float ds = sds[(warp * kOwn + r) * kPS + c];
#pragma unroll
        for (int t = 0; t < L::kDims; ++t) acc[r][t] += ds * kr[t];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    const int row = i0 + warp * kOwn + r;
    if (row >= seq) continue;
    const long long at = ((static_cast<long long>(b) * seq + row) * nq + n) * H;
#pragma unroll
    for (int t = 0; t < L::kDims; ++t) {
      const int d = lane + 32 * t;
      if (d < H) dq[at + d] = from_f32<T>(acc[r][t] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // keys (dkdv) or query rows (dq) of a block, and of each tile it walks

template <int H>
struct TcLayout {
  static_assert(H % 16 == 0, "head width must be a multiple of 16");
  // padded row stride (elements): the 8 rows of an ldmatrix hit 8 bank groups
  static constexpr int kS = H + 8;
  static constexpr int kT = kTile * kS;
  // four operand tiles, then the tile's lse (log2 domain) and D rows
  static constexpr size_t kBytes = sizeof(bf16) * 4 * kT + sizeof(float) * 2 * kTile;
};

// acc (16 rows x 64 cols, C fragments) = A[a_row0, +16) . B[0, 64)^T over
// width H, A and B row-major (rows, H) tiles in shared memory
template <int H>
__device__ __forceinline__ void gemm_nt(float (&acc)[8][4], const bf16* a, int a_row0,
                                        const bf16* b, int lane) {
  constexpr int kS = TcLayout<H>::kS;
  const int a_off = (a_row0 + (lane & 15)) * kS + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * kS + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + a_off + kk * 16);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + np * 16 * kS + b_off + kk * 16);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 rows x H) += P (16 x 64, A fragments) . C[0, 64) (a row-major
// (64, H) tile in shared memory)
template <int H>
__device__ __forceinline__ void gemm_pc(float (&acc)[H / 8][4], const uint32_t (&pf)[4][4],
                                        const bf16* c, int lane) {
  constexpr int kS = TcLayout<H>::kS;
  const int c_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * kS + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dp = 0; dp < H / 16; ++dp) {
      uint32_t bc[4];
      ldmatrix_x4_trans(bc, c + kk * 16 * kS + c_off + dp * 16);
      mma_bf16(acc[2 * dp], pf[kk], bc[0], bc[1]);
      mma_bf16(acc[2 * dp + 1], pf[kk], bc[2], bc[3]);
    }
  }
}

// C fragments (16 x 64, fp32) rounded to bf16 A fragments of four k-steps
__device__ __forceinline__ void to_a_frags(uint32_t (&f)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    f[nt >> 1][(nt & 1) * 2] = pack_bf16(x[nt][0], x[nt][1]);
    f[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(x[nt][2], x[nt][3]);
  }
}

// lse (in the log2 domain) and D of rows [r0, r0 + kTile) of head n; rows
// past S get lse 1e30, so their probabilities are exactly 0
__device__ __forceinline__ void load_tc_rows(float* slse, float* sdelta, const float* lse,
                                             const float* delta, int b, int n, int nq, int r0,
                                             int seq) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const long long at = (static_cast<long long>(b) * nq + n) * seq + r0 + r;
    const bool ok = r0 + r < seq;
    slse[r] = ok ? lse[at] * kLog2e : 1e30f;
    sdelta[r] = ok ? delta[at] : 0.f;
  }
}

// The (B, S, N, H) operand's rows of head n of batch row b: base pointer
// (row stride N * H)
__device__ __forceinline__ const bf16* head_rows(const bf16* t, int b, int n, int seq,
                                                 int heads, int h) {
  return t + (static_cast<long long>(b) * seq * heads + n) * h;
}

// One block per (64-key tile, kv head, batch row); warp w owns keys
// [16 w, 16 w + 16) of the tile and sums their dK and dV rows in registers
// over the g query heads and the query tiles at or past the key tile.
// Per query tile (S^T = K Q^T; rows keys, columns queries):
// P^T = exp2(S^T scale log2e - lse2), dV += P^T dO, dP^T = V dO^T,
// dS^T = P^T (dP^T - D), dK += dS^T Q; P^T and dS^T become the A
// operands in registers, rounded to bf16 (the forward's P is too).
template <int H>
__global__ void __launch_bounds__(kThreads)
dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int seq, int nq, int nkv,
               float scale) {
  using L = TcLayout<H>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + L::kT;
  bf16* sq = sv + L::kT;
  bf16* sdo = sq + L::kT;
  float* slse = reinterpret_cast<float*>(sdo + L::kT);
  float* sdelta = slse + kTile;

  const int j0 = blockIdx.x * kTile;  // the first key tiles see the most query tiles: first
  const int kvh = blockIdx.y, b = blockIdx.z, g = nq / nkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, quad = lane & 3;
  const long long q_rs = static_cast<long long>(nq) * H, kv_rs = static_cast<long long>(nkv) * H;
  const float scale_log2 = scale * kLog2e;
  copy_rows_async<kTile, H, kThreads>(sk, L::kS, head_rows(k, b, kvh, seq, nkv, H), kv_rs, j0,
                                      seq);
  copy_rows_async<kTile, H, kThreads>(sv, L::kS, head_rows(v, b, kvh, seq, nkv, H), kv_rs, j0,
                                      seq);
  cp_async_commit();

  float dka[H / 8][4], dva[H / 8][4];
#pragma unroll
  for (int i = 0; i < H / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  const int key0 = warp * 16 + (lane >> 2);  // this lane's keys (in the tile): key0, key0 + 8

  for (int gi = 0; gi < g; ++gi) {
    const int n = kvh * g + gi;
    for (int i0 = j0; i0 < seq; i0 += kTile) {  // causal: the query tiles at or past the keys
      __syncthreads();  // the previous tile's readers are done
      copy_rows_async<kTile, H, kThreads>(sq, L::kS, head_rows(q, b, n, seq, nq, H), q_rs, i0,
                                          seq);
      copy_rows_async<kTile, H, kThreads>(sdo, L::kS, head_rows(dout, b, n, seq, nq, H), q_rs,
                                          i0, seq);
      cp_async_commit();
      load_tc_rows(slse, sdelta, lse, delta, b, n, nq, i0, seq);
      cp_async_wait<0>();
      __syncthreads();
      const bool diag = i0 == j0;

      float s[8][4];  // S^T, then P^T
      gemm_nt<H>(s, sk, warp * 16, sq, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * quad + (e & 1);  // query (in the tile)
          const float p = exp2f(s[nt][e] * scale_log2 - slse[col]);
          s[nt][e] = diag && col < key0 + (e >> 1) * 8 ? 0.f : p;
        }
      uint32_t pf[4][4];
      to_a_frags(pf, s);
      gemm_pc<H>(dva, pf, sdo, lane);

      float dp[8][4];  // dP^T, then dS^T
      gemm_nt<H>(dp, sv, warp * 16, sdo, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[nt][e] = s[nt][e] * (dp[nt][e] - sdelta[nt * 8 + 2 * quad + (e & 1)]);
      uint32_t dsf[4][4];
      to_a_frags(dsf, dp);
      gemm_pc<H>(dka, dsf, sq, lane);
    }
  }

  const long long kv_at = static_cast<long long>(b) * seq * nkv + kvh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = j0 + key0 + 8 * r;
    if (key >= seq) continue;
    const long long at = (kv_at + static_cast<long long>(key) * nkv) * H;
#pragma unroll
    for (int dn = 0; dn < H / 8; ++dn) {
      const int col = dn * 8 + 2 * quad;
      *reinterpret_cast<__nv_bfloat162*>(dk + at + col) =
          __floats2bfloat162_rn(dka[dn][2 * r] * scale, dka[dn][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
          __floats2bfloat162_rn(dva[dn][2 * r], dva[dn][2 * r + 1]);
    }
  }
}

// One block per (64-query tile, query head, batch row); warp w owns query
// rows [16 w, 16 w + 16) and sums their dQ in registers over the key tiles
// up to the diagonal: S = Q K^T, P = exp2(S scale log2e - lse2),
// dP = dO V^T, dS = P (dP - D), dQ += dS K.
template <int H>
__global__ void __launch_bounds__(kThreads)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const bf16* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, bf16* __restrict__ dq, int seq, int nq, int nkv,
             float scale) {
  using L = TcLayout<H>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + L::kT;
  bf16* sk = sdo + L::kT;
  bf16* sv = sk + L::kT;
  float* slse = reinterpret_cast<float*>(sv + L::kT);
  float* sdelta = slse + kTile;

  const int i0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // the longest causal sweeps first
  const int n = blockIdx.y, b = blockIdx.z, kvh = n / (nq / nkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, quad = lane & 3;
  const long long q_rs = static_cast<long long>(nq) * H, kv_rs = static_cast<long long>(nkv) * H;
  const float scale_log2 = scale * kLog2e;
  copy_rows_async<kTile, H, kThreads>(sq, L::kS, head_rows(q, b, n, seq, nq, H), q_rs, i0, seq);
  copy_rows_async<kTile, H, kThreads>(sdo, L::kS, head_rows(dout, b, n, seq, nq, H), q_rs, i0,
                                      seq);
  cp_async_commit();
  load_tc_rows(slse, sdelta, lse, delta, b, n, nq, i0, seq);

  float dqa[H / 8][4];
#pragma unroll
  for (int i = 0; i < H / 8; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;
  const int row0 = warp * 16 + (lane >> 2);  // this lane's rows (in the tile): row0, row0 + 8
  const bf16* kb = head_rows(k, b, kvh, seq, nkv, H);
  const bf16* vb = head_rows(v, b, kvh, seq, nkv, H);

  for (int j0 = 0; j0 <= i0; j0 += kTile) {  // causal: up to the diagonal tile
    __syncthreads();  // the previous tile's readers are done
    copy_rows_async<kTile, H, kThreads>(sk, L::kS, kb, kv_rs, j0, seq);
    copy_rows_async<kTile, H, kThreads>(sv, L::kS, vb, kv_rs, j0, seq);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const bool diag = j0 == i0;

    float s[8][4];  // S, then P
    gemm_nt<H>(s, sq, warp * 16, sk, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8, col = nt * 8 + 2 * quad + (e & 1);
        const float p = exp2f(s[nt][e] * scale_log2 - slse[row]);
        s[nt][e] = diag && col > row ? 0.f : p;
      }
    float dp[8][4];  // dP, then dS
    gemm_nt<H>(dp, sdo, warp * 16, sv, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = s[nt][e] * (dp[nt][e] - sdelta[row0 + (e >> 1) * 8]);
    uint32_t dsf[4][4];
    to_a_frags(dsf, dp);
    gemm_pc<H>(dqa, dsf, sk, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + row0 + 8 * r;
    if (row >= seq) continue;
    bf16* out = dq + ((static_cast<long long>(b) * seq + row) * nq + n) * H;
#pragma unroll
    for (int dn = 0; dn < H / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(out + dn * 8 + 2 * quad) =
          __floats2bfloat162_rn(dqa[dn][2 * r] * scale, dqa[dn][2 * r + 1] * scale);
  }
}

template <int H>
int launch_tc(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int seq,
              int nq, int nkv, float scale, cudaStream_t s) {
  constexpr size_t bytes = TcLayout<H>::kBytes;
  cudaError_t err = allow_shared_bytes(dkdv_tc_kernel<H>, bytes);
  if (err == cudaSuccess) err = allow_shared_bytes(dq_tc_kernel<H>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const int rows = b * seq * nq;
  delta_kernel<bf16, H><<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const bf16*>(o), dot, delta, rows, seq, nq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (seq + kTile - 1) / kTile;
  dkdv_tc_kernel<H><<<dim3(tiles, nkv, b), kThreads, bytes, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq, nq, nkv,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_tc_kernel<H><<<dim3(tiles, nq, b), kThreads, bytes, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dq), seq, nq, nkv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int H>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int seq, int nq,
           int nkv, float scale, cudaStream_t s) {
  constexpr size_t bytes = BwdLayout<H>::kBytes;
  cudaError_t err = allow_shared_bytes(dkdv_kernel<T, H>, bytes);
  if (err == cudaSuccess) err = allow_shared_bytes(dq_kernel<T, H>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int rows = b * seq * nq;
  delta_kernel<T, H><<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const T*>(o), dot, delta, rows, seq, nq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (seq + kB - 1) / kB;
  dkdv_kernel<T, H><<<dim3(tiles, nkv, b), kThreads, bytes, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), seq, nq, nkv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, H><<<dim3(tiles, nq, b), kThreads, bytes, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), seq, nq, nkv, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_widths(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int seq,
                  int nq, int nkv, int h, float scale, int dtype, cudaStream_t s) {
  if (dtype == kBFloat16)
    return h == 128 ? launch_tc<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, seq, nq, nkv,
                                     scale, s)
                    : static_cast<int>(cudaErrorInvalidValue);  // no instantiation for h
  if (dtype != kFloat32) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_BWD(H)                                                                      \
  if (h == H)                                                                                   \
    return launch<float, H>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, seq, nq, nkv, scale, s);
  REPRO_FLASH_BWD(16)
  REPRO_FLASH_BWD(32)
  REPRO_FLASH_BWD(128)
#undef REPRO_FLASH_BWD
  return static_cast<int>(cudaErrorInvalidValue);  // no instantiation for h
}

}  // namespace

// Causal; q, o, do, dq (B, S, Nq, H), k, v, dk, dv (B, S, Nkv, H), all
// contiguous and of one dtype, 16-byte aligned in bf16; lse and delta (the
// D scratch) fp32 (B, Nq, S) contiguous; Nkv divides Nq.  bf16 runs on the
// tensor cores (H 128), fp32 on the CUDA cores (H 16, 32, 128).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int b,
                                          int seq, int nq, int nkv, int h, float scale,
                                          int dtype, void* stream) {
  if (nkv < 1 || nq % nkv) return static_cast<int>(cudaErrorInvalidValue);
  return launch_widths(q, k, v, o, dout, static_cast<const float*>(lse),
                       static_cast<float*>(delta), dq, dk, dv, b, seq, nq, nkv, h, scale, dtype,
                       static_cast<cudaStream_t>(stream));
}
