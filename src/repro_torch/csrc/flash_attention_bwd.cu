// Backward of GQA flash attention, causal or full: dq, dk, dv from q, k, v,
// the forward's output o and row log-sum-exp lse, and the output gradient
// do.  The value width Hv may differ from the query/key width H (MLA
// prefill: 192 / 128), and full attention may take a key length Sk of its
// own (enc-dec cross-attention: S decoder tokens against Sk frames).
//
// Replaces: the gradient XLA takes of the reference's jnp attention
// (src/repro/models/layers.py::_sdpa under jax.value_and_grad); the TPU
// forward kernel, src/repro/kernels/flash_attention.py::flash_attention,
// has no backward of its own.
//
// Bound on this card: operations.  Attention over S queries and Sk keys
// does five S x Sk products per query head (QK^T and dO V^T recomputed,
// dV = P^T dO, dK = dS^T Q, dQ = dS K; the causal half when causal), ~2.5
// (2H + Hv) S Sk Nq flops over ~(S Nq + Sk Nkv)(2H + 2Hv) elements read or
// written: at the training shapes (S 1024, H 64-192; whisper's 1500 frames)
// hundreds of flops a byte, above the ridge.
//
// Design: FlashAttention-2's recompute backward, in three kernels and no
// float atomics, so every run gives the same bits:
//   * delta_kernel: D = rowsum(dO * O) in fp32 over Hv, one warp per
//     (b, i, n) row;
//   * dkdv: one block per (key tile, kv head, batch row).  K and V of the
//     tile stay in shared memory; the block walks the g = Nq/Nkv query
//     heads of its kv head and, for each, the query tiles that see the tile
//     (those at or past it when causal, all when not), recomputing P =
//     exp(scale * QK^T - lse) and dS = P * (dO V^T - D), and sums dV += P^T
//     dO and dK += dS^T Q in registers: the grouped heads are summed in the
//     block, not by atomics;
//   * dq: one block per (query tile, query head, batch row); it walks the
//     key tiles up to the diagonal (causal) or all Sk keys (full),
//     recomputes P and dS the same way and sums dQ += dS K in registers.
// Masks: queries past S carry P = 0; keys past Sk are masked where dq sums
// over them and never written where dk/dv own them.
// Two versions of the dk/dv and dq kernels, chosen by dtype:
//   * bf16, tensor cores (dkdv_tc_kernel, dq_tc_kernel) at (H, Hv) = (64,
//     64) whisper, (112, 112) zamba2, (128, 128) internlm2 and (192, 128)
//     MLA: 64-row tiles, 4 warps of 16 rows, every product an
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate) fed by ldmatrix from
//     shared memory padded by 16 bytes a row -- S = QK^T and dP = dO V^T
//     (or their transposes in dkdv) from row-major tiles, P and dS kept in
//     registers and rounded to bf16 as the A operand of the next product,
//     as the forward rounds P.  What held the first version (PR 23) back,
//     and what this one does about it:
//       - it waited for each streamed tile before computing on it: the
//         streamed operand (dkdv: Q, dO, lse and D; dq: K and V) now runs
//         through a ring of two cp.async stages, the next tile landing
//         while this one is computed -- except at (192, 128), where two
//         stages (130 KB) leave room for one block an SM and one stage
//         (86 KB) for two, which measured faster (PERF.md, PR 26);
//       - the blocks of one head ran heaviest first but one head after
//         another, so the lightest causal tiles of the last heads made the
//         tail: the grid now puts the tile index last (blockIdx.y), so the
//         heaviest tiles of every head start first;
//       - a warp holds its 16 x 64 S and dP tiles (64 fp32 registers)
//         beside (H + Hv) / 2 accumulators, and dkdv spills 24-240 bytes
//         from (112, 112) up (phase 2 of chip_smoke.py prints the counts).
//         Taking the tile's columns 32 at a time did not bring dkdv under
//         255 registers and ran slower at (128, 128) and (192, 128), so
//         the tiles stay 64 wide;
//     dq still recomputes S and dP: 7 S x Sk products where a fused pass
//     does 5, the price of summing dQ without atomics or an fp32 scratch
//     round trip per key tile (which at S 1024 would move more bytes than
//     the two products cost);
//   * fp32, CUDA cores (dkdv_kernel, dq_kernel) at the same widths and the
//     reduced configs' (16, 16), (24, 16) and (32, 32): 32-row tiles staged
//     in shared memory, rows padded to H + 1 (Hv + 1) floats so the 32
//     lanes reading 32 keys at one head dim hit 32 banks.
// Outputs are in q's dtype.
//
// q, o, do contiguous (B, S, Nq, .), k, v contiguous (B, Sk, Nkv, .), all
// 16-byte aligned in bf16; Sk = S when causal.  The wrapper refuses
// anything else before any launch.
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kB = 32;            // query rows per tile = keys per tile
constexpr int kOwn = kB / kWarps;  // keys (dkdv) or rows (dq) a warp owns
constexpr int kPS = kB + 1;       // row stride of the P and dS tiles

template <int H, int HV>
struct BwdLayout {
  static constexpr int kS = H + 1;    // padded row stride of a q or k tile (floats)
  static constexpr int kSV = HV + 1;  // of a v or do tile
  static constexpr int kDims = (H + 31) / 32;   // head dims per lane
  static constexpr int kDimsV = (HV + 31) / 32;
  // q, k, v and do tiles, P and dS, and the tile's lse and D rows
  static constexpr size_t kBytes =
      sizeof(float) * (2 * kB * kS + 2 * kB * kSV + 2 * kB * kPS + 2 * kB);
};

// rows [r0, r0 + kB) of head n of an operand (B, rows, N, W), widened to
// fp32 into a tile of row stride W + 1, zeros past `rows`
template <typename T, int W>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int b, int r0,
                                          int n, int heads, int rows) {
  for (int i = threadIdx.x; i < kB * W; i += kThreads) {
    const int r = i / W, d = i - r * W;
    const int row = r0 + r;
    dst[r * (W + 1) + d] =
        row < rows ? to_f32(src[((static_cast<long long>(b) * rows + row) * heads + n) * W + d])
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
// query row and the tile's 32 keys; masked pairs (a key past Sk or, when
// causal, past the row; a row past S) give P = dS = 0.  Ends before any
// barrier: callers sync.
template <int H, int HV>
__device__ __forceinline__ void probs(const float* sq, const float* sk, const float* sdo,
                                      const float* sv, const float* slse, const float* sdelta,
                                      float* sp, float* sds, int i0, int j0, int seq,
                                      int seq_k, bool causal, float scale) {
  using L = BwdLayout<H, HV>;
  const int c = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kB; r += kWarps) {
    const float* qr = sq + r * L::kS;
    const float* kr = sk + c * L::kS;
    const float* dor = sdo + r * L::kSV;
    const float* vr = sv + c * L::kSV;
    float s = 0.f, dp = 0.f;
#pragma unroll 8
    for (int d = 0; d < H; ++d) s += qr[d] * kr[d];
#pragma unroll 8
    for (int d = 0; d < HV; ++d) dp += dor[d] * vr[d];
    const int row = i0 + r, col = j0 + c;
    const bool ok = row < seq && col < seq_k && (!causal || col <= row);
    const float p = ok ? expf(s * scale - slse[r]) : 0.f;
    sp[r * kPS + c] = p;
    sds[r * kPS + c] = p * (dp - sdelta[r]);
  }
}

template <typename T, int HV>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int rows, int seq, int nq) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* orow = o + w * HV;
  const T* drow = dout + w * HV;
  float acc = 0.f;
  for (int d = lane; d < HV; d += 32) acc += to_f32(orow[d]) * to_f32(drow[d]);
  acc = warp_sum(acc);
  if (lane == 0) {  // row w = (b * S + i) * Nq + n -> delta (b, n, i)
    const long long bi = w / nq;
    const int n = static_cast<int>(w - bi * nq);
    const long long b = bi / seq;
    const int i = static_cast<int>(bi - b * seq);
    delta[(b * nq + n) * seq + i] = acc;
  }
}

template <typename T, int H, int HV>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int seq,
            int seq_k, int nq, int nkv, int causal, float scale) {
  using L = BwdLayout<H, HV>;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kB * L::kS;
  float* sq = sv + kB * L::kSV;
  float* sdo = sq + kB * L::kS;
  float* sp = sdo + kB * L::kSV;
  float* sds = sp + kB * kPS;
  float* slse = sds + kB * kPS;
  float* sdelta = slse + kB;

  const int j0 = blockIdx.x * kB;  // the first key tiles see the most query tiles: first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int g = nq / nkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_tile<T, H>(sk, k, b, j0, kvh, nkv, seq_k);
  load_tile<T, HV>(sv, v, b, j0, kvh, nkv, seq_k);

  float acc_k[kOwn][L::kDims], acc_v[kOwn][L::kDimsV];
#pragma unroll
  for (int c = 0; c < kOwn; ++c) {
#pragma unroll
    for (int t = 0; t < L::kDims; ++t) acc_k[c][t] = 0.f;
#pragma unroll
    for (int t = 0; t < L::kDimsV; ++t) acc_v[c][t] = 0.f;
  }

  for (int gi = 0; gi < g; ++gi) {
    const int n = kvh * g + gi;
    // causal: the query tiles at or past the keys; full: every query tile
    for (int i0 = causal ? j0 : 0; i0 < seq; i0 += kB) {
      __syncthreads();  // the previous tile's readers are done (and K, V landed)
      load_tile<T, H>(sq, q, b, i0, n, nq, seq);
      load_tile<T, HV>(sdo, dout, b, i0, n, nq, seq);
      load_rows(slse, sdelta, lse, delta, b, n, nq, i0, seq);
      __syncthreads();
      probs<H, HV>(sq, sk, sdo, sv, slse, sdelta, sp, sds, i0, j0, seq, seq_k, causal, scale);
      __syncthreads();
      for (int r = 0; r < kB; ++r) {
        float dor[L::kDimsV], qr[L::kDims];
#pragma unroll
        for (int t = 0; t < L::kDimsV; ++t) {
          const int d = lane + 32 * t;
          dor[t] = d < HV ? sdo[r * L::kSV + d] : 0.f;
        }
#pragma unroll
        for (int t = 0; t < L::kDims; ++t) {
          const int d = lane + 32 * t;
          qr[t] = d < H ? sq[r * L::kS + d] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < kOwn; ++c) {
          const int col = warp * kOwn + c;
          const float p = sp[r * kPS + col], ds = sds[r * kPS + col];
#pragma unroll
          for (int t = 0; t < L::kDimsV; ++t) acc_v[c][t] += p * dor[t];
#pragma unroll
          for (int t = 0; t < L::kDims; ++t) acc_k[c][t] += ds * qr[t];
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kOwn; ++c) {
    const int key = j0 + warp * kOwn + c;
    if (key >= seq_k) continue;
    const long long at = (static_cast<long long>(b) * seq_k + key) * nkv + kvh;
#pragma unroll
    for (int t = 0; t < L::kDims; ++t) {
      const int d = lane + 32 * t;
      if (d < H) dk[at * H + d] = from_f32<T>(acc_k[c][t] * scale);
    }
#pragma unroll
    for (int t = 0; t < L::kDimsV; ++t) {
      const int d = lane + 32 * t;
      if (d < HV) dv[at * HV + d] = from_f32<T>(acc_v[c][t]);
    }
  }
}

template <typename T, int H, int HV>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int seq, int seq_k, int nq,
          int nkv, int causal, float scale) {
  using L = BwdLayout<H, HV>;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kB * L::kS;
  float* sk = sdo + kB * L::kSV;
  float* sv = sk + kB * L::kS;
  float* sp = sv + kB * L::kSV;
  float* sds = sp + kB * kPS;
  float* slse = sds + kB * kPS;
  float* sdelta = slse + kB;

  const int i0 = (gridDim.x - 1 - blockIdx.x) * kB;  // the longest causal sweeps first
  const int n = blockIdx.y, b = blockIdx.z;
  const int kvh = n / (nq / nkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_tile<T, H>(sq, q, b, i0, n, nq, seq);
  load_tile<T, HV>(sdo, dout, b, i0, n, nq, seq);
  load_rows(slse, sdelta, lse, delta, b, n, nq, i0, seq);

  float acc[kOwn][L::kDims];
#pragma unroll
  for (int r = 0; r < kOwn; ++r)
#pragma unroll
    for (int t = 0; t < L::kDims; ++t) acc[r][t] = 0.f;

  const int j_end = causal ? i0 + 1 : seq_k;  // causal: up to the diagonal tile
  for (int j0 = 0; j0 < j_end; j0 += kB) {
    __syncthreads();
    load_tile<T, H>(sk, k, b, j0, kvh, nkv, seq_k);
    load_tile<T, HV>(sv, v, b, j0, kvh, nkv, seq_k);
    __syncthreads();
    probs<H, HV>(sq, sk, sdo, sv, slse, sdelta, sp, sds, i0, j0, seq, seq_k, causal, scale);
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

template <int H, int HV>
struct TcLayout {
  static_assert(H % 16 == 0 && HV % 16 == 0, "head widths must be multiples of 16");
  // padded row strides (elements): the 8 rows of an ldmatrix hit 8 bank groups
  static constexpr int kS = H + 8;    // q and k tiles
  static constexpr int kSV = HV + 8;  // v and do tiles
  static constexpr int kT = kTile * kS;
  static constexpr int kTV = kTile * kSV;
  // stages of the ring of streamed tiles: two, but one at (192, 128), where
  // two would leave room for one block an SM (dkdv's registers allow two)
  static constexpr int kStages = H + HV > 256 ? 1 : 2;
  // a (q or k, do or v) pair of tiles; the streamed stage adds two rows of
  // floats (dkdv: the tile's lse and D)
  static constexpr size_t kPair = sizeof(bf16) * (kT + kTV);
  static constexpr size_t kStage = kPair + sizeof(float) * 2 * kTile;
  // the resident pair, its rows of floats (dq: lse and D) and the ring
  static constexpr size_t kBytes = kPair + sizeof(float) * 2 * kTile + kStages * kStage;
};

// 4-byte global -> shared copy; with valid == false the word is zeroed
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// acc (16 rows x 64 cols, C fragments) = A[a_row0, +16) . B[0, 64)^T over
// width W, A and B row-major (rows, W) tiles in shared memory of row stride S
template <int W, int S>
__device__ __forceinline__ void gemm_nt(float (&acc)[8][4], const bf16* a, int a_row0,
                                        const bf16* b, int lane) {
  const int a_off = (a_row0 + (lane & 15)) * S + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + a_off + kk * 16);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + np * 16 * S + b_off + kk * 16);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 rows x W) += P (16 x 64, A fragments) . C[0, 64) (a row-major
// (64, W) tile in shared memory of row stride S)
template <int W, int S>
__device__ __forceinline__ void gemm_pc(float (&acc)[W / 8][4], const uint32_t (&pf)[4][4],
                                        const bf16* c, int lane) {
  const int c_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * S + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dp = 0; dp < W / 16; ++dp) {
      uint32_t bc[4];
      ldmatrix_x4_trans(bc, c + kk * 16 * S + c_off + dp * 16);
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

// The (B, rows, N, W) operand's rows of head n of batch row b: base
// pointer (row stride N * W)
__device__ __forceinline__ const bf16* head_rows(const bf16* t, int b, int n, int rows,
                                                 int heads, int w) {
  return t + (static_cast<long long>(b) * rows * heads + n) * w;
}

// One block per (kv head and batch row, 64-key tile), the key tiles in
// order (when causal the first sees the most query tiles, so the heaviest
// blocks of every head start first); warp w owns keys [16 w, 16 w + 16)
// of the tile and sums their dK and dV rows in registers over the g query
// heads and the query tiles that see the key tile.  K and V stay in shared
// memory; the query tiles (Q, dO, lse, D) stream through the ring of
// cp.async stages, the next tile landing while this one is computed.  Per
// query tile (S^T = K Q^T; rows keys, columns queries): P^T = exp2(S^T
// scale log2e - lse log2e), dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T
// - D), dK += dS^T Q; P^T and dS^T become the A
// operands in registers, rounded to bf16 (the forward's P is too).  Keys
// past Sk are rows of this block that are never written; queries past S
// are masked.
template <int H, int HV>
__global__ void __launch_bounds__(kThreads)
dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int seq, int seq_k, int nq,
               int nkv, int causal, float scale) {
  using L = TcLayout<H, HV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + L::kT;
  unsigned char* ring = smem_raw + L::kPair + sizeof(float) * 2 * kTile;

  const int kvh = blockIdx.x % nkv, b = blockIdx.x / nkv, g = nq / nkv;
  const int j0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, quad = lane & 3;
  const long long q_rs = static_cast<long long>(nq) * H, do_rs = static_cast<long long>(nq) * HV;
  const long long k_rs = static_cast<long long>(nkv) * H, v_rs = static_cast<long long>(nkv) * HV;
  const float scale_log2 = scale * kLog2e;
  copy_rows_async<kTile, H, kThreads>(sk, L::kS, head_rows(k, b, kvh, seq_k, nkv, H), k_rs, j0,
                                      seq_k);
  copy_rows_async<kTile, HV, kThreads>(sv, L::kSV, head_rows(v, b, kvh, seq_k, nkv, HV), v_rs,
                                       j0, seq_k);
  cp_async_commit();

  // the walk: for each of the g heads, the query tiles at or past the keys
  // (causal) or every query tile (full)
  const int first = causal ? j0 : 0;
  const int per_head = (seq - first + kTile - 1) / kTile;
  const int total = g * per_head;
  auto issue = [&](int t) {
    const int gi = t / per_head, i0 = first + (t - gi * per_head) * kTile, n = kvh * g + gi;
    bf16* sq = reinterpret_cast<bf16*>(ring + (t % L::kStages) * L::kStage);
    bf16* sdo = sq + L::kT;
    float* slse = reinterpret_cast<float*>(sdo + L::kTV);
    copy_rows_async<kTile, H, kThreads>(sq, L::kS, head_rows(q, b, n, seq, nq, H), q_rs, i0, seq);
    copy_rows_async<kTile, HV, kThreads>(sdo, L::kSV, head_rows(dout, b, n, seq, nq, HV), do_rs,
                                         i0, seq);
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      const bool ok = i0 + r < seq;
      const long long at = ok ? (static_cast<long long>(b) * nq + n) * seq + i0 + r : 0;
      cp_async_4(slse + r, lse + at, ok);
      cp_async_4(slse + kTile + r, delta + at, ok);
    }
    cp_async_commit();
  };

  float dka[H / 8][4], dva[HV / 8][4];
#pragma unroll
  for (int i = 0; i < H / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < HV / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[i][e] = 0.f;
  const int key0 = warp * 16 + (lane >> 2);  // this lane's keys (in the tile): key0, key0 + 8

  if (L::kStages > 1) issue(0);
  for (int t = 0; t < total; ++t) {
    if (L::kStages == 1) {
      issue(t);
      cp_async_wait<0>();
    } else if (t + 1 < total) {
      issue(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and K, V) landed for every thread
    const int i0 = first + (t % per_head) * kTile;
    const bf16* sq = reinterpret_cast<const bf16*>(ring + (t % L::kStages) * L::kStage);
    const bf16* sdo = sq + L::kT;
    const float* slse = reinterpret_cast<const float*>(sdo + L::kTV);
    const float* sdelta = slse + kTile;
    const bool diag = causal && i0 == j0;

    float s[8][4];  // S^T, then P^T
    gemm_nt<H, L::kS>(s, sk, warp * 16, sq, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * quad + (e & 1);  // query (in the tile)
        const float p = exp2f(s[nt][e] * scale_log2 - slse[col] * kLog2e);
        s[nt][e] = i0 + col >= seq || (diag && col < key0 + (e >> 1) * 8) ? 0.f : p;
      }
    uint32_t pf[4][4];
    to_a_frags(pf, s);
    gemm_pc<HV, L::kSV>(dva, pf, sdo, lane);

    float dp[8][4];  // dP^T, then dS^T
    gemm_nt<HV, L::kSV>(dp, sv, warp * 16, sdo, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = s[nt][e] * (dp[nt][e] - sdelta[nt * 8 + 2 * quad + (e & 1)]);
    uint32_t dsf[4][4];
    to_a_frags(dsf, dp);
    gemm_pc<H, L::kS>(dka, dsf, sq, lane);
    __syncthreads();  // tile t's readers are done: its stage takes the next tile
  }

  const long long kv_at = static_cast<long long>(b) * seq_k * nkv + kvh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = j0 + key0 + 8 * r;
    if (key >= seq_k) continue;
    const long long at = kv_at + static_cast<long long>(key) * nkv;
#pragma unroll
    for (int dn = 0; dn < H / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(dk + at * H + dn * 8 + 2 * quad) =
          __floats2bfloat162_rn(dka[dn][2 * r] * scale, dka[dn][2 * r + 1] * scale);
#pragma unroll
    for (int dn = 0; dn < HV / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(dv + at * HV + dn * 8 + 2 * quad) =
          __floats2bfloat162_rn(dva[dn][2 * r], dva[dn][2 * r + 1]);
  }
}

// One block per (query head and batch row, 64-query tile), the last query
// tile first (when causal it sees the most key tiles); warp w owns query
// rows [16 w, 16 w + 16) and sums their dQ in registers over the key tiles
// up to the diagonal (causal) or over all Sk keys (full).  Q, dO, lse and
// D stay in shared memory; the key tiles (K, V) stream through the ring
// of cp.async stages.  Per key tile: S = Q K^T, P = exp2(S scale
// log2e - lse log2e), dP = dO V^T, dS = P (dP - D), dQ += dS K.  Keys past
// Sk (the ragged last tile) get P = 0.
template <int H, int HV>
__global__ void __launch_bounds__(kThreads)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const bf16* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, bf16* __restrict__ dq, int seq, int seq_k, int nq,
             int nkv, int causal, float scale) {
  using L = TcLayout<H, HV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + L::kT;
  float* slse = reinterpret_cast<float*>(sdo + L::kTV);
  float* sdelta = slse + kTile;
  unsigned char* ring = smem_raw + L::kPair + sizeof(float) * 2 * kTile;

  const int n = blockIdx.x % nq, b = blockIdx.x / nq, kvh = n / (nq / nkv);
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, quad = lane & 3;
  const long long q_rs = static_cast<long long>(nq) * H, do_rs = static_cast<long long>(nq) * HV;
  const long long k_rs = static_cast<long long>(nkv) * H, v_rs = static_cast<long long>(nkv) * HV;
  const float scale_log2 = scale * kLog2e;
  copy_rows_async<kTile, H, kThreads>(sq, L::kS, head_rows(q, b, n, seq, nq, H), q_rs, i0, seq);
  copy_rows_async<kTile, HV, kThreads>(sdo, L::kSV, head_rows(dout, b, n, seq, nq, HV), do_rs,
                                       i0, seq);
  cp_async_commit();
  load_tc_rows(slse, sdelta, lse, delta, b, n, nq, i0, seq);

  const bf16* kb = head_rows(k, b, kvh, seq_k, nkv, H);
  const bf16* vb = head_rows(v, b, kvh, seq_k, nkv, HV);
  const int j_end = causal ? i0 + 1 : seq_k;  // causal: up to the diagonal tile
  const int total = (j_end + kTile - 1) / kTile;
  auto issue = [&](int t) {
    bf16* sk = reinterpret_cast<bf16*>(ring + (t % L::kStages) * L::kStage);
    copy_rows_async<kTile, H, kThreads>(sk, L::kS, kb, k_rs, t * kTile, seq_k);
    copy_rows_async<kTile, HV, kThreads>(sk + L::kT, L::kSV, vb, v_rs, t * kTile, seq_k);
    cp_async_commit();
  };

  float dqa[H / 8][4];
#pragma unroll
  for (int i = 0; i < H / 8; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;
  const int row0 = warp * 16 + (lane >> 2);  // this lane's rows (in the tile): row0, row0 + 8

  if (L::kStages > 1) issue(0);
  for (int t = 0; t < total; ++t) {
    if (L::kStages == 1) {
      issue(t);
      cp_async_wait<0>();
    } else if (t + 1 < total) {
      issue(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q, dO, lse, D) landed for every thread
    const int j0 = t * kTile;
    const bf16* sk = reinterpret_cast<const bf16*>(ring + (t % L::kStages) * L::kStage);
    const bf16* sv = sk + L::kT;
    const bool diag = causal && j0 == i0;
    const int cols = seq_k - j0;  // keys of the tile inside Sk

    float s[8][4];  // S, then P
    gemm_nt<H, L::kS>(s, sq, warp * 16, sk, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8, col = nt * 8 + 2 * quad + (e & 1);
        const float p = exp2f(s[nt][e] * scale_log2 - slse[row]);
        s[nt][e] = (diag && col > row) || col >= cols ? 0.f : p;
      }
    float dp[8][4];  // dP, then dS
    gemm_nt<HV, L::kSV>(dp, sdo, warp * 16, sv, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = s[nt][e] * (dp[nt][e] - sdelta[row0 + (e >> 1) * 8]);
    uint32_t dsf[4][4];
    to_a_frags(dsf, dp);
    gemm_pc<H, L::kS>(dqa, dsf, sk, lane);
    __syncthreads();  // tile t's readers are done: its stage takes the next tile
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

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int b, seq, seq_k, nq, nkv, causal;
  float scale;
};

template <int H, int HV>
int launch_tc(const Args& a, cudaStream_t s) {
  constexpr size_t bytes = TcLayout<H, HV>::kBytes;
  cudaError_t err = allow_shared_bytes(dkdv_tc_kernel<H, HV>, bytes);
  if (err == cudaSuccess) err = allow_shared_bytes(dq_tc_kernel<H, HV>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* qt = static_cast<const bf16*>(a.q);
  const bf16* kt = static_cast<const bf16*>(a.k);
  const bf16* vt = static_cast<const bf16*>(a.v);
  const bf16* dot = static_cast<const bf16*>(a.dout);
  const int rows = a.b * a.seq * a.nq;
  delta_kernel<bf16, HV><<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const bf16*>(a.o), dot, a.delta, rows, a.seq, a.nq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_tc_kernel<H, HV><<<dim3(a.nkv * a.b, (a.seq_k + kTile - 1) / kTile), kThreads, bytes, s>>>(
      qt, kt, vt, dot, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.seq,
      a.seq_k, a.nq, a.nkv, a.causal, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_tc_kernel<H, HV><<<dim3(a.nq * a.b, (a.seq + kTile - 1) / kTile), kThreads, bytes, s>>>(
      qt, kt, vt, dot, a.lse, a.delta, static_cast<bf16*>(a.dq), a.seq, a.seq_k, a.nq, a.nkv,
      a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int H, int HV>
int launch_f32(const Args& a, cudaStream_t s) {
  using T = float;
  constexpr size_t bytes = BwdLayout<H, HV>::kBytes;
  cudaError_t err = allow_shared_bytes(dkdv_kernel<T, H, HV>, bytes);
  if (err == cudaSuccess) err = allow_shared_bytes(dq_kernel<T, H, HV>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(a.q);
  const T* kt = static_cast<const T*>(a.k);
  const T* vt = static_cast<const T*>(a.v);
  const T* dot = static_cast<const T*>(a.dout);
  const int rows = a.b * a.seq * a.nq;
  delta_kernel<T, HV><<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const T*>(a.o), dot, a.delta, rows, a.seq, a.nq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, H, HV><<<dim3((a.seq_k + kB - 1) / kB, a.nkv, a.b), kThreads, bytes, s>>>(
      qt, kt, vt, dot, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.seq,
      a.seq_k, a.nq, a.nkv, a.causal, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, H, HV><<<dim3((a.seq + kB - 1) / kB, a.nq, a.b), kThreads, bytes, s>>>(
      qt, kt, vt, dot, a.lse, a.delta, static_cast<T*>(a.dq), a.seq, a.seq_k, a.nq, a.nkv,
      a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_widths(const Args& a, int h, int hv, int dtype, cudaStream_t s) {
#define REPRO_FLASH_BWD(LAUNCH, H, HV) \
  if (h == H && hv == HV) return LAUNCH<H, HV>(a, s);
  if (dtype == kBFloat16) {
    REPRO_FLASH_BWD(launch_tc, 64, 64)
    REPRO_FLASH_BWD(launch_tc, 112, 112)
    REPRO_FLASH_BWD(launch_tc, 128, 128)
    REPRO_FLASH_BWD(launch_tc, 192, 128)
  } else if (dtype == kFloat32) {
    REPRO_FLASH_BWD(launch_f32, 16, 16)
    REPRO_FLASH_BWD(launch_f32, 24, 16)
    REPRO_FLASH_BWD(launch_f32, 32, 32)
    REPRO_FLASH_BWD(launch_f32, 64, 64)
    REPRO_FLASH_BWD(launch_f32, 112, 112)
    REPRO_FLASH_BWD(launch_f32, 128, 128)
    REPRO_FLASH_BWD(launch_f32, 192, 128)
  }
#undef REPRO_FLASH_BWD
  return static_cast<int>(cudaErrorInvalidValue);  // no instantiation for (h, hv)
}

}  // namespace

// q, o, do, dq (B, S, Nq, .), k, v, dk, dv (B, Sk, Nkv, .), all contiguous
// and of one dtype, 16-byte aligned in bf16; q, k, dq, dk of width H, v, o,
// do, dv of width Hv; lse and delta (the D scratch) fp32 (B, Nq, S)
// contiguous; Nkv divides Nq; Sk = S when causal.  bf16 runs on the tensor
// cores, fp32 on the CUDA cores, at the (H, Hv) pairs of launch_widths.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int b,
                                          int seq, int seq_k, int nq, int nkv, int h, int hv,
                                          int causal, float scale, int dtype, void* stream) {
  if (nkv < 1 || nq % nkv || seq_k < 1 || (causal && seq_k != seq))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  k,  v,  o,    dout, static_cast<const float*>(lse), static_cast<float*>(delta),
               dq, dk, dv, b,    seq,  seq_k, nq, nkv, causal, scale};
  return launch_widths(a, h, hv, dtype, static_cast<cudaStream_t>(stream));
}
