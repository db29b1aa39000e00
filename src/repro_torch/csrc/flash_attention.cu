// Causal (or full) GQA attention for prefill, flash style, with a value
// width Hv that may differ from the query/key width H (MLA prefill: H 192,
// Hv 128) and, when not causal, a key/value length Sk that may differ from
// the query length S (enc-dec cross-attention: S the prompt bucket, Sk the
// encoder's 1500 frames).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention
// (_flash_kernel), the TPU kernel with a (B, Nq, S/bq, S/bk) grid whose KV
// axis runs sequentially with the online softmax in VMEM scratch.
//
// Bound on this card: operations at long S, latency at the served ones.
// Causal prefill does ~2 * S^2 * Nq * (H + Hv) / 2 flops on
// 2 * S * (Nq + Nkv) * H elements read or written, ~S/2 flops per byte --
// above the bf16 ridge from a few hundred tokens on.  At the prefill
// buckets (S <= 256, at most 4 rows) a block walks at most 4 KV tiles, so
// what costs is the latency of each tile (its copy, its products, its
// softmax), not the tensor cores' rate.  Full (encoder) attention at S =
// Sk = 1500 does 4 * S^2 * Nq * H flops on 4 * S * Nq * H elements, ~S/2
// flops per byte: there the tensor cores' rate bounds it.
//
// Two kernels, chosen by dtype in flash_attention_launch:
//
// bf16, tensor cores (flash_tc_kernel), FlashAttention-2 style.  One block
// per (64 query rows, query head, batch row); each group of 16 query rows
// belongs to one warp (4 warps) or, when the grid leaves SMs idle, to two
// warps that take half the keys of every tile each (8 warps) and merge
// their softmax states through shared memory at the end.  Q is copied
// once and held in registers as mma A fragments (ldmatrix).  K and V tiles
// of 64 positions stream through a ring of 2 (4 when the grid leaves SMs
// idle) shared buffers with 16-byte cp.async, K and V in separate copy
// groups, so the scores of a tile start as soon as its K lands and later
// tiles stay in flight; rows are padded by 16 bytes so the 8 row
// addresses of every ldmatrix fall in 8 distinct bank groups.  S = Q K^T
// and O += P V run on mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  The
// online softmax lives in registers: each lane holds two rows' values,
// row max and sum are quad shuffles, and P is rounded to bf16 in registers
// to become PV's A operand (the plain version rounds the normalised
// probabilities instead; both stay within the bf16 tolerance).  Tiles
// wholly above the diagonal are never loaded, and only the diagonal tile
// and the ragged edges at S (query rows) and Sk (keys) are masked; in the
// diagonal tile a warp skips the key groups past its last row, and full
// tiles take a branch-free path.  Query rows past S and key rows past Sk
// are zero-filled by the copies, so any S and Sk work.  mma.sync, not
// wgmma: at the decoder's shapes (S <= 256, at most 4 rows) the time goes
// to each tile's latency, which a 64-row warpgroup tile does not shorten,
// and mma.sync needs no descriptor layouts or warpgroup barriers.  Head
// widths are template parameters; the widths of the repo's attention
// configs are instantiated (H = Hv in 64, 112, 128; H 192 / Hv 128; and
// 16, the reduced configs' that the serving launcher runs), and the
// launch refuses any other.  Every global base and row stride must be
// 16-byte aligned (the wrapper checks).
//
// Both kernels can also write each query row's log-sum-exp of its scaled
// scores, lse = log(sum_j exp(scale * q.k_j)) in the natural log, fp32,
// (B, Nq, S): the backward kernel (flash_attention_bwd.cu) recomputes the
// probabilities from it.  With a null lse pointer nothing more is done.
//
// fp32, CUDA cores (flash_kernel): fp32 inputs cannot use bf16 tensor
// cores and must hold 1e-5, so they keep the first kernel: one block per
// (16 query rows, head, row), KV tiles of 32 positions up to the diagonal,
// scores and PV on the CUDA cores from shared memory with the online
// softmax of online_softmax.cuh.  The key tile's row stride is H+1 floats
// so the 32 lanes reading 32 keys at one head dim hit 32 banks.
#include "online_softmax.cuh"
#include "tensor_core.cuh"

namespace {

struct Strides {
  long long b, s, n;  // batch, position and head strides (the head dim is unit-stride)
};

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kBQ = 16;  // query rows per block
constexpr int kBK = 32;  // key positions per tile

int flash_smem_floats(int h, int hv) {
  return kBQ * h + kBK * (h + 1) + kBK * hv + kBQ * kBK + softmax_state_floats(kBQ, hv);
}

__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
             int seq, int seq_k, int nq,
             int nkv, int h, int hv, Strides qs, Strides ks, Strides vs, Strides os, int causal,
             float scale) {
  extern __shared__ float smem[];
  const int i0 = blockIdx.x * kBQ, n = blockIdx.y, b = blockIdx.z;
  const int kvh = n / (nq / nkv);
  float* sq = smem;               // (BQ, h)
  float* sk = sq + kBQ * h;       // (BK, h+1)
  float* sv = sk + kBK * (h + 1); // (BK, hv)
  float* ss = sv + kBK * hv;      // (BQ, BK)
  SoftmaxState st;
  carve_softmax_state(ss + kBQ * kBK, kBQ, hv, &st);

  const float* qb = q + b * qs.b + n * qs.n;
  const float* kb = k + b * ks.b + kvh * ks.n;
  const float* vb = v + b * vs.b + kvh * vs.n;
  for (int i = threadIdx.x; i < kBQ * h; i += kThreads) {
    const int r = i / h, d = i - r * h;
    sq[i] = i0 + r < seq ? qb[static_cast<long long>(i0 + r) * qs.s + d] : 0.f;
  }
  online_softmax_init(st, kBQ, hv);
  __syncthreads();

  const int last_row = min(i0 + kBQ, seq) - 1;
  const int kv_end = causal ? last_row + 1 : seq_k;  // exclusive
  for (int j0 = 0; j0 < kv_end; j0 += kBK) {
    for (int i = threadIdx.x; i < kBK * h; i += kThreads) {
      const int c = i / h, d = i - c * h;
      sk[c * (h + 1) + d] =
          j0 + c < seq_k ? kb[static_cast<long long>(j0 + c) * ks.s + d] : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * hv; i += kThreads) {
      const int c = i / hv, d = i - c * hv;
      sv[i] = j0 + c < seq_k ? vb[static_cast<long long>(j0 + c) * vs.s + d] : 0.f;
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
      const bool ok = col < seq_k && (!causal || col <= row);
      ss[i] = ok ? a * scale : kNegInf;
    }
    __syncthreads();
    online_softmax_block(st, ss, sv, kBQ, kBK, hv);
  }

  float* ob = out + b * os.b + n * os.n;
  for (int i = threadIdx.x; i < kBQ * hv; i += kThreads) {
    const int r = i / hv, d = i - r * hv;
    if (i0 + r < seq)
      ob[static_cast<long long>(i0 + r) * os.s + d] = online_softmax_finalize(st, i, hv);
  }
  if (lse != nullptr && threadIdx.x < kBQ && i0 + threadIdx.x < seq)
    lse[(static_cast<long long>(b) * nq + n) * seq + i0 + threadIdx.x] =
        st.m[threadIdx.x] + logf(fmaxf(st.l[threadIdx.x], 1e-30f));
}

int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int b,
               int seq,
               int seq_k, int nq, int nkv, int h, int hv, Strides qs, Strides ks, Strides vs,
               Strides os, int causal, float scale, cudaStream_t s) {
  const size_t bytes = sizeof(float) * flash_smem_floats(h, hv);
  cudaError_t err = allow_shared_bytes(flash_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kBQ - 1) / kBQ, nq, b);
  flash_kernel<<<grid, kThreads, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, seq, seq_k, nq, nkv, h, hv, qs,
      ks, vs, os, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // query rows per block = key positions per tile

template <int H, int HV, int kStages>
struct TcLayout {
  static_assert(H % 16 == 0 && HV % 16 == 0, "head widths must be multiples of 16");
  static constexpr int kKS = H + 8;   // padded row stride of the Q and K tiles
  static constexpr int kVS = HV + 8;  // and of the V tile (elements)
  static constexpr int kQ = kTile * kKS;
  static constexpr int kK = kTile * kKS;
  static constexpr int kV = kTile * kVS;
  static constexpr size_t kBytes = sizeof(bf16) * (kQ + kStages * (kK + kV));
  // the key-half merge reuses the K buffers: (64, HV) accumulators, m, l
  static_assert(sizeof(float) * (kTile * HV + 2 * kTile) <= sizeof(bf16) * kStages * kK,
                "the merge scratch must fit in the K buffers");
};

// S = Q K^T over the key groups [g0, g0 + n) of a tile, n = kGroups when
// kAll (no branch, so the next group's fragment loads can overlap the
// products) and `groups` otherwise (the diagonal tile).
template <int H, int kGroups, int kKS, bool kAll>
__device__ __forceinline__ void qk_tile(float (&s)[2 * kGroups][4],
                                        const uint32_t (&qf)[H / 16][4], const bf16* kt, int g0,
                                        int groups, int k_off) {
#pragma unroll
  for (int nt = 0; nt < 2 * kGroups; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < kGroups; ++np) {
      if (kAll || np < groups) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kt + (g0 + np) * 16 * kKS + k_off + kk * 16);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }
  }
}

// O += P V over the same key groups
template <int HV, int kGroups, int kVS, bool kAll>
__device__ __forceinline__ void pv_tile(float (&o)[HV / 8][4], const uint32_t (&pf)[kGroups][4],
                                        const bf16* vt, int g0, int groups, int v_off) {
#pragma unroll
  for (int kk = 0; kk < kGroups; ++kk) {
    if (kAll || kk < groups) {
#pragma unroll
      for (int dp = 0; dp < HV / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + (g0 + kk) * 16 * kVS + v_off + dp * 16);
        mma_bf16(o[2 * dp], pf[kk], bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pf[kk], bv[2], bv[3]);
      }
    }
  }
}

// KS warps share each 16-row group and split every key tile between them
// (KS = 1: 4 warps, each owning whole tiles; KS = 2: 8 warps, each owning
// 32 keys of every tile); their softmax states merge at the end.
template <int H, int HV, int KS, int kStages>
__global__ void __launch_bounds__(128 * KS)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                int seq, int seq_k, int nq, int nkv, Strides qs, Strides ks, Strides vs,
                Strides os, int causal, float scale_log2) {
  using L = TcLayout<H, HV, kStages>;
  constexpr int kThreadsT = 128 * KS;
  constexpr int kAhead = 2 * kStages - 3;  // copy groups committed after K(j) or V(j)
  constexpr int kGroups = 4 / KS;  // 16-key groups of a tile per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // (64, H+8)
  bf16* sk = sq + L::kQ;                          // kStages x (64, H+8)
  bf16* sv = sk + kStages * L::kK;                // kStages x (64, HV+8)

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal sweeps start first
  const int i0 = qt * kTile, n = blockIdx.y, b = blockIdx.z;
  const int kvh = n / (nq / nkv);
  const bf16* qb = q + b * qs.b + n * qs.n;
  const bf16* kb = k + b * ks.b + kvh * ks.n;
  const bf16* vb = v + b * vs.b + kvh * vs.n;
  const int ntiles = causal ? qt + 1 : (seq_k + kTile - 1) / kTile;

  // A ring of kStages K and V tile buffers.  Copy groups, oldest first:
  // [Q, K0], [V0], ..., [K(kStages-2)], [V(kStages-2)]; then per tile j,
  // [K(j+kStages-1)] once K(j) has landed and [V(j+kStages-1)] once V(j)
  // has -- empty groups past the last tile keep the counts uniform.  The
  // scores of tile j overlap V(j)'s copy and the later tiles'.
  copy_rows_async<kTile, H, kThreadsT>(sq, L::kKS, qb, qs.s, i0, seq);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles)
      copy_rows_async<kTile, H, kThreadsT>(sk + t * L::kK, L::kKS, kb, ks.s, t * kTile, seq_k);
    cp_async_commit();
    if (t < ntiles)
      copy_rows_async<kTile, HV, kThreadsT>(sv + t * L::kV, L::kVS, vb, vs.s, t * kTile, seq_k);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp & 3;               // this warp's 16-row group
  const int g0 = (warp >> 2) * kGroups;  // its first 16-key group of a tile
  const int quad = lane & 3;
  const int row0 = i0 + rw * 16 + (lane >> 2);  // this lane's rows: row0, row0 + 8
  // ldmatrix lane offsets: A (Q) rows 0-15 x k halves; B (K) two 8-key
  // n-tiles x k halves; B^T (V) two k halves x 8-wide value n-tiles
  const int a_off = (rw * 16 + (lane & 15)) * L::kKS + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * L::kKS + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * L::kVS + (lane >> 4) * 8;

  uint32_t qf[H / 16][4];
  float o[HV / 8][4];
#pragma unroll
  for (int i = 0; i < HV / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this lane's partial row sums

  for (int j = 0; j < ntiles; ++j) {
    const int buf = j % kStages;
    const int next = j + kStages - 1;  // the tile whose copy starts now
    const int nbuf = next % kStages;   // the buffer tile j-1 used
    cp_async_wait<kAhead>();  // K(j) (and Q) landed; V(j) may be in flight
    __syncthreads();
    if (next < ntiles)
      copy_rows_async<kTile, H, kThreadsT>(sk + nbuf * L::kK, L::kKS, kb, ks.s, next * kTile,
                                           seq_k);
    cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) ldmatrix_x4(qf[kk], sq + a_off + kk * 16);
    }
    const bf16* kt = sk + buf * L::kK;
    const bf16* vt = sv + buf * L::kV;
    const int col0 = j * kTile + g0 * 16;  // this warp's first key
    const bool diag = causal && j == qt;
    // key groups this warp needs: in the diagonal tile none past its last
    // row (rw * 16 + 15), and none at or past Sk; a warp with none skips
    // the tile (its state is unchanged)
    const int groups = diag ? min(kGroups, rw + 1 - g0) : kGroups;
    const bool work = groups > 0 && col0 < seq_k;
    uint32_t pf[kGroups][4];  // P as A fragments: one k-step per key group
    if (work) {
      float s[2 * kGroups][4];
      if (diag)
        qk_tile<H, kGroups, L::kKS, false>(s, qf, kt, g0, groups, k_off);
      else
        qk_tile<H, kGroups, L::kKS, true>(s, qf, kt, g0, groups, k_off);

      // scale into the log2 domain; mask the diagonal tile and the ragged edge
      const bool masked = diag || col0 + 16 * kGroups > seq_k;
#pragma unroll
      for (int nt = 0; nt < 2 * kGroups; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * scale_log2;
          if (masked) {
            const int row = row0 + (e >> 1) * 8;
            const int col = col0 + nt * 8 + 2 * quad + (e & 1);
            if (col >= seq_k || (causal && col > row)) x = kNegInf;
          }
          s[nt][e] = x;
        }
      }

      // online softmax in registers: rows row0 (e 0, 1) and row0 + 8 (e 2, 3)
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_run[r];
#pragma unroll
        for (int nt = 0; nt < 2 * kGroups; ++nt)
          mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
        mx = quad_max(mx);
        alpha[r] = exp2f(m_run[r] - mx);
        m_run[r] = mx;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 2 * kGroups; ++nt) {
        const float p0 = exp2f(s[nt][0] - m_run[0]);
        const float p1 = exp2f(s[nt][1] - m_run[0]);
        const float p2 = exp2f(s[nt][2] - m_run[1]);
        const float p3 = exp2f(s[nt][3] - m_run[1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pf[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
        pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
      for (int dn = 0; dn < HV / 8; ++dn) {
        o[dn][0] *= alpha[0];
        o[dn][1] *= alpha[0];
        o[dn][2] *= alpha[1];
        o[dn][3] *= alpha[1];
      }
    }
    cp_async_wait<kAhead>();  // V(j) landed; later tiles may be in flight
    __syncthreads();
    if (next < ntiles)
      copy_rows_async<kTile, HV, kThreadsT>(sv + nbuf * L::kV, L::kVS, vb, vs.s, next * kTile,
                                            seq_k);
    cp_async_commit();
    if (work) {
      if (diag)
        pv_tile<HV, kGroups, L::kVS, false>(o, pf, vt, g0, groups, v_off);
      else
        pv_tile<HV, kGroups, L::kVS, true>(o, pf, vt, g0, groups, v_off);
    }
  }

  cp_async_wait<0>();  // only empty groups remain; the merge reuses the K ring
  float l_tot[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_tot[r] = quad_sum(l_run[r]);
  if (KS == 2) {
    // the second key half hands (m, l, acc) to the first through the K
    // buffers, which the loop no longer reads; the first merges them
    float* so = reinterpret_cast<float*>(sk);  // (64, HV)
    float* sm = so + kTile * HV;               // (64,)
    float* sl = sm + kTile;                    // (64,)
    const int r_loc = rw * 16 + (lane >> 2);
    if (warp >= 4) {
#pragma unroll
      for (int dn = 0; dn < HV / 8; ++dn) {
        const int col = dn * 8 + 2 * quad;
        *reinterpret_cast<float2*>(so + r_loc * HV + col) = make_float2(o[dn][0], o[dn][1]);
        *reinterpret_cast<float2*>(so + (r_loc + 8) * HV + col) =
            make_float2(o[dn][2], o[dn][3]);
      }
      if (quad == 0) {
        sm[r_loc] = m_run[0];
        sm[r_loc + 8] = m_run[1];
        sl[r_loc] = l_tot[0];
        sl[r_loc + 8] = l_tot[1];
      }
    }
    __syncthreads();
    if (warp >= 4) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m2 = sm[r_loc + 8 * r];
      const float mx = fmaxf(m_run[r], m2);
      const float w1 = exp2f(m_run[r] - mx), w2 = exp2f(m2 - mx);
      l_tot[r] = l_tot[r] * w1 + sl[r_loc + 8 * r] * w2;
      m_run[r] = mx;  // the merged state's max, for the lse
#pragma unroll
      for (int dn = 0; dn < HV / 8; ++dn) {
        const float2 x = *reinterpret_cast<const float2*>(so + (r_loc + 8 * r) * HV + dn * 8 +
                                                          2 * quad);
        o[dn][2 * r] = o[dn][2 * r] * w1 + x.x * w2;
        o[dn][2 * r + 1] = o[dn][2 * r + 1] * w1 + x.y * w2;
      }
    }
  }

  if (lse != nullptr && quad == 0) {
    // natural log: the scores' max and sum live in the log2 domain
    float* lb = lse + (static_cast<long long>(b) * nq + n) * seq;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < seq)
        lb[row0 + 8 * r] = (m_run[r] + log2f(fmaxf(l_tot[r], 1e-30f))) * kLn2;
  }
  bf16* ob = out + b * os.b + n * os.n;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(l_tot[r], 1e-30f);
#pragma unroll
  for (int dn = 0; dn < HV / 8; ++dn) {
    const int col = dn * 8 + 2 * quad;
    if (row0 < seq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * os.s + col) =
          __floats2bfloat162_rn(o[dn][0] * inv[0], o[dn][1] * inv[0]);
    if (row0 + 8 < seq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (row0 + 8) * os.s + col) =
          __floats2bfloat162_rn(o[dn][2] * inv[1], o[dn][3] * inv[1]);
  }
}

template <int H, int HV, int KS, int kStages>
int launch_tc(const void* q, const void* k, const void* v, void* out, float* lse, int b, int seq,
              int seq_k,
              int nq, int nkv, Strides qs, Strides ks, Strides vs, Strides os, int causal,
              float scale, cudaStream_t s) {
  constexpr size_t bytes = TcLayout<H, HV, kStages>::kBytes;
  cudaError_t err = allow_shared_bytes(flash_tc_kernel<H, HV, KS, kStages>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kTile - 1) / kTile, nq, b);
  flash_tc_kernel<H, HV, KS, kStages><<<grid, 128 * KS, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, seq, seq_k, nq, nkv, qs, ks, vs, os, causal,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// Two configurations of the tensor-core kernel, chosen from the grid:
// when every block has an SM of its own and walks at least two KV tiles
// (a single prefill row; a cross-attention prefill over 1500 frames), the
// block's serial sweep is the whole kernel, so 8 warps split each tile's
// keys and a 4-deep ring keeps the sweep's next tiles in flight; otherwise
// 4 warps and a 2-deep ring leave room for two blocks per SM (the batched
// buckets, the encoder).
template <int H, int HV>
int launch_widths(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                  int seq,
                  int seq_k, int nq, int nkv, Strides qs, Strides ks, Strides vs, Strides os,
                  int causal, float scale, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kv_tiles = (seq_k + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>((seq + kTile - 1) / kTile) * nq * b;
  if (kv_tiles > 1 && blocks <= sms)
    return launch_tc<H, HV, 2, 4>(q, k, v, out, lse, b, seq, seq_k, nq, nkv, qs, ks, vs, os,
                                  causal, scale, s);
  return launch_tc<H, HV, 1, 2>(q, k, v, out, lse, b, seq, seq_k, nq, nkv, qs, ks, vs, os,
                                causal, scale, s);
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                int seq,
                int seq_k, int nq, int nkv, int h, int hv, Strides qs, Strides ks, Strides vs,
                Strides os, int causal, float scale, cudaStream_t s) {
#define REPRO_FLASH_TC(H, HV)                                                             \
  if (h == H && hv == HV)                                                                 \
    return launch_widths<H, HV>(q, k, v, out, lse, b, seq, seq_k, nq, nkv, qs, ks, vs, os, \
                                causal, scale, s);
  REPRO_FLASH_TC(16, 16)
  REPRO_FLASH_TC(64, 64)
  REPRO_FLASH_TC(112, 112)
  REPRO_FLASH_TC(128, 128)
  REPRO_FLASH_TC(192, 128)
#undef REPRO_FLASH_TC
  return static_cast<int>(cudaErrorInvalidValue);  // no instantiation for (h, hv)
}

}  // namespace

// q (B, S, Nq, H), k (B, Sk, Nkv, H), v (B, Sk, Nkv, Hv), out (B, S, Nq, Hv);
// each given by its batch/position/head strides, head dim unit-stride; Sk
// equals S when causal.  lse, when not null, receives each query row's
// natural-log log-sum-exp of its scaled scores, fp32 (B, Nq, S)
// contiguous.  fp32 runs on the CUDA cores; bf16 on the tensor cores, for
// the (H, Hv) pairs instantiated above only, with 16-byte aligned bases and
// strides.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      void* lse, int b, int seq, int seq_k, int nq, int nkv,
                                      int h, int hv,
                                      long long q_sb, long long q_ss, long long q_sn,
                                      long long k_sb, long long k_ss, long long k_sn,
                                      long long v_sb, long long v_ss, long long v_sn,
                                      long long o_sb, long long o_ss, long long o_sn,
                                      int causal, float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq_k < 1 || (causal && seq_k != seq)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sn}, ks{k_sb, k_ss, k_sn}, vs{v_sb, v_ss, v_sn},
      os{o_sb, o_ss, o_sn};
  if (dtype == kFloat32)
    return launch_f32(q, k, v, out, static_cast<float*>(lse), b, seq, seq_k, nq, nkv, h, hv, qs,
                      ks, vs, os, causal, scale, s);
  if (dtype == kBFloat16)
    return launch_bf16(q, k, v, out, static_cast<float*>(lse), b, seq, seq_k, nq, nkv, h, hv, qs,
                       ks, vs, os, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
