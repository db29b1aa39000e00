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
// Bound on this card: bytes in principle -- a step reads each row's live
// positions once, (R + PR) elements each, and does 2 * Nq * (2R + PR)
// flops per position, ~30 flops per bf16 byte at Nq 16 -- but at decode
// sizes (4 rows, a few hundred positions, 0.55 MB) latency: one block
// walking a row's tiles one after another leaves the card idle.
//
// Design: a split KV sweep (flash-decoding).  A tile is one pool block of
// BS positions.  Split s of a row covers tiles [s*T, (s+1)*T), T =
// tiles_per_split (a launch argument the wrapper fixes), and one block per
// (split, group of up to 16 heads, row) walks its tiles for all heads of
// the group, so each latent tile is read once per group (once per step at
// deepseek width, Nq 16).  A block writes its partial softmax state -- the
// running max m, the denominator l and the unnormalised accumulator over
// (heads, R), all fp32 -- to scratch; a second kernel (split_merge.cuh,
// shared with the GQA decode pair) merges the splits of each row in split
// order and writes o_lat.
//
// Split-boundary invariant: a split's positions depend only on tile
// indices and T, never on the table width W, the batch or the grid, and
// the merge sums splits in a fixed order.  So a row gives the same bits
// through a width-16 table of a batched step and through the width-32
// identity table of the unbatched dense cache, and paged equals the
// dense view exactly.  The grid is sized from W on the host (no read of
// `lengths`); splits at or past a row's last tile exit at once, and a row
// of length 0 merges no split and gives exactly 0.
//
// bf16 (mla_tc_kernel, R 512, PR 64, BS 16): heads are the M dimension of
// mma.sync.m16n8k16 -- 16 heads make one A tile, padded with zero query
// rows below 16.  Per tile, scores = [q_lat | q_rope] (16 x 576) times the
// tile's [c_kv | k_rope]^T (576 x 16): 36 k-steps, 9 per warp, their
// partial sums added through shared memory in warp order.  The softmax of
// the 16 x 16 scores is computed in registers by every warp alike, P is
// rounded to bf16 and PV = P (16 x 16) times the c_kv tile (16 x 512) runs
// as 64 n-tiles, 16 per warp, each warp owning 128 columns of the
// accumulator.  The tile is staged as one [c_kv | k_rope] row per position
// with 16-byte cp.async, double-buffered, rows padded by 16 bytes against
// ldmatrix bank conflicts; positions at or past the length are zero-filled
// and their scores masked.
//
// fp32 (mla_f32_kernel, any R, PR, BS): fp32 inputs must hold 1e-5, so the
// products stay on the CUDA cores -- one warp per (head, position) score,
// the online softmax of online_softmax.cuh with c_kv as the value tile --
// but take the same split and merge, so both dtypes share one structure.
#include "online_softmax.cuh"
#include "split_merge.cuh"
#include "tensor_core.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kHeads = 16;  // heads per block (one mma M tile)
constexpr int kF32Threads = 256;

__host__ __device__ inline int mla_smem_floats(int g, int r, int pr, int bs) {
  return g * (r + pr) + bs * (r + pr) + g * bs + softmax_state_floats(g, r);
}

__global__ void __launch_bounds__(kF32Threads)
mla_f32_kernel(const float* __restrict__ q_lat, const float* __restrict__ q_rope,
               const float* __restrict__ ckv, const float* __restrict__ krope,
               const int* __restrict__ tables, const int* __restrict__ lengths, Partials part,
               int nq, int r, int pr, int bs, int w, int tps, long long cb, long long ct,
               long long kb, long long kt, float scale) {
  extern __shared__ float smem[];
  const int split = blockIdx.x, h0 = blockIdx.y * kHeads, b = blockIdx.z;
  const int length = max(0, min(lengths[b], w * bs));
  const int ntiles = (length + bs - 1) / bs;
  const int t_begin = split * tps;
  if (t_begin >= ntiles) return;
  const int t_end = min(t_begin + tps, ntiles);
  const int g = min(kHeads, nq - h0);
  float* sql = smem;           // (g, r)   latent queries
  float* sqr = sql + g * r;    // (g, pr)  rope queries
  float* sc = sqr + g * pr;    // (bs, r)  c_kv tile: key part and value
  float* skr = sc + bs * r;    // (bs, pr) k_rope tile
  float* ss = skr + bs * pr;   // (g, bs)  scores, then probabilities
  SoftmaxState st;
  carve_softmax_state(ss + g * bs, g, r, &st);

  const long long row0 = static_cast<long long>(b) * nq + h0;  // first head's row
  for (int i = threadIdx.x; i < g * r; i += blockDim.x) sql[i] = q_lat[row0 * r + i];
  for (int i = threadIdx.x; i < g * pr; i += blockDim.x) sqr[i] = q_rope[row0 * pr + i];
  online_softmax_init(st, g, r);
  __syncthreads();

  const int* table = tables + static_cast<long long>(b) * w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int j = t_begin; j < t_end; ++j) {
    const int col0 = j * bs;
    const long long blk = table[j];
    // positions at or past the length load as 0 (their scores are masked;
    // a zero value keeps 0 * garbage out of the accumulator)
    for (int i = threadIdx.x; i < bs * r; i += blockDim.x) {
      const int t = i / r, d = i - t * r;
      sc[i] = col0 + t < length ? ckv[blk * cb + t * ct + d] : 0.f;
    }
    for (int i = threadIdx.x; i < bs * pr; i += blockDim.x) {
      const int t = i / pr, d = i - t * pr;
      skr[i] = col0 + t < length ? krope[blk * kb + t * kt + d] : 0.f;
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
  const long long prow = (static_cast<long long>(b) * part.ns + split) * nq + h0;
  for (int i = threadIdx.x; i < g * r; i += blockDim.x) part.acc[prow * r + i] = st.acc[i];
  for (int i = threadIdx.x; i < g; i += blockDim.x) {
    part.stats[(prow + i) * 2] = st.m[i];
    part.stats[(prow + i) * 2 + 1] = st.l[i];
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kR = 512, kPR = 64, kBS = 16;
constexpr int kKW = kR + kPR;     // key width, 576
constexpr int kRowS = kKW + 8;    // padded shared row stride (elements)
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kKSteps = kKW / 16 / kTcWarps;  // score k-steps per warp, 9
constexpr int kVTiles = kR / 8 / kTcWarps;    // PV n-tiles per warp, 16
constexpr int kTileElems = kBS * kRowS;
// shared: queries, two tiles, and the warps' partial scores
constexpr size_t kTcBytes =
    sizeof(bf16) * (kHeads * kRowS + 2 * kTileElems) + sizeof(float) * kTcWarps * 32 * 8;

// Copies one pool block's 16 positions as [c_kv | k_rope] rows; positions
// at or past `length` (col0 + t) are zero-filled and never read.
__device__ __forceinline__ void copy_latent_tile(bf16* dst, const bf16* ckv, const bf16* krope,
                                                 long long blk, long long cb, long long ct,
                                                 long long kb, long long kt, int col0,
                                                 int length) {
  constexpr int kChunks = kKW / 8;  // 72: 64 of c_kv, 8 of k_rope
  static_assert(kBS * kChunks % kTcThreads == 0, "copies must split evenly");
#pragma unroll
  for (int it = 0; it < kBS * kChunks / kTcThreads; ++it) {
    const int i = threadIdx.x + it * kTcThreads;
    const int t = i / kChunks, c = i - t * kChunks;
    const bool ok = col0 + t < length;
    const bf16* p = c < kR / 8 ? ckv + blk * cb + t * ct + c * 8
                               : krope + blk * kb + t * kt + (c - kR / 8) * 8;
    cp_async_16(dst + t * kRowS + c * 8, ok ? p : ckv, ok);
  }
}

__global__ void __launch_bounds__(kTcThreads)
mla_tc_kernel(const bf16* __restrict__ q_lat, const bf16* __restrict__ q_rope,
              const bf16* __restrict__ ckv, const bf16* __restrict__ krope,
              const int* __restrict__ tables, const int* __restrict__ lengths, Partials part,
              int nq, int w, int tps, long long cb, long long ct, long long kb, long long kt,
              float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);         // (16, 584) queries
  bf16* stile = sq + kHeads * kRowS;                     // 2 x (16, 584) tiles
  float* spart = reinterpret_cast<float*>(stile + 2 * kTileElems);  // (4 warps, 32 lanes, 8)

  const int split = blockIdx.x, h0 = blockIdx.y * kHeads, b = blockIdx.z;
  const int length = max(0, min(lengths[b], w * kBS));
  const int ntiles = (length + kBS - 1) / kBS;
  const int t_begin = split * tps;
  if (t_begin >= ntiles) return;
  const int t_end = min(t_begin + tps, ntiles);
  const int g = min(kHeads, nq - h0);
  const int* table = tables + static_cast<long long>(b) * w;

  // queries: 16 rows of [q_lat | q_rope], rows past the group zero
  {
    constexpr int kChunks = kKW / 8;
    const long long row0 = static_cast<long long>(b) * nq + h0;
#pragma unroll
    for (int it = 0; it < kHeads * kChunks / kTcThreads; ++it) {
      const int i = threadIdx.x + it * kTcThreads;
      const int hi = i / kChunks, c = i - hi * kChunks;
      const bool ok = hi < g;
      const bf16* p = c < kR / 8 ? q_lat + (row0 + hi) * kR + c * 8
                                 : q_rope + (row0 + hi) * kPR + (c - kR / 8) * 8;
      cp_async_16(sq + hi * kRowS + c * 8, ok ? p : q_lat, ok);
    }
  }
  copy_latent_tile(stile, ckv, krope, table[t_begin], cb, ct, kb, kt, t_begin * kBS, length);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) * 8;

  uint32_t qf[kKSteps][4];
  float o[kVTiles][4];
#pragma unroll
  for (int i = 0; i < kVTiles; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this lane's partial row sums

  for (int j = t_begin; j < t_end; ++j) {
    const int buf = (j - t_begin) & 1;
    if (j + 1 < t_end) {
      copy_latent_tile(stile + (buf ^ 1) * kTileElems, ckv, krope, table[j + 1], cb, ct, kb,
                       kt, (j + 1) * kBS, length);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == t_begin) {
#pragma unroll
      for (int i = 0; i < kKSteps; ++i)
        ldmatrix_x4(qf[i], sq + a_row * kRowS + (warp * kKSteps + i) * 16 + a_col);
    }
    const bf16* tile = stile + buf * kTileElems;

    // this warp's share of the scores: 9 of the 36 k-steps, 2 n-tiles of 8
    float sp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < kKSteps; ++i) {
      uint32_t bk[4];
      ldmatrix_x4(bk, tile + k_row * kRowS + (warp * kKSteps + i) * 16 + k_col);
      mma_bf16(sp[0], qf[i], bk[0], bk[1]);
      mma_bf16(sp[1], qf[i], bk[2], bk[3]);
    }
    float4* mine = reinterpret_cast<float4*>(spart + (warp * 32 + lane) * 8);
    mine[0] = make_float4(sp[0][0], sp[0][1], sp[0][2], sp[0][3]);
    mine[1] = make_float4(sp[1][0], sp[1][1], sp[1][2], sp[1][3]);
    __syncthreads();
    // every warp adds the four partials in warp order, so all hold the
    // same scores and the same softmax state
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int wi = 0; wi < kTcWarps; ++wi) {
      const float4* part4 = reinterpret_cast<const float4*>(spart + (wi * 32 + lane) * 8);
      const float4 x = part4[0], y = part4[1];
      s[0][0] += x.x; s[0][1] += x.y; s[0][2] += x.z; s[0][3] += x.w;
      s[1][0] += y.x; s[1][1] += y.y; s[1][2] += y.z; s[1][3] += y.w;
    }
    const int col0 = j * kBS;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + nt * 8 + 2 * quad + (e & 1);
        s[nt][e] = col < length ? s[nt][e] * scale_log2 : kNegInf;
      }

    // online softmax: lane rows `group` (e 0, 1) and `group + 8` (e 2, 3)
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(m_run[r], fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                       fmaxf(s[1][2 * r], s[1][2 * r + 1])));
      mx = quad_max(mx);
      alpha[r] = exp2f(m_run[r] - mx);
      m_run[r] = mx;
    }
    uint32_t pf[4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float p0 = exp2f(s[nt][0] - m_run[0]);
      const float p1 = exp2f(s[nt][1] - m_run[0]);
      const float p2 = exp2f(s[nt][2] - m_run[1]);
      const float p3 = exp2f(s[nt][3] - m_run[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[nt * 2] = pack_bf16(p0, p1);
      pf[nt * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];

    // O += P V over this warp's 128 latent columns
#pragma unroll
    for (int dp = 0; dp < kVTiles / 2; ++dp) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, tile + v_row * kRowS + warp * (kR / kTcWarps) + dp * 16 + v_col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float(&acc)[4] = o[2 * dp + half];
        acc[0] *= alpha[0];
        acc[1] *= alpha[0];
        acc[2] *= alpha[1];
        acc[3] *= alpha[1];
        mma_bf16(acc, pf, bv[2 * half], bv[2 * half + 1]);
      }
    }
    __syncthreads();  // the next iteration's copy reuses this buffer and spart
  }

  // partial state of this split: rows `group` and `group + 8` of the group
  const int hr = lane >> 2;
  const long long prow = (static_cast<long long>(b) * part.ns + split) * nq + h0;
  float l_tot[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_tot[r] = quad_sum(l_run[r]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int hi = hr + 8 * r;
    if (hi >= g) continue;
    float* acc = part.acc + (prow + hi) * kR + warp * (kR / kTcWarps) + 2 * quad;
#pragma unroll
    for (int dn = 0; dn < kVTiles; ++dn)
      *reinterpret_cast<float2*>(acc + dn * 8) = make_float2(o[dn][2 * r], o[dn][2 * r + 1]);
    if (warp == 0 && quad == 0) {
      part.stats[(prow + hi) * 2] = m_run[r];
      part.stats[(prow + hi) * 2 + 1] = l_tot[r];
    }
  }
}

}  // namespace

// q_lat (B, Nq, R) and q_rope (B, Nq, PR) contiguous; pools ckv (NB, BS, R)
// and k_rope (NB, BS, PR) given by their block and position strides (the
// last axis unit-stride); tables (B, W) and lengths (B,) int32; out
// (B, Nq, R) contiguous.  Scratch: acc (B, NS, Nq, R) and stats
// (B, NS, Nq, 2) fp32 with NS = ceil(W / tiles_per_split), fresh per call.
// bf16 takes the tensor cores and needs R 512, PR 64, BS 16 and 16-byte
// aligned bases and strides; fp32 takes any widths.
extern "C" int paged_mla_decode_attention_launch(
    const void* q_lat, const void* q_rope, const void* ckv_pool, const void* krope_pool,
    const void* tables, const void* lengths, void* out, void* acc, void* stats, int b, int nq,
    int r, int pr, int bs, int w, int tiles_per_split, long long cb, long long ct, long long kb,
    long long kt, float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  if (tiles_per_split < 1 || nq < 1 || w < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ns = (w + tiles_per_split - 1) / tiles_per_split;
  const Partials part{static_cast<float*>(acc), static_cast<float*>(stats), ns};
  const dim3 grid(ns, (nq + kHeads - 1) / kHeads, b);
  if (dtype == kFloat32) {
    if (ns > 0) {
      const size_t bytes = sizeof(float) * mla_smem_floats(min(nq, kHeads), r, pr, bs);
      cudaError_t err = allow_shared_bytes(mla_f32_kernel, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      mla_f32_kernel<<<grid, kF32Threads, bytes, s>>>(
          static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
          static_cast<const float*>(ckv_pool), static_cast<const float*>(krope_pool), tab, len,
          part, nq, r, pr, bs, w, tiles_per_split, cb, ct, kb, kt, scale);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return launch_split_merge<float, false>(part, len, out, b, nq, r, bs, w * bs,
                                            tiles_per_split, s);
  }
  if (dtype == kBFloat16) {
    if (r != kR || pr != kPR || bs != kBS) return static_cast<int>(cudaErrorInvalidValue);
    if (ns > 0) {
      cudaError_t err = allow_shared_bytes(mla_tc_kernel, kTcBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      mla_tc_kernel<<<grid, kTcThreads, kTcBytes, s>>>(
          static_cast<const bf16*>(q_lat), static_cast<const bf16*>(q_rope),
          static_cast<const bf16*>(ckv_pool), static_cast<const bf16*>(krope_pool), tab, len,
          part, nq, w, tiles_per_split, cb, ct, kb, kt, scale * kLog2e);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return launch_split_merge<bf16, true>(part, len, out, b, nq, r, bs, w * bs,
                                          tiles_per_split, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
