// Split KV sweep of the GQA decode pair: paged_decode_attention.cu (KV block
// pools through a block table) and decode_attention.cu (a contiguous cache).
// The two differ only in how a tile is addressed -- their `Addr` maps (row
// b, tile j) to the element offset of the tile's first position at kv head
// 0 -- so both run the kernels below and the merge of split_merge.cuh.
//
// Bound on this card: bytes in principle -- a step reads each row's live K
// and V once (2 * length * Nkv * H elements) for 4 * length * Nq * H flops,
// about one flop per bf16 byte at g = 2 -- but at decode sizes (4 rows, a
// few hundred positions, 2 MB) latency: one block walking a row's tiles one
// after another leaves most of the 132 SMs idle.
//
// Design: flash-decoding.  A tile is `bs` positions (a pool block, or the
// dense kernel's block_k).  Split s of a row covers tiles [s*T, (s+1)*T),
// T = tiles_per_split (a launch argument the wrapper fixes), and one block
// per (split, group of up to 16 query heads of one kv head, row) walks its
// tiles for all heads of the group, so each K/V tile is read once per group.
// The grid is sized from the table width (or Smax / block_k) on the host,
// with no read of `lengths`; splits at or past a row's last tile exit at
// once.  Each block writes its partial softmax state to fp32 scratch and
// split_merge.cuh combines a row's splits in split order.
//
// Split-boundary invariant: a split's positions depend only on tile indices
// and T, never on the table width, the batch or the grid.  So a row gives
// the same bits through a width-16 table, a width-32 table and the dense
// cache with block_k = bs, and paged equals dense decode exactly.  A row
// of length 0 merges no split and gives exactly 0.
//
// bf16 (decode_tc_kernel<H>, H in {16, 64, 112, 128}, bs a multiple of 16): one
// warp per block on mma.sync.m16n8k16.  The group's query heads are the M
// dimension, padded with zero rows to 16, and held in registers as A
// fragments.  The split is walked in chunks of 16 positions: scores = Q
// (16 x H) times the chunk's K^T (H x 16), H/16 k-steps per 8-position
// n-tile; the online softmax runs in registers (quad shuffles); P is
// rounded to bf16 and is PV's A operand against the chunk's V (16 x H), H/8
// n-tiles.  K and V chunks are staged with 16-byte cp.async into rows
// padded by 16 bytes (no ldmatrix bank conflicts), double-buffered, so the
// next chunk loads while this one computes; positions at or past the length
// are zero-filled and their scores masked.  The lanes hold the split's
// tile offsets (one table read per tile, T <= 32), so a chunk's copy waits
// on no table load.
//
// fp32 (decode_f32_kernel, any H and bs): fp32 inputs must hold 1e-5, so
// the products stay on the CUDA cores -- 128 threads, one warp per (head,
// position) score, the online softmax of online_softmax.cuh -- with tiles
// staged by float4 loads where the widths and strides allow, and the same
// split and merge, so both dtypes share one structure.
#pragma once

#include <initializer_list>

#include "online_softmax.cuh"
#include "split_merge.cuh"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kDecodeGroup = 16;  // query heads per block: one mma M tile
constexpr int kDecodeChunk = 16;  // positions per bf16 step: one PV k tile

// A launch's shape, shared by its split kernel and its merge.
struct DecodeShape {
  int nq;            // query heads
  int h, bs;         // head width; positions per tile
  int cap;           // positions a row can hold (W * bs, or Smax)
  int tps;           // tiles per split
  long long pt, pn;  // element strides between positions, between kv heads
  int g = 0, ngroups = 0;  // query heads per kv head, head groups per kv head (set at launch)
};

// Which (split, kv head, head group, row) a block serves, and its tiles.
struct SplitBlock {
  int split, kvh, h0, gb, b, length, t_begin, t_end;

  __device__ __forceinline__ explicit SplitBlock(const DecodeShape& sh, const int* lengths) {
    split = blockIdx.x;
    kvh = blockIdx.y / sh.ngroups;
    h0 = (blockIdx.y - kvh * sh.ngroups) * kDecodeGroup;
    gb = min(kDecodeGroup, sh.g - h0);
    b = blockIdx.z;
    length = max(0, min(lengths[b], sh.cap));
    const int ntiles = (length + sh.bs - 1) / sh.bs;
    t_begin = split * sh.tps;
    t_end = min(t_begin + sh.tps, ntiles);
  }
  __device__ __forceinline__ bool idle() const { return t_begin >= t_end; }
  // the group's first query row in (B, Nq) and its first row in the scratch
  __device__ __forceinline__ long long q_row(const DecodeShape& sh) const {
    return static_cast<long long>(b) * sh.nq + kvh * sh.g + h0;
  }
  __device__ __forceinline__ long long part_row(const DecodeShape& sh, int ns) const {
    return (static_cast<long long>(b) * ns + split) * sh.nq + kvh * sh.g + h0;
  }
};

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kDecodeF32Threads = 128;

__host__ __device__ inline int decode_f32_smem_floats(int gb, int h, int bs) {
  return gb * h + 2 * bs * h + gb * bs + softmax_state_floats(gb, h);
}

// Stages `rows` head vectors of h floats, `stride` elements apart from src,
// into dst (rows, h); rows at or past `valid` load as 0.  With `vec` (h, the
// stride and src all multiples of 4 floats) in float4s.
__device__ __forceinline__ void stage_f32(float* dst, const float* __restrict__ src,
                                          long long stride, int rows, int valid, int h,
                                          bool vec) {
  if (vec) {
    const int h4 = h >> 2;
    for (int i = threadIdx.x; i < rows * h4; i += blockDim.x) {
      const int t = i / h4, c = i - t * h4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < valid) x = *reinterpret_cast<const float4*>(src + t * stride + 4 * c);
      reinterpret_cast<float4*>(dst + t * h)[c] = x;
    }
  } else {
    for (int i = threadIdx.x; i < rows * h; i += blockDim.x) {
      const int t = i / h, d = i - t * h;
      dst[i] = t < valid ? src[t * stride + d] : 0.f;
    }
  }
}

template <typename Addr>
__global__ void __launch_bounds__(kDecodeF32Threads)
decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, Addr addr, const int* __restrict__ lengths,
                  Partials part, DecodeShape sh, float scale, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const SplitBlock blk(sh, lengths);
  if (blk.idle()) return;
  const int gb = blk.gb, h = sh.h, bs = sh.bs, length = blk.length;
  float* sq = smem;         // (gb, h) queries
  float* sk = sq + gb * h;  // (bs, h) key tile
  float* sv = sk + bs * h;  // (bs, h) value tile
  float* ss = sv + bs * h;  // (gb, bs) scores, then probabilities
  SoftmaxState st;
  carve_softmax_state(ss + gb * bs, gb, h, &st);

  stage_f32(sq, q + blk.q_row(sh) * h, h, gb, gb, h, vec);
  online_softmax_init(st, gb, h);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int j = blk.t_begin; j < blk.t_end; ++j) {
    const int col0 = j * bs;
    const long long base = addr.tile(blk.b, j) + blk.kvh * sh.pn;
    stage_f32(sk, k + base, sh.pt, bs, length - col0, h, vec);
    stage_f32(sv, v + base, sh.pt, bs, length - col0, h, vec);
    __syncthreads();
    // one warp per (query head, position): lanes split the head dim
    for (int p = warp; p < gb * bs; p += nwarps) {
      const int gi = p / bs, t = p - gi * bs;
      float a = 0.f;
      for (int d = lane; d < h; d += 32) a += sq[gi * h + d] * sk[t * h + d];
      a = warp_sum(a);
      if (lane == 0) ss[p] = col0 + t < length ? a * scale : kNegInf;
    }
    __syncthreads();
    online_softmax_block(st, ss, sv, gb, bs, h);
  }
  const long long prow = blk.part_row(sh, part.ns);
  for (int i = threadIdx.x; i < gb * h; i += blockDim.x) part.acc[prow * h + i] = st.acc[i];
  for (int i = threadIdx.x; i < gb; i += blockDim.x) {
    part.stats[(prow + i) * 2] = st.m[i];
    part.stats[(prow + i) * 2 + 1] = st.l[i];
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, one warp per block
// ---------------------------------------------------------------------------

template <int H>
struct TcDecode {
  static_assert(H % 16 == 0, "head width must be a multiple of 16");
  static constexpr int kRowS = H + 8;    // padded shared row stride (elements)
  static constexpr int kPieces = H / 8;  // 16-byte pieces per row
  static constexpr int kKSteps = H / 16;
  static constexpr int kNTiles = H / 8;
  static constexpr int kChunkElems = kDecodeChunk * kRowS;
  // queries, then two buffers of (K chunk, V chunk)
  static constexpr size_t kBytes = sizeof(bf16) * (kDecodeGroup * kRowS + 4 * kChunkElems);
};

template <int H, typename Addr>
__global__ void __launch_bounds__(32)
decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, Addr addr, const int* __restrict__ lengths,
                 Partials part, DecodeShape sh, float scale_log2) {
  using L = TcDecode<H>;
  constexpr int kRowS = L::kRowS, kPieces = L::kPieces, kChunkElems = L::kChunkElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // (16, kRowS) queries
  bf16* skv = sq + kDecodeGroup * kRowS;          // 2 x (K, V) chunks of (16, kRowS)

  const SplitBlock blk(sh, lengths);
  if (blk.idle()) return;
  const int lane = threadIdx.x, gb = blk.gb, length = blk.length;
  const int p_begin = blk.t_begin * sh.bs;
  const int nchunks = (min(blk.t_end * sh.bs, length) - p_begin + kDecodeChunk - 1) / kDecodeChunk;
  // lane i holds the offset of the split's tile i at this kv head
  long long tile_off = 0;
  if (lane < blk.t_end - blk.t_begin)
    tile_off = addr.tile(blk.b, blk.t_begin + lane) + blk.kvh * sh.pn;

  // K and V of chunk c (positions p_begin + 16c ..) into buffer dst
  auto copy_chunk = [&](int c, bf16* dst) {
    const int p0 = p_begin + c * kDecodeChunk;
    const int j = p0 / sh.bs;
    const long long base = __shfl_sync(0xffffffffu, tile_off, j - blk.t_begin) +
                           static_cast<long long>(p0 - j * sh.bs) * sh.pt;
#pragma unroll
    for (int it = 0; it < kDecodeChunk * kPieces / 32; ++it) {
      const int i = lane + 32 * it;
      const int t = i / kPieces, pc = i - t * kPieces;
      const bool ok = p0 + t < length;
      const long long off = base + t * sh.pt + pc * 8;
      cp_async_16(dst + t * kRowS + pc * 8, ok ? k + off : k, ok);
      cp_async_16(dst + kChunkElems + t * kRowS + pc * 8, ok ? v + off : v, ok);
    }
  };

  {  // queries: 16 rows, rows past the group zero
    const bf16* qg = q + blk.q_row(sh) * H;
#pragma unroll
    for (int it = 0; it < kDecodeGroup * kPieces / 32; ++it) {
      const int i = lane + 32 * it;
      const int hi = i / kPieces, pc = i - hi * kPieces;
      const bool ok = hi < gb;
      cp_async_16(sq + hi * kRowS + pc * 8, ok ? qg + hi * H + pc * 8 : q, ok);
    }
  }
  copy_chunk(0, skv);
  cp_async_commit();

  const int quad = lane & 3;
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) * 8;

  uint32_t qf[L::kKSteps][4];
  float o[L::kNTiles][4];
#pragma unroll
  for (int i = 0; i < L::kNTiles; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this lane's partial row sums

  for (int c = 0; c < nchunks; ++c) {
    const bf16* kt = skv + (c & 1) * 2 * kChunkElems;
    const bf16* vt = kt + kChunkElems;
    if (c + 1 < nchunks) {
      copy_chunk(c + 1, skv + ((c + 1) & 1) * 2 * kChunkElems);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < L::kKSteps; ++i)
        ldmatrix_x4(qf[i], sq + a_row * kRowS + i * 16 + a_col);
    }

    // scores of the chunk's 16 positions: two n-tiles of 8
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < L::kKSteps; ++i) {
      uint32_t bk[4];
      ldmatrix_x4(bk, kt + k_row * kRowS + i * 16 + k_col);
      mma_bf16(s[0], qf[i], bk[0], bk[1]);
      mma_bf16(s[1], qf[i], bk[2], bk[3]);
    }
    const int col0 = p_begin + c * kDecodeChunk;
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

    // O += P V over all H columns
#pragma unroll
    for (int dp = 0; dp < L::kKSteps; ++dp) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vt + v_row * kRowS + dp * 16 + v_col);
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
    __syncwarp();  // the next iteration's copy reuses this buffer
  }

  // partial state of this split: rows `group` and `group + 8` of the group
  const int hr = lane >> 2;
  const long long prow = blk.part_row(sh, part.ns);
  float l_tot[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_tot[r] = quad_sum(l_run[r]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int hi = hr + 8 * r;
    if (hi >= gb) continue;
    float* acc = part.acc + (prow + hi) * H + 2 * quad;
#pragma unroll
    for (int dn = 0; dn < L::kNTiles; ++dn)
      *reinterpret_cast<float2*>(acc + dn * 8) = make_float2(o[dn][2 * r], o[dn][2 * r + 1]);
    if (quad == 0) {
      part.stats[(prow + hi) * 2] = m_run[r];
      part.stats[(prow + hi) * 2 + 1] = l_tot[r];
    }
  }
}

template <int H, typename Addr>
int launch_tc(const void* q, const void* k, const void* v, Addr addr, const int* lengths,
              const Partials& part, const DecodeShape& sh, dim3 grid, float scale,
              cudaStream_t s) {
  cudaError_t err = allow_shared_bytes(decode_tc_kernel<H, Addr>, TcDecode<H>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_tc_kernel<H, Addr><<<grid, 32, TcDecode<H>::kBytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      addr, lengths, part, sh, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// one launch: the split kernel, then the merge
// ---------------------------------------------------------------------------

// q (B, Nq, H) and out (B, Nq, H) contiguous; k/v addressed by `addr` plus
// sh.pt per position and sh.pn per kv head (the last axis unit-stride);
// `width` tiles per row (the table width, or ceil(Smax / bs)); scratch
// holds B * NS * Nq * (H + 2) floats, NS = ceil(width / tps): the
// accumulators (B, NS, Nq, H), then the (m, l) pairs (B, NS, Nq, 2).
// bf16 takes the tensor cores and needs H in {16, 64, 112, 128}, bs a multiple
// of 16, tps <= 32 and 16-byte aligned bases and strides; fp32 takes any
// widths (float4 staging where `vec`).
template <typename Addr>
int launch_decode_split(const void* q, const void* k, const void* v, Addr addr,
                        const int* lengths, void* out, void* scratch, int b, int nkv,
                        DecodeShape sh, int width, bool vec, float scale, int dtype,
                        cudaStream_t s) {
  if (sh.tps < 1 || sh.nq < 1 || nkv < 1 || sh.nq % nkv || width < 0 || sh.bs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  sh.g = sh.nq / nkv;
  sh.ngroups = (sh.g + kDecodeGroup - 1) / kDecodeGroup;
  const int ns = (width + sh.tps - 1) / sh.tps;
  float* acc = static_cast<float*>(scratch);
  const Partials part{acc, acc + static_cast<long long>(b) * ns * sh.nq * sh.h, ns};
  const dim3 grid(ns, nkv * sh.ngroups, b);
  if (dtype == kFloat32) {
    if (ns > 0) {
      const size_t bytes = sizeof(float) * decode_f32_smem_floats(min(sh.g, kDecodeGroup), sh.h,
                                                                  sh.bs);
      cudaError_t err = allow_shared_bytes(decode_f32_kernel<Addr>, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      decode_f32_kernel<Addr><<<grid, kDecodeF32Threads, bytes, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), addr, lengths, part, sh, scale, vec);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return launch_split_merge<float, false>(part, lengths, out, b, sh.nq, sh.h, sh.bs, sh.cap,
                                            sh.tps, s);
  }
  if (dtype == kBFloat16) {
    if (sh.bs % kDecodeChunk || sh.tps > 32) return static_cast<int>(cudaErrorInvalidValue);
    if (ns > 0) {
      int err;
      switch (sh.h) {
        case 16: err = launch_tc<16>(q, k, v, addr, lengths, part, sh, grid, scale, s); break;
        case 64: err = launch_tc<64>(q, k, v, addr, lengths, part, sh, grid, scale, s); break;
        case 112: err = launch_tc<112>(q, k, v, addr, lengths, part, sh, grid, scale, s); break;
        case 128: err = launch_tc<128>(q, k, v, addr, lengths, part, sh, grid, scale, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
      if (err != 0) return err;
    }
    return launch_split_merge<bf16, true>(part, lengths, out, b, sh.nq, sh.h, sh.bs, sh.cap,
                                          sh.tps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// float4 staging of fp32: every base a multiple of 16 bytes, every stride
// a multiple of 4 elements
inline bool vec4_ok(std::initializer_list<const void*> ptrs,
                    std::initializer_list<long long> strides) {
  for (const void* p : ptrs)
    if (reinterpret_cast<unsigned long long>(p) % 16) return false;
  for (long long st : strides)
    if (st % 4) return false;
  return true;
}

}  // namespace
