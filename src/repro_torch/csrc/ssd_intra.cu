// Mamba-2 SSD intra-chunk part: per chunk m and head h, with seg =
// cumsum(dA) over the chunk's Q positions,
//     y[i, :] = sum_{j <= i} (C_i . B_j) exp(seg_i - seg_j) (x_j dt_j)   (Q, P)
//     s[:, :] = sum_j B_j^T exp(seg_{Q-1} - seg_j) dt_j x_j             (N, P)
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_intra (_ssd_kernel), the
// compute hot-spot of the chunked SSD prefill (models/ssm.py, ssd_chunked).
// Here it is the intra-chunk part of every SSM layer's prefill.
//
// Bound on this card: at Q = 256, N = 128, P = 64 and 48 heads a chunk
// takes ~0.4 GFLOP (C B^T, then Q^2/2 * P and Q * N * P multiply-adds per
// head) against ~6.5 MB of bf16 inputs and fp32 outputs: bytes bound it at
// the tensor cores' bf16 rate (~2 us), operations at the CUDA cores' fp32
// rate (~6 us).  What bounds a kernel this short in practice is the
// latency of each block's serial chain: its cumsum, its copies, and its
// walk over the tiles of j.
//
// Two kernels, chosen by the wrapper from dtype and widths:
//
// bf16 at the (P, N) widths instantiated below (mamba2-780m 64/128,
// zamba2-7b 64/64), tensor cores (ssd_tc_kernel).  The step is causal
// linear attention with a decay mask, so it is built like flash's tiles:
// one launch, one block of 4 warps per (64-row tile of i, head, chunk)
// plus one state block per (head, chunk), the longest y tiles first.
//   * A y block copies its 64 C rows once and streams the 64-position
//     tiles of B_j and x_j, double-buffered with 16-byte cp.async into
//     rows padded by 16 bytes (x is a strided view with a unit-stride P
//     row: one P-wide copy per position).  Each warp owns 16 rows of i:
//     S = C_i B_j^T runs on mma.sync.m16n8k16 with K = N (C B^T is
//     recomputed per head: ~0.4 us of tensor-core work at this shape,
//     cheaper than an fp32 (M, Q, Q) scratch in L2 and a launch of its
//     own); W = S exp(seg_i - seg_j) dt_j is formed in fp32
//     registers, with the causal mask on the diagonal tile only and the
//     16-key groups above a warp's last row skipped there; tiles above
//     the diagonal are never loaded.  y += W x_j on mma, W as the A
//     operand straight from S's accumulator layout, x_j through
//     ldmatrix.trans, so dt enters through W and x is never rounded again.
//   * W is rounded to bf16 twice: hi = bf16(W), lo = bf16(W - hi), and
//     y += hi x + lo x.  One rounding (as flash rounds P) is not enough
//     here: W is an unnormalised score of size ~|C||B| summed over up to
//     256 positions, and its 2^-9 relative rounding moves y by up to ~0.8
//     at y ~ 100 -- far past the 2e-2 tolerance wherever y is small.  The
//     pair carries ~16 bits of W for one more mma per k-step.
//   * A state block runs s = (B o exp(seg_last - seg) dt)^T x with K = Q,
//     each warp owning N/4 rows of s: B_j^T comes through ldmatrix.trans
//     as the A operand, is scaled per position in registers and split
//     into the same bf16 pair; x_j is the B operand as in y.
//   * The cumsum stays sequential (the port's pinned order, ROADMAP C):
//     one thread sums the block's positions once while the first copies
//     are in flight; every other block of the launch repeats it for its
//     own (chunk, head) -- up to 256 dependent adds from shared memory.
//   * Ragged chunks: tiles start at position 0 with a fixed width and
//     zero-fill rows past Q (dt and dA read as 0 there, so seg stays
//     finite), so any Q <= 256 works and the mma sequence of a row
//     depends only on its position: positions with dt = 0 past a row's
//     true length (a length-bucketed prefill) add exact zeros, and a
//     padded chunk gives the exact-length chunk's bits.
//   Every global base and row stride must be 16-byte aligned (the wrapper
//   checks, and takes the CUDA-core kernel otherwise).
//
// fp32, and bf16 at other widths (the reduced configs' P 16 / N 16), CUDA
// cores (fp32 holds 1e-5 of the plain version): one launch runs three
// kernels:
//   1. cb_kernel: C B^T once per chunk (ngroups = 1: the same for all
//      heads) into an fp32 (M, Q, Q) scratch buffer the wrapper allocates;
//      only tiles on or below the diagonal are computed;
//   2. y_kernel: one block per (16-row tile of i, head, chunk) loops over
//      32-column tiles of j up to its last row (the causal skip), building
//      the decayed scores of the tile and the dt-weighted inputs in shared
//      memory;
//   3. s_kernel: one block per (32-wide tile of N, head, chunk) sums the
//      chunk state over all Q positions.
// Every block computes the cumulative decay of its head itself, by one
// thread in sequential order, and every output element sums over j (or n)
// in one fixed sequential order, so a padded prefill gives the bits of the
// exact-length one here too.
//
// y is written in fp32 by both: the caller adds the inter-chunk term
// before it casts (the model path's rounding; the Pallas kernel casts y
// itself).
#include <cstring>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQMax = 256;  // longest chunk (the model's chunk size)
constexpr int kPMax = 128;  // widest head
constexpr int kTile = 32;   // C B^T output tile, and the j tile of y and s
constexpr int kRows = 16;   // rows of y per block
constexpr int kNTile = 32;  // columns of s's N per block
constexpr int kYOut = kRows * kPMax / kThreads;   // y outputs per thread
constexpr int kSOut = kNTile * kPMax / kThreads;  // s outputs per thread

struct Strides {
  long long xm, xh, xq;  // x (M, H, Q, P), P unit-stride
  long long dm, dh, dq;  // dt (M, H, Q)
  long long am, ah, aq;  // dA (M, H, Q)
  long long bm, bq;      // B (M, Q, N), N unit-stride
  long long cm, cq;      // C (M, Q, N), N unit-stride
  long long ym, yh, yq;  // y (M, H, Q, P) fp32, P unit-stride
};
static_assert(sizeof(Strides) == 16 * sizeof(long long), "Strides is 16 packed values");

// seg[0..len) = cumsum(dA) of (chunk m, head h), sequential; dts = dt.
__device__ void load_decay(const float* __restrict__ dt, const float* __restrict__ da,
                           const Strides& st, int m, int h, int len, float* seg,
                           float* dts) {
  for (int t = threadIdx.x; t < len; t += kThreads) {
    dts[t] = dt[m * st.dm + h * st.dh + t * st.dq];
    seg[t] = da[m * st.am + h * st.ah + t * st.aq];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int t = 0; t < len; ++t) {
      run += seg[t];
      seg[t] = run;
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cb_kernel(const T* __restrict__ cmat, const T* __restrict__ bmat, float* __restrict__ cb,
          int q, int n, Strides st) {
  const int it = blockIdx.x, jt = blockIdx.y, m = blockIdx.z;
  if (jt > it) return;  // above the diagonal: never read
  __shared__ float cs[kTile][kTile + 1];
  __shared__ float bs[kTile][kTile + 1];
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;  // ty < 8
  constexpr int kPer = kTile * kTile / kThreads;                  // 4
  float acc[kPer] = {};
  for (int n0 = 0; n0 < n; n0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile;
      const int i = it * kTile + r, j = jt * kTile + r, nn = n0 + c;
      cs[r][c] = (i < q && nn < n) ? to_f32(cmat[m * st.cm + i * st.cq + nn]) : 0.f;
      bs[r][c] = (j < q && nn < n) ? to_f32(bmat[m * st.bm + j * st.bq + nn]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kTile; ++c) {
      const float bv = bs[tx][c];
#pragma unroll
      for (int k = 0; k < kPer; ++k) acc[k] += cs[ty + 8 * k][c] * bv;
    }
    __syncthreads();
  }
  const int j = jt * kTile + tx;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = it * kTile + ty + 8 * k;
    if (i < q && j < q) cb[(static_cast<long long>(m) * q + i) * q + j] = acc[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
y_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ da,
         const float* __restrict__ cb, float* __restrict__ y, int q, int p, Strides st) {
  __shared__ float seg[kQMax];
  __shared__ float dts[kQMax];
  __shared__ float ws[kRows][kTile + 1];  // decayed scores of the tile
  __shared__ float xdt[kTile][kPMax];     // dt-weighted inputs of the tile
  const int i0 = blockIdx.x * kRows, h = blockIdx.y, m = blockIdx.z;
  const int i_end = min(q, i0 + kRows);
  load_decay(dt, da, st, m, h, i_end, seg, dts);
  const T* xm = x + m * st.xm + h * st.xh;
  const float* cbm = cb + static_cast<long long>(m) * q * q;
  float acc[kYOut] = {};
  for (int j0 = 0; j0 < i_end; j0 += kTile) {
    const int jn = min(kTile, i_end - j0);
    for (int e = threadIdx.x; e < jn * p; e += kThreads) {
      const int jj = e / p, pp = e % p;
      xdt[jj][pp] = to_f32(xm[(j0 + jj) * st.xq + pp]) * dts[j0 + jj];
    }
    for (int e = threadIdx.x; e < kRows * kTile; e += kThreads) {
      const int r = e / kTile, jj = e % kTile, i = i0 + r, j = j0 + jj;
      ws[r][jj] = (i < i_end && jj < jn && j <= i)
                      ? cbm[static_cast<long long>(i) * q + j] * expf(seg[i] - seg[j])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kYOut; ++k) {
      const int e = threadIdx.x + k * kThreads;
      if (e < kRows * p) {
        const int r = e / p, pp = e % p;
        float a = acc[k];
        for (int jj = 0; jj < jn; ++jj) a += ws[r][jj] * xdt[jj][pp];
        acc[k] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kYOut; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int r = e / p, pp = e % p, i = i0 + r;
    if (e < kRows * p && i < i_end) y[m * st.ym + h * st.yh + i * st.yq + pp] = acc[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
s_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ da,
         const T* __restrict__ bmat, float* __restrict__ s, int hn, int q, int p, int n,
         Strides st) {
  __shared__ float seg[kQMax];
  __shared__ float dts[kQMax];
  __shared__ float bd[kTile][kNTile + 1];  // B_j * exp(seg_last - seg_j) * dt_j
  __shared__ float xs[kTile][kPMax];
  const int n0 = blockIdx.x * kNTile, h = blockIdx.y, m = blockIdx.z;
  const int nw = min(kNTile, n - n0);
  load_decay(dt, da, st, m, h, q, seg, dts);
  const float last = seg[q - 1];
  const T* xm = x + m * st.xm + h * st.xh;
  float acc[kSOut] = {};
  for (int j0 = 0; j0 < q; j0 += kTile) {
    const int jn = min(kTile, q - j0);
    for (int e = threadIdx.x; e < jn * p; e += kThreads) {
      const int jj = e / p, pp = e % p;
      xs[jj][pp] = to_f32(xm[(j0 + jj) * st.xq + pp]);
    }
    for (int e = threadIdx.x; e < jn * nw; e += kThreads) {
      const int jj = e / nw, nn = e % nw, j = j0 + jj;
      bd[jj][nn] = to_f32(bmat[m * st.bm + j * st.bq + n0 + nn]) *
                   (expf(last - seg[j]) * dts[j]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSOut; ++k) {
      const int e = threadIdx.x + k * kThreads;
      if (e < nw * p) {
        const int nn = e / p, pp = e % p;
        float a = acc[k];
        for (int jj = 0; jj < jn; ++jj) a += bd[jj][nn] * xs[jj][pp];
        acc[k] = a;
      }
    }
    __syncthreads();
  }
  float* sm = s + (static_cast<long long>(m) * hn + h) * n * p;
#pragma unroll
  for (int k = 0; k < kSOut; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (e < nw * p) sm[static_cast<long long>(n0 + e / p) * p + e % p] = acc[k];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* da, const void* b, const void* c,
           void* y, void* s, void* cb, int m, int h, int q, int p, int n, const Strides& st,
           cudaStream_t stream) {
  if (q < 1 || q > kQMax || p < 1 || p > kPMax || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (q + kTile - 1) / kTile;
  cb_kernel<T><<<dim3(tiles, tiles, m), kThreads, 0, stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(b), static_cast<float*>(cb), q, n, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  y_kernel<T><<<dim3((q + kRows - 1) / kRows, h, m), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(da),
      static_cast<const float*>(cb), static_cast<float*>(y), q, p, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  s_kernel<T><<<dim3((n + kNTile - 1) / kNTile, h, m), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(da),
      static_cast<const T*>(b), static_cast<float*>(s), h, q, p, n, st);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;  // 4 warps
constexpr int kTcTile = 64;      // rows of i per y block = positions per j tile

template <int P, int N>
struct TcLayout {
  static_assert(P % 16 == 0 && N % 64 == 0, "P must be a multiple of 16, N of 64");
  static constexpr int kNS = N + 8;  // padded row stride of the C and B tiles
  static constexpr int kPS = P + 8;  // and of the x tile (elements)
  static constexpr int kC = kTcTile * kNS;
  static constexpr int kB = kTcTile * kNS;
  static constexpr int kX = kTcTile * kPS;
  static constexpr size_t kBytes = sizeof(bf16) * (kC + 2 * (kB + kX));
};

// (a, b) split into the bf16 pair hi + lo (hi = bf16(v), lo = bf16(v - hi))
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// acc += (hi + lo) x over one 16-position k-step of an x tile (P wide)
template <int P>
__device__ __forceinline__ void times_x(float (&acc)[P / 8][4], const uint32_t (&hi)[4],
                                        const uint32_t (&lo)[4], const bf16* xt, int x_off) {
#pragma unroll
  for (int dp = 0; dp < P / 16; ++dp) {
    uint32_t bx[4];
    ldmatrix_x4_trans(bx, xt + x_off + dp * 16);
    mma_bf16(acc[2 * dp], hi, bx[0], bx[1]);
    mma_bf16(acc[2 * dp + 1], hi, bx[2], bx[3]);
    mma_bf16(acc[2 * dp], lo, bx[0], bx[1]);
    mma_bf16(acc[2 * dp + 1], lo, bx[2], bx[3]);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kTcThreads)
ssd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ da, const bf16* __restrict__ bmat,
              const bf16* __restrict__ cmat, float* __restrict__ y, float* __restrict__ s,
              int hn, int q, Strides st) {
  using L = TcLayout<P, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sc = reinterpret_cast<bf16*>(smem_raw);  // (64, N+8), y blocks only
  bf16* sb = sc + L::kC;                          // 2 x (64, N+8)
  bf16* sx = sb + 2 * L::kB;                      // 2 x (64, P+8)
  __shared__ float seg[kQMax];
  __shared__ float dts[kQMax];

  const int ytiles = (q + kTcTile - 1) / kTcTile;
  const bool state = blockIdx.x == ytiles;  // the last block of each (head, chunk)
  const int it = ytiles - 1 - blockIdx.x;   // y tile: the longest walks start first
  const int h = blockIdx.y, m = blockIdx.z;
  const int ntiles = state ? ytiles : it + 1;  // j tiles this block walks
  const int span = ntiles * kTcTile;           // positions of decay it needs

  const bf16* xm = x + m * st.xm + h * st.xh;
  const bf16* bm = bmat + m * st.bm;
  auto copy_tile = [&](int j) {  // B_j and x_j into stage j & 1
    copy_rows_async<kTcTile, N, kTcThreads>(sb + (j & 1) * L::kB, L::kNS, bm, st.bq,
                                            j * kTcTile, q);
    copy_rows_async<kTcTile, P, kTcThreads>(sx + (j & 1) * L::kX, L::kPS, xm, st.xq,
                                            j * kTcTile, q);
  };
  // copy groups, oldest first: [C, tile 0], [tile 1], then one per tile
  if (!state)
    copy_rows_async<kTcTile, N, kTcThreads>(sc, L::kNS, cmat + m * st.cm, st.cq,
                                            it * kTcTile, q);
  copy_tile(0);
  cp_async_commit();
  if (ntiles > 1) copy_tile(1);
  cp_async_commit();

  // dt and dA of the positions the block needs; 0 past q, so seg stays
  // finite (= seg[q-1]) and every weight there is an exact 0
  for (int t = threadIdx.x; t < span; t += kTcThreads) {
    const bool ok = t < q;
    dts[t] = ok ? dt[m * st.dm + h * st.dh + t * st.dq] : 0.f;
    seg[t] = ok ? da[m * st.am + h * st.ah + t * st.aq] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // sequential cumsum; the copies are in flight
    float run = 0.f;
    for (int t0 = 0; t0 < span; t0 += 8) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = seg[t0 + k];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        run += v[k];
        seg[t0 + k] = run;
      }
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane >> 2, quad = lane & 3;
  // ldmatrix lane offsets, as flash's Q, K and V: A (C) rows 0-15 x k
  // halves; B (B_j^T) two 8-key n-tiles x k halves -- with .trans the same
  // addresses give the state's A operand B_j^T, two 8-row halves of N x k
  // halves; B^T (x) two k halves x 8-wide n-tiles
  const int c_off = (warp * 16 + (lane & 15)) * L::kNS + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * L::kNS + ((lane >> 3) & 1) * 8;
  const int x_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * L::kPS + (lane >> 4) * 8;

  if (!state) {
    // ---- y rows [it*64, it*64 + 64): warp w owns 16 of them ----
    const int row0 = it * kTcTile + warp * 16 + group;  // this lane's rows: row0, row0 + 8
    uint32_t cf[N / 16][4];
    float o[P / 8][4] = {};
    float seg_r[2];
    for (int j = 0; j < ntiles; ++j) {
      cp_async_wait<1>();  // tile j (and C) landed; tile j+1 may be in flight
      __syncthreads();     // ... for every thread; at j = 0 also the cumsum
      const bf16* bt = sb + (j & 1) * L::kB;
      const bf16* xt = sx + (j & 1) * L::kX;
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) ldmatrix_x4(cf[kk], sc + c_off + kk * 16);
        seg_r[0] = seg[row0];
        seg_r[1] = seg[row0 + 8];
      }
      const bool diag = j == it;
      // 16-key groups this warp needs: on the diagonal none past its last row
      const int groups = diag ? warp + 1 : 4;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (g < groups) {
          float sg[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < N / 16; ++kk) {
            uint32_t bk[4];
            ldmatrix_x4(bk, bt + g * 16 * L::kNS + b_off + kk * 16);
            mma_bf16(sg[0], cf[kk], bk[0], bk[1]);
            mma_bf16(sg[1], cf[kk], bk[2], bk[3]);
          }
          // W = S exp(seg_i - seg_j) dt_j, causal on the diagonal tile
          float w[2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = j * kTcTile + g * 16 + nt * 8 + 2 * quad + (e & 1);
              const int row = row0 + (e >> 1) * 8;
              const float v = sg[nt][e] * expf(seg_r[e >> 1] - seg[col]) * dts[col];
              w[nt][e] = (!diag || col <= row) ? v : 0.f;
            }
          }
          uint32_t hi[4], lo[4];
          split_bf16(w[0][0], w[0][1], hi[0], lo[0]);
          split_bf16(w[0][2], w[0][3], hi[1], lo[1]);
          split_bf16(w[1][0], w[1][1], hi[2], lo[2]);
          split_bf16(w[1][2], w[1][3], hi[3], lo[3]);
          times_x<P>(o, hi, lo, xt, x_off + g * 16 * L::kPS);
        }
      }
      __syncthreads();  // every warp is done with this stage
      if (j + 2 < ntiles) copy_tile(j + 2);
      cp_async_commit();
    }
    float* ym = y + m * st.ym + h * st.yh;
#pragma unroll
    for (int dn = 0; dn < P / 8; ++dn) {
      const int col = dn * 8 + 2 * quad;
      if (row0 < q)
        *reinterpret_cast<float2*>(ym + row0 * st.yq + col) = make_float2(o[dn][0], o[dn][1]);
      if (row0 + 8 < q)
        *reinterpret_cast<float2*>(ym + (row0 + 8) * st.yq + col) =
            make_float2(o[dn][2], o[dn][3]);
    }
    return;
  }

  // ---- chunk state s (N, P): warp w owns rows [w*N/4, (w+1)*N/4) of N ----
  constexpr int kMT = N / 64;  // 16-row m-tiles per warp
  float acc[kMT][P / 8][4] = {};
  const int n0 = warp * (N / 4);
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<1>();
    __syncthreads();
    const float last = seg[q - 1];
    const bf16* bt = sb + (j & 1) * L::kB;
    const bf16* xt = sx + (j & 1) * L::kX;
#pragma unroll
    for (int kk = 0; kk < kTcTile / 16; ++kk) {
      // exp(seg_last - seg_k) dt_k of this lane's four positions k
      const int k0 = j * kTcTile + kk * 16 + 2 * quad;
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + (e & 1) + (e >> 1) * 8;
        f[e] = expf(last - seg[k]) * dts[k];
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t a[4], hi[4], lo[4];
        ldmatrix_x4_trans(a, bt + kk * 16 * L::kNS + b_off + n0 + mt * 16);
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // registers 0, 1: k0, k0+1; 2, 3: k0+8, k0+9
          const float2 v = unpack_bf16(a[r]);
          const int e = (r >> 1) * 2;
          split_bf16(v.x * f[e], v.y * f[e + 1], hi[r], lo[r]);
        }
        times_x<P>(acc[mt], hi, lo, xt, x_off + kk * 16 * L::kPS);
      }
    }
    __syncthreads();
    if (j + 2 < ntiles) copy_tile(j + 2);
    cp_async_commit();
  }
  float* sm = s + (static_cast<long long>(m) * hn + h) * N * P;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int n = n0 + mt * 16 + group;
#pragma unroll
    for (int dn = 0; dn < P / 8; ++dn) {
      const int col = dn * 8 + 2 * quad;
      *reinterpret_cast<float2*>(sm + n * P + col) = make_float2(acc[mt][dn][0], acc[mt][dn][1]);
      *reinterpret_cast<float2*>(sm + (n + 8) * P + col) =
          make_float2(acc[mt][dn][2], acc[mt][dn][3]);
    }
  }
}

template <int P, int N>
int launch_tc(const void* x, const void* dt, const void* da, const void* b, const void* c,
              void* y, void* s, int m, int h, int q, const Strides& st, cudaStream_t stream) {
  constexpr size_t bytes = TcLayout<P, N>::kBytes;
  cudaError_t err = allow_shared_bytes(ssd_tc_kernel<P, N>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ytiles = (q + kTcTile - 1) / kTcTile;
  ssd_tc_kernel<P, N><<<dim3(ytiles + 1, h, m), kTcThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(da),
      static_cast<const bf16*>(b), static_cast<const bf16*>(c), static_cast<float*>(y),
      static_cast<float*>(s), h, q, st);
  return static_cast<int>(cudaGetLastError());
}

int launch_tensor_cores(const void* x, const void* dt, const void* da, const void* b,
                        const void* c, void* y, void* s, int m, int h, int q, int p, int n,
                        const Strides& st, cudaStream_t stream) {
  if (q < 1 || q > kQMax) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_SSD_TC(P, N) \
  if (p == P && n == N) return launch_tc<P, N>(x, dt, da, b, c, y, s, m, h, q, st, stream);
  REPRO_SSD_TC(64, 128)
  REPRO_SSD_TC(64, 64)
#undef REPRO_SSD_TC
  return static_cast<int>(cudaErrorInvalidValue);  // no instantiation for (p, n)
}

}  // namespace

// strides: 16 values in the order of struct Strides.  tensor_cores = 1
// takes ssd_tc_kernel (bf16 at an instantiated (p, n), 16-byte aligned
// operands; cb unused), 0 the CUDA-core kernels (cb: fp32 (m, q, q)).
extern "C" int ssd_intra_launch(const void* x, const void* dt, const void* da, const void* b,
                                const void* c, void* y, void* s, void* cb, int m, int h,
                                int q, int p, int n, const long long* strides, int dtype,
                                int tensor_cores, void* stream) {
  Strides st;
  memcpy(&st, strides, sizeof(Strides));
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (tensor_cores)
    return dtype == kBFloat16
               ? launch_tensor_cores(x, dt, da, b, c, y, s, m, h, q, p, n, st, cs)
               : static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return launch<float>(x, dt, da, b, c, y, s, cb, m, h, q, p, n, st, cs);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, dt, da, b, c, y, s, cb, m, h, q, p, n, st, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}
