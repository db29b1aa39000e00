// Backward of the Mamba-2 SSD intra-chunk part (ssd_intra.cu): per chunk m
// and head h, with seg = cumsum(dA), L_ij = exp(seg_i - seg_j) (i >= j),
// G = C B^T, u = x dt, W = G o L and e_j = exp(seg_last - seg_j) dt_j, the
// forward gave y = W u and s = sum_j e_j B_j x_j^T.  From the cotangents dy
// (Q, P) and ds (N, P):
//     D = dy x^T, dW = D dt_j (i >= j), du = W^T dy, R = dW o W,
//     w_j = ds^T B_j (P), v_j = w_j . x_j,
//     dx_j = du_j dt_j + e_j w_j,
//     ddt_j = du_j . x_j + v_j exp(seg_last - seg_j),
//     dseg = rowsum(R) - colsum(R) - v o e, plus sum_j v_j e_j at the last
//     position; ddA = the reverse cumsum of dseg,
//     dGs = sum_h dW o L (the heads' dG summed),
//     dC = dGs B, dB = dGs^T C + sum_h e_j (ds x_j).
//
// Replaces: the gradient XLA takes of the reference's jnp SSD
// (src/repro/models/ssm.py::ssd_chunked under jax.value_and_grad); the TPU
// kernel src/repro/kernels/ssd_scan.py::ssd_intra has no backward of its
// own.
//
// Bound on this card: bytes.  At the training shape of mamba2-780m (16
// chunks of 256, 48 heads, P 64, N 128, bf16 x) the inputs, the fp32
// cotangents and the gradients are ~133 MB (0.040 ms at 3.35 TB/s) against
// ~13 GFLOP of products (0.013 ms at the bf16 tensor-core rate).  This
// version runs every product on the CUDA cores in fp32 (~0.2 ms at their
// 67 TF/s for the products alone): right and deterministic first.
//
// Design: every product is a 64 x 64 output tile of a small GEMM, 256
// threads a block, each thread a 4 x 4 register tile fed from shared
// memory by one float4 and four broadcast scalars per k step (operands
// staged k-major where the thread reads a row of four).  Seven kernels in
// one launch, no float atomics (not even in shared memory), every sum in
// one fixed order, so reruns give the same bits:
//   1. ssd_bwd_seg_kernel: seg = cumsum(dA) per (chunk, head), one warp
//      each, in the forward's sequential order (fp32 scratch (M, H, Q));
//   2. ssd_bwd_cb_kernel: C B^T per chunk (one group: every head's), tiles
//      on or below the diagonal (fp32 scratch (M, Q, Q));
//   3. ssd_bwd_head_kernel: one block per (64-wide j tile, head, chunk):
//      w = ds^T B of the tile, then over the i tiles at or below it D, W, dW and R of
//      the tile pair, du += W^T dy in registers, R's row sums per pair
//      (scratch (M, H, Q/64, Q)) and column sums; then dx, ddt, R's column
//      sums and v e of the tile (scratch (M, H, Q) each);
//   4. ssd_bwd_dseg_kernel: one warp per (chunk, head): dseg from the row
//      sums (pair order), the column sums and v e; ddA its reverse cumsum;
//   5. ssd_bwd_dgs_kernel: one block per (i tile, j tile <= i tile, chunk)
//      walks the heads in order, recomputes D and sums dW o L (scratch
//      (M, Q, Q));
//   6. ssd_bwd_dc_kernel: dC = dGs B, one block per (i tile, 64 columns of
//      N, chunk);
//   7. ssd_bwd_db_kernel: dB = dGs^T C + sum_h (e x_h) ds_h^T, one block per
//      (j tile, 64 columns of N, chunk): one K loop over i, then one over
//      (head, p).
// Takes Q <= 256, P <= 128, N <= 128; x, B, C fp32 or bf16 (widened as read)
// with a unit-stride last axis, dt and dA fp32 strided, dy fp32 strided, ds
// fp32 contiguous; dx is written through its strides, ddt and ddA fp32
// contiguous (M, H, Q), dB and dC contiguous (M, Q, N) in x's dtype.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;          // rows and columns of an output tile
constexpr int kQMax = 256;
constexpr int kPMax = 128;
constexpr int kNMax = 128;
constexpr int kPC = kPMax / kT;  // 64-wide column groups of P a thread covers
constexpr int kS = kT + 4;       // row stride of a 64-wide tile (floats)
constexpr int kSP = kPMax + 4;   // row stride of a P-wide tile

struct Strides {
  long long xm, xh, xq;  // x (M, H, Q, P), P unit-stride
  long long dm, dh, dq;  // dt (M, H, Q)
  long long am, ah, aq;  // dA (M, H, Q)
  long long bm, bq;      // B (M, Q, N), N unit-stride
  long long cm, cq;      // C (M, Q, N), N unit-stride
  long long ym, yh, yq;  // dy (M, H, Q, P) fp32, P unit-stride
  long long gm, gh, gq;  // dx (M, H, Q, P), P unit-stride
};
static_assert(sizeof(Strides) == 19 * sizeof(long long), "Strides is 19 packed values");

// the fp32 scratch the wrapper allocates, carved in this order
struct Scratch {
  float *seg, *cb, *dgs, *rowpart, *colsum, *ve;
  __host__ Scratch(float* base, int m, int h, int q) {
    const long long mhq = static_cast<long long>(m) * h * q;
    const long long mqq = static_cast<long long>(m) * q * q;
    seg = base;
    cb = seg + mhq;
    dgs = cb + mqq;
    rowpart = dgs + mqq;
    colsum = rowpart + mhq * ((q + kT - 1) / kT);
    ve = colsum + mhq;
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at4(const float4& v, int b) {
  return b == 0 ? v.x : b == 1 ? v.y : b == 2 ? v.z : v.w;
}

// acc[a][b] += sum_k A[k][ty*4 + a] * B[k][tx*4 + b] over k < kn: A and B
// k-major tiles in shared memory of row strides sa and sb
__device__ __forceinline__ void mma_kmajor(float (&acc)[4][4], const float* a, int sa,
                                           const float* b, int sb, int kn, int ty, int tx) {
  for (int k = 0; k < kn; ++k) {
    const float4 av = ld4(a + k * sa + ty * 4);
    const float4 bv = ld4(b + k * sb + tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += at4(av, i) * at4(bv, j);
  }
}

// rows [r0, r0 + kT) of a (rows, w) operand with row stride rs into a
// shared (kT, ss) tile, widened to fp32, zeros past `rows` and past w up
// to w_pad
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ss, const T* __restrict__ src,
                                          long long rs, int r0, int rows, int w, int w_pad) {
  for (int e = threadIdx.x; e < kT * w_pad; e += kThreads) {
    const int r = e / w_pad, c = e - r * w_pad;
    dst[r * ss + c] = r0 + r < rows && c < w ? to_f32(src[(r0 + r) * rs + c]) : 0.f;
  }
}

// the same rows stored transposed: dst[c][r] (a (w, kT) tile of row
// stride ss), zeros past `rows`
template <typename T>
__device__ __forceinline__ void load_rows_t(float* dst, int ss, const T* __restrict__ src,
                                            long long rs, int r0, int rows, int w) {
  for (int e = threadIdx.x; e < kT * w; e += kThreads) {
    const int r = e / w, c = e - r * w;
    dst[c * ss + r] = r0 + r < rows ? to_f32(src[(r0 + r) * rs + c]) : 0.f;
  }
}

// One warp per (chunk, head): lane l loads position t0 + l of each 32
// positions; the running sum walks them in order through shuffles, so
// every lane adds in the forward's sequential order and lane k keeps the
// prefix at its position.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_seg_kernel(const float* __restrict__ da, float* __restrict__ seg, int m, int h,
                   int q, Strides st) {
  const long long r = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (r >= static_cast<long long>(m) * h) return;  // whole warps
  const int mi = static_cast<int>(r / h), hi = static_cast<int>(r - static_cast<long long>(mi) * h);
  const float* a = da + mi * st.am + hi * st.ah;
  float* out = seg + r * q;
  float run = 0.f;
  for (int t0 = 0; t0 < q; t0 += 32) {
    const int t = t0 + lane;
    const float v = t < q ? a[t * st.aq] : 0.f;
    float mine = 0.f;
    for (int k = 0; k < 32 && t0 + k < q; ++k) {
      run += __shfl_sync(0xffffffffu, v, k);
      if (lane == k) mine = run;
    }
    if (t < q) out[t] = mine;
  }
}

// C B^T of chunk m, the 64 x 64 tiles on or below the diagonal
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cb_kernel(const T* __restrict__ cmat, const T* __restrict__ bmat,
                  float* __restrict__ cb, int q, int n, Strides st) {
  const int it = blockIdx.x, jt = blockIdx.y, m = blockIdx.z;
  if (jt > it) return;  // above the diagonal: never read
  extern __shared__ float4 smem4[];
  float* sc = reinterpret_cast<float*>(smem4);  // (n, kS): C rows of the i tile, n-major
  float* sb = sc + kNMax * kS;                  // (n, kS): B rows of the j tile, n-major
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int i0 = it * kT, j0 = jt * kT;
  load_rows_t(sc, kS, cmat + m * st.cm, st.cq, i0, q, n);
  load_rows_t(sb, kS, bmat + m * st.bm, st.bq, j0, q, n);
  __syncthreads();
  float acc[4][4] = {};
  mma_kmajor(acc, sc, kS, sb, kS, n, ty, tx);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx * 4 + b;
      if (i < q && j < q) cb[(static_cast<long long>(m) * q + i) * q + j] = acc[a][b];
    }
  }
}

// One block per (j tile, head, chunk).  Thread (ty, tx) holds rows ty*4..+3
// and columns tx*4..+3 of each 64 x 64 tile: (i, j) for D, W and R; (j, p)
// for w and du, over kPC groups of 64 p.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_head_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const T* __restrict__ bmat, const float* __restrict__ dy,
                    const float* __restrict__ ds, Scratch sc, T* __restrict__ dx,
                    float* __restrict__ ddt, int h, int q, int p, int n, Strides st) {
  __shared__ float sseg[kQMax], sdt[kQMax];
  extern __shared__ float4 smem4[];
  float* sxt = reinterpret_cast<float*>(smem4);  // (P, kS): x of the j tile, p-major
  float* sdy = sxt + kPMax * kS;                 // (kT, kSP): dy of the i tile; ds chunks
  float* sw = sdy + kT * kSP;                    // (kT, kS): W of the tile pair; B chunks

  const int jt = blockIdx.x, hh = blockIdx.y, m = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nt = (q + kT - 1) / kT, j0 = jt * kT;
  const int p_pad = (p + 3) & ~3;
  const long long mh = static_cast<long long>(m) * h + hh;
  for (int t = tid; t < q; t += kThreads) {
    sseg[t] = sc.seg[mh * q + t];
    sdt[t] = dt[m * st.dm + hh * st.dh + t * st.dq];
  }
  const T* xh = x + m * st.xm + hh * st.xh;
  const float* dyh = dy + m * st.ym + hh * st.yh;
  const float* cbm = sc.cb + static_cast<long long>(m) * q * q;

  // w[j][p] = sum_n B[j][n] ds[n][p], n in chunks of 64 through sw and sdy
  float w[4][4 * kPC] = {};
  for (int n0 = 0; n0 < n; n0 += kT) {
    const int nc = min(kT, n - n0);
    __syncthreads();
    load_rows_t(sw, kS, bmat + m * st.bm + n0, st.bq, j0, q, nc);  // sw[n][j]
    load_rows(sdy, kSP, ds + (mh * n + n0) * p, p, 0, nc, p, p_pad);  // sdy[n][p]
    __syncthreads();
    for (int k = 0; k < nc; ++k) {
      const float4 bv = ld4(sw + k * kS + ty * 4);
#pragma unroll
      for (int c = 0; c < kPC; ++c) {
        if (c * kT >= p) break;
        const float4 dv = ld4(sdy + k * kSP + c * kT + tx * 4);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) w[a][c * 4 + b] += at4(bv, a) * at4(dv, b);
      }
    }
  }
  __syncthreads();
  load_rows_t(sxt, kS, xh, st.xq, j0, q, p);  // sxt[p][j]

  float du[4][4 * kPC] = {};
  float col[4] = {};
  for (int it = jt; it < nt; ++it) {  // the i tiles at or below the j tile
    const int i0 = it * kT;
    __syncthreads();  // the previous pair's readers of sdy and sw are done
    load_rows(sdy, kSP, dyh, st.yq, i0, q, p, p_pad);  // sdy[i][p]
    __syncthreads();
    // D[i][j] = dy_i . x_j: A = dy (i-major: four broadcast scalars), B = x^T
    float d[4][4] = {};
    for (int k = 0; k < p; ++k) {
      const float4 xv = ld4(sxt + k * kS + tx * 4);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float yv = sdy[(ty * 4 + a) * kSP + k];
#pragma unroll
        for (int b = 0; b < 4; ++b) d[a][b] += yv * at4(xv, b);
      }
    }
    float row[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty * 4 + a;
      float wr[4];
      row[a] = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = j0 + tx * 4 + b;
        float wv = 0.f, rv = 0.f;
        if (i < q && j <= i) {
          wv = cbm[static_cast<long long>(i) * q + j] * expf(sseg[i] - sseg[j]);
          rv = d[a][b] * sdt[j] * wv;
        }
        wr[b] = wv;
        row[a] += rv;
        col[b] += rv;
      }
      *reinterpret_cast<float4*>(sw + (ty * 4 + a) * kS + tx * 4) =
          make_float4(wr[0], wr[1], wr[2], wr[3]);
    }
    // R's row sums over the pair's 64 columns: the 16 lanes of a row, in order
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
#pragma unroll
      for (int a = 0; a < 4; ++a) row[a] += __shfl_xor_sync(0xffffffffu, row[a], o);
    if (tx == 0)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty * 4 + a;
        if (i < q) sc.rowpart[(mh * nt + jt) * q + i] = row[a];
      }
    __syncthreads();  // sw complete
    // du[j][p] += sum_i W[i][j] dy[i][p]
    for (int i = 0; i < kT; ++i) {
      const float4 wv = ld4(sw + i * kS + ty * 4);
#pragma unroll
      for (int c = 0; c < kPC; ++c) {
        if (c * kT >= p) break;
        const float4 yv = ld4(sdy + i * kSP + c * kT + tx * 4);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) du[a][c * 4 + b] += at4(wv, a) * at4(yv, b);
      }
    }
  }

  // R's column sums: each thread's four columns over its rows, then the
  // 16 threads of a column in ty order, through sw
  __syncthreads();
#pragma unroll
  for (int b = 0; b < 4; ++b) sw[ty * kS + tx * 4 + b] = col[b];
  __syncthreads();
  if (tid < kT && j0 + tid < q) {
    float a = 0.f;
    for (int r = 0; r < 16; ++r) a += sw[r * kS + tid];
    sc.colsum[mh * q + j0 + tid] = a;
  }
  // dx, ddt and v e of the j tile: thread (ty, tx) holds j = j0 + ty*4 + a
  const float seg_last = sseg[q - 1];
  float a_du[4] = {}, a_w[4] = {};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int jj = ty * 4 + a, j = j0 + jj;
    const bool ok = j < q;
    const float dtj = ok ? sdt[j] : 0.f;
    const float e = ok ? expf(seg_last - sseg[j]) * dtj : 0.f;
    T* dxr = dx + m * st.gm + hh * st.gh + static_cast<long long>(ok ? j : 0) * st.gq;
#pragma unroll
    for (int c = 0; c < kPC; ++c)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int pp = c * kT + tx * 4 + b;
        if (pp < p) {
          const float xv = sxt[pp * kS + jj];
          a_du[a] += du[a][c * 4 + b] * xv;
          a_w[a] += w[a][c * 4 + b] * xv;
          if (ok) dxr[pp] = from_f32<T>(du[a][c * 4 + b] * dtj + e * w[a][c * 4 + b]);
        }
      }
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      a_du[a] += __shfl_xor_sync(0xffffffffu, a_du[a], o);
      a_w[a] += __shfl_xor_sync(0xffffffffu, a_w[a], o);
    }
  if (tx == 0)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + ty * 4 + a;
      if (j < q) {
        const float decay = expf(seg_last - sseg[j]);
        ddt[mh * q + j] = a_du[a] + a_w[a] * decay;
        sc.ve[mh * q + j] = a_w[a] * decay * sdt[j];
      }
    }
}

// dseg = rowsum(R) - colsum(R) - v e, plus sum(v e) at the last position;
// ddA = its reverse cumsum.  One warp per (chunk, head): dseg lane-parallel
// over 32 positions at a time, the sums in position order through shuffles
// (the total of v e forwards, the cumsum backwards from the last position).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dseg_kernel(Scratch sc, float* __restrict__ dda, int mh_count, int q) {
  const long long mh = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (mh >= mh_count) return;  // whole warps
  const int nt = (q + kT - 1) / kT;
  const float* ve = sc.ve + mh * q;
  const float* colsum = sc.colsum + mh * q;
  const float* rowpart = sc.rowpart + mh * nt * q;
  float tot = 0.f;
  for (int t0 = 0; t0 < q; t0 += 32) {
    const float v = t0 + lane < q ? ve[t0 + lane] : 0.f;
    for (int k = 0; k < 32 && t0 + k < q; ++k) tot += __shfl_sync(0xffffffffu, v, k);
  }
  float run = 0.f;
  for (int t0 = (q - 1) / 32 * 32; t0 >= 0; t0 -= 32) {
    const int t = t0 + lane;
    float d = 0.f;
    if (t < q) {
      float row = 0.f;
      for (int jt = 0; jt <= t / kT; ++jt) row += rowpart[jt * q + t];
      d = row - colsum[t] - ve[t] + (t == q - 1 ? tot : 0.f);
    }
    float mine = 0.f;
    for (int k = min(31, q - 1 - t0); k >= 0; --k) {
      run += __shfl_sync(0xffffffffu, d, k);
      if (lane == k) mine = run;
    }
    if (t < q) dda[mh * q + t] = mine;
  }
}

// dGs[i][j] = sum_h D_h[i][j] dt_h[j] exp(seg_h[i] - seg_h[j]) (i >= j),
// heads in order.  One block per (tile pair (it, jt <= it), chunk).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dgs_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ dy, Scratch sc, int h, int q, int p, Strides st) {
  __shared__ float sseg_i[kT], sseg_j[kT], sdt_j[kT];
  extern __shared__ float4 smem4[];
  float* sxt = reinterpret_cast<float*>(smem4);  // (P, kS): x of the j tile, p-major
  float* sdy = sxt + kPMax * kS;                 // (kT, kSP): dy of the i tile
  int it = 0, pair = blockIdx.x;  // pairs in order: (0,0), (1,0), (1,1), (2,0), ...
  while (pair > it) pair -= ++it;
  const int jt = pair, m = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int i0 = it * kT, j0 = jt * kT, p_pad = (p + 3) & ~3;
  float g[4][4] = {};
  for (int hh = 0; hh < h; ++hh) {
    const long long mh = static_cast<long long>(m) * h + hh;
    __syncthreads();  // the previous head's readers are done
    if (tid < kT) {
      const int i = i0 + tid, j = j0 + tid;
      sseg_i[tid] = i < q ? sc.seg[mh * q + i] : 0.f;
      sseg_j[tid] = j < q ? sc.seg[mh * q + j] : 0.f;
      sdt_j[tid] = j < q ? dt[m * st.dm + hh * st.dh + j * st.dq] : 0.f;
    }
    load_rows(sdy, kSP, dy + m * st.ym + hh * st.yh, st.yq, i0, q, p, p_pad);
    load_rows_t(sxt, kS, x + m * st.xm + hh * st.xh, st.xq, j0, q, p);
    __syncthreads();
    float d[4][4] = {};
    for (int k = 0; k < p; ++k) {
      const float4 xv = ld4(sxt + k * kS + tx * 4);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float yv = sdy[(ty * 4 + a) * kSP + k];
#pragma unroll
        for (int b = 0; b < 4; ++b) d[a][b] += yv * at4(xv, b);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ii = ty * 4 + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int jj = tx * 4 + b;
        if (i0 + ii < q && j0 + jj <= i0 + ii)
          g[a][b] += d[a][b] * sdt_j[jj] * expf(sseg_i[ii] - sseg_j[jj]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx * 4 + b;
      if (i < q && j <= i) sc.dgs[(static_cast<long long>(m) * q + i) * q + j] = g[a][b];
    }
  }
}

// dGs of rows [i0, +64) and columns [j0, +64) of chunk m into a shared
// tile: transposed (dst[j][i]) or not (dst[i][j]), zeros where j > i or
// past q
__device__ __forceinline__ void load_dgs(float* dst, const float* dgm, int i0, int j0, int q,
                                         bool transposed) {
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int r = e / kT, c = e - r * kT;  // r: i, c: j
    const int i = i0 + r, j = j0 + c;
    const float v = i < q && j <= i ? dgm[static_cast<long long>(i) * q + j] : 0.f;
    if (transposed)
      dst[c * kS + r] = v;
    else
      dst[r * kS + c] = v;
  }
}

// dC[i][n] = sum_{j <= i} dGs[i][j] B[j][n].  One block per (i tile, 64
// columns of N, chunk).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dc_kernel(const T* __restrict__ bmat, Scratch sc, T* __restrict__ dc, int q, int n,
                  Strides st) {
  extern __shared__ float4 smem4[];
  float* sg = reinterpret_cast<float*>(smem4);  // (kT, kS): dGs^T of the tile, j-major
  float* sb = sg + kT * kS;                     // (kT, kS): B rows of the j tile
  const int it = blockIdx.x, n0 = blockIdx.y * kT, m = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int i0 = it * kT, nc = min(kT, n - n0);
  const float* dgm = sc.dgs + static_cast<long long>(m) * q * q;
  float acc[4][4] = {};
  for (int jt = 0; jt <= it; ++jt) {
    __syncthreads();
    load_dgs(sg, dgm, i0, jt * kT, q, true);
    load_rows(sb, kS, bmat + m * st.bm + n0, st.bq, jt * kT, q, nc, kT);
    __syncthreads();
    mma_kmajor(acc, sg, kS, sb, kS, kT, ty, tx);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int nn = tx * 4 + b;
      if (i < q && nn < nc) dc[(static_cast<long long>(m) * q + i) * n + n0 + nn] =
          from_f32<T>(acc[a][b]);
    }
  }
}

// dB[j][n] = sum_{i >= j} dGs[i][j] C[i][n] + sum_h sum_p e_h[j] x_h[j][p]
// ds_h[n][p].  One block per (j tile, 64 columns of N, chunk).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_db_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const T* __restrict__ cmat, const float* __restrict__ ds, Scratch sc,
                  T* __restrict__ db, int h, int q, int p, int n, Strides st) {
  __shared__ float se[kT];
  extern __shared__ float4 smem4[];
  float* sa = reinterpret_cast<float*>(smem4);  // (kPMax, kS): k-major A operand
  float* sb = sa + kPMax * kS;                  // (kPMax, kS): k-major B operand
  const int jt = blockIdx.x, n0 = blockIdx.y * kT, m = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int j0 = jt * kT, nc = min(kT, n - n0), nt = (q + kT - 1) / kT;
  const float* dgm = sc.dgs + static_cast<long long>(m) * q * q;
  float acc[4][4] = {};
  for (int it = jt; it < nt; ++it) {  // dGs^T C, i in order
    __syncthreads();
    load_dgs(sa, dgm, it * kT, j0, q, false);  // sa[i][j]
    load_rows(sb, kS, cmat + m * st.cm + n0, st.cq, it * kT, q, nc, kT);  // sb[i][n]
    __syncthreads();
    mma_kmajor(acc, sa, kS, sb, kS, kT, ty, tx);
  }
  for (int hh = 0; hh < h; ++hh) {  // sum_h (e x_h) ds_h^T, heads in order
    const long long mh = static_cast<long long>(m) * h + hh;
    __syncthreads();
    if (tid < kT) {
      const int j = j0 + tid;
      se[tid] = j < q ? expf(sc.seg[mh * q + q - 1] - sc.seg[mh * q + j]) *
                            dt[m * st.dm + hh * st.dh + j * st.dq]
                      : 0.f;
    }
    load_rows_t(sa, kS, x + m * st.xm + hh * st.xh, st.xq, j0, q, p);  // sa[p][j]
    load_rows_t(sb, kS, ds + mh * n * p + static_cast<long long>(n0) * p, p, 0, nc, p);  // sb[p][n]
    __syncthreads();
    float part[4][4] = {};
    mma_kmajor(part, sa, kS, sb, kS, p, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] += se[ty * 4 + a] * part[a][b];
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty * 4 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int nn = tx * 4 + b;
      if (j < q && nn < nc) db[(static_cast<long long>(m) * q + j) * n + n0 + nn] =
          from_f32<T>(acc[a][b]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* da, const void* b, const void* c,
           const float* dy, const float* ds, void* dx, float* ddt, float* dda, void* db,
           void* dc, float* scratch, int m, int h, int q, int p, int n, const Strides& st,
           cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(b);
  const T* ct = static_cast<const T*>(c);
  const Scratch sc(scratch, m, h, q);
  const int nt = (q + kT - 1) / kT, ncol = (n + kT - 1) / kT;
  const size_t cb_bytes = sizeof(float) * 2 * kNMax * kS;
  const size_t head_bytes = sizeof(float) * (kPMax * kS + kT * kSP + kT * kS);
  const size_t dgs_bytes = sizeof(float) * (kPMax * kS + kT * kSP);
  const size_t dc_bytes = sizeof(float) * 2 * kT * kS;
  const size_t db_bytes = sizeof(float) * 2 * kPMax * kS;
  cudaError_t err = allow_shared_bytes(ssd_bwd_cb_kernel<T>, cb_bytes);
  if (err == cudaSuccess) err = allow_shared_bytes(ssd_bwd_head_kernel<T>, head_bytes);
  if (err == cudaSuccess) err = allow_shared_bytes(ssd_bwd_dgs_kernel<T>, dgs_bytes);
  if (err == cudaSuccess) err = allow_shared_bytes(ssd_bwd_dc_kernel<T>, dc_bytes);
  if (err == cudaSuccess) err = allow_shared_bytes(ssd_bwd_db_kernel<T>, db_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(m) * h;  // a warp each
  const unsigned row_blocks = static_cast<unsigned>((rows * 32 + kThreads - 1) / kThreads);
  ssd_bwd_seg_kernel<<<row_blocks, kThreads, 0, s>>>(da, sc.seg, m, h, q, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_cb_kernel<T><<<dim3(nt, nt, m), kThreads, cb_bytes, s>>>(ct, bt, sc.cb, q, n,
                                                                   st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_head_kernel<T><<<dim3(nt, h, m), kThreads, head_bytes, s>>>(
      xt, dt, bt, dy, ds, sc, static_cast<T*>(dx), ddt, h, q, p, n, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dseg_kernel<<<row_blocks, kThreads, 0, s>>>(sc, dda, static_cast<int>(rows), q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dgs_kernel<T><<<dim3(nt * (nt + 1) / 2, m), kThreads, dgs_bytes, s>>>(
      xt, dt, dy, sc, h, q, p, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dc_kernel<T><<<dim3(nt, ncol, m), kThreads, dc_bytes, s>>>(
      bt, sc, static_cast<T*>(dc), q, n, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_db_kernel<T><<<dim3(nt, ncol, m), kThreads, db_bytes, s>>>(
      xt, dt, ct, ds, sc, static_cast<T*>(db), h, q, p, n, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, H, Q, P), B/C (M, Q, N) fp32 or bf16 (`dtype`), dt/dA (M, H, Q) fp32,
// dy (M, H, Q, P) fp32 through `strides`; ds (M, H, N, P) fp32 contiguous.
// Writes dx (x's dtype, through its strides), ddt and ddA (M, H, Q) fp32,
// dB and dC (M, Q, N) in x's dtype.  `scratch` is fp32 of
// M H Q (3 + ceil(Q / 64)) + 2 M Q Q floats.  Q <= 256, P <= 128, N <= 128.
extern "C" int ssd_intra_bwd_launch(const void* x, const void* dt, const void* da,
                                    const void* b, const void* c, const void* dy,
                                    const void* ds, void* dx, void* ddt, void* dda, void* db,
                                    void* dc, void* scratch, int m, int h, int q, int p, int n,
                                    const long long* strides, int dtype, void* stream) {
  if (m < 1 || h < 1 || q < 1 || q > kQMax || p < 1 || p > kPMax || n < 1 || n > kNMax)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  memcpy(&st, strides, sizeof(Strides));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* daf = static_cast<const float*>(da);
  const float* dyf = static_cast<const float*>(dy);
  const float* dsf = static_cast<const float*>(ds);
  float* ddtf = static_cast<float*>(ddt);
  float* ddaf = static_cast<float*>(dda);
  float* scr = static_cast<float*>(scratch);
  if (dtype == kFloat32)
    return launch<float>(x, dtf, daf, b, c, dyf, dsf, dx, ddtf, ddaf, db, dc, scr, m, h, q, p, n,
                         st, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, dtf, daf, b, c, dyf, dsf, dx, ddtf, ddaf, db, dc, scr, m, h,
                                 q, p, n, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
