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
// ~13 GFLOP of products (0.013 ms at the bf16 tensor-core rate).
//
// Two routes, no float atomics on either (not even in shared memory),
// every sum in one fixed order, so reruns give the same bits.
//
// The CUDA cores (fp32, and bf16 at the other widths): every product is a
// 64 x 64 output tile of a small GEMM, 256 threads a block, each thread a
// 4 x 4 register tile fed from shared memory by one float4 and four
// broadcast scalars per k step (operands staged k-major where the thread
// reads a row of four).  Seven kernels in one launch:
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
//
// The tensor cores (bf16 at (P, N) = (64, 128), mamba2, and (64, 64),
// zamba2, with 16-byte aligned x, B and C: the forward's route).  What
// held the CUDA-core route back at these shapes (1.93 ms at mamba2's, 49x
// the bound): every product in fp32 on the CUDA cores; the dGs kernel's
// 160 blocks (about one an SM), each walking all H heads and recomputing
// D per head; the db kernel's head loop in the same 128 blocks.  Here:
//   * every product is an mma.sync.m16n8k16 (bf16 in, fp32 accumulate) fed
//     by ldmatrix from tiles padded by 16 bytes a row, 4 warps of 16 rows;
//   * the fp32 operands enter as the bf16 pair hi + lo (hi = bf16(v), lo =
//     bf16(v - hi)): dy and ds (the cotangents) and W = G o L in the head
//     kernel, two products each, three for W^T dy (hi hi, hi lo, lo hi).
//     One rounding would leave 2^-9 of each value where the fp32 route
//     keeps 2^-24; the pair keeps 2^-17, so the route's error against the
//     plain version is the final bf16 rounding of dx, dB and dC.  x, B
//     and C are bf16 already: exact;
//   * ssd_bwd_split_kernel writes dy's and ds's pairs once (bf16 scratch),
//     so the other kernels copy every operand tile with cp.async;
//   * ssd_bwd_head_tc_kernel takes the head kernel's place (C B^T of the
//     tile pair recomputed on the tensor cores, so no cb kernel);
//   * the head sums of dGs (ssd_bwd_groups_tc_kernel, one block per (tile
//     pair, group of heads, chunk): 1,280 blocks at mamba2's shape) and of
//     dB's e x ds^T term (ssd_bwd_dbh_tc_kernel, per (j tile, group,
//     chunk)) run per group of at most 8 heads, each group's partial sums
//     in fp32 scratch, the heads of a group in a ring of two cp.async
//     stages; ssd_bwd_group_sum_kernel adds the groups in order;
//   * seg, dseg, dc and db (with the summed head term) stay as above.
// Takes Q <= 256, P <= 128, N <= 128; x, B, C fp32 or bf16 (widened as read)
// with a unit-stride last axis, dt and dA fp32 strided, dy fp32 strided, ds
// fp32 contiguous; dx is written through its strides, ddt and ddA fp32
// contiguous (M, H, Q), dB and dC contiguous (M, Q, N) in x's dtype.
#include <cstring>

#include "common.cuh"
#include "tensor_core.cuh"

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
                  const float* __restrict__ dbh, T* __restrict__ db, int h, int q, int p, int n,
                  Strides st) {
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
  // sum_h (e x_h) ds_h^T, heads in order (or summed already: dbh)
  for (int hh = 0; dbh == nullptr && hh < h; ++hh) {
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
      if (j >= q || nn >= nc) continue;
      const long long at = (static_cast<long long>(m) * q + j) * n + n0 + nn;
      db[at] = from_f32<T>(dbh == nullptr ? acc[a][b] : acc[a][b] + dbh[at]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at the tensor-core widths (P, N) = (64, 128), (64, 64)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;  // 4 warps, 16 rows of a 64-row tile each
constexpr int kGroups = 8;       // head groups of the dGs and dB head sums

template <int P, int N>
struct TcLayout {
  static_assert(P % 16 == 0 && N % 64 == 0, "P must be a multiple of 16, N of 64");
  static constexpr int kPS = P + 8;  // padded row strides (elements): the 8
  static constexpr int kNS = N + 8;  // rows of an ldmatrix hit 8 bank groups
  static constexpr int kX = kT * kPS;  // a 64-row x or dy tile
  static constexpr int kB = kT * kNS;  // a 64-row B or C tile
  static constexpr int kDs = N * kPS;  // ds (N, P)
  // head kernel: x_j, B_j, then (C_i, dy_i hi, lo) or, after the walk,
  // (ds hi, lo); seg and dt of the chunk; R's row sums by warp.  One stage:
  // with the columns of a pair taken kIC at a time the kernel fits in
  // under 170 registers, and three blocks an SM (65 KB each) hid the loads
  // better than two blocks with a second stage
  static constexpr int kIC = 32;
  static constexpr int kWalk = kB + 2 * kX > 2 * kDs ? kB + 2 * kX : 2 * kDs;
  static constexpr size_t kHeadBytes =
      sizeof(bf16) * (kX + kB + kWalk) + sizeof(float) * (2 * kQMax + 4 * kT);
  // groups kernel: a ring of two (dy_i hi, lo, x_j) stages; their seg_i,
  // seg_j and dt_j
  static constexpr size_t kGroupBytes = sizeof(bf16) * 2 * 3 * kX + sizeof(float) * 2 * 3 * kT;
  // dB head kernel: a ring of two (x_j, ds hi, lo) stages; their e_j
  static constexpr size_t kDbhBytes = sizeof(bf16) * 2 * (kX + 2 * kDs) + sizeof(float) * 2 * kT;
};

// (a, b) as the bf16 pair hi + lo (hi = bf16(v), lo = bf16(v - hi)), two
// columns in one register each: the A or B operand of two products whose
// sum carries ~16 bits of v's mantissa
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack_bf16(a - __low2float(h2), b - __high2float(h2));
}

// acc (16 x 8 NT, C fragments) += A[a_row0, +16) . B[b_row0, +8 NT)^T over
// width K, A and B row-major tiles in shared memory of row strides SA, SB
template <int K, int SA, int SB, int NT>
__device__ __forceinline__ void mma_nt(float (&acc)[NT][4], const bf16* a, int a_row0,
                                       const bf16* b, int b_row0, int lane) {
  const int a_off = (a_row0 + (lane & 15)) * SA + (lane >> 4) * 8;
  const int b_off = (b_row0 + (lane & 7) + ((lane >> 4) << 3)) * SB + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + a_off + kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + np * 16 * SB + b_off + kk * 16);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x 8 NT) += A (16 x K, A fragments in registers) . C[0, K) (a
// row-major (K, 8 NT) tile in shared memory of row stride SC)
template <int K, int SC, int NT>
__device__ __forceinline__ void mma_rc(float (&acc)[NT][4], const uint32_t (&af)[K / 16][4],
                                       const bf16* c, int lane) {
  const int c_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * SC + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      uint32_t bc[4];
      ldmatrix_x4_trans(bc, c + kk * 16 * SC + c_off + dp * 16);
      mma_bf16(acc[2 * dp], af[kk], bc[0], bc[1]);
      mma_bf16(acc[2 * dp + 1], af[kk], bc[2], bc[3]);
    }
  }
}

// acc (16 x 8 NT) += A[a_row0, +16) (a row-major (rows, K) tile of row
// stride SA) . C[0, K) (row-major (K, 8 NT) of row stride SC)
template <int K, int SA, int SC, int NT>
__device__ __forceinline__ void mma_sc(float (&acc)[NT][4], const bf16* a, int a_row0,
                                       const bf16* c, int lane) {
  const int a_off = (a_row0 + (lane & 15)) * SA + (lane >> 4) * 8;
  const int c_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * SC + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + a_off + kk * 16);
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      uint32_t bc[4];
      ldmatrix_x4_trans(bc, c + kk * 16 * SC + c_off + dp * 16);
      mma_bf16(acc[2 * dp], af, bc[0], bc[1]);
      mma_bf16(acc[2 * dp + 1], af, bc[2], bc[3]);
    }
  }
}

// dy and ds as their bf16 pairs hi + lo, (M, H, Q, P) and (M, H, N, P)
// contiguous: the tensor-core kernels then copy their operand tiles with
// cp.async, and no tile is split twice.  One block per row: the M Q rows
// (m, q) of dy (its H heads, in the model's (M, Q, H, P) order) and then
// the M H rows (m, h) of ds; 8 columns a thread at a time.
__device__ __forceinline__ void split8(const float* __restrict__ src, bf16* hi, bf16* lo) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  uint4 h, l;
  split_pair(a.x, a.y, h.x, l.x);
  split_pair(a.z, a.w, h.y, l.y);
  split_pair(b.x, b.y, h.z, l.z);
  split_pair(b.z, b.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_split_kernel(const float* __restrict__ dy, const float* __restrict__ ds,
                     bf16* __restrict__ yh, bf16* __restrict__ yl, bf16* __restrict__ dh,
                     bf16* __restrict__ dl, int m, int h, int q, Strides st) {
  constexpr int kC = P / 8;  // 8-column chunks of a head's row
  const int row = blockIdx.x;
  if (row < m * q) {
    const int mi = row / q, qi = row - mi * q;
    for (int c = threadIdx.x; c < h * kC; c += kThreads) {
      const int hh = c / kC, pp = (c - hh * kC) * 8;
      const long long at = ((static_cast<long long>(mi) * h + hh) * q + qi) * P + pp;
      split8(dy + mi * st.ym + hh * st.yh + qi * st.yq + pp, yh + at, yl + at);
    }
  } else {
    const long long at0 = static_cast<long long>(row - m * q) * N * P;
    for (int c = threadIdx.x; c < N * kC; c += kThreads)
      split8(ds + at0 + 8 * c, dh + at0 + 8 * c, dl + at0 + 8 * c);
  }
}

// One block per (j tile, head, chunk), as ssd_bwd_head_kernel, on the
// tensor cores; warp w owns rows j [16 w, 16 w + 16) of the tile.  Per i
// tile at or below it, with C_i and dy_i's pair in shared memory, kIC
// columns i at a time: G^T = B_j C_i^T (bf16 operands, exact products),
// D^T = x_j dy_i^T (dy's pair), then in registers W^T = G^T o L^T, R^T =
// D^T dt_j o W^T, R's column sums over i (rows j here) and row sums over
// j (through shared memory, by warp); du += W^T dy_i with W^T's pair as
// the A operand (three products: hi hi, hi lo, lo hi).  After the walk w
// = B_j ds (ds's pair), then dx, ddt and v e of the tile's rows.
template <int P, int N>
__global__ void __launch_bounds__(kTcThreads, 3)
ssd_bwd_head_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const bf16* __restrict__ bmat, const bf16* __restrict__ cmat,
                       const bf16* __restrict__ yhi, const bf16* __restrict__ ylo,
                       const bf16* __restrict__ dshi, const bf16* __restrict__ dslo, Scratch sc,
                       bf16* __restrict__ dx, float* __restrict__ ddt, int h, int q, Strides st) {
  using L = TcLayout<P, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sx = reinterpret_cast<bf16*>(smem_raw);  // (64, P+8): x of the j tile
  bf16* sbj = sx + L::kX;                         // (64, N+8): B of the j tile
  bf16* sci = sbj + L::kB;                        // (64, N+8): C of the i tile
  bf16* syh = sci + L::kB;                        // (64, P+8): dy of the i tile, hi
  bf16* syl = syh + L::kX;                        //   and lo
  bf16* sdh = sci;                                // (N, P+8): ds hi, after the walk
  bf16* sdl = sdh + L::kDs;                       //   and lo
  float* sseg = reinterpret_cast<float*>(sci + L::kWalk);
  float* sdt = sseg + kQMax;
  float* srow = sdt + kQMax;  // (4, 64): R's row sums of the tile pair, by warp

  const int jt = blockIdx.x, hh = blockIdx.y, m = blockIdx.z;
  const int nt = (q + kT - 1) / kT, j0 = jt * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, group = lane >> 2, quad = lane & 3;
  const long long mh = static_cast<long long>(m) * h + hh;
  copy_rows_async<kT, P, kTcThreads>(sx, L::kPS, x + m * st.xm + hh * st.xh, st.xq, j0, q);
  copy_rows_async<kT, N, kTcThreads>(sbj, L::kNS, bmat + m * st.bm, st.bq, j0, q);
  cp_async_commit();
  const bf16* yh = yhi + mh * q * P;
  const bf16* yl = ylo + mh * q * P;
  for (int t = threadIdx.x; t < q; t += kTcThreads) {
    sseg[t] = sc.seg[mh * q + t];
    sdt[t] = dt[m * st.dm + hh * st.dh + t * st.dq];
  }
  const int jr = warp * 16 + group;  // this lane's rows of the tile: jr, jr + 8

  float du[P / 8][4];
#pragma unroll
  for (int i = 0; i < P / 8; ++i) du[i][0] = du[i][1] = du[i][2] = du[i][3] = 0.f;
  float colp[2] = {0.f, 0.f};  // R's column sums (over i) of rows jr, jr + 8
  for (int it = jt; it < nt; ++it) {  // the i tiles at or below the j tile
    const int i0 = it * kT;
    copy_rows_async<kT, N, kTcThreads>(sci, L::kNS, cmat + m * st.cm, st.cq, i0, q);
    copy_rows_async<kT, P, kTcThreads>(syh, L::kPS, yh, P, i0, q);
    copy_rows_async<kT, P, kTcThreads>(syl, L::kPS, yl, P, i0, q);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // tile it (and x_j, B_j, seg, dt) landed for every thread
    constexpr int kNT = L::kIC / 8;
#pragma unroll 1
    for (int c0 = 0; c0 < kT; c0 += L::kIC) {
      float g[kNT][4], d[kNT][4];
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) g[t][e] = d[t][e] = 0.f;
      mma_nt<N, L::kNS, L::kNS, kNT>(g, sbj, warp * 16, sci, c0, lane);  // G^T = B_j C_i^T
      mma_nt<P, L::kPS, L::kPS, kNT>(d, sx, warp * 16, syh, c0, lane);   // D^T = x_j dy_i^T
      mma_nt<P, L::kPS, L::kPS, kNT>(d, sx, warp * 16, syl, c0, lane);
      uint32_t wh[kNT / 2][4], wl[kNT / 2][4];  // W^T's pair as A fragments (k = i)
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + jr + (e >> 1) * 8, i = i0 + c0 + t * 8 + 2 * quad + (e & 1);
          const bool ok = i < q && j <= i;
          w[e] = ok ? g[t][e] * expf(sseg[i] - sseg[j]) : 0.f;
          d[t][e] = ok ? d[t][e] * sdt[j] * w[e] : 0.f;  // R^T
          colp[e >> 1] += d[t][e];
        }
        split_pair(w[0], w[1], wh[t >> 1][(t & 1) * 2], wl[t >> 1][(t & 1) * 2]);
        split_pair(w[2], w[3], wh[t >> 1][(t & 1) * 2 + 1], wl[t >> 1][(t & 1) * 2 + 1]);
      }
      // R's row sums (over j) of these columns: this lane's two rows, then
      // the warp's 8 row groups, then (below) the 4 warps in order
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v = d[t][c] + d[t][c + 2];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (group == 0) srow[warp * kT + c0 + t * 8 + 2 * quad + c] = v;
        }
      // du[j][p] += sum_i W[i][j] dy[i][p]
      mma_rc<L::kIC, L::kPS, P / 8>(du, wh, syh + c0 * L::kPS, lane);
      mma_rc<L::kIC, L::kPS, P / 8>(du, wh, syl + c0 * L::kPS, lane);
      mma_rc<L::kIC, L::kPS, P / 8>(du, wl, syh + c0 * L::kPS, lane);
    }
    __syncthreads();  // srow complete; the tiles' readers are done
    if (threadIdx.x < kT && i0 + threadIdx.x < q)
      sc.rowpart[(mh * nt + jt) * q + i0 + threadIdx.x] =
          srow[threadIdx.x] + srow[kT + threadIdx.x] + srow[2 * kT + threadIdx.x] +
          srow[3 * kT + threadIdx.x];
  }

  // R's column sums of rows jr, jr + 8: the 4 lanes of a row
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    colp[c] += __shfl_xor_sync(0xffffffffu, colp[c], 1);
    colp[c] += __shfl_xor_sync(0xffffffffu, colp[c], 2);
    const int j = j0 + jr + 8 * c;
    if (quad == 0 && j < q) sc.colsum[mh * q + j] = colp[c];
  }
  copy_rows_async<N, P, kTcThreads>(sdh, L::kPS, dshi + mh * N * P, P, 0, N);
  copy_rows_async<N, P, kTcThreads>(sdl, L::kPS, dslo + mh * N * P, P, 0, N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float w[P / 8][4];  // w[j][p] = sum_n B[j][n] ds[n][p]
#pragma unroll
  for (int i = 0; i < P / 8; ++i) w[i][0] = w[i][1] = w[i][2] = w[i][3] = 0.f;
  mma_sc<N, L::kNS, L::kPS, P / 8>(w, sbj, warp * 16, sdh, lane);
  mma_sc<N, L::kNS, L::kPS, P / 8>(w, sbj, warp * 16, sdl, lane);

  // dx, ddt and v e of rows jr, jr + 8
  const float seg_last = sseg[q - 1];
  float a_du[2] = {0.f, 0.f}, a_w[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int jj = jr + 8 * c, j = j0 + jj;
    const bool ok = j < q;
    const float dtj = ok ? sdt[j] : 0.f;
    const float e = ok ? expf(seg_last - sseg[j]) * dtj : 0.f;
    bf16* dxr = dx + m * st.gm + hh * st.gh + static_cast<long long>(ok ? j : 0) * st.gq;
#pragma unroll
    for (int t = 0; t < P / 8; ++t) {
      const int pp = t * 8 + 2 * quad;
      const float x0 = __bfloat162float(sx[jj * L::kPS + pp]);
      const float x1 = __bfloat162float(sx[jj * L::kPS + pp + 1]);
      const float u0 = du[t][2 * c], u1 = du[t][2 * c + 1];
      const float w0 = w[t][2 * c], w1 = w[t][2 * c + 1];
      a_du[c] += u0 * x0 + u1 * x1;
      a_w[c] += w0 * x0 + w1 * x1;
      if (ok)
        *reinterpret_cast<__nv_bfloat162*>(dxr + pp) =
            __floats2bfloat162_rn(u0 * dtj + e * w0, u1 * dtj + e * w1);
    }
    a_du[c] += __shfl_xor_sync(0xffffffffu, a_du[c], 1);
    a_du[c] += __shfl_xor_sync(0xffffffffu, a_du[c], 2);
    a_w[c] += __shfl_xor_sync(0xffffffffu, a_w[c], 1);
    a_w[c] += __shfl_xor_sync(0xffffffffu, a_w[c], 2);
    if (quad == 0 && ok) {
      const float decay = expf(seg_last - sseg[j]);
      ddt[mh * q + j] = a_du[c] + a_w[c] * decay;
      sc.ve[mh * q + j] = a_w[c] * decay * dtj;
    }
  }
}

// The heads of a group [h0, h1) of chunk m, a ring of two cp.async stages
// over them: the tiles of head h0 + t go to stage t & 1.
struct HeadRing {
  int h0, h1;
  __device__ HeadRing(int h, int groups, int grp) {
    const int per = (h + groups - 1) / groups;
    h0 = grp * per;
    h1 = min(h, h0 + per);
  }
};

// One block per (tile pair (it, jt <= it), head group, chunk): over the
// group's heads in order, dGs[i][j] += D[i][j] dt_j exp(seg_i - seg_j)
// with D = dy_i x_j^T on the tensor cores (dy's pair; the next head's
// tiles land while this one is computed); warp w owns rows i [16 w, 16 w +
// 16).  Each group writes its own partial sums; ssd_bwd_group_sum_kernel
// adds the groups in order.
template <int P, int N>
__global__ void __launch_bounds__(kTcThreads, 3)
ssd_bwd_groups_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                         const bf16* __restrict__ yhi, const bf16* __restrict__ ylo, Scratch sc,
                         float* __restrict__ dgs_part, int h, int q, Strides st) {
  using L = TcLayout<P, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // 2 x (dy_i hi, lo, x_j), (64, P+8) each
  float* sf = reinterpret_cast<float*>(ring + 2 * 3 * L::kX);  // 2 x (seg_i, seg_j, dt_j)

  int it = 0, pair = blockIdx.x;  // pairs in order: (0,0), (1,0), (1,1), (2,0), ...
  while (pair > it) pair -= ++it;
  const int jt = pair, grp = blockIdx.y, m = blockIdx.z, m_count = gridDim.z;
  const HeadRing hr(h, gridDim.y, grp);
  const int i0 = it * kT, j0 = jt * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, group = lane >> 2, quad = lane & 3;
  const int ir = warp * 16 + group;  // this lane's rows: ir, ir + 8
  auto issue = [&](int hh) {
    const long long mh = static_cast<long long>(m) * h + hh;
    const int stg = (hh - hr.h0) & 1;
    bf16* yh = ring + stg * 3 * L::kX;
    copy_rows_async<kT, P, kTcThreads>(yh, L::kPS, yhi + mh * q * P, P, i0, q);
    copy_rows_async<kT, P, kTcThreads>(yh + L::kX, L::kPS, ylo + mh * q * P, P, i0, q);
    copy_rows_async<kT, P, kTcThreads>(yh + 2 * L::kX, L::kPS, x + m * st.xm + hh * st.xh,
                                       st.xq, j0, q);
    cp_async_commit();
    // seg and dt are written by plain stores: the barrier after the wait
    // publishes them with the tiles
    float* f = sf + stg * 3 * kT;
    if (threadIdx.x < kT) {
      const int t = threadIdx.x, i = i0 + t, j = j0 + t;
      f[t] = i < q ? sc.seg[mh * q + i] : 0.f;
      f[kT + t] = j < q ? sc.seg[mh * q + j] : 0.f;
      f[2 * kT + t] = j < q ? dt[m * st.dm + hh * st.dh + j * st.dq] : 0.f;
    }
  };

  float g[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t) g[t][0] = g[t][1] = g[t][2] = g[t][3] = 0.f;
  if (hr.h0 < hr.h1) issue(hr.h0);
  for (int hh = hr.h0; hh < hr.h1; ++hh) {
    if (hh + 1 < hr.h1) {
      issue(hh + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // head hh's tiles landed for every thread
    const int stg = (hh - hr.h0) & 1;
    const bf16* syh = ring + stg * 3 * L::kX;
    const float* sseg_i = sf + stg * 3 * kT;
    const float* sseg_j = sseg_i + kT;
    const float* sdt_j = sseg_j + kT;
    float d[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) d[t][0] = d[t][1] = d[t][2] = d[t][3] = 0.f;
    mma_nt<P, L::kPS, L::kPS, 8>(d, syh, warp * 16, syh + 2 * L::kX, 0, lane);  // D = dy_i x_j^T
    mma_nt<P, L::kPS, L::kPS, 8>(d, syh + L::kX, warp * 16, syh + 2 * L::kX, 0, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = ir + (e >> 1) * 8, jj = t * 8 + 2 * quad + (e & 1);
        if (i0 + ii < q && j0 + jj <= i0 + ii)
          g[t][e] += d[t][e] * sdt_j[jj] * expf(sseg_i[ii] - sseg_j[jj]);
      }
    __syncthreads();  // this stage's readers are done: it takes head hh + 2
  }
  float* gp = dgs_part + grp * static_cast<long long>(m_count) * q * q +
              static_cast<long long>(m) * q * q;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + ir + (e >> 1) * 8, j = j0 + t * 8 + 2 * quad + (e & 1);
      if (i < q && j <= i) gp[static_cast<long long>(i) * q + j] = g[t][e];
    }
}

// One block per (j tile, head group, chunk): the dB head term of the
// tile's rows over the group's heads in order, sum_h e_h[j] x_h[j] ds_h^T
// (ds's pair), N in 64-wide column blocks; the next head's tiles land
// while this one is computed.  Each group writes its own partial sums.
template <int P, int N>
__global__ void __launch_bounds__(kTcThreads)
ssd_bwd_dbh_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const bf16* __restrict__ dshi, const bf16* __restrict__ dslo, Scratch sc,
                      float* __restrict__ dbh_part, int h, int q, Strides st) {
  using L = TcLayout<P, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // 2 x (x_j, ds hi, lo)
  float* se = reinterpret_cast<float*>(ring + 2 * (L::kX + 2 * L::kDs));  // 2 x e_j

  const int jt = blockIdx.x, grp = blockIdx.y, m = blockIdx.z, m_count = gridDim.z;
  const HeadRing hr(h, gridDim.y, grp);
  const int j0 = jt * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, group = lane >> 2, quad = lane & 3;
  const int jr = warp * 16 + group;  // this lane's rows: jr, jr + 8
  constexpr int kStage = L::kX + 2 * L::kDs;
  auto issue = [&](int hh) {
    const long long mh = static_cast<long long>(m) * h + hh;
    const int stg = (hh - hr.h0) & 1;
    bf16* sx = ring + stg * kStage;
    copy_rows_async<kT, P, kTcThreads>(sx, L::kPS, x + m * st.xm + hh * st.xh, st.xq, j0, q);
    copy_rows_async<N, P, kTcThreads>(sx + L::kX, L::kPS, dshi + mh * N * P, P, 0, N);
    copy_rows_async<N, P, kTcThreads>(sx + L::kX + L::kDs, L::kPS, dslo + mh * N * P, P, 0, N);
    cp_async_commit();
    if (threadIdx.x < kT) {
      const int j = j0 + threadIdx.x;
      se[stg * kT + threadIdx.x] =
          j < q ? expf(sc.seg[mh * q + q - 1] - sc.seg[mh * q + j]) *
                      dt[m * st.dm + hh * st.dh + j * st.dq]
                : 0.f;
    }
  };

  float b[N / 8][4];
#pragma unroll
  for (int t = 0; t < N / 8; ++t) b[t][0] = b[t][1] = b[t][2] = b[t][3] = 0.f;
  if (hr.h0 < hr.h1) issue(hr.h0);
  for (int hh = hr.h0; hh < hr.h1; ++hh) {
    if (hh + 1 < hr.h1) {
      issue(hh + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int stg = (hh - hr.h0) & 1;
    const bf16* sx = ring + stg * kStage;
    const float er[2] = {se[stg * kT + jr], se[stg * kT + jr + 8]};
#pragma unroll
    for (int nc = 0; nc < N / 64; ++nc) {
      float t8[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t) t8[t][0] = t8[t][1] = t8[t][2] = t8[t][3] = 0.f;
      mma_nt<P, L::kPS, L::kPS, 8>(t8, sx, warp * 16, sx + L::kX, nc * 64, lane);
      mma_nt<P, L::kPS, L::kPS, 8>(t8, sx, warp * 16, sx + L::kX + L::kDs, nc * 64, lane);
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) b[nc * 8 + t][e] += er[e >> 1] * t8[t][e];
    }
    __syncthreads();  // this stage's readers are done: it takes head hh + 2
  }
  float* bp = dbh_part + grp * static_cast<long long>(m_count) * q * N +
              static_cast<long long>(m) * q * N;
#pragma unroll
  for (int t = 0; t < N / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + jr + (e >> 1) * 8;
      if (j < q) bp[static_cast<long long>(j) * N + t * 8 + 2 * quad + (e & 1)] = b[t][e];
    }
}

// dGs (the lower triangle of each chunk's (Q, Q)) and the dB head term (M,
// Q, N): the head groups' partial sums added in group order
__global__ void __launch_bounds__(kThreads)
ssd_bwd_group_sum_kernel(const float* __restrict__ dgs_part, const float* __restrict__ dbh_part,
                         Scratch sc, float* __restrict__ dbh, int m, int q, int n, int groups) {
  const long long qq = static_cast<long long>(m) * q * q, qn = static_cast<long long>(m) * q * n;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; e < qq + qn;
       e += stride) {
    float a = 0.f;
    if (e < qq) {
      const long long r = e % (static_cast<long long>(q) * q);
      if (r % q > r / q) continue;  // j > i: never read
      for (int g = 0; g < groups; ++g) a += dgs_part[g * qq + e];
      sc.dgs[e] = a;
    } else {
      for (int g = 0; g < groups; ++g) a += dbh_part[g * qn + e - qq];
      dbh[e - qq] = a;
    }
  }
}

// floats a tensor-core scratch region of `count` floats takes, rounded up
// so that the next one starts 16-byte aligned
inline long long aligned4(long long count) { return (count + 3) / 4 * 4; }

template <int P, int N>
int launch_tc(const bf16* x, const float* dt, const float* da, const bf16* b, const bf16* c,
              const float* dy, const float* ds, bf16* dx, float* ddt, float* dda, bf16* db,
              bf16* dc, float* scratch, int m, int h, int q, const Strides& st,
              cudaStream_t s) {
  using L = TcLayout<P, N>;
  const Scratch sc(scratch, m, h, q);
  const int nt = (q + kT - 1) / kT, ncol = (N + kT - 1) / kT;
  const int groups = h < kGroups ? h : kGroups;
  const long long ny = static_cast<long long>(m) * h * q * P;  // dy's elements
  const long long nd = static_cast<long long>(m) * h * N * P;  // ds's
  const long long qq = static_cast<long long>(m) * q * q, qn = static_cast<long long>(m) * q * N;
  // beyond Scratch: dy's and ds's pairs (bf16), the dB head term, and the
  // head groups' partial dGs and dB head terms
  float* extra = scratch + aligned4(static_cast<long long>(m) * h * q * (3 + nt) + 2 * qq);
  bf16* yh = reinterpret_cast<bf16*>(extra);
  bf16* yl = yh + ny;
  bf16* dh = yl + ny;
  bf16* dl = dh + nd;
  float* dbh = extra + aligned4(ny + nd);
  float* dbh_part = dbh + aligned4(qn);
  float* dgs_part = dbh_part + aligned4(groups * qn);
  const size_t dc_bytes = sizeof(float) * 2 * kT * kS;
  const size_t db_bytes = sizeof(float) * 2 * kPMax * kS;
  cudaError_t err = allow_shared_bytes(ssd_bwd_head_tc_kernel<P, N>, L::kHeadBytes);
  if (err == cudaSuccess) err = allow_shared_bytes(ssd_bwd_groups_tc_kernel<P, N>, L::kGroupBytes);
  if (err == cudaSuccess) err = allow_shared_bytes(ssd_bwd_dbh_tc_kernel<P, N>, L::kDbhBytes);
  if (err == cudaSuccess) err = allow_shared_bytes(ssd_bwd_dc_kernel<bf16>, dc_bytes);
  if (err == cudaSuccess) err = allow_shared_bytes(ssd_bwd_db_kernel<bf16>, db_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto blocks_for = [](long long n) {
    const long long want = (n + kThreads - 1) / kThreads;
    return static_cast<unsigned>(want < 1184 ? want : 1184);  // 8 blocks an SM at most
  };
  const long long rows = static_cast<long long>(m) * h;  // a warp each
  const unsigned row_blocks = static_cast<unsigned>((rows * 32 + kThreads - 1) / kThreads);
  ssd_bwd_seg_kernel<<<row_blocks, kThreads, 0, s>>>(da, sc.seg, m, h, q, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_split_kernel<P, N><<<m * q + m * h, kThreads, 0, s>>>(dy, ds, yh, yl, dh, dl, m, h,
                                                                 q, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_head_tc_kernel<P, N><<<dim3(nt, h, m), kTcThreads, L::kHeadBytes, s>>>(
      x, dt, b, c, yh, yl, dh, dl, sc, dx, ddt, h, q, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dseg_kernel<<<row_blocks, kThreads, 0, s>>>(sc, dda, static_cast<int>(rows), q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_groups_tc_kernel<P, N><<<dim3(nt * (nt + 1) / 2, groups, m), kTcThreads,
                                    L::kGroupBytes, s>>>(x, dt, yh, yl, sc, dgs_part, h, q, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dbh_tc_kernel<P, N><<<dim3(nt, groups, m), kTcThreads, L::kDbhBytes, s>>>(
      x, dt, dh, dl, sc, dbh_part, h, q, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_group_sum_kernel<<<blocks_for(qq + qn), kThreads, 0, s>>>(dgs_part, dbh_part, sc, dbh,
                                                                    m, q, N, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dc_kernel<bf16><<<dim3(nt, ncol, m), kThreads, dc_bytes, s>>>(b, sc, dc, q, N, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_db_kernel<bf16><<<dim3(nt, ncol, m), kThreads, db_bytes, s>>>(
      x, dt, c, ds, sc, dbh, db, h, q, P, N, st);
  return static_cast<int>(cudaGetLastError());
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
      xt, dt, ct, ds, sc, nullptr, static_cast<T*>(db), h, q, p, n, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, H, Q, P), B/C (M, Q, N) fp32 or bf16 (`dtype`), dt/dA (M, H, Q) fp32,
// dy (M, H, Q, P) fp32 through `strides`; ds (M, H, N, P) fp32 contiguous.
// Writes dx (x's dtype, through its strides), ddt and ddA (M, H, Q) fp32,
// dB and dC (M, Q, N) in x's dtype.  Q <= 256, P <= 128, N <= 128.  route
// 0: the CUDA cores (fp32 or bf16); route 1: the tensor cores (bf16 at (P,
// N) = (64, 128) or (64, 64), x, B and C 16-byte aligned).  `scratch` is
// fp32 of M H Q (3 + ceil(Q / 64)) + 2 M Q Q floats, and on route 1 also
// M H P (Q + N) + M Q N (1 + G) + G M Q Q with G = min(H, 8) head groups,
// plus 16 floats of alignment.
extern "C" int ssd_intra_bwd_launch(const void* x, const void* dt, const void* da,
                                    const void* b, const void* c, const void* dy,
                                    const void* ds, void* dx, void* ddt, void* dda, void* db,
                                    void* dc, void* scratch, int m, int h, int q, int p, int n,
                                    const long long* strides, int dtype, int route,
                                    void* stream) {
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
  if (dtype == kFloat32 && route == 0)
    return launch<float>(x, dtf, daf, b, c, dyf, dsf, dx, ddtf, ddaf, db, dc, scr, m, h, q, p, n,
                         st, s);
  if (dtype == kBFloat16 && route == 1) {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* bb = static_cast<const bf16*>(b);
    const bf16* cb = static_cast<const bf16*>(c);
    bf16* dxb = static_cast<bf16*>(dx);
    bf16* dbb = static_cast<bf16*>(db);
    bf16* dcb = static_cast<bf16*>(dc);
    if (p == 64 && n == 128)
      return launch_tc<64, 128>(xb, dtf, daf, bb, cb, dyf, dsf, dxb, ddtf, ddaf, dbb, dcb, scr, m,
                                h, q, st, s);
    if (p == 64 && n == 64)
      return launch_tc<64, 64>(xb, dtf, daf, bb, cb, dyf, dsf, dxb, ddtf, ddaf, dbb, dcb, scr, m,
                               h, q, st, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == kBFloat16 && route == 0)
    return launch<__nv_bfloat16>(x, dtf, daf, b, c, dyf, dsf, dx, ddtf, ddaf, db, dc, scr, m, h,
                                 q, p, n, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
