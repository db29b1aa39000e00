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
// takes ~0.4 GFLOP (C B^T once, then Q^2/2 * P and Q * N * P multiply-adds
// per head) against ~6 MB of bf16 inputs and fp32 outputs: bytes bound it at
// the tensor cores' bf16 rate, operations at the fp32 rate.  This first
// version computes in fp32 on CUDA cores, so operations bound it (wgmma on
// bf16 tiles is later work).
//
// Design.  The Pallas step holds the whole (Q, Q) decay and score matrices
// in VMEM (~1 MiB), more than a Hopper block's 227 KB of shared memory, and
// recomputes C B^T for every head.  Here one launch runs three kernels:
//   1. cb_kernel: C B^T once per chunk (ngroups = 1: the same for all
//      heads) into an fp32 (M, Q, Q) scratch buffer the wrapper allocates;
//      only tiles on or below the diagonal are computed.  The 48 heads then
//      re-read it from L2 instead of recomputing it (48x less work on it);
//   2. y_kernel: one block per (16-row tile of i, head, chunk) loops over
//      32-column tiles of j up to its last row (the causal skip), building
//      the decayed scores of the tile and the dt-weighted inputs in shared
//      memory;
//   3. s_kernel: one block per (32-wide tile of N, head, chunk) sums the
//      chunk state over all Q positions.
// Every block computes the cumulative decay of its head itself, by one
// thread in sequential order, and every output element sums over j (or n)
// in one fixed sequential order.  So positions with dt = 0 past a row's
// true length (a length-bucketed prefill) add exact zeros, and a padded
// prefill gives the bits of the exact-length one.  y is written in fp32:
// the caller adds the inter-chunk term before it casts (the model path's
// rounding; the Pallas kernel casts y itself).  Any Q <= 256 works; the
// ragged tiles are masked.
#include <cstring>

#include "common.cuh"

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

}  // namespace

// strides: 16 values in the order of struct Strides
extern "C" int ssd_intra_launch(const void* x, const void* dt, const void* da, const void* b,
                                const void* c, void* y, void* s, void* cb, int m, int h,
                                int q, int p, int n, const long long* strides, int dtype,
                                void* stream) {
  Strides st;
  memcpy(&st, strides, sizeof(Strides));
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(x, dt, da, b, c, y, s, cb, m, h, q, p, n, st, cs);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, dt, da, b, c, y, s, cb, m, h, q, p, n, st, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}
