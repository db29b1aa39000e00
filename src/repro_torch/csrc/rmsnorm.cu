// RMSNorm over the last axis: y = cast(x * rsqrt(mean(x^2) + eps)) * w.
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm (_rmsnorm_kernel), the TPU
// kernel that fuses the fp32 round trip of the residual stream.
//
// Bound on this card: bytes.  Per row it reads D values of x once and writes
// D values once (w is 2*D bytes shared by every row and stays in L2); the
// arithmetic is ~4 flops per element, far below the ~295 flop/byte ridge.
// At the decode shape (4 rows of 2048) the bytes take ~0.01 us, so what is
// left is latency: one load round trip, one reduction, one store.
//
// Design: one warp per row, several rows per block (prefill's 256 rows
// fill 64 blocks), no block barrier.  Three routes, chosen by the wrapper
// from the row width and alignment before the launch:
//   * registers (row_kernel<T, D>): the widths of the repo's configs (512,
//     the MLA latent; 1024; 1536; 2048; 3072, mamba2's gated norm; 3584;
//     7168, zamba2's gated norm) are template parameters, each taken while
//     the row is at most kRowBytes (fp32 at 7168 takes the vector loop).
//     Each lane loads its share of the row once, in 16-byte vectors (8
//     bf16 or 4 fp32, D / 256 or D / 128 of them, all issued before the
//     first use), keeps it in registers, reduces the fp32 sum of squares
//     with warp shuffles, and writes the result from the same registers:
//     one trip to memory each way;
//   * vectors (vec_kernel<T>): any other width that is a whole number of
//     16-byte vectors loops over the row in vectors, and re-reads it (from
//     L1) for the second pass;
//   * scalar (scalar_kernel<T>): any other width, element by element.
// The backward (below) follows the same rounding.
//
// Rounding follows the model path (repro/models/layers.py:41-45): normalize
// in fp32, cast to x's dtype, then multiply by the scale in that dtype --
// the Pallas kernel multiplies in fp32 and casts once, which differs in
// bf16.
#include <cstring>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kWarps = 4;  // rows per block
constexpr int kThreads = 32 * kWarps;
// the widest row the register route holds: 28 16-byte vectors a lane
// (repro_torch/kernels/rmsnorm.py::ROW_BYTES)
constexpr size_t kRowBytes = 32 * 28 * 16;

// 16 bytes of T, loaded and stored as one uint4
template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

template <typename T>
__device__ __forceinline__ Vec<T> load_vec(const T* p) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  Vec<T> a;
  memcpy(&a, &r, sizeof(r));
  return a;
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const Vec<T>& a) {
  uint4 r;
  memcpy(&r, &a, sizeof(r));
  *reinterpret_cast<uint4*>(p) = r;
}

template <typename T>
__device__ __forceinline__ float sum_squares(const Vec<T>& a) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < Vec<T>::kN; ++e) {
    const float f = to_f32(a.v[e]);
    s += f * f;
  }
  return s;
}

// out = cast(x * inv) * w, elementwise over one vector
template <typename T>
__device__ __forceinline__ Vec<T> normalize(const Vec<T>& a, const Vec<T>& w, float inv) {
  Vec<T> o;
#pragma unroll
  for (int e = 0; e < Vec<T>::kN; ++e)
    o.v[e] = from_f32<T>(to_f32(from_f32<T>(to_f32(a.v[e]) * inv)) * to_f32(w.v[e]));
  return o;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
row_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int rows,
           float eps) {
  constexpr int kVecs = D / (32 * Vec<T>::kN);  // vectors per lane
  static_assert(kVecs * 32 * Vec<T>::kN == D, "D must be a whole number of warp-wide vectors");
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  constexpr int kN = Vec<T>::kN;
  const T* xr = x + row * D;
  Vec<T> a[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) a[i] = load_vec(xr + (i * 32 + lane) * kN);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) ss += sum_squares(a[i]);
  const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(D) + eps);
  T* orow = out + row * D;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int off = (i * 32 + lane) * kN;
    store_vec(orow + off, normalize(a[i], load_vec(w + off), inv));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
vec_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int rows,
           int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  constexpr int kN = Vec<T>::kN;
  const T* xr = x + row * d;
  float ss = 0.f;
  for (int i = lane * kN; i < d; i += 32 * kN) ss += sum_squares(load_vec(xr + i));
  const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
  T* orow = out + row * d;
  for (int i = lane * kN; i < d; i += 32 * kN)
    store_vec(orow + i, normalize(load_vec(xr + i), load_vec(w + i), inv));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scalar_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int rows,
              int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
  for (int i = lane; i < d; i += 32)
    orow[i] = from_f32<T>(to_f32(from_f32<T>(to_f32(xr[i]) * inv)) * to_f32(w[i]));
}

// route codes shared with repro_torch/kernels/rmsnorm.py
enum Route : int { kScalar = 0, kVectors = 1, kRegisters = 2 };

template <typename T>
int launch(const void* xp, const void* wp, void* op, int rows, int d, float eps, int route,
           cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wp);
  T* out = static_cast<T*>(op);
  const int blocks = (rows + kWarps - 1) / kWarps;
  if (route == kRegisters) {
#define REPRO_RMSNORM_ROW(D)                                              \
  if constexpr (D * sizeof(T) <= kRowBytes) {                             \
    if (d == D) {                                                         \
      row_kernel<T, D><<<blocks, kThreads, 0, s>>>(x, w, out, rows, eps); \
      return static_cast<int>(cudaGetLastError());                        \
    }                                                                     \
  }
    REPRO_RMSNORM_ROW(512)
    REPRO_RMSNORM_ROW(1024)
    REPRO_RMSNORM_ROW(1536)
    REPRO_RMSNORM_ROW(2048)
    REPRO_RMSNORM_ROW(3072)
    REPRO_RMSNORM_ROW(3584)
    REPRO_RMSNORM_ROW(7168)
#undef REPRO_RMSNORM_ROW
    return static_cast<int>(cudaErrorInvalidValue);  // no instantiation for d
  }
  if (route == kVectors) {
    if (d % Vec<T>::kN) return static_cast<int>(cudaErrorInvalidValue);
    vec_kernel<T><<<blocks, kThreads, 0, s>>>(x, w, out, rows, d, eps);
  } else if (route == kScalar) {
    scalar_kernel<T><<<blocks, kThreads, 0, s>>>(x, w, out, rows, d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// backward: dx and dw
// ---------------------------------------------------------------------------
//
// With r = rsqrt(mean(x^2) + eps) in fp32, n = cast(x * r) and y = n * w,
// the gradient treats the cast as the identity (as autograd does):
//   dw = sum over rows of dy * n,
//   dx = r * (g - x * r^2 * mean(g * x)),  g = dy * w in fp32.
//
// Bound: bytes.  Each row reads x and dy once and writes dx once; w and
// dw are D values each (~12 flops an element, far below the ridge).  At
// the training shape (4096 rows of 2048 in bf16) that is 50 MB, 15 us at
// 3.35 TB/s.  Two kernels:
//
// Row pass, register route (bwd_rows_kernel<T, D>, D in the configs'
// widths): blocks of 8 warps, two per SM (the wrapper sizes the grid from
// the SM count; at most 128 registers and 112 KB of shared memory a
// block).  The rows are dealt out in turn to row groups of kSplit warps:
// the fewest that keep a lane's share of the row within 64 bytes, or the
// most that split the row into whole 16-byte vectors a lane (bf16: 1 warp
// to 1024, 2 at 1536, 2048 and 3584, 4 at 3072 and 7168; fp32: up to 8).
// A lane owns the same columns in every row it takes, so its dw terms
// stay in fp32 registers across all its rows; they go to shared memory
// once, at the end, where the block sums its groups in order into one row
// of partial sums.  Rows reach the warp through a ring of 2 or 3 stages
// in shared memory, filled by cp.async 16 bytes a lane (each lane copies
// and later reads only its own slots: no barrier), so one or two rows are
// in flight while one is reduced.  The row is read from its stage twice,
// for the statistics and for dx: held in registers beside the dw sums,
// its fp32 copy spilled at bf16 2048, and the 128-register cap is what
// lets two blocks share an SM.  The statistics are warp shuffles,
// then across the group's warps one exchange through shared memory at a
// named barrier (two buffers by row parity; a __syncwarp in its place for
// one-warp rows keeps the compiler from hoisting the dx pass's reads above
// the sums, which spilled).  The stage is refilled once dx is stored.
//
// Row pass, loop routes (bwd_loop_kernel<T, kVec>: any other width, or
// misaligned bases): 4 warps a block, a row per warp, 16-byte vectors
// (kVec) or elements; each warp adds its dw terms into its own fp32 row
// of shared memory, laid out so that lane l of a 16-byte round holds slot
// (round * kN + e) * 32 + l: consecutive lanes on consecutive banks.
//
// dw pass (dw_reduce_kernel): one block of 32 warps per 32 columns; warp
// k sums the partial rows k, k + 32, ... in order, then warp 0 sums the
// 32 warps in order.  No float atomics: every run gives the same bits.

// dx of one element and its dw term, from the row's r and c = r^2 mean(g * x)
template <typename T>
__device__ __forceinline__ float grad_x(float xv, float dyv, float wv, float r, float c,
                                        float* dw_term) {
  *dw_term = dyv * to_f32(from_f32<T>(xv * r));
  return r * (dyv * wv - xv * c);
}

constexpr int kBwdWarps = 8;  // the register route's block, two per SM
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kLaneBytes = 64;           // of x (and of dy) a lane aims to hold of one row
constexpr int kBwdSmem = 112 * 1024;     // shared memory a block may take
constexpr int kMaxStages = 3;            // rows of a warp in shared memory

// warps that share one row on the register route (a power of two): the
// fewest that keep a lane's share within kLaneBytes, or, where D splits no
// further into whole warp-wide vectors, the most it splits into (bf16 3584
// and 7168, fp32 3584: 112 bytes a lane)
// (repro_torch/kernels/rmsnorm.py::bwd_row_split)
template <typename T, int D>
constexpr int row_split() {
  constexpr int kN = Vec<T>::kN;
  int k = 1;
  while (k < kBwdWarps && D * static_cast<int>(sizeof(T)) > 32 * kLaneBytes * k &&
         D % (2 * k * 32 * kN) == 0)
    k *= 2;
  return k;
}

template <typename T, int D>
struct BwdShape {
  static constexpr int kN = Vec<T>::kN;
  static constexpr int kSplit = row_split<T, D>();
  static constexpr int kGroups = kBwdWarps / kSplit;        // rows a block takes at once
  static constexpr int kVecs = D / (32 * kSplit * kN);       // vectors a lane holds of x
  static constexpr int kStage = 2 * kVecs * 32;              // 16-byte slots of x and dy
  static constexpr int kStages = kBwdSmem / (kBwdWarps * kStage * 16) < kMaxStages
                                     ? kBwdSmem / (kBwdWarps * kStage * 16)
                                     : kMaxStages;
  static constexpr int kRingBytes = kStages * kBwdWarps * kStage * 16;
  static constexpr int kSumBytes = kGroups * D * 4;          // the groups' dw rows
  static constexpr int kSmem = kRingBytes > kSumBytes ? kRingBytes : kSumBytes;
  static_assert(kVecs * 32 * kSplit * kN == D, "D must be whole warp-wide vectors per warp");
  static_assert(kStages >= 2 && kSmem <= kBwdSmem, "a row too wide for the ring");
};

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 16 bytes of a stage, read anew at every call: the dx pass reads the row
// again rather than keep it (as fp32, which the compiler would) live in
// registers beside the dw sums
template <typename T>
__device__ __forceinline__ Vec<T> stage_vec(const uint4* p) {
  uint4 r;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "r"(smem_u32(p)));
  Vec<T> a;
  memcpy(&a, &r, sizeof(r));
  return a;
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 2)
bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
                T* __restrict__ dx, float* __restrict__ partial, int rows, float eps) {
  using S = BwdShape<T, D>;
  constexpr int kN = S::kN, kVecs = S::kVecs, kSplit = S::kSplit;
  extern __shared__ uint4 bwd_smem[];
  __shared__ float2 stats[2][kBwdWarps];  // by row parity: each warp's (sum x^2, sum g x)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / kSplit, part = warp % kSplit;
  // this warp's ring: [stage][x, dy][vector][lane]
  uint4* ring = bwd_smem + warp * S::kStages * S::kStage + lane;
  const long long step = static_cast<long long>(gridDim.x) * S::kGroups;
  const long long first = static_cast<long long>(blockIdx.x) * S::kGroups + group;
  const int n = first < rows ? static_cast<int>((rows - 1 - first) / step + 1) : 0;
  // column of the lane's vector i
  auto col = [&](int i) { return ((i * kSplit + part) * 32 + lane) * kN; };
  // the k-th row of this group into stage s (an empty group past the end)
  auto issue = [&](int k, int s) {
    if (k < n) {
      const long long off = (first + k * step) * D;
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        cp_async_16(ring + (s * 2 * kVecs + i) * 32, x + off + col(i), true);
        cp_async_16(ring + ((s * 2 + 1) * kVecs + i) * 32, dy + off + col(i), true);
      }
    }
    cp_async_commit();
  };
  float acc[kVecs][kN];
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
#pragma unroll
    for (int e = 0; e < kN; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int s = 0; s < S::kStages; ++s) issue(s, s);
  for (int k = 0; k < n; ++k) {
    const int s = k % S::kStages;
    cp_async_wait<S::kStages - 1>();  // row k has landed
    const uint4* xs = ring + s * 2 * kVecs * 32;  // the stage's x, then dy
    const uint4* gs = xs + kVecs * 32;
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const Vec<T> a = stage_vec<T>(xs + i * 32), g = stage_vec<T>(gs + i * 32);
      const Vec<T> wv = load_vec(w + col(i));
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float xv = to_f32(a.v[e]);
        ss += xv * xv;
        gx += to_f32(g.v[e]) * to_f32(wv.v[e]) * xv;
      }
    }
    ss = warp_sum(ss);
    gx = warp_sum(gx);
    if constexpr (kSplit > 1) {  // the group's warps, summed in order
      const int buf = k & 1;
      if (lane == 0) stats[buf][warp] = make_float2(ss, gx);
      named_barrier(1 + group, 32 * kSplit);
      ss = gx = 0.f;
#pragma unroll
      for (int p = 0; p < kSplit; ++p) {
        const float2 t = stats[buf][group * kSplit + p];
        ss += t.x;
        gx += t.y;
      }
    } else {
      __syncwarp();  // keeps the dx pass's reads of the stage after the sums
    }
    const float r = rsqrtf(ss / static_cast<float>(D) + eps);
    const float c = r * r * (gx / static_cast<float>(D));
    T* dxr = dx + (first + k * step) * D;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const Vec<T> a = stage_vec<T>(xs + i * 32), g = stage_vec<T>(gs + i * 32);
      const Vec<T> wv = load_vec(w + col(i));
      Vec<T> o;
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        float t;
        o.v[e] = from_f32<T>(grad_x<T>(to_f32(a.v[e]), to_f32(g.v[e]), to_f32(wv.v[e]), r, c,
                                       &t));
        acc[i][e] += t;
      }
      store_vec(dxr + col(i), o);
    }
    // the stores above wait for the stage's values, so it may be refilled
    issue(k + S::kStages, s);
  }
  cp_async_wait<0>();
  __syncthreads();
  // the block's dw row: each group's sums, then the groups in order
  float* sums = reinterpret_cast<float*>(bwd_smem);  // (kGroups, D), over the ring
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
#pragma unroll
    for (int e = 0; e < kN; e += 4)
      *reinterpret_cast<float4*>(sums + group * D + col(i) + e) =
          make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2], acc[i][e + 3]);
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += kBwdThreads) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < S::kGroups; ++q) t += sums[q * D + c];
    partial[static_cast<long long>(blockIdx.x) * D + c] = t;
  }
}

// one row by 16-byte vectors of a runtime width d; the lane's dw terms
// into acc at slot (round * kN + e) * 32 + lane
template <typename T>
__device__ __forceinline__ void bwd_row_vec(const T* xr, const T* __restrict__ w, const T* dyr,
                                            T* dxr, float* acc, int d, float eps, int lane) {
  constexpr int kN = Vec<T>::kN;
  float ss = 0.f, gx = 0.f;
  for (int i = lane * kN; i < d; i += 32 * kN) {
    const Vec<T> a = load_vec(xr + i), g = load_vec(dyr + i), wv = load_vec(w + i);
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float xv = to_f32(a.v[e]);
      ss += xv * xv;
      gx += to_f32(g.v[e]) * to_f32(wv.v[e]) * xv;
    }
  }
  const float r = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
  const float c = r * r * (warp_sum(gx) / static_cast<float>(d));
  float* slot = acc + lane;
  for (int i = lane * kN; i < d; i += 32 * kN, slot += 32 * kN) {
    const Vec<T> a = load_vec(xr + i), g = load_vec(dyr + i), wv = load_vec(w + i);
    Vec<T> o;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      float t;
      o.v[e] = from_f32<T>(grad_x<T>(to_f32(a.v[e]), to_f32(g.v[e]), to_f32(wv.v[e]), r, c,
                                     &t));
      slot[e * 32] += t;
    }
    store_vec(dxr + i, o);
  }
}

// one row element by element; the lane's dw terms into acc at their column
template <typename T>
__device__ __forceinline__ void bwd_row_scalar(const T* xr, const T* __restrict__ w,
                                               const T* dyr, T* dxr, float* acc, int d,
                                               float eps, int lane) {
  float ss = 0.f, gx = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float xv = to_f32(xr[i]);
    ss += xv * xv;
    gx += to_f32(dyr[i]) * to_f32(w[i]) * xv;
  }
  const float r = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
  const float c = r * r * (warp_sum(gx) / static_cast<float>(d));
  for (int i = lane; i < d; i += 32) {
    float t;
    dxr[i] = from_f32<T>(grad_x<T>(to_f32(xr[i]), to_f32(dyr[i]), to_f32(w[i]), r, c, &t));
    acc[i] += t;
  }
}

// a warp's row of dw sums in shared memory: the vector loop's d rounded
// up to whole rounds of 32 vectors
template <typename T, bool kVec>
__host__ __device__ __forceinline__ int loop_sum_width(int d) {
  constexpr int kRound = 32 * Vec<T>::kN;
  return kVec ? (d + kRound - 1) / kRound * kRound : d;
}

// the loop routes.  Block b takes rows [b * per_block, (b+1) * per_block).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
bwd_loop_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
                T* __restrict__ dx, float* __restrict__ partial, int rows, int d, int per_block,
                float eps) {
  constexpr int kN = Vec<T>::kN;
  extern __shared__ float sacc[];  // (kWarps, width): each warp's dw partial sums
  const int width = loop_sum_width<T, kVec>(d);
  for (int i = threadIdx.x; i < kWarps * width; i += kThreads) sacc[i] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* acc = sacc + warp * width;
  const long long first = static_cast<long long>(blockIdx.x) * per_block;
  const long long end = min(static_cast<long long>(rows), first + per_block);
  for (long long row = first + warp; row < end; row += kWarps) {
    if constexpr (kVec)
      bwd_row_vec<T>(x + row * d, w, dy + row * d, dx + row * d, acc, d, eps, lane);
    else
      bwd_row_scalar<T>(x + row * d, w, dy + row * d, dx + row * d, acc, d, eps, lane);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kThreads) {
    // column c = (round * 32 + l) * kN + e sits at slot (round * kN + e) * 32 + l
    const int at = kVec ? ((c / (32 * kN)) * kN + c % kN) * 32 + (c / kN) % 32 : c;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += sacc[k * width + at];
    partial[static_cast<long long>(blockIdx.x) * d + c] = s;
  }
}

constexpr int kReduceWarps = 32;  // the dw pass's block, per 32 columns

// dw[c] = sum over blocks of partial[block, c], in a fixed order
template <typename T>
__global__ void __launch_bounds__(32 * kReduceWarps)
dw_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dw, int blocks, int d) {
  __shared__ float sums[kReduceWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int b = warp; b < blocks; b += kReduceWarps)
      s += partial[static_cast<long long>(b) * d + c];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kReduceWarps; ++k) t += sums[k][lane];
    dw[c] = from_f32<T>(t);
  }
}

template <typename T, int D>
int launch_bwd_rows(const T* x, const T* w, const T* dy, T* dx, float* partial, int rows,
                    int blocks, float eps, cudaStream_t s) {
  // opt in whatever the size (the static stats count too), with room for
  // two blocks an SM
  constexpr int bytes = BwdShape<T, D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_rows_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_rows_kernel<T, D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_rows_kernel<T, D><<<blocks, kBwdThreads, bytes, s>>>(x, w, dy, dx, partial, rows, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec>
int launch_bwd_loop(const T* x, const T* w, const T* dy, T* dx, float* partial, int rows,
                    int d, int blocks, float eps, cudaStream_t s) {
  const size_t bytes = sizeof(float) * kWarps * loop_sum_width<T, kVec>(d);
  const cudaError_t err = allow_shared_bytes(bwd_loop_kernel<T, kVec>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = (rows + blocks - 1) / blocks;
  bwd_loop_kernel<T, kVec><<<blocks, kThreads, bytes, s>>>(x, w, dy, dx, partial, rows, d,
                                                           per_block, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* xp, const void* wp, const void* dyp, void* dxp, void* dwp,
               void* partialp, int rows, int d, int blocks, float eps, int route,
               cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wp);
  const T* dy = static_cast<const T*>(dyp);
  T* dx = static_cast<T*>(dxp);
  float* partial = static_cast<float*>(partialp);
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (route == kRegisters) {
#define REPRO_RMSNORM_BWD_ROW(D) \
  if (d == D) err = launch_bwd_rows<T, D>(x, w, dy, dx, partial, rows, blocks, eps, s);
    REPRO_RMSNORM_BWD_ROW(512)
    REPRO_RMSNORM_BWD_ROW(1024)
    REPRO_RMSNORM_BWD_ROW(1536)
    REPRO_RMSNORM_BWD_ROW(2048)
    REPRO_RMSNORM_BWD_ROW(3072)
    REPRO_RMSNORM_BWD_ROW(3584)
    REPRO_RMSNORM_BWD_ROW(7168)
#undef REPRO_RMSNORM_BWD_ROW
  } else if (route == kVectors) {
    if (d % Vec<T>::kN == 0)
      err = launch_bwd_loop<T, true>(x, w, dy, dx, partial, rows, d, blocks, eps, s);
  } else if (route == kScalar) {
    err = launch_bwd_loop<T, false>(x, w, dy, dx, partial, rows, d, blocks, eps, s);
  }
  if (err != 0) return err;
  dw_reduce_kernel<T><<<(d + 31) / 32, 32 * kReduceWarps, 0, s>>>(
      partial, static_cast<T*>(dwp), blocks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (rows, d) contiguous, w (d,); the vector and register routes need
// 16-byte aligned x, w and out (the wrapper checks).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int rows, int d,
                              float eps, int dtype, int route, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(x, w, out, rows, d, eps, route, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(x, w, out, rows, d, eps, route, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, dy, dx (rows, d) contiguous, w, dw (d,), partial fp32 (blocks, d)
// scratch, blocks >= 1; the routes as rmsnorm_launch's.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w, const void* dy, void* dx,
                                  void* dw, void* partial, int rows, int d, int blocks,
                                  float eps, int dtype, int route, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return launch_bwd<float>(x, w, dy, dx, dw, partial, rows, d, blocks, eps, route, s);
  if (dtype == kBFloat16)
    return launch_bwd<__nv_bfloat16>(x, w, dy, dx, dw, partial, rows, d, blocks, eps, route, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
