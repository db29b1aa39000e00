// The routed experts of a MoE decode call: for each (row t, choice k) slot
// of the router's top-k, h = silu(x[t] W_gate[e]) * (x[t] W_up[e]) and
// y[t, k] = h W_down[e] with e = idx[t, k]; then out[t] = sum_k w[t, k]
// y[t, k].  Only the experts some row chose are read.
//
// Replaces: no TPU kernel.  The reference's moe_dense
// (src/repro/models/moe.py) is jnp: every token through all E experts,
// the products of the experts it did not choose multiplied by a zero
// combine weight.  The port's moe_dense does the same in torch.matmul and
// stays the path of training and prefill; this kernel serves the decode
// step (repro_torch/models/moe.py::moe_route), where that waste is the
// call's cost: at deepseek-v2-lite's widths (64 experts of D 2048, F 1408,
// top 6) each MoE layer holds 1.107 GB of expert weights, and a decode
// call of 1-16 rows needs only the 6-50 experts its rows chose.
//
// Bound on this card: bytes.  A weight byte feeds at most 16 multiply-adds
// at <= 16 rows, far under the ~295 flop/byte ridge, so the least time is
// the chosen experts' weights (3 * D * F elements each) over 3.35 TB/s:
// 0.031 ms for 6 experts at deepseek's widths, 0.26 ms for 51.
//
// Design: three launches on the caller's stream, a fixed grid each (so a
// CUDA graph captures them), no host sync, no float atomics.
//   * Routing table.  Each block of the two expert kernels builds it in
//     shared memory from idx (T*K int64): every expert's count, its slots
//     in ascending order (a stable counting sort), and the list of row
//     tiles -- (expert, first slot, rows <= 16) -- of the experts with a
//     count, in expert order.  No separate pass, no global scratch.
//   * Work items.  An item is (row tile, 64 output columns); the items are
//     dealt round-robin to a persistent grid of blocks (3 a streaming
//     multiprocessor, the wrapper's), so no block is launched for an
//     expert no row chose, and a 1-row call's 132 items (6 experts x 22
//     column tiles of F 1408) take one block each.  A block streams its
//     items' weight tiles through one ring of 3 cp.async stages that runs
//     on from one item into the next (no refill between items); three
//     such blocks a multiprocessor kept more bytes in flight than two of
//     4 or 5 stages or one of 6 or 8 (PERF.md's kernel table).
//   * Gate/up (kGated): per stage a (64 x 64) tile of W_gate[e] and of
//     W_up[e] and the (16 x 64) x rows of the tile's slots; each of the 4
//     warps takes 16 columns, bf16 mma.sync m16n8k16 with fp32 sums, B
//     operands by ldmatrix.trans from rows padded by 16 bytes.  It writes
//     h into a (T*K, F) scratch by slot, rounding where moe_dense rounds:
//     g and u to x's dtype, silu in fp32 rounded, the product rounded.
//   * Down: the same kernel over W_down[e] with the tile's h rows, y into a
//     (T*K, D) scratch by slot, rounded to x's dtype.
//   * Combine: out[t] = sum over k in order of w[t, k] y[t, k] in fp32,
//     rounded once (moe_dense's einsum rounds its fp32 sum once too).
// Every slot belongs to one expert and every output element to one block,
// so every run gives the same bits.  A row's sums run over the same k
// order whatever other rows share its experts (a tile's rows never mix:
// an mma output element reads its own A row), so a row's result does not
// depend on the call's other rows: batched equals unbatched.
//
// fp32, or widths that are not whole 64-column tiles (the reduced
// configs), take the scalar route: the same table and items, 128 columns
// an item, one column a thread, the slots' x (or h) rows staged in fp32
// in shared memory 64 deep, sequential fp32 sums on the CUDA cores.
//
// The mechanism's counter (unsigned long long [2], may be null): block 0
// of the gate/up kernel adds the experts with a count and E, once a call,
// so counter[0] / counter[1] is the share of the experts' weights read.
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;        // 4 warps
constexpr int kRowTile = 16;         // slots of one expert a tile holds (the mma's rows)
constexpr int kBK = 64;              // depth of a stage
constexpr int kBN = 64;              // columns of a tensor-core item: 16 a warp
constexpr int kAS = kBK + 8;         // A tile row stride (bf16): 16 bytes of padding
constexpr int kWS = kBN + 8;         // W tile row stride (bf16)
// the tensor-core ring's stages: with the grid's three blocks a streaming
// multiprocessor (repro_torch/kernels/moe_experts.py) they keep the bytes
// in flight that the bandwidth needs
constexpr int kStages = 3;
constexpr int kScalarBN = kThreads;  // columns of a scalar item: one a thread
constexpr int kCombineThreads = 256;

// route codes of repro_torch/kernels/moe_experts.py
enum Route : int { kScalar = 0, kTensorCores = 1 };

__host__ __device__ inline int rt_max(int n, int e) { return n / kRowTile + (n < e ? n : e) + 1; }
__host__ __device__ inline int table_ints(int n, int e) { return 2 * n + 3 * e + 3 * rt_max(n, e) + 2; }

struct Table {
  const int* slot;       // slots by expert, ascending within one
  const int* rt_expert;  // per row tile: its expert,
  const int* rt_first;   // its first index into slot,
  const int* rt_rows;    // its rows (1..16)
  int n_rt;              // row tiles
  int n_hit;             // experts with a count
};

// The routing table of the n = T*K slots of idx, built by the whole block
// in shared memory `s` (table_ints(n, n_experts) ints).  A slot whose
// expert lies outside [0, n_experts) belongs to no expert.
__device__ Table build_table(const long long* __restrict__ idx, int n, int n_experts, int* s) {
  int* key = s;
  int* slot = key + n;
  int* cnt = slot + n;
  int* off = cnt + n_experts;
  int* rt_off = off + n_experts;
  const int rmax = rt_max(n, n_experts);
  int* rt_expert = rt_off + n_experts;
  int* rt_first = rt_expert + rmax;
  int* rt_rows = rt_first + rmax;
  int* totals = rt_rows + rmax;
  for (int e = threadIdx.x; e < n_experts; e += blockDim.x) cnt[e] = 0;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const long long v = idx[j];
    key[j] = (v >= 0 && v < n_experts) ? static_cast<int>(v) : -1;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    if (key[j] >= 0) atomicAdd(&cnt[key[j]], 1);
  __syncthreads();
  if (threadIdx.x < 32) {  // exclusive prefix sums of the counts and row tiles, 32 experts a step
    const int lane = threadIdx.x;
    int o = 0, r = 0, hit = 0;
    for (int e0 = 0; e0 < n_experts; e0 += 32) {
      const int e = e0 + lane;
      const int c = e < n_experts ? cnt[e] : 0;
      const int t = (c + kRowTile - 1) / kRowTile;
      int sc = c, st = t;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int a = __shfl_up_sync(0xffffffffu, sc, d);
        const int b = __shfl_up_sync(0xffffffffu, st, d);
        if (lane >= d) {
          sc += a;
          st += b;
        }
      }
      if (e < n_experts) {
        off[e] = o + sc - c;
        rt_off[e] = r + st - t;
      }
      o += __shfl_sync(0xffffffffu, sc, 31);
      r += __shfl_sync(0xffffffffu, st, 31);
      hit += __popc(__ballot_sync(0xffffffffu, c > 0));
    }
    if (lane == 0) {
      totals[0] = r;
      totals[1] = hit;
    }
  }
  __syncthreads();
  // stable: a slot's rank is the number of earlier slots of its expert
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int k = key[j];
    if (k < 0) continue;
    int rank = 0;
    for (int i = 0; i < j; ++i) rank += key[i] == k;
    slot[off[k] + rank] = j;
  }
  for (int e = threadIdx.x; e < n_experts; e += blockDim.x)
    for (int r = 0; r * kRowTile < cnt[e]; ++r) {
      rt_expert[rt_off[e] + r] = e;
      rt_first[rt_off[e] + r] = off[e] + r * kRowTile;
      rt_rows[rt_off[e] + r] = min(kRowTile, cnt[e] - r * kRowTile);
    }
  __syncthreads();
  return Table{slot, rt_expert, rt_first, rt_rows, totals[0], totals[1]};
}

__device__ __forceinline__ void count_call(unsigned long long* counter, const Table& tab,
                                           int n_experts) {
  if (counter != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(counter, static_cast<unsigned long long>(tab.n_hit));
    atomicAdd(counter + 1, static_cast<unsigned long long>(n_experts));
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// silu(g) * u as moe_dense rounds it: g and u in T, silu in fp32 rounded to
// T; the product is rounded by the caller's store
template <typename T>
__device__ __forceinline__ float swiglu(float g, float u) {
  const float gr = round_to<T>(g);
  return round_to<T>(gr / (1.f + expf(-gr))) * round_to<T>(u);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// out[slot] = a[slot / a_div] W[e] (kGated: swiglu of W0 and W1) for every
// slot of every row tile, 64 columns an item.  kdim and ndim are whole
// tiles; a is (rows, kdim), w0 / w1 (E, kdim, ndim), out (T*K, ndim).
template <bool kGated>
__global__ void __launch_bounds__(kThreads)
experts_tc_kernel(const bf16* __restrict__ a, int a_div, const long long* __restrict__ idx, int n,
                  const bf16* __restrict__ w0, const bf16* __restrict__ w1,
                  bf16* __restrict__ out, int kdim, int ndim, int n_experts,
                  unsigned long long* counter) {
  constexpr int kMats = kGated ? 2 : 1;
  constexpr int kA = kRowTile * kAS;  // bf16 of an A tile
  constexpr int kW = kBK * kWS;       // bf16 of a W tile
  constexpr int kStage = kA + kMats * kW;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const Table tab = build_table(idx, n, n_experts, reinterpret_cast<int*>(ring + kStages * kStage));
  count_call(counter, tab, n_experts);

  const int ntiles = ndim / kBN, ksteps = kdim / kBK;
  const int items = tab.n_rt * ntiles;
  const int mine = items > static_cast<int>(blockIdx.x)
                       ? (items - blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;
  const int steps = mine * ksteps;

  // stage s: k-step s % ksteps of this block's item s / ksteps
  auto load = [&](int s) {
    const int item = blockIdx.x + (s / ksteps) * gridDim.x;
    const int k0 = (s % ksteps) * kBK;
    const int rt = item / ntiles, n0 = (item - rt * ntiles) * kBN;
    const int e = tab.rt_expert[rt], first = tab.rt_first[rt], rows = tab.rt_rows[rt];
    bf16* st = ring + (s % kStages) * kStage;
    {  // the tile's rows of a: 16 rows x 8 chunks, one a thread
      const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
      const bool ok = r < rows;
      const bf16* p =
          ok ? a + static_cast<long long>(tab.slot[first + r] / a_div) * kdim + k0 + c * 8 : a;
      cp_async_16(st + r * kAS + c * 8, p, ok);
    }
#pragma unroll
    for (int m = 0; m < kMats; ++m) {  // 64 rows x 8 chunks, four a thread
      const bf16* w = (m == 0 ? w0 : w1) + (static_cast<long long>(e) * kdim + k0) * ndim + n0;
#pragma unroll
      for (int it = 0; it < kBK * kBN / 8 / kThreads; ++it) {
        const int i = threadIdx.x + it * kThreads;
        const int r = i >> 3, c = i & 7;
        cp_async_16(st + kA + m * kW + r * kWS + c * 8, w + static_cast<long long>(r) * ndim + c * 8,
                    true);
      }
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a_off = (lane & 15) * kAS + (lane >> 4) * 8;
  const int w_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * kWS + (lane >> 4) * 8 + warp * 16;
  float acc[kMats][2][4];
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed for all; stage s - 1's buffer is free
    if (s + kStages - 1 < steps) load(s + kStages - 1);
    cp_async_commit();
    const bf16* st = ring + (s % kStages) * kStage;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, st + a_off + kk * 16);
#pragma unroll
      for (int m = 0; m < kMats; ++m) {
        uint32_t bw[4];
        ldmatrix_x4_trans(bw, st + kA + m * kW + kk * 16 * kWS + w_off);
        mma_bf16(acc[m][0], af, bw[0], bw[1]);
        mma_bf16(acc[m][1], af, bw[2], bw[3]);
      }
    }
    if ((s + 1) % ksteps != 0) continue;
    // the item's last k-step: write its rows and start the next from zero
    const int item = blockIdx.x + (s / ksteps) * gridDim.x;
    const int rt = item / ntiles, n0 = (item - rt * ntiles) * kBN;
    const int first = tab.rt_first[rt], rows = tab.rt_rows[rt];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = (lane >> 2) + 8 * hi;
      if (r < rows) {
        bf16* o = out + static_cast<long long>(tab.slot[first + r]) * ndim + n0 + warp * 16 +
                  2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v0 = acc[0][j][2 * hi], v1 = acc[0][j][2 * hi + 1];
          if constexpr (kGated) {
            v0 = swiglu<bf16>(v0, acc[1][j][2 * hi]);
            v1 = swiglu<bf16>(v1, acc[1][j][2 * hi + 1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMats; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// any dtype: CUDA cores
// ---------------------------------------------------------------------------

template <typename T, bool kGated>
__global__ void __launch_bounds__(kThreads)
experts_kernel(const T* __restrict__ a, int a_div, const long long* __restrict__ idx, int n,
               const T* __restrict__ w0, const T* __restrict__ w1, T* __restrict__ out, int kdim,
               int ndim, int n_experts, unsigned long long* counter) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sa = reinterpret_cast<float*>(smem);  // (16, kBK) rows of a in fp32
  const Table tab = build_table(idx, n, n_experts, reinterpret_cast<int*>(sa + kRowTile * kBK));
  count_call(counter, tab, n_experts);

  const int ntiles = (ndim + kScalarBN - 1) / kScalarBN;
  const int items = tab.n_rt * ntiles;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int rt = item / ntiles;
    const int col = (item - rt * ntiles) * kScalarBN + threadIdx.x;
    const int e = tab.rt_expert[rt], first = tab.rt_first[rt], rows = tab.rt_rows[rt];
    const bool live = col < ndim;
    const long long base = static_cast<long long>(e) * kdim * ndim + col;
    float acc0[kRowTile], acc1[kRowTile];
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) acc0[r] = acc1[r] = 0.f;
    for (int k0 = 0; k0 < kdim; k0 += kBK) {
      const int kn = min(kBK, kdim - k0);
      __syncthreads();  // the last chunk's reads are done
      for (int i = threadIdx.x; i < kRowTile * kBK; i += kThreads) {
        const int r = i / kBK, c = i - r * kBK;
        sa[i] = (r < rows && c < kn)
                    ? to_f32(a[static_cast<long long>(tab.slot[first + r] / a_div) * kdim + k0 + c])
                    : 0.f;
      }
      __syncthreads();
      if (!live) continue;
#pragma unroll 8
      for (int c = 0; c < kn; ++c) {
        const long long at = base + static_cast<long long>(k0 + c) * ndim;
        const float v0 = to_f32(w0[at]);
        float v1 = 0.f;
        if constexpr (kGated) v1 = to_f32(w1[at]);
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          acc0[r] = fmaf(sa[r * kBK + c], v0, acc0[r]);
          if constexpr (kGated) acc1[r] = fmaf(sa[r * kBK + c], v1, acc1[r]);
        }
      }
    }
    if (!live) continue;
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      if (r < rows) {
        float v = acc0[r];
        if constexpr (kGated) v = swiglu<T>(v, acc1[r]);
        out[static_cast<long long>(tab.slot[first + r]) * ndim + col] = from_f32<T>(v);
      }
    }
  }
}

// out[t] = sum over k in order of w[t, k] y[t * K + k] (fp32), rounded once;
// a slot outside [0, n_experts) adds nothing
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const T* __restrict__ y, const T* __restrict__ w, const long long* __restrict__ idx,
               T* __restrict__ out, int k, int d, int n_experts) {
  const int t = blockIdx.x;
  const int col = blockIdx.y * kCombineThreads + threadIdx.x;
  if (col >= d) return;
  float s = 0.f;
  for (int j = 0; j < k; ++j) {
    const int slot = t * k + j;
    const long long e = idx[slot];
    if (e < 0 || e >= n_experts) continue;
    s = fmaf(to_f32(w[slot]), to_f32(y[static_cast<long long>(slot) * d + col]), s);
  }
  out[static_cast<long long>(t) * d + col] = from_f32<T>(s);
}

cudaError_t launch_tc(const bf16* x, const long long* idx, const bf16* w_gate, const bf16* w_up,
                      const bf16* w_down, bf16* h, bf16* y, int n, int k, int n_experts, int d,
                      int f, int grid, unsigned long long* counter, cudaStream_t s) {
  const size_t table = sizeof(int) * table_ints(n, n_experts);
  const size_t gate_up = sizeof(bf16) * kStages * (kRowTile * kAS + 2 * kBK * kWS) + table;
  const size_t down = sizeof(bf16) * kStages * (kRowTile * kAS + kBK * kWS) + table;
  cudaError_t err = allow_shared_bytes(experts_tc_kernel<true>, gate_up);
  if (err != cudaSuccess) return err;
  experts_tc_kernel<true><<<grid, kThreads, gate_up, s>>>(x, k, idx, n, w_gate, w_up, h, d, f,
                                                          n_experts, counter);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_shared_bytes(experts_tc_kernel<false>, down)) != cudaSuccess) return err;
  experts_tc_kernel<false><<<grid, kThreads, down, s>>>(h, 1, idx, n, w_down, nullptr, y, f, d,
                                                        n_experts, nullptr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const long long* idx, const void* weights, const void* w_gate,
                   const void* w_up, const void* w_down, void* h, void* y, void* out,
                   unsigned long long* counter, int t, int k, int n_experts, int d, int f, int grid,
                   int route, cudaStream_t s) {
  const int n = t * k;
  cudaError_t err;
  if (route == kTensorCores) {
    if constexpr (sizeof(T) != 2) return cudaErrorInvalidValue;
    else
      err = launch_tc(static_cast<const bf16*>(x), idx, static_cast<const bf16*>(w_gate),
                      static_cast<const bf16*>(w_up), static_cast<const bf16*>(w_down),
                      static_cast<bf16*>(h), static_cast<bf16*>(y), n, k, n_experts, d, f, grid,
                      counter, s);
  } else if (route == kScalar) {
    const size_t bytes = sizeof(float) * kRowTile * kBK + sizeof(int) * table_ints(n, n_experts);
    err = allow_shared_bytes(experts_kernel<T, true>, bytes);
    if (err != cudaSuccess) return err;
    experts_kernel<T, true><<<grid, kThreads, bytes, s>>>(
        static_cast<const T*>(x), k, idx, n, static_cast<const T*>(w_gate),
        static_cast<const T*>(w_up), static_cast<T*>(h), d, f, n_experts, counter);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = allow_shared_bytes(experts_kernel<T, false>, bytes)) != cudaSuccess) return err;
    experts_kernel<T, false><<<grid, kThreads, bytes, s>>>(
        static_cast<const T*>(h), 1, idx, n, static_cast<const T*>(w_down), nullptr,
        static_cast<T*>(y), f, d, n_experts, nullptr);
    err = cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const dim3 cgrid(t, (d + kCombineThreads - 1) / kCombineThreads);
  combine_kernel<T><<<cgrid, kCombineThreads, 0, s>>>(static_cast<const T*>(y),
                                                       static_cast<const T*>(weights), idx,
                                                       static_cast<T*>(out), k, d, n_experts);
  return cudaGetLastError();
}

}  // namespace

// x (T, D); idx (T, K) int64 and weights (T, K) contiguous; w_gate, w_up
// (E, D, F) and w_down (E, F, D) contiguous; h (T*K, F), y (T*K, D) and
// out (T, D) outputs; counter (2,) int64 or null.  grid >= 1 persistent
// blocks of each expert kernel; the tensor-core route takes bf16 with D
// and F whole 64-column tiles and 16-byte aligned operands (the wrapper
// checks).
extern "C" int moe_routed_experts_launch(const void* x, const void* idx, const void* weights,
                                         const void* w_gate, const void* w_up,
                                         const void* w_down, void* h, void* y, void* out,
                                         void* counter, int t, int k, int n_experts, int d, int f,
                                         int grid, int dtype, int route, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t < 1 || k < 1 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long* ix = static_cast<const long long*>(idx);
  unsigned long long* c = static_cast<unsigned long long*>(counter);
  if (dtype == kFloat32)
    return launch<float>(x, ix, weights, w_gate, w_up, w_down, h, y, out, c, t, k, n_experts, d,
                         f, grid, route, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, ix, weights, w_gate, w_up, w_down, h, y, out, c, t, k,
                                 n_experts, d, f, grid, route, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
