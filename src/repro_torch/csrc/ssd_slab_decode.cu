// One Mamba-2 recurrent step with each row's state addressed through a slab
// pool: state' = exp(dt*A) * state + (dt*x) B^T,  y = state' C.
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_slab_decode
// (_slab_decode_kernel), where the slab ids ride as a scalar-prefetch
// operand of the Pallas grid.  Here it is the SSM step of every layer of
// every decode call: slab-paged decode passes the engine's slab ids, dense
// decode passes 0..B-1 over its own (B,H,P,N) state, so both paths run the
// same arithmetic per row.
//
// Bound on this card: bytes.  A row's step reads its H*P*N fp32 state once
// and writes it once (4 rows at mamba2-780m widths: 2 x 6.3 MB per layer);
// the arithmetic is ~4 flops per 8 bytes.
//
// Design: one block per (head, row).  The block reads slab_ids[row] itself
// and the group head / (H/G) of B and C itself, so neither the gather nor
// the group-to-head repeat is materialized; B and C are staged in shared
// memory as fp32.  Each warp owns whole P-rows of the (P, N) state: its
// lanes stride N with neighbouring lanes on neighbouring addresses (every
// load and store is coalesced), update the state, and reduce y along N
// with warp shuffles -- a fixed order, so a row's result does not depend on
// the other rows of the launch.  The updated states come back GATHERED, in
// row order, and the caller scatters them into the pool: padding rows and
// warm-up rows repeat a slab id within one launch, and an in-kernel write
// would let one block read a slab another block has already stepped.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
slab_decode_kernel(const float* __restrict__ pool, const int* __restrict__ slab_ids,
                   const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const T* __restrict__ bmat,
                   const T* __restrict__ cmat, T* __restrict__ y,
                   float* __restrict__ states, int ns, int h, int p, int n, int hg,
                   long long sxb, long long sxh, long long sdb, long long sdh,
                   long long sbb, long long sbg, long long scb, long long scg) {
  extern __shared__ float smem[];
  float* bs = smem;      // (N,) this row's B of the head's group, fp32
  float* cs = smem + n;  // (N,) C
  const int head = blockIdx.x, row = blockIdx.y, group = head / hg;
  const int slab = slab_ids[row];
  const long long tile = static_cast<long long>(p) * n;
  float* dst = states + (static_cast<long long>(row) * h + head) * tile;
  T* yr = y + (static_cast<long long>(row) * h + head) * p;
  if (slab < 0 || slab >= ns) {  // an id outside the pool: poison the row
    for (long long e = threadIdx.x; e < tile; e += kThreads) dst[e] = __int_as_float(0x7fc00000);
    for (int e = threadIdx.x; e < p; e += kThreads) yr[e] = from_f32<T>(__int_as_float(0x7fc00000));
    return;
  }
  for (int e = threadIdx.x; e < n; e += kThreads) {
    bs[e] = to_f32(bmat[row * sbb + group * sbg + e]);
    cs[e] = to_f32(cmat[row * scb + group * scg + e]);
  }
  __syncthreads();
  const float dtv = dt[row * sdb + head * sdh];
  const float dec = expf(dtv * a[head]);
  const float* src = pool + (static_cast<long long>(slab) * h + head) * tile;
  const T* xr = x + row * sxb + head * sxh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int pi = warp; pi < p; pi += kWarps) {
    const float xdt = dtv * to_f32(xr[pi]);
    const long long off = static_cast<long long>(pi) * n;
    float acc = 0.f;
    for (int ni = lane; ni < n; ni += 32) {
      const float s = dec * src[off + ni] + xdt * bs[ni];
      dst[off + ni] = s;
      acc += s * cs[ni];
    }
    acc = warp_sum(acc);
    if (lane == 0) yr[pi] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* pool, const int* slab_ids, const void* x, const void* dt,
           const void* a, const void* b, const void* c, void* y, void* states, int rows,
           int ns, int h, int p, int n, int g, long long sxb, long long sxh, long long sdb,
           long long sdh, long long sbb, long long sbg, long long scb, long long scg,
           cudaStream_t s) {
  const size_t bytes = sizeof(float) * 2 * n;
  cudaError_t err = allow_shared_bytes(slab_decode_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  slab_decode_kernel<T><<<dim3(h, rows), kThreads, bytes, s>>>(
      static_cast<const float*>(pool), slab_ids, static_cast<const T*>(x),
      static_cast<const float*>(dt), static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), static_cast<float*>(states), ns, h, p, n,
      h / g, sxb, sxh, sdb, sdh, sbb, sbg, scb, scg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_slab_decode_launch(const void* pool, const void* slab_ids, const void* x,
                                      const void* dt, const void* a, const void* b,
                                      const void* c, void* y, void* states, int rows, int ns,
                                      int h, int p, int n, int g, long long sxb,
                                      long long sxh, long long sdb, long long sdh,
                                      long long sbb, long long sbg, long long scb,
                                      long long scg, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(slab_ids);
  if (dtype == kFloat32)
    return launch<float>(pool, ids, x, dt, a, b, c, y, states, rows, ns, h, p, n, g, sxb, sxh,
                         sdb, sdh, sbb, sbg, scb, scg, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(pool, ids, x, dt, a, b, c, y, states, rows, ns, h, p, n, g,
                                 sxb, sxh, sdb, sdh, sbb, sbg, scb, scg, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
