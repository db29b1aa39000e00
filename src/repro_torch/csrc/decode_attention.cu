// Dense decode attention: one query token per row against a contiguous KV
// cache, with per-row lengths; optionally each row against a row of its
// own choosing (`rows`) of a shared (R, Smax, Nkv, H) cache.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention
// (_decode_kernel), the TPU kernel that streams the cache once per query
// head.  Here it serves the dense decode of the unbatched generate path,
// and the enc-dec cross-attention of both decode paths: the dense cross
// cache (row b of the cache) and the shared cross segments of paged decode
// (row rows[b] of a segment pool, the gather being the addressing -- a
// copy of the segments would move 6.1 MB per row and layer in bf16).
//
// Bound, design and numerics: decode_split.cuh, shared with the paged
// kernel.  A tile is `block_k` positions of the cache, which keeps the
// model's (B, Smax, Nkv, H) layout and is addressed through its strides;
// with block_k equal to the paged kernel's block size both kernels split a
// row at the same positions and give the same bits.  Both the dense and
// the row-indexed cache go through one address functor, so a row gives the
// same bits whether it is row b of a dense cache or row rows[b] of a pool
// holding the same values.
#include "decode_split.cuh"

namespace {

// row b's tile j starts at row (rows ? rows[b] : b) of the cache
struct RowAddr {
  const int* rows;  // (B,) row ids, or null: row b
  long long sb;     // stride between rows
  long long st;     // stride between tiles: block_k positions
  __device__ __forceinline__ long long tile(int b, int j) const {
    return static_cast<long long>(rows ? rows[b] : b) * sb + j * st;
  }
};

}  // namespace

// q (B, Nq, H) contiguous; k/v (R, Smax, Nkv, H) given by their strides
// (sb, ss, sn; the last axis unit-stride), R = B when `rows` is null, else
// `rows` (B,) int32 ids in [0, R); lengths (B,) int32; out (B, Nq, H)
// contiguous; scratch as launch_decode_split says, fresh per call.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, const void* rows, void* out,
                                       void* scratch, int b, int nq, int nkv, int h, int smax,
                                       long long sb, long long ss, long long sn, int bk,
                                       int tiles_per_split, float scale, int dtype,
                                       void* stream) {
  if (bk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const DecodeShape sh{nq, h, bk, smax, tiles_per_split, ss, sn};
  const bool vec = h % 4 == 0 && vec4_ok({q, k, v}, {sb, ss, sn});
  const RowAddr addr{static_cast<const int*>(rows), sb, bk * ss};
  return launch_decode_split(q, k, v, addr, static_cast<const int*>(lengths), out, scratch, b,
                             nkv, sh, (smax + bk - 1) / bk, vec, scale, dtype,
                             static_cast<cudaStream_t>(stream));
}
