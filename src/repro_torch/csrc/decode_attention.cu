// Dense decode attention: one query token per row against a contiguous KV
// cache, with per-row lengths.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention
// (_decode_kernel), the TPU kernel that streams the cache once per query
// head.  Here it serves the dense decode of the unbatched generate path.
//
// Bound, design and numerics: decode_split.cuh, shared with the paged
// kernel.  A tile is `block_k` positions of the cache, which keeps the
// model's (B, Smax, Nkv, H) layout and is addressed through its strides;
// with block_k equal to the paged kernel's block size both kernels split a
// row at the same positions and give the same bits.
#include "decode_split.cuh"

namespace {

struct DenseAddr {
  long long sb;  // stride between rows
  long long st;  // stride between tiles: block_k positions
  __device__ __forceinline__ long long tile(int b, int j) const { return b * sb + j * st; }
};

}  // namespace

// q (B, Nq, H) contiguous; k/v (B, Smax, Nkv, H) given by their strides
// (sb, ss, sn; the last axis unit-stride); lengths (B,) int32; out
// (B, Nq, H) contiguous; scratch as launch_decode_split says, fresh per
// call.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, void* scratch, int b,
                                       int nq, int nkv, int h, int smax, long long sb,
                                       long long ss, long long sn, int bk, int tiles_per_split,
                                       float scale, int dtype, void* stream) {
  if (bk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const DecodeShape sh{nq, h, bk, smax, tiles_per_split, ss, sn};
  const bool vec = h % 4 == 0 && vec4_ok({q, k, v}, {sb, ss, sn});
  return launch_decode_split(q, k, v, DenseAddr{sb, bk * ss}, static_cast<const int*>(lengths),
                             out, scratch, b, nkv, sh, (smax + bk - 1) / bk, vec, scale, dtype,
                             static_cast<cudaStream_t>(stream));
}
