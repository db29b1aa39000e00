// Paged decode attention: one query token per row against a KV block pool
// addressed through a block table (vLLM-style paging).
//
// Replaces: src/repro/kernels/paged_decode_attention.py,
// paged_decode_attention (_paged_kernel), where the block table rides as a
// scalar-prefetch operand of the Pallas grid and every pool block is read
// once per query head.  Here it is the batched decode kernel of every GQA
// layer on the serving engine's main path.
//
// Bound, design and numerics: decode_split.cuh, shared with the dense
// decode kernel.  A tile is one pool block; a block of the split kernel
// walks its split's entries of the row's table itself -- the gather is the
// addressing, nothing is materialized -- and never reads a table lane past
// the row's length, so lanes pointing at the scratch block are never read.
#include "decode_split.cuh"

namespace {

struct PagedAddr {
  const int* tables;  // (B, W)
  int w;
  long long pb;  // pool stride between blocks
  __device__ __forceinline__ long long tile(int b, int j) const {
    return static_cast<long long>(tables[static_cast<long long>(b) * w + j]) * pb;
  }
};

}  // namespace

// q (B, Nq, H) contiguous; pools (NB, BS, Nkv, H) given by their strides
// (pb, pt, pn; the last axis unit-stride); tables (B, W) and lengths (B,)
// int32; out (B, Nq, H) contiguous; scratch as launch_decode_split says,
// fresh per call.
extern "C" int paged_decode_attention_launch(const void* q, const void* k_pool,
                                             const void* v_pool, const void* tables,
                                             const void* lengths, void* out, void* scratch,
                                             int b, int nq, int nkv, int h, int bs, int w,
                                             int tiles_per_split, long long pb, long long pt,
                                             long long pn, float scale, int dtype,
                                             void* stream) {
  const DecodeShape sh{nq, h, bs, w * bs, tiles_per_split, pt, pn};
  const bool vec = h % 4 == 0 && vec4_ok({q, k_pool, v_pool}, {pb, pt, pn});
  return launch_decode_split(q, k_pool, v_pool, PagedAddr{static_cast<const int*>(tables), w, pb},
                             static_cast<const int*>(lengths), out, scratch, b, nkv, sh, w, vec,
                             scale, dtype, static_cast<cudaStream_t>(stream));
}
