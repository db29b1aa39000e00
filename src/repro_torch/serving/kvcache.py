"""Paged cache management for the serving engine — all cache families.

vLLM-style block tables adapted to TPU constraints: the cache pool is a
dense (num_blocks, block_size, n_kv, head_dim) tensor per layer (TPU wants
dense gathers, not pointer chasing); each stream owns a list of block ids;
the block table (max_blocks_per_seq int32 per slot) is the indirection the
decode gather uses.

This module is the HOST-side allocator + table builder:
  * allocate/extend/free with O(1) free-list ops;
  * copy-on-write sharing for common prefixes (prefix caching), with
    reference counts — the paper's server has central knowledge of all
    requests (§7), which is what makes cross-stream prefix sharing safe to
    coordinate;
  * fragmentation-free by construction (fixed-size blocks).

Cache families
--------------
Not every architecture caches GQA-shaped KV, so the allocator manages
three POOL KINDS and a :class:`CacheFamily` spec says which ones a model
needs:

  * BLOCK pools — growable per-token attention KV (GQA k/v stacks, MLA
    latent c_kv/k_rope).  Fixed-size blocks, COW refcounts, the classic
    layout above.
  * SLAB pools — constant-size per-stream state (SSM conv tail +
    recurrent state).  One slab id per sequence, never grows, never
    shared (a fork gets a FRESH slab; the engine copies the contents).
  * SEGMENT pools — read-only-after-prefill shareable caches (enc-dec
    cross-attention KV).  Acquired by CONTENT KEY with refcounts: two
    streams decoding against the same encoder output share one segment
    (COW-dedup of shared prefixes / system prompts); the last release
    frees it.

  family   blocks  slab  segment   models
  ------   ------  ----  -------   -------------------------------------
  gqa        x                     llama/qwen/internlm/granite/vlm
  mla        x                     deepseek (latent cache, smaller rows)
  ssm                x             mamba2
  hybrid     x       x             zamba2 (shared-attn + mamba groups)
  encdec     x            x        whisper (self-KV blocks + cross seg)

To ADD a family: register a :class:`CacheFamily` in :data:`FAMILIES`,
declare ``cache_family`` on the config (or teach
``models.model.cache_family`` to derive it), return matching device pools
from the model's ``init_paged_cache`` (``pools`` dict + ``pool_kinds``
kind map), and give the model a paged decode branch that consumes the
per-kind index arrays the engine stages (block table row / slab id /
segment id).  The allocator here is family-agnostic beyond the three
kinds.

Device-side data path (the paged batched decode hot loop):

  block POOL (device)       one zero pool per server & layer,
    (num_blocks, block_size, n_kv, head_dim)    built by
    ``models.model.init_paged_cache``;          prefill KV is scattered
    into a stream's reserved blocks once (ServeEngine._insert_paged_impl)
        │
  block TABLE (host->device)   this manager's per-sequence block list,
    (rows, W) int32            padded row built by :meth:`block_table`;
        │                      W covers only the LIVE rows' lengths
        ▼                      (power-of-two bucketed per step)
  paged gather-attend       pool[tables] -> (rows, W*block_size, ...) view,
                            masked past ``lengths``; kernels/
                            paged_decode_attention.py does the same via
                            scalar-prefetch indirection, one block per
                            grid step, early-exiting past each length

Slab pools skip the table: the staged row carries the slab id and the
model gathers/scatters ``state_pool[slab]`` directly.  Segment pools are
gather-only (read-only after prefill): the staged row carries the segment
id and the decode scan reads ``seg_pool[seg]`` without ever writing it.

When does which knob kick in (ServeEngine, paged=True):
  * slot COMPACTION — every step: only live rows enter the device call,
    padded to the next power of two; the call narrows whenever fewer than
    half the slots are decoding (pow2(n) < max_batch <=> n <= max_batch/2).
  * length BUCKETING — every step for the gather width W (pow2 of the
    longest live row's block count); at prefill, same-bucket prompts
    coalesce under batch_key ("prefill", server, bucket).  Slab-only
    families have no gather width — their single decode cell is width 0.

Exact per-stream lengths stay HERE, host-side: the device never sees a
length it doesn't need, and the analysis side keeps its per-request bounds
(declared WCET = full-width call; compaction/bucketing only shrink).

Migration protocol (live cross-server stream moves)
---------------------------------------------------
A stream's live cache can move from server A's pool to server B's pool
without recomputation.  The host-side half lives here; the device-side
half (one gather, one host copy, one scatter) is
``ServeEngine._execute_migration``:

  1. ``export_seq(seq_id)`` on the SOURCE manager snapshots the sequence
     into a frozen :class:`SeqExport` — the exact block-id order, token
     length, whether a slab rides along, and the segment content key.
     The source allocation stays live (blocks still owned) so the
     stream can keep decoding or abort cleanly until commit.
  2. ``import_seq(export)`` on the DESTINATION manager allocates the same
     number of FRESH private blocks (refcount 1 each) under the same
     seq_id, a fresh slab if the export carries one, and acquires the
     segment by key (joining an existing shared segment on B if one
     stream already holds that key).  COW block sharing is intentionally
     not preserved across pools: the destination copy is private, so a
     forked sibling left behind on the source keeps its shared blocks
     untouched.  Raises :class:`OutOfBlocksError` with the destination
     unchanged (all-or-nothing across every pool kind).
  3. The engine gathers ``pool[:, export.blocks]`` (and the slab /
     segment rows) on A (pow2-padded table so a precompiled "migrate"
     cell is reused — no mid-traffic trace), copies once through the
     host, scatters into the fresh ids on B, then COMMITS: ``free_seq``
     on the source, decode resumes on B.  Greedy tokens are bit-identical
     because pool contents and the (blocks, length) mapping are copied
     exactly.

Atomicity w.r.t. ``ServeEngine.remove``: the engine holds both sides in
its ``_held`` ledger for the whole window and serializes commit/abort
against ``remove`` under one lock, so a concurrent remove frees each
side exactly once (``free_seq(..., missing_ok=True)`` makes the race
idempotent, never a double-free).
"""

from __future__ import annotations

from dataclasses import dataclass, field


class OutOfBlocksError(RuntimeError):
    """Any pool kind (blocks, slabs, segments) is exhausted.  One type on
    purpose: the engine's backpressure path treats every kind the same."""


@dataclass(frozen=True)
class CacheFamily:
    """Which pool kinds a model family's cache needs (see module doc)."""

    name: str
    uses_blocks: bool = True
    uses_slab: bool = False
    uses_segment: bool = False

    @property
    def kinds(self) -> tuple[str, ...]:
        out = []
        if self.uses_blocks:
            out.append("block")
        if self.uses_slab:
            out.append("slab")
        if self.uses_segment:
            out.append("segment")
        return tuple(out)


FAMILIES: dict[str, CacheFamily] = {
    "gqa": CacheFamily("gqa"),
    "mla": CacheFamily("mla"),
    "ssm": CacheFamily("ssm", uses_blocks=False, uses_slab=True),
    "hybrid": CacheFamily("hybrid", uses_slab=True),
    "encdec": CacheFamily("encdec", uses_segment=True),
}


@dataclass
class SeqAlloc:
    blocks: list[int] = field(default_factory=list)
    length: int = 0  # tokens written
    slab: int | None = None
    segment: int | None = None
    segment_key: str | None = None


@dataclass(frozen=True)
class SeqExport:
    """Host-side snapshot of one sequence for cross-pool migration: the
    source pool's block ids in table order, the token length, whether a
    state slab rides along, and the shared-segment content key.  Pool
    *contents* travel separately (the engine's gather/scatter pair); this
    carries exactly what :meth:`PagedKVCacheManager.import_seq` needs to
    rebuild the allocation on another pool."""

    seq_id: str
    blocks: tuple[int, ...]
    length: int
    has_slab: bool = False
    segment_key: str | None = None


class PagedKVCacheManager:
    def __init__(self, *, num_blocks: int, block_size: int,
                 num_slabs: int = 0, num_segments: int = 0,
                 family: str | CacheFamily | None = None):
        if family is None:
            family = FAMILIES["gqa"]
        elif isinstance(family, str):
            family = FAMILIES[family]
        self.family = family
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.free: list[int] = list(range(num_blocks - 1, -1, -1))
        self.refcount = [0] * num_blocks
        self.seqs: dict[str, SeqAlloc] = {}
        # -- slab pool (constant-size per-stream state, unshared) --
        self.num_slabs = num_slabs
        self.free_slabs: list[int] = list(range(num_slabs - 1, -1, -1))
        # -- segment pool (read-only shared caches, keyed + refcounted) --
        self.num_segments = num_segments
        self.free_segments: list[int] = list(range(num_segments - 1, -1, -1))
        self.segment_refcount = [0] * num_segments
        self.segments: dict[str, int] = {}  # content key -> segment id

    # -- allocation ---------------------------------------------------------
    def _take_block(self) -> int:
        if not self.free:
            raise OutOfBlocksError("KV cache block pool exhausted")
        b = self.free.pop()
        self.refcount[b] = 1
        return b

    def _take_slab(self) -> int:
        if not self.free_slabs:
            raise OutOfBlocksError("state slab pool exhausted")
        return self.free_slabs.pop()

    def acquire_segment(self, key: str) -> tuple[int, bool]:
        """Refcounted acquire of the shared read-only segment for ``key``.
        Returns ``(segment_id, fresh)`` — ``fresh`` is True when this call
        allocated the segment (the caller must write its contents; joining
        callers must NOT, the contents are already live and shared)."""
        if key in self.segments:
            seg = self.segments[key]
            self.segment_refcount[seg] += 1
            return seg, False
        if not self.free_segments:
            raise OutOfBlocksError("shared segment pool exhausted")
        seg = self.free_segments.pop()
        self.segment_refcount[seg] = 1
        self.segments[key] = seg
        return seg, True

    def release_segment(self, seg: int) -> None:
        """Drop one reference; the last release returns the segment to the
        free list and retires its content key."""
        self.segment_refcount[seg] -= 1
        if self.segment_refcount[seg] == 0:
            self.free_segments.append(seg)
            for k, v in list(self.segments.items()):
                if v == seg:
                    del self.segments[k]

    def allocate(self, seq_id: str, num_tokens: int, *,
                 segment_key: str | None = None) -> list[int]:
        """Allocate every pool kind the family needs for a fresh sequence
        of ``num_tokens``; returns the block ids (empty for slab-only
        families).  All-or-nothing across kinds: exhaustion of any pool
        leaves the manager unchanged."""
        if seq_id in self.seqs:
            raise ValueError(f"{seq_id!r} already allocated")
        fam = self.family
        n = self._blocks_for(num_tokens) if fam.uses_blocks else 0
        if len(self.free) < n:
            raise OutOfBlocksError(f"need {n} blocks, {len(self.free)} free")
        if fam.uses_slab and not self.free_slabs:
            raise OutOfBlocksError("state slab pool exhausted")
        if (fam.uses_segment and segment_key not in self.segments
                and not self.free_segments):
            raise OutOfBlocksError("shared segment pool exhausted")
        alloc = SeqAlloc([self._take_block() for _ in range(n)], num_tokens)
        if fam.uses_slab:
            alloc.slab = self._take_slab()
        if fam.uses_segment:
            key = segment_key if segment_key is not None else seq_id
            alloc.segment, _ = self.acquire_segment(key)
            alloc.segment_key = key
        self.seqs[seq_id] = alloc
        return list(alloc.blocks)

    def extend(self, seq_id: str, new_tokens: int = 1) -> list[int]:
        """Grow a sequence; returns newly allocated block ids (often []).

        Copy-on-write: the fork decision is made BEFORE any blocks are
        appended — if the first new token lands in a shared, partially-
        filled tail block (``length % block_size != 0`` and refcount > 1),
        that tail is forked; a full shared tail needs no fork because new
        tokens only ever touch freshly appended blocks.  Slabs and
        segments are constant-size — only the length advances."""
        a = self.seqs[seq_id]
        if not self.family.uses_blocks:
            a.length += new_tokens
            return []
        fresh = []
        if new_tokens and a.length % self.block_size:
            last = a.blocks[-1]
            if self.refcount[last] > 1:
                fork = self._take_block()
                self.refcount[last] -= 1
                a.blocks[-1] = fork
                fresh.append(fork)
        target = self._blocks_for(a.length + new_tokens)
        while len(a.blocks) < target:
            fresh.append(self._take_block())
            a.blocks.append(fresh[-1])
        a.length += new_tokens
        return fresh

    def fork(self, src_id: str, dst_id: str) -> None:
        """Share ``src``'s blocks with a new sequence (prefix caching).
        Blocks share via COW refcounts; a shared segment gains a reference
        (read-only, so true sharing); a slab is NEVER shared — the fork
        gets a fresh one (the engine copies its contents)."""
        if dst_id in self.seqs:
            raise ValueError(f"{dst_id!r} already allocated")
        src = self.seqs[src_id]
        if src.slab is not None and not self.free_slabs:
            raise OutOfBlocksError("state slab pool exhausted")
        for b in src.blocks:
            self.refcount[b] += 1
        dst = SeqAlloc(list(src.blocks), src.length)
        if src.slab is not None:
            dst.slab = self._take_slab()
        if src.segment is not None:
            self.segment_refcount[src.segment] += 1
            dst.segment, dst.segment_key = src.segment, src.segment_key
        self.seqs[dst_id] = dst

    def free_seq(self, seq_id: str, *, missing_ok: bool = False) -> None:
        """Release every pool kind a sequence holds.  ``missing_ok`` makes
        the free idempotent — the fault-recovery paths (stream eviction,
        engine ``remove``) may race the generating thread's own cleanup,
        and whichever frees second must be a no-op, not a KeyError."""
        a = self.seqs.pop(seq_id, None)
        if a is None:
            if missing_ok:
                return
            raise KeyError(seq_id)
        for b in a.blocks:
            self.refcount[b] -= 1
            if self.refcount[b] == 0:
                self.free.append(b)
        if a.slab is not None:
            self.free_slabs.append(a.slab)
        if a.segment is not None:
            self.release_segment(a.segment)

    # -- migration ----------------------------------------------------------
    def export_seq(self, seq_id: str) -> SeqExport:
        """Snapshot ``seq_id`` for migration (step 1 of the protocol in the
        module docstring).  Pure read: the source allocation stays live and
        owned until the engine commits with :meth:`free_seq`."""
        a = self.seqs[seq_id]
        return SeqExport(seq_id=seq_id, blocks=tuple(a.blocks),
                         length=a.length, has_slab=a.slab is not None,
                         segment_key=a.segment_key)

    def import_seq(self, export: SeqExport) -> list[int]:
        """Rebuild an exported sequence on THIS pool with fresh private
        blocks (step 2 of the protocol); returns the new block ids in the
        same table order as ``export.blocks``.  The block count is
        preserved exactly — including any reservation padding beyond
        ``_blocks_for(length)`` — so a mid-generation move keeps the
        blocks the source had already set aside for upcoming tokens.  A
        slab import gets a fresh slab; a segment import acquires by key
        (joining a same-key segment already live here).  All-or-nothing:
        on exhaustion of ANY kind the pool is left unchanged."""
        if export.seq_id in self.seqs:
            raise ValueError(f"{export.seq_id!r} already allocated")
        n = len(export.blocks)
        if len(self.free) < n:
            raise OutOfBlocksError(
                f"migration needs {n} blocks, {len(self.free)} free")
        if export.has_slab and not self.free_slabs:
            raise OutOfBlocksError("state slab pool exhausted")
        if (export.segment_key is not None
                and export.segment_key not in self.segments
                and not self.free_segments):
            raise OutOfBlocksError("shared segment pool exhausted")
        alloc = SeqAlloc([self._take_block() for _ in range(n)],
                         export.length)
        if export.has_slab:
            alloc.slab = self._take_slab()
        if export.segment_key is not None:
            alloc.segment, _ = self.acquire_segment(export.segment_key)
            alloc.segment_key = export.segment_key
        self.seqs[export.seq_id] = alloc
        return list(alloc.blocks)

    def seq_ids(self, prefix: str = "") -> list[str]:
        """Live sequence ids, optionally filtered by stream-name prefix
        (engine sequence ids are ``f"{stream}#{counter}"``)."""
        return [s for s in self.seqs if s.startswith(prefix)]

    # -- tables -------------------------------------------------------------
    def block_table(self, seq_id: str, *, max_blocks: int) -> list[int]:
        """Padded block table row for the device-side gather (pad = 0 with
        the length masking the tail, matching decode_attention's lengths)."""
        a = self.seqs[seq_id]
        if len(a.blocks) > max_blocks:
            raise ValueError("sequence exceeds max_blocks")
        return a.blocks + [0] * (max_blocks - len(a.blocks))

    def slab(self, seq_id: str) -> int | None:
        return self.seqs[seq_id].slab

    def segment(self, seq_id: str) -> int | None:
        return self.seqs[seq_id].segment

    def length(self, seq_id: str) -> int:
        return self.seqs[seq_id].length

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self.free)

    @property
    def slabs_in_use(self) -> int:
        return self.num_slabs - len(self.free_slabs)

    @property
    def segments_in_use(self) -> int:
        return self.num_segments - len(self.free_segments)

    def usage(self) -> dict[str, int]:
        """Per-kind live counts — the leak probe's unit of account."""
        return {"blocks": self.blocks_in_use, "slabs": self.slabs_in_use,
                "segments": self.segments_in_use}

    def utilization(self) -> float:
        return self.blocks_in_use / self.num_blocks if self.num_blocks else 0.0

    def _blocks_for(self, tokens: int) -> int:
        return max(1, -(-tokens // self.block_size))
