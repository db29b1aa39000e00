"""Serving engine of the port: the paper's GPU server as the dispatch layer
of a PyTorch inference runtime -- a multi-server pool with continuous,
paged, length-aware decode batching.

Counterpart of ``repro/serving/engine.py`` (see its docstring for the
architecture).  The port has the main path, ``batching=True,
paged=True`` -- family-generic: GQA KV block pools, MLA latent block
pools (plus the MoE prefix layer's pools on the same block tables), SSM
state-slab pools, the hybrid stack's two kinds per row (the shared
attention block's KV block pools and the Mamba-2 state-slab pools, staged
in one decode call), and the enc-dec stack's decoder KV block pools beside
its cross-attention segments (refcounted, read-only, shared by the
streams of one encoder output) -- and the unbatched ``generate`` path that
serves as its reference:

  client streams --admit--> PoolAdmissionController (Eqs (1)-(6) per
        |                   device partition)
        +--submit--> ServerPool --> BatchingServer (one request, or one
                         |            batch, at a time per server)
                         v
           length-bucketed batched prefill / compacted paged decode

How the reference's device mechanisms map onto PyTorch:

  * each server owns a CUDA stream; every device call runs on the server's
    thread inside ``torch.inference_mode()`` and that stream (both are
    thread-local, so they are entered in the callable, never around the
    client), and the stream is synchronized before the call is timed --
    the counterpart of ``jax.block_until_ready``;
  * buffer donation becomes in-place updates: a server's block or slab
    pools are allocated once and every insert and decode step writes into
    them;
  * ``jax.jit`` per cell becomes a CUDA graph per cell: ``precompile``
    runs every (rows, width) decode cell and (rows, bucket) prefill cell
    on each server, eagerly twice on the server's stream, then captures it
    (``serving/graphs.py``; one graph memory pool per server); a call of a
    warm cell copies its staged rows into the graph's static inputs and
    replays it.  A cell first hit mid-traffic is bumped up to the cheapest
    warm cell that covers it (widening is sound: extra width lanes read
    the scratch block past each row's length, extra rows duplicate row 0
    and write identical values); with no warm cover it runs eagerly and is
    never captured mid-traffic.  On the CPU nothing is captured and every
    cell runs eagerly.  Slab-only families have no gather width: their one
    width bucket is 0;
  * the enc-dec frontend is a stub, as in the reference: every prefill
    encodes zero frames, so all of a server's streams share one
    cross-attention segment (the copy-on-write dedup case).

Out of this slice, each raising ``NotImplementedError``: the masked-dense
batched layout and fault tolerance, migration (of blocks, slabs and
segments), work stealing and elastic scaling (ROADMAP A10), and static
cell pricing (ROADMAP A5).
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis.cost_model import autotune_buckets, bucket_up
from repro_torch.core.admission import PoolAdmissionController
from repro_torch.core.dispatch.pool import ServerPool
from repro_torch.core.task_model import GpuSegment, Task
from repro_torch.models import model as M
from repro_torch.runtime.straggler import DeadlineAwarePolicy
from repro_torch.serving.graphs import GraphCell
from repro_torch.serving.kvcache import FAMILIES, PagedKVCacheManager


def _pow2_ladder(cap: int) -> tuple[int, ...]:
    """Every bucket the pow2-with-clamp rule can produce up to ``cap``:
    1, 2, 4, ... plus ``cap`` itself when cap is not a power of two."""
    out = []
    v = 1
    while v < cap:
        out.append(v)
        v *= 2
    out.append(cap)
    return tuple(out)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _clone(tree):
    """Copy of every tensor of a (dicts, lists, tuples) tree."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


@dataclass
class PrecompileReport:
    """What one ``precompile()`` call did: ``compiled`` distinct cells
    warmed now, ``skipped`` reachable cells not run (already warm from an
    earlier call, or filtered out by the traffic model), ``captured`` CUDA
    graphs captured over all servers (0 on the CPU)."""

    compiled: int = 0
    skipped: int = 0
    decode_cells: tuple = ()
    prefill_cells: tuple = ()
    captured: int = 0


@dataclass
class StreamSpec:
    name: str
    priority: int
    period_ms: float
    deadline_ms: float
    # declared worst-case segment costs for admission (measured or profiled)
    prefill_ms: float
    decode_ms: float
    decode_steps: int  # decode segments per job (period)
    cpu_ms: float = 0.1


@dataclass
class GenerationResult:
    tokens: list[int] = field(default_factory=list)
    prefill_latency_s: float = 0.0
    decode_latencies_s: list[float] = field(default_factory=list)


class _SlotState:
    """Per-server decode slots: at most ``max_batch`` streams hold one at a
    time, so a server's reserved KV never outgrows its pool."""

    def __init__(self, max_batch: int):
        self.free = list(range(max_batch))
        self.cond = threading.Condition()


class _PagedState:
    """Per-server paged-cache state: the host-side allocator (blocks, state
    slabs, shared segments -- whichever kinds the cache family uses) plus
    the device pools.  ``mgr``/``lock`` are touched from client threads at
    job start/end; ``pools`` and the staging buffer only from the server's
    own thread (serialized with its batches)."""

    def __init__(self, num_blocks: int, block_size: int, max_batch: int,
                 max_seq: int, *, family: str = "gqa", num_slabs: int = 0,
                 num_segments: int = 0):
        self.mgr = PagedKVCacheManager(num_blocks=num_blocks,
                                       block_size=block_size,
                                       num_slabs=num_slabs,
                                       num_segments=num_segments,
                                       family=family)
        self.lock = threading.Lock()
        # table width covering max_seq (0 for slab-only families)
        self.nb_max = (max_seq // block_size
                       if FAMILIES[family].uses_blocks else 0)
        # one resource of each kind the family uses is held back as the
        # scratch target of padded lanes and unused staging columns;
        # nothing ever reads its content
        self.mgr.allocate("__scratch__", 1)
        scratch = self.mgr.seqs["__scratch__"]
        self.scratch_block = scratch.blocks[0] if scratch.blocks else 0
        self.scratch_slab = scratch.slab if scratch.slab is not None else 0
        self.scratch_seg = (scratch.segment if scratch.segment is not None
                            else 0)
        self.pools = None  # allocated once, on the server's thread
        # ("decode", rows, width) / ("prefill", rows, bucket) -> GraphCell,
        # captured by precompile on the card, all in one memory pool
        self.graphs: dict[tuple, GraphCell] = {}
        self.graph_pool = None
        # preallocated staging for the compacted decode batch, packed into
        # ONE int32 array so each step pays a single host->device copy:
        # row = [token, length, slab, segment, block_table...]
        self.pack_scratch = np.zeros((max_batch, 4 + self.nb_max), np.int32)


class ServeEngine:
    def __init__(self, cfg, params, *, max_seq: int = 128,
                 ordering: str = "priority", admission_cores: int = 2,
                 epsilon_ms: float = 0.05, kv_blocks: int = 0,
                 kv_block_size: int = 16, num_servers: int = 1,
                 batching: bool = False, max_batch: int = 8,
                 paged: bool = False, cost_model=None, device=None):
        self.device = resolve_device(device)
        if batching and not paged:
            _not_ported("the masked-dense batched decode layout "
                        "(batching=True, paged=False)", "A10")
        if paged and not batching:
            raise ValueError("paged=True requires batching=True (the block "
                             "pools are the batched decode cache layout)")
        if paged and not M.supports_paged(cfg):
            raise ValueError(f"paged decode unsupported for {cfg.family}/"
                             f"{cfg.attn_type}")
        # pool kinds of the model's cache family ({} when not paged):
        # "block" -> KV block pool, "slab" -> fixed-size state slab,
        # "segment" -> refcounted read-only shared segment
        self._pool_kinds = M.paged_pool_kinds(cfg) if paged else {}
        self._cache_kinds = set(self._pool_kinds.values())
        if "block" in self._cache_kinds and max_seq % kv_block_size:
            raise ValueError(f"max_seq={max_seq} must be a multiple of "
                             f"kv_block_size={kv_block_size} for the paged "
                             "layout")
        # family-tagged cost-model phases: GQA keeps the untagged names,
        # other families get their own fit groups
        self._family = (M.cache_family(cfg) or "gqa") if paged else "gqa"
        tag = "" if self._family == "gqa" else "@" + self._family
        self._decode_kind = "decode" + tag
        self._prefill_kind = "prefill" + tag
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.batching = batching
        self.paged = paged
        self.max_batch = max_batch
        self.cost_model = cost_model
        self.kv_block_size = kv_block_size
        self.pool = ServerPool(num_servers, ordering=ordering,
                               batching=batching, max_batch=max_batch,
                               name="serve-engine")
        self.admission = PoolAdmissionController(
            num_servers, cores_per_device=admission_cores,
            epsilon_ms=epsilon_ms, cost_model=cost_model)
        self.straggler = DeadlineAwarePolicy()
        # optional paged-KV accounting for the UNBATCHED path: generate()
        # holds block allocations for its sequence's lifetime; exhaustion
        # rejects the request before any device work is dispatched
        self.kv = (PagedKVCacheManager(num_blocks=kv_blocks,
                                       block_size=kv_block_size)
                   if kv_blocks and not paged else None)
        self._kv_lock = threading.Lock()
        self._seq_counter = 0
        self._held: dict[str, set] = {}  # stream -> {(si | None, seq_id)}
        self._streams: dict[str, StreamSpec] = {}
        # one CUDA stream per server: its device calls queue behind each
        # other and never behind another server's
        self._cuda_streams = ([torch.cuda.Stream(self.device)
                               for _ in range(num_servers)]
                              if self.device.type == "cuda" else None)
        # warm cells become CUDA graphs on the card only
        self._graphs = self.device.type == "cuda"
        # shape-bucket boundaries (tunable via tune_buckets()): batch rows
        # and prefill pad lengths default to the full pow2 ladder
        self._row_buckets = _pow2_ladder(max_batch)
        self.prefill_buckets = _pow2_ladder(max_seq)
        self.width_buckets: tuple[int, ...] = ()
        # cells warmed by precompile(); consulted by the bump-up of cold
        # cells in the hot path
        self._warm_decode: set[tuple[int, int]] = set()
        self._warm_prefill: set[tuple[int, int]] = set()
        self._slots: list[_SlotState] = []
        self._paged: list[_PagedState] = []
        if batching:
            self._slots = [_SlotState(max_batch) for _ in range(num_servers)]
            uses_blocks = "block" in self._cache_kinds
            # default block pool: every slot can hold a max_seq sequence,
            # plus the scratch block (slab-only families carry no blocks)
            num_blocks = ((kv_blocks or max_batch * (max_seq // kv_block_size)
                           + 1) if uses_blocks else 0)
            # slabs: one per slot, doubled as in the reference (room for a
            # migration's source and destination), plus scratch; segments:
            # shared across slots (refcounted), so max_batch distinct keys
            # plus scratch cover the worst case
            num_slabs = 2 * max_batch + 2 if "slab" in self._cache_kinds else 0
            num_segments = (max_batch + 2 if "segment" in self._cache_kinds
                            else 0)
            self._paged = [_PagedState(num_blocks, kv_block_size, max_batch,
                                       max_seq, family=self._family,
                                       num_slabs=num_slabs,
                                       num_segments=num_segments)
                           for _ in range(num_servers)]
            # slab-only families have no gather width: the single 0 bucket
            # keeps every bucket_up() call well-defined
            self.width_buckets = (_pow2_ladder(self._paged[0].nb_max)
                                  if uses_blocks else (0,))

    # -- device calls --------------------------------------------------------
    def _on_device(self, si: int, fn):
        """Run ``fn`` in server ``si``'s device context -- inference mode
        and the server's CUDA stream, both thread-local -- and return its
        result once the stream has drained."""
        with torch.inference_mode():
            if self._cuda_streams is None:
                return fn()
            stream = self._cuda_streams[si]
            with torch.cuda.stream(stream):
                out = fn()
            stream.synchronize()
            return out

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _prefill(self, tokens, lengths=None):
        """Prefill ``tokens`` (B, S) (true ``lengths`` (B,) int32 of a
        padded batch), numpy arrays or device tensors, on the current
        device context; the cache comes back padded to max_seq.  An enc-dec
        stack encodes zero frames (B, encoder_seq, d_model) in the config's
        dtype: the audio frontend is a stub."""
        if isinstance(tokens, np.ndarray):
            tokens = self._tensor(tokens)
        if isinstance(lengths, np.ndarray):
            lengths = self._tensor(lengths)
        batch = {"tokens": tokens, "max_seq": self.max_seq}
        if self.cfg.family == "encdec":
            batch["frames"] = torch.zeros(
                (tokens.shape[0], self.cfg.encoder_seq, self.cfg.d_model),
                dtype=getattr(torch, self.cfg.dtype), device=self.device)
        if lengths is not None:
            batch["lengths"] = lengths
        return M.apply(self.cfg, self.params, batch, mode="prefill")

    def _prefill_batch_impl(self, tokens: torch.Tensor,
                            lengths: torch.Tensor):
        """One bucketed prefill call: tokens (R, bucket), lengths (R,)
        int32 -> (each row's last-token logits (R, V) fp32, the cache)."""
        logits, cache, _ = self._prefill(tokens, lengths)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        return logits[rows, lengths.long() - 1], cache

    # -- stream admission (analysis-driven, Eqs (1)-(6) per partition) -----
    def admit(self, spec: StreamSpec, *, cell=None):
        """``cell``: optional cost-model shape hint enabling CALIBRATED
        admission when the engine was built with a ``cost_model``."""
        segs = (GpuSegment(e=spec.prefill_ms * 0.9, m=spec.prefill_ms * 0.1),
                *(GpuSegment(e=spec.decode_ms * 0.9, m=spec.decode_ms * 0.1),)
                * spec.decode_steps)
        task = Task(name=spec.name, C=spec.cpu_ms, T=spec.period_ms,
                    D=spec.deadline_ms, segments=segs, priority=spec.priority)
        decision, device = self.admission.try_admit(task, cell=cell)
        if decision.admitted:
            self._streams[spec.name] = spec
            self.straggler.register(spec.name, spec.deadline_ms)
            # the router follows the admission's device-assignment step
            self.pool.assign(spec.name, utilization=task.G / task.T,
                             priority=spec.priority, server=device)
        return decision

    def remove(self, name: str) -> None:
        """Withdraw a stream: admission slot, router binding, and any KV
        blocks still held for it.  Never call while the stream has a device
        call in flight."""
        self.admission.remove(name)
        self.pool.remove(name)
        self._streams.pop(name, None)
        with self._kv_lock:
            held = self._held.pop(name, set())
        for si, seq_id in held:
            self._free(si, seq_id)

    def _free(self, si, seq_id: str) -> None:
        if si is None:
            with self._kv_lock:
                self.kv.free_seq(seq_id, missing_ok=True)
        else:
            state = self._paged[si]
            with state.lock:
                state.mgr.free_seq(seq_id, missing_ok=True)

    # -- bucket auto-tuning (cost-model driven) ----------------------------
    def tune_buckets(self, prompt_lengths, *, steps_hint: int = 0,
                     cost_model=None, max_buckets: int = 4):
        """Pick the prefill-length and (paged) gather-width bucket
        boundaries for an expected workload: exact DP over the pow2
        candidate ladder minimizing total padding waste -- or, when a
        fitted ``cost_model`` (default: the engine's own) can price the
        phase, total predicted step cost.  The largest candidate always
        survives (coverage).  Call BEFORE precompile()/traffic: retuning
        clears both warm sets.  Returns (prefill_buckets, width_buckets)."""
        model = cost_model if cost_model is not None else self.cost_model
        lengths = [int(l) for l in prompt_lengths]
        if any(l > self.max_seq for l in lengths):
            raise ValueError("prompt length exceeds max_seq")

        def priced(phase, rows):
            if model is None:
                return None
            probe = model.predict(phase, rows, _pow2_ladder(self.max_seq)[-1])
            if not math.isfinite(probe):
                return None  # phase unmeasured: fall back to padding waste
            return lambda bucket, value: model.predict(phase, rows, bucket)

        self.prefill_buckets = autotune_buckets(
            lengths or [1], _pow2_ladder(self.max_seq),
            max_buckets=max_buckets, cost_of=priced(self._prefill_kind, 1))
        if self.paged and self._paged[0].nb_max:
            bs = self.kv_block_size
            nb_max = self._paged[0].nb_max
            # widths are driven by each stream's FINAL length (the widest
            # gather its decode steps reach): ceil((len + steps + 1) / bs)
            needs = [min(nb_max, -(-(l + steps_hint + 1) // bs))
                     for l in lengths] or [1]
            wmodel = None
            if model is not None:
                probe = model.predict(self._decode_kind, 1, nb_max)
                if math.isfinite(probe):
                    wmodel = lambda bucket, value: model.predict(
                        self._decode_kind, 1, bucket)
            self.width_buckets = autotune_buckets(
                needs, _pow2_ladder(nb_max), max_buckets=max_buckets,
                cost_of=wmodel)
        self._warm_decode.clear()
        self._warm_prefill.clear()
        return self.prefill_buckets, self.width_buckets

    # -- batched decode internals (paged pools, family-generic) -------------
    def _make_pools(self, state):
        return M.init_paged_cache(self.cfg, state.mgr.num_blocks,
                                  state.mgr.block_size,
                                  num_slabs=state.mgr.num_slabs,
                                  num_segments=state.mgr.num_segments,
                                  device=self.device)

    def _insert_paged_impl(self, pools, cache, src_row: int,
                           table: np.ndarray, slab: int, seg: int) -> None:
        """Copy row ``src_row`` of a prefill cache into the pools, per pool
        kind: "block" leaves scatter at ``table`` (nb_max entries; lanes
        past the sequence's reserved blocks point at the scratch block and
        carry all-zero rows, so duplicate scatter lanes stay
        deterministic); "slab" leaves land in row ``slab`` (the SSM cache
        has no sequence axis: one row, one slab); "segment" leaves land in
        row ``seg`` (a shared segment: re-staging a key already present
        rewrites the same content)."""
        bs = self.kv_block_size
        views = M.paged_insert_views(self.cfg, cache)
        idx = self._tensor(table).long() if "block" in self._cache_kinds \
            else None
        for key, kind in self._pool_kinds.items():
            for pool, leaf in zip(pools[key], views[key]):
                if kind == "block":
                    # leaf (L, B, max_seq, ...) -> rows (L, nb_max, bs, ...)
                    rows = leaf[:, src_row].reshape(leaf.shape[0], -1, bs,
                                                    *leaf.shape[3:])
                    pool[:, idx] = rows.to(pool.dtype)
                else:  # "slab" or "segment": one row of the pool
                    pool[:, slab if kind == "slab" else seg] = (
                        leaf[:, src_row].to(pool.dtype))

    def _decode_paged_impl(self, packed: torch.Tensor, pools):
        """One compacted paged decode step.  ``packed`` (n, 4+W) int32 rows
        are [token, length, slab, segment, block_table...] -- one header
        for every family; the columns a family does not use carry scratch
        ids and are never read.  The table width W addresses only the
        blocks the live rows need.  Rows write their new KV or state into
        their own blocks or slabs in place.  Returns the (n, 1, V) fp32
        logits."""
        cache = dict(pools)
        cache["pos"] = packed[:, 1]
        if "block" in self._cache_kinds:
            cache["block_tables"] = packed[:, 4:].contiguous()
        if "slab" in self._cache_kinds:
            cache["slab_ids"] = packed[:, 2].contiguous()
        if "segment" in self._cache_kinds:
            cache["segment_ids"] = packed[:, 3].contiguous()
        logits, _, _ = M.apply(self.cfg, self.params,
                               {"tokens": packed[:, :1]}, mode="decode",
                               cache=cache)
        return logits

    def _insert_slot_paged(self, si: int, cache, src_row: int,
                           table: np.ndarray, slab: int, seg: int) -> None:
        """Runs on server ``si``'s thread (serialized with its batches)."""
        state = self._paged[si]

        def insert():
            if state.pools is None:
                state.pools = self._make_pools(state)
            self._insert_paged_impl(state.pools, cache, src_row, table, slab,
                                    seg)

        self._on_device(si, insert)

    def _run_paged_decode(self, si: int):
        """run_batch callable for server ``si``: payloads are (token,
        block_table, length, slab, segment) tuples.  Slot compaction and
        length bucketing happen here: only the live rows enter the device
        call (padded to a row bucket by duplicating row 0 -- duplicate
        scatter lanes write identical values), and the block-table gather
        is truncated to the width bucket that covers the longest live row
        (0 for slab-only families: no gather axis at all)."""

        def run(payloads):
            state = self._paged[si]
            bs = state.mgr.block_size
            n = len(payloads)
            n_pad = bucket_up(n, self._row_buckets)
            need = (max(-(-(length + 1) // bs)
                        for _, _, length, _, _ in payloads)
                    if state.nb_max else 0)
            w = bucket_up(need, self.width_buckets)
            # a cold cell mid-traffic bumps up to the cheapest warm cell
            # that covers it; with no warm cover it runs cold
            cold = False
            if self._warm_decode and (n_pad, w) not in self._warm_decode:
                covers = [c for c in self._warm_decode
                          if c[0] >= n_pad and c[1] >= w]
                if covers:
                    n_pad, w = min(covers, key=lambda c: c[0] * c[1])
                else:
                    cold = True
            pack = state.pack_scratch
            for i, (token, table, length, slab, seg) in enumerate(payloads):
                pack[i, 0] = token
                pack[i, 1] = length
                pack[i, 2] = slab
                pack[i, 3] = seg
                pack[i, 4:] = table
            for i in range(n, n_pad):  # idempotent padding rows
                pack[i] = pack[0]
            staged = pack[:n_pad, : 4 + w]
            graph = state.graphs.get(("decode", n_pad, w))

            def step():
                if graph is not None:
                    logits = graph.replay(staged)
                else:
                    logits = self._decode_paged_impl(self._tensor(staged),
                                                     state.pools)
                return logits[:n, -1].cpu().numpy()

            t0 = time.monotonic()
            rows = self._on_device(si, step)
            dt = time.monotonic() - t0
            self._ran_cold(self._warm_decode, cold, (n_pad, w))
            self.pool.servers[si].record_meta(
                kind=self._decode_kind, rows=n, padded=n_pad, width=w,
                compacted=n_pad < self.max_batch, seconds=dt, cold=cold,
                graphed=graph is not None)
            return [rows[i] for i in range(n)]

        return run

    def _paged_reserve(self, si: int, name: str, prompt_len: int,
                       steps: int, bucket: int
                       ) -> tuple[str, np.ndarray, int, int]:
        """Reserve every resource the job will touch up front (reject early
        rather than stall mid-generation), including the bucketed-prefill
        pad region, whose padding-token KV must land in owned blocks.
        Returns (seq_id, full-width block table, slab id, segment id); the
        kinds the family does not use come back as the scratch ids."""
        state = self._paged[si]
        with self._kv_lock:
            self._seq_counter += 1
            seq_id = f"{name}#{self._seq_counter}"
        with state.lock:
            # every stream's encoder frames are the same zeros (_prefill),
            # so all streams share one cross-attention segment; families
            # without segments ignore the key
            state.mgr.allocate(seq_id, prompt_len, segment_key="__frames__")
            try:
                state.mgr.extend(seq_id, max(prompt_len + steps, bucket)
                                 - prompt_len)
            except Exception:
                state.mgr.free_seq(seq_id)
                raise
            alloc = state.mgr.seqs[seq_id]
            table = np.full((state.nb_max,), state.scratch_block, np.int32)
            table[: len(alloc.blocks)] = alloc.blocks
            slab = (alloc.slab if alloc.slab is not None
                    else state.scratch_slab)
            seg = (alloc.segment if alloc.segment is not None
                   else state.scratch_seg)
        with self._kv_lock:
            self._held.setdefault(name, set()).add((si, seq_id))
        return seq_id, table, slab, seg

    def _paged_release(self, si, seq_id) -> None:
        """Free ``seq_id``'s blocks on server ``si`` (``si`` None: the
        unbatched path's manager) and drop it from the stream's ledger."""
        if seq_id is None:
            return
        with self._kv_lock:
            held = self._held.get(seq_id.rsplit("#", 1)[0])
            if held is not None:
                held.discard((si, seq_id))
        self._free(si, seq_id)

    # -- batched prefill (length-bucketed) ---------------------------------
    def _run_prefill_batch(self, si: int, bucket: int):
        """run_batch callable coalescing same-bucket prefills: payloads are
        (prompt_row, true_len); ONE device call prefills them all, padded to
        ``bucket``.  Each result is (last-token logits row, the coalesced
        cache, this payload's row index) -- the caller inserts its row in
        a later call, so a replayed cell's cache is copied out of the
        graph's static outputs first (another prefill of the same cell may
        replay in between)."""

        def run(payloads):
            n = len(payloads)
            n_pad = bucket_up(n, self._row_buckets)
            # bump-up on the row axis (the bucket axis was already steered
            # to a warm pad length by _attempt_batched): padding rows
            # duplicate row 0 and their outputs are discarded
            cold = False
            if self._warm_prefill and (n_pad, bucket) not in self._warm_prefill:
                covers = [r for r, b in self._warm_prefill
                          if b == bucket and r >= n_pad]
                if covers:
                    n_pad = min(covers)
                else:
                    cold = True
            toks = np.zeros((n_pad, bucket), np.int32)
            lens = np.zeros((n_pad,), np.int32)
            for i, (prompt, true_len) in enumerate(payloads):
                toks[i, :true_len] = prompt
                lens[i] = true_len
            for i in range(n, n_pad):  # padding rows: discarded outputs
                toks[i] = toks[0]
                lens[i] = lens[0]

            graph = self._paged[si].graphs.get(("prefill", n_pad, bucket))

            def prefill():
                if graph is not None:
                    rows, cache = graph.replay(toks, lens)
                    cache = _clone(cache)
                else:
                    rows, cache = self._prefill_batch_impl(
                        self._tensor(toks), self._tensor(lens))
                return rows[:n].cpu().numpy(), cache

            t0 = time.monotonic()
            rows, cache = self._on_device(si, prefill)
            dt = time.monotonic() - t0
            self._ran_cold(self._warm_prefill, cold, (n_pad, bucket))
            self.pool.servers[si].record_meta(
                kind=self._prefill_kind, rows=n, padded=n_pad, bucket=bucket,
                seconds=dt, cold=cold, graphed=graph is not None)
            return [(rows[i], cache, i) for i in range(n)]

        return run

    def _ran_cold(self, warm: set, cold: bool, cell: tuple) -> None:
        """After a cold cell ran eagerly: on the CPU later hits count as
        warm; on the card a warm cell is a captured one, and a cell is
        never captured mid-traffic, so it stays cold."""
        if cold and not self._graphs:
            warm.add(cell)

    def precompile(self, prompt_buckets: tuple[int, ...] = (), *,
                   traffic=None) -> PrecompileReport:
        """Warm batched-decode/prefill shape cells before taking load.

        Every reachable (rows, width) decode cell and each (rows, bucket)
        prefill cell of ``prompt_buckets`` (snapped up into
        ``prefill_buckets``) runs on every server, so its allocations,
        library heuristics and the server's stream are warm, and on the
        card is then captured as a CUDA graph that the hot path replays
        (a capture that fails raises).  ``traffic`` --
        a ``cost_model.TrafficModel`` or an iterable of CellKeys -- restricts
        the set to the predicted-hit cells PLUS, always, the largest cell on
        each phase: the target the hot path bumps cold cells up to.  Cells
        already warm from an earlier call are skipped.  The dummy inserts
        scribble on the scratch block, so never call this while streams are
        live.  No-op unless batching."""
        if not self.batching:
            return PrecompileReport()
        hot = None
        if traffic is not None:
            hot = (set(traffic.hot_cells())
                   if hasattr(traffic, "hot_cells") else set(traffic))
        rows_ladder = self._row_buckets
        reachable_d = [(r, w) for r in rows_ladder for w in self.width_buckets]
        fb_d = (rows_ladder[-1], self.width_buckets[-1])
        plan_d = [c for c in reachable_d
                  if hot is None or c == fb_d
                  or (self._decode_kind, *c) in hot]
        todo_d = [c for c in plan_d if c not in self._warm_decode]
        buckets = sorted({bucket_up(b, self.prefill_buckets)
                          for b in prompt_buckets})
        reachable_p = [(r, b) for b in buckets for r in rows_ladder]
        fb_p = (rows_ladder[-1], buckets[-1]) if buckets else None
        plan_p = [c for c in reachable_p
                  if hot is None or c == fb_p
                  or (self._prefill_kind, *c) in hot]
        todo_p = [c for c in plan_p if c not in self._warm_prefill]
        captured = 0
        for si, server in enumerate(self.pool.servers):
            captured += server.submit(lambda si=si: self._precompile_server(
                si, todo_d, todo_p), name=f"precompile-{si}").wait()
        self._warm_decode.update(todo_d)
        self._warm_prefill.update(todo_p)
        skipped = ((len(reachable_d) - len(todo_d))
                   + (len(reachable_p) - len(todo_p)))
        return PrecompileReport(compiled=len(todo_d) + len(todo_p),
                                skipped=skipped, decode_cells=tuple(todo_d),
                                prefill_cells=tuple(todo_p),
                                captured=captured)

    def _precompile_server(self, si: int, decode_cells, prefill_cells) -> int:
        """Warm the cells on server ``si`` and, on the card, capture each
        one not captured yet; returns the number of graphs captured."""
        state = self._paged[si]
        before = len(state.graphs)

        def graph(key, fn, *arrays):
            """Run ``fn`` once more, eagerly, on the server's stream, then
            capture it on that stream into the server's graph pool."""
            if not self._graphs or key in state.graphs:
                return
            inputs = [self._tensor(a) for a in arrays]
            fn(*inputs)
            if state.graph_pool is None:
                state.graph_pool = torch.cuda.graph_pool_handle()
            state.graphs[key] = GraphCell(fn, inputs, pool=state.graph_pool)

        def decode(packed):
            return self._decode_paged_impl(packed, state.pools)

        def warm():
            if state.pools is None:
                state.pools = self._make_pools(state)
            for rows, w in decode_cells:
                # dummy batch: every row writes token 0 at offset 0 of the
                # scratch block or into the scratch slab (identical
                # duplicates)
                pack = np.zeros((rows, 4 + w), np.int32)
                pack[:, 2] = state.scratch_slab
                pack[:, 3] = state.scratch_seg
                pack[:, 4:] = state.scratch_block
                self._decode_paged_impl(self._tensor(pack), state.pools)
                graph(("decode", rows, w), decode, pack)
            table = np.full((state.nb_max,), state.scratch_block, np.int32)
            for rows, bucket in prefill_cells:
                toks = np.zeros((rows, bucket), np.int32)
                lens = np.ones((rows,), np.int32)
                _, cache = self._prefill_batch_impl(self._tensor(toks),
                                                    self._tensor(lens))
                self._insert_paged_impl(state.pools, cache, 0, table,
                                        state.scratch_slab, state.scratch_seg)
                del cache
                graph(("prefill", rows, bucket), self._prefill_batch_impl,
                      toks, lens)
            return len(state.graphs) - before

        return self._on_device(si, warm)

    # -- generation ---------------------------------------------------------
    def generate(self, name: str, prompt: np.ndarray, *, steps: int,
                 greedy: bool = True) -> GenerationResult:
        """Run one job of stream ``name``: prefill + ``steps`` greedy decode
        segments, each arbitrated by the stream's server.  The calling
        thread suspends between segments (never busy-waits)."""
        if self.batching:
            return self._generate_batched(name, prompt, steps=steps)
        spec = self._streams[name]
        prio = self.straggler.boost(name, spec.priority)
        si = self.pool.server_of(name)
        res = GenerationResult()
        prompt = np.asarray(prompt, np.int32)

        def prefill():
            logits, cache, _ = self._prefill(prompt)
            return logits[:, -1].cpu().numpy(), cache

        def decode(tokens, cache):
            logits, cache, _ = M.apply(
                self.cfg, self.params, {"tokens": self._tensor(tokens)},
                mode="decode", cache=cache)
            return logits[:, -1].cpu().numpy(), cache

        seq_id = self._kv_reserve(name, prompt, steps)
        try:
            t0 = time.monotonic()
            rows, cache = self.pool.submit(
                name, lambda: self._on_device(si, prefill), priority=prio,
                name=f"{name}/prefill").wait()
            res.prefill_latency_s = time.monotonic() - t0
            self.straggler.observe(name, res.prefill_latency_s * 1e3)
            last = np.argmax(rows, axis=-1).astype(np.int32)
            for i in range(steps):
                t1 = time.monotonic()
                rows, cache = self.pool.submit(
                    name, lambda t=last[:, None], c=cache:
                        self._on_device(si, lambda: decode(t, c)),
                    priority=prio, name=f"{name}/decode{i}").wait()
                dt = time.monotonic() - t1
                res.decode_latencies_s.append(dt)
                self.straggler.observe(name, dt * 1e3)
                last = np.argmax(rows, axis=-1).astype(np.int32)
                res.tokens.append(int(last[0]))
        finally:
            self._paged_release(None, seq_id)
        return res

    def _generate_batched(self, name: str, prompt: np.ndarray, *,
                          steps: int) -> GenerationResult:
        """Continuous-batching path: length-bucketed batched prefill through
        the pool, insert into the server's block pools, then submit each
        decode step as a batchable request that the server coalesces and
        compacts with other streams' steps."""
        if prompt.shape[0] != 1:
            raise ValueError("batched decode serves one sequence per stream "
                             f"job; got prompt batch {prompt.shape[0]}")
        if prompt.shape[1] + steps > self.max_seq:
            raise ValueError(f"prompt {prompt.shape[1]} + steps {steps} "
                             f"exceeds max_seq {self.max_seq}")
        res = GenerationResult()
        self._attempt_batched(name, self.pool.server_of(name),
                              np.asarray(prompt[0], np.int32), steps, res)
        return res

    def _attempt_batched(self, name: str, si: int, prompt: np.ndarray,
                         steps: int, res: GenerationResult) -> None:
        """Prefill ``prompt`` on server ``si``, then decode ``steps``
        tokens into ``res``.  Owns its reservation and slot, released on
        any exit."""
        spec = self._streams[name]
        prio = self.straggler.boost(name, spec.priority)
        true_len = int(prompt.shape[0])
        bucket = bucket_up(true_len, self.prefill_buckets)
        if self._warm_prefill:
            # precompile warmed a subset of pad lengths: steer to the
            # smallest warm bucket that fits (padding tokens' KV lands in
            # owned blocks; per-row true lengths mask it out of attention)
            warm = sorted({b for _r, b in self._warm_prefill
                           if b >= true_len})
            if warm:
                bucket = warm[0]
        server = self.pool.servers[si]
        seq_id, table, slab, seg = self._paged_reserve(si, name, true_len,
                                                       steps, bucket)
        try:
            slot = self._acquire_slot(si)
            try:
                t0 = time.monotonic()
                row_logits, cache, src_row = server.submit_batch(
                    (prompt, true_len),
                    run_batch=self._run_prefill_batch(si, bucket),
                    batch_key=("prefill", si, bucket), priority=prio,
                    name=f"{name}/prefill").wait()
                server.submit(
                    lambda: self._insert_slot_paged(si, cache, src_row, table,
                                                    slab, seg),
                    priority=prio, name=f"{name}/insert").wait()
                res.prefill_latency_s = time.monotonic() - t0
                self.straggler.observe(name, res.prefill_latency_s * 1e3)
                token = int(np.argmax(row_logits))
                length = true_len
                run_batch = self._run_paged_decode(si)
                for i in range(steps):
                    t1 = time.monotonic()
                    row = server.submit_batch(
                        (token, table, length, slab, seg),
                        run_batch=run_batch, batch_key=("decode", si),
                        priority=prio, name=f"{name}/decode{i}").wait()
                    dt = time.monotonic() - t1
                    res.decode_latencies_s.append(dt)
                    self.straggler.observe(name, dt * 1e3)
                    token = int(np.argmax(row))
                    length += 1
                    res.tokens.append(token)
            finally:
                self._release_slot(si, slot)
        finally:
            self._paged_release(si, seq_id)

    def _acquire_slot(self, si: int) -> int:
        state = self._slots[si]
        with state.cond:
            while not state.free:
                state.cond.wait()
            return state.free.pop()

    def _release_slot(self, si: int, slot: int) -> None:
        state = self._slots[si]
        with state.cond:
            state.free.append(slot)
            state.cond.notify()

    # -- unbatched KV accounting --------------------------------------------
    def _kv_reserve(self, name: str, prompt: np.ndarray, steps: int):
        if self.kv is None:
            return None
        with self._kv_lock:
            self._seq_counter += 1
            seq_id = f"{name}#{self._seq_counter}"
            # reserve prompt + all decode tokens up front (reject early
            # rather than stall mid-generation)
            self.kv.allocate(seq_id, prompt.shape[1])
            try:
                self.kv.extend(seq_id, steps)
            except Exception:
                self.kv.free_seq(seq_id)
                raise
            self._held.setdefault(name, set()).add((None, seq_id))
        return seq_id

    # -- occupancy and teardown ---------------------------------------------
    def kv_usage(self) -> dict:
        """Per-kind pooled-cache occupancy across every manager -- {"blocks",
        "slabs", "segments"} -- excluding each server's scratch resources.
        Every count must return to zero once all streams drain."""
        usage = {"blocks": self.kv.blocks_in_use if self.kv is not None
                 else 0, "slabs": 0, "segments": 0}
        for st in self._paged:
            scratch = st.mgr.seqs["__scratch__"]
            usage["blocks"] += st.mgr.blocks_in_use - len(scratch.blocks)
            usage["slabs"] += st.mgr.slabs_in_use - (scratch.slab is not None)
            usage["segments"] += (st.mgr.segments_in_use
                                  - (scratch.segment is not None))
        return usage

    def kv_blocks_in_use(self) -> int:
        """Total pooled-cache resources held, scratch excluded."""
        return sum(self.kv_usage().values())

    def close(self) -> None:
        self.pool.shutdown()

    # -- engine features of later slices ------------------------------------
    def static_cell_costs(self, cells=None) -> dict:
        _not_ported("static cell pricing", "A5")

    def enable_fault_tolerance(self, **kwargs) -> "ServeEngine":
        _not_ported("fault tolerance and stream recovery", "A10")

    def rebalance_once(self, **kwargs) -> int:
        _not_ported("work stealing", "A10")

    def enable_work_stealing(self, **kwargs) -> "ServeEngine":
        _not_ported("work stealing", "A10")

    def consolidate(self, si: int) -> dict:
        _not_ported("consolidation (live KV migration)", "A10")

    def add_server(self) -> int:
        _not_ported("elastic scale-up", "A10")

    def remove_server(self, si: int, **kwargs) -> None:
        _not_ported("elastic scale-down", "A10")
