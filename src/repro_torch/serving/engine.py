"""Serving engine of the port: the paper's GPU server as the dispatch layer
of a PyTorch inference runtime -- a multi-server pool with continuous,
paged, length-aware decode batching, stream recovery from a dead server,
live cache migration between servers and an elastic pool.

Counterpart of ``repro/serving/engine.py`` (see its docstring for the
architecture).  Both batched layouts are ported, family-generic:

  * paged (``batching=True, paged=True``): GQA KV block pools, MLA latent
    block pools (plus the MoE prefix layer's pools on the same block
    tables), SSM state-slab pools, the hybrid stack's two kinds per row
    (the shared attention block's KV block pools and the Mamba-2 state-slab
    pools, staged in one decode call), and the enc-dec stack's decoder KV
    block pools beside its cross-attention segments (refcounted, read-only,
    shared by the streams of one encoder output);
  * masked-dense (``batching=True, paged=False``): one dense slot cache of
    ``max_batch`` rows per server, every step over all of its rows with the
    inactive ones masked and carried through untouched -- the reference's
    yardstick for paged decode;

and the unbatched ``generate`` path that serves as their reference:

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
    pools, or its slot cache, are allocated once and every insert, decode
    step and migration import writes into them (the captured graphs read
    those tensors, so they are never rebound);
  * the reference's ``where(active, new, old)`` over the whole slot cache
    becomes a save and restore of what a masked-dense step writes of an
    inactive row: the position it writes of each sequence leaf and the
    whole row of each state leaf (SSM conv window and state);
  * ``jax.jit`` per cell becomes a CUDA graph per cell and server:
    ``precompile`` runs every (rows, width) decode cell, (rows, bucket)
    prefill cell and migration width on each server, eagerly twice on the
    server's stream, then captures it (``serving/graphs.py``; one graph
    memory pool per server); a call of a warm cell copies its staged rows
    into the graph's static inputs and replays it.  A cell first hit
    mid-traffic is bumped up to the cheapest warm cell that covers it
    (widening is sound: extra width lanes read the scratch block past each
    row's length, extra rows duplicate row 0 and write identical values);
    with no warm cover it runs eagerly and is never captured mid-traffic.
    ``add_server`` captures every warm cell on the new server's own thread
    while the others serve.  On the CPU nothing is captured and every cell
    runs eagerly.  Slab-only families have no gather width: their one
    width bucket is 0;
  * a migration keeps the reference's host hop (its servers are separate
    devices): a gather on the source server into one packed buffer, one
    device-to-host copy, one host-to-device copy into the destination's
    staging, and a scatter into the destination's pools;
  * the enc-dec frontend is a stub, as in the reference: every prefill
    encodes zero frames, so all of a server's streams share one
    cross-attention segment (the copy-on-write dedup case).

``static_cell_costs`` prices cells without running them on the card: each
cell's impl runs once on meta twins of the weights and pools under
``analysis.op_cost``, the counterpart of the reference's compile-and-walk
of each cell's HLO.
"""

from __future__ import annotations

import dataclasses
import logging
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
from repro_torch.core.faults import ServerFailedError, StreamShedError
from repro_torch.core.task_model import GpuSegment, Task
from repro_torch.models import model as M
from repro_torch.runtime.straggler import DeadlineAwarePolicy, StepTimeWatchdog
from repro_torch.serving.graphs import GraphCell
from repro_torch.serving.kvcache import (FAMILIES, OutOfBlocksError,
                                         PagedKVCacheManager)


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


def _map_tree(fn, tree):
    """``fn`` applied to every leaf of a (dicts, lists, tuples) tree."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _clone(tree):
    """Copy of every tensor of a (dicts, lists, tuples) tree."""
    return _map_tree(torch.Tensor.clone, tree)


def _meta_twin(tree):
    """The tree with every tensor replaced by an empty one of its shape and
    dtype on the meta device (no memory, no values)."""
    return _map_tree(lambda t: (torch.empty_like(t, device="meta")
                                if isinstance(t, torch.Tensor) else t), tree)


def _tensors(tree) -> list:
    """The tensors of a (dicts, lists, tuples) tree in a fixed order: dict
    keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def _cache_leaves(cache) -> list:
    """A dense decode cache's tensors other than ``pos``, in a fixed
    order."""
    return _tensors({k: v for k, v in cache.items() if k != "pos"})


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
    migrate_cells: tuple = ()
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
    recoveries: int = 0  # server deaths this job survived
    # monotonic timestamp per recovery at which the retained prefix was
    # re-established on a survivor (resume point, for latency measurement)
    resumed_at_monotonic: list[float] = field(default_factory=list)


@dataclass
class _RecoveryLog:
    """Per-stream-job recovery state: the retained token prefix.

    The first attempt's prefill argmax (``first_token``) is fed to decode
    step 0 but never appended to the result; every decode argmax is
    appended to both the result and ``generated``.  The retained prefix --
    prompt ++ [first_token] ++ generated -- is therefore exactly the token
    sequence whose cache the dead server held, so re-prefilling it on a
    survivor puts the cache in the state the failed decode step saw, and
    its last-position argmax is the token that step would have produced."""

    prompt: np.ndarray
    first_token: int | None = None
    generated: list[int] = field(default_factory=list)

    def retained_prefix(self) -> np.ndarray:
        if self.first_token is None:
            return self.prompt
        return np.concatenate([
            self.prompt,
            np.asarray([self.first_token], np.int32),
            np.asarray(self.generated, np.int32),
        ])


class _SlotState:
    """Per-server decode slots: at most ``max_batch`` streams hold one at a
    time, so a server's reserved cache never outgrows its pool.  In the
    masked-dense layout a slot is a row of ``cache`` (allocated once, on
    the server's thread) and the server's graphs live here; the staging
    array of the masked step -- rows of [token, active] -- is preallocated
    so the decode loop does not allocate."""

    def __init__(self, max_batch: int):
        self.free = list(range(max_batch))
        self.cond = threading.Condition()
        self.cache = None
        self.pack_scratch = np.zeros((max_batch, 2), np.int32)
        self.graphs: dict[tuple, GraphCell] = {}
        self.graph_pool = None


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
        # ("decode", rows, width) / ("prefill", rows, bucket) / ("export",
        # width) / ("import", width) -> GraphCell, captured by precompile
        # on the card, all in one memory pool
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
        self._migrate_kind = "migrate" + tag
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
        # optional paged-KV accounting for the unpaged paths: a job holds
        # block allocations for its sequence's lifetime; exhaustion rejects
        # the request before any device work is dispatched
        self.kv = (PagedKVCacheManager(num_blocks=kv_blocks,
                                       block_size=kv_block_size)
                   if kv_blocks and not paged else None)
        self._kv_lock = threading.Lock()
        self._seq_counter = 0
        # fault-tolerance state (see enable_fault_tolerance): recovery is
        # serialized -- concurrent failure observers queue on the lock and
        # find the server already handled
        self._recovery_lock = threading.Lock()
        self._shed: set[str] = set()
        self._held: dict[str, set] = {}  # stream -> {(si | None, seq_id)}
        self.degraded_reports: list = []
        # migration state: _mig_lock serializes every _held mutation the
        # migration protocol and remove() can race on (see
        # _execute_migration); _active_jobs is the per-server active-stream
        # depth signal the work-stealing rebalancer reads
        self._mig_lock = threading.Lock()
        self._active_jobs: dict[str, int] = {}
        self._ft_params: dict | None = None  # set by enable_fault_tolerance
        self._steal_stop: threading.Event | None = None
        self._steal_min_gain_ms = 0.0
        self.migrations_completed = 0
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
        self._warm_migrate: set[int] = set()
        self._slots: list[_SlotState] = []
        self._paged: list[_PagedState] = []
        if batching:
            self._slots = [_SlotState(max_batch) for _ in range(num_servers)]
        if batching and not paged:
            self._batch_axes = _cache_batch_axes(cfg, max_seq)
        if paged:
            uses_blocks = "block" in self._cache_kinds
            # default block pool: every slot can hold a max_seq sequence,
            # plus the scratch block (slab-only families carry no blocks)
            num_blocks = ((kv_blocks or max_batch * (max_seq // kv_block_size)
                           + 1) if uses_blocks else 0)
            # slabs: one per slot, doubled so an in-flight migration can
            # hold its source and destination at once, plus scratch;
            # segments: shared across slots (refcounted), so max_batch
            # distinct keys plus scratch cover the worst case
            self._num_blocks = num_blocks
            self._num_slabs = (2 * max_batch + 2
                               if "slab" in self._cache_kinds else 0)
            self._num_segments = (max_batch + 2
                                  if "segment" in self._cache_kinds else 0)
            self._paged = [self._paged_state() for _ in range(num_servers)]
            # slab-only families have no gather width: the single 0 bucket
            # keeps every bucket_up() call well-defined
            self.width_buckets = (_pow2_ladder(self._paged[0].nb_max)
                                  if uses_blocks else (0,))

    def _paged_state(self) -> _PagedState:
        return _PagedState(self._num_blocks, self.kv_block_size,
                           self.max_batch, self.max_seq, family=self._family,
                           num_slabs=self._num_slabs,
                           num_segments=self._num_segments)

    @property
    def server(self):
        """The first pool server (single-server alias)."""
        return self.pool.servers[0]

    def _cells(self, si: int):
        """Server ``si``'s state that holds its graphs."""
        return self._paged[si] if self.paged else self._slots[si]

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

    def _sync(self) -> None:
        """Drain the current stream (inside ``_on_device``; no-op on the
        CPU)."""
        if self._cuda_streams is not None:
            torch.cuda.current_stream(self.device).synchronize()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _prefill(self, tokens, lengths=None, params=None):
        """Prefill ``tokens`` (B, S) (true ``lengths`` (B,) int32 of a
        padded batch), numpy arrays or device tensors, on the current
        device context; the cache comes back padded to max_seq.  An enc-dec
        stack encodes zero frames (B, encoder_seq, d_model) in the config's
        dtype: the audio frontend is a stub.  ``params`` (default: the
        engine's) lets pricing run on meta twins of the weights."""
        if isinstance(tokens, np.ndarray):
            tokens = self._tensor(tokens)
        if isinstance(lengths, np.ndarray):
            lengths = self._tensor(lengths)
        batch = {"tokens": tokens, "max_seq": self.max_seq}
        if self.cfg.family == "encdec":
            batch["frames"] = torch.zeros(
                (tokens.shape[0], self.cfg.encoder_seq, self.cfg.d_model),
                dtype=getattr(torch, self.cfg.dtype), device=tokens.device)
        if lengths is not None:
            batch["lengths"] = lengths
        return M.apply(self.cfg, self.params if params is None else params,
                       batch, mode="prefill")

    def _prefill_batch_impl(self, tokens: torch.Tensor,
                            lengths: torch.Tensor, params=None):
        """One bucketed prefill call: tokens (R, bucket), lengths (R,)
        int32 -> (each row's last-token logits (R, V) fp32, the cache)."""
        logits, cache, _ = self._prefill(tokens, lengths, params)
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
        """Withdraw a stream: admission slot, router binding, and any cache
        resources still held for it (a stream evicted by failure or shed by
        degraded admission may leave reservations behind if its generating
        thread is gone; ``missing_ok`` makes the free race-safe against that
        thread's own cleanup).  Never call while the stream has a device
        call in flight.

        The sweep runs under ``_mig_lock``, so it is atomic with respect to
        an in-flight migration of this stream: during the copy the ledger
        holds both (src, seq) and (dst, seq); freeing both here is right
        (the stream is gone), and the migrating thread's commit re-checks
        the ledger under the same lock and aborts instead of freeing twice
        (see _execute_migration)."""
        self.admission.remove(name)
        self.pool.remove(name)
        self._streams.pop(name, None)
        self._shed.discard(name)
        self._active_jobs.pop(name, None)
        with self._mig_lock:
            held = self._held.pop(name, set())
            for si, seq_id in held:
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

    # -- batched decode internals (masked-dense layout) ---------------------
    def _insert_impl(self, full, batched, src_row: int, slot: int) -> None:
        """Copy row ``src_row`` of a (possibly coalesced) prefill cache into
        row ``slot`` of the slot cache, in place."""
        for f, o, (bax, _, _) in zip(_cache_leaves(full),
                                     _cache_leaves(batched),
                                     self._batch_axes, strict=True):
            f.select(bax, slot).copy_(o.select(bax, src_row))
        full["pos"][slot] = batched["pos"][src_row]

    def _decode_masked_impl(self, packed: torch.Tensor, cache):
        """One masked-dense decode step over all ``max_batch`` rows of the
        slot cache: ``packed`` (B, 2) int32 rows are [token, active].  Rows
        whose ``active`` is 0 keep every cache leaf bit for bit (their
        logits are garbage, discarded by the caller).  The dense decode
        writes in place -- every row's new K/V at its ``pos``, every row's
        SSM state -- so the step first saves what it would take from an
        inactive row (the position it writes of each sequence leaf, the
        whole row of each state leaf) and puts it back after.  An inactive
        row decodes at position 0 (a finished row's ``pos`` may equal
        max_seq) and its ``pos`` does not advance.  Returns the (B, 1, V)
        fp32 logits."""
        active = packed[:, 1] != 0
        pos = cache["pos"]
        pos_in = torch.where(active, pos, torch.zeros_like(pos))
        at = pos_in.long()
        rows = torch.arange(pos.shape[0], device=pos.device)
        leaves = _cache_leaves(cache)
        saved = []
        for leaf, (bax, role, sax) in zip(leaves, self._batch_axes):
            if role == "seq":
                saved.append(leaf.movedim((bax, sax), (0, 1))[rows, at])
            else:
                saved.append(leaf.clone() if role == "state" else None)
        logits, new, _ = M.apply(self.cfg, self.params,
                                 {"tokens": packed[:, :1]}, mode="decode",
                                 cache={**cache, "pos": pos_in})
        for leaf, out, keep, (bax, role, sax) in zip(
                leaves, _cache_leaves(new), saved, self._batch_axes):
            if out is not leaf:
                leaf.copy_(out)
            if role == "seq":
                view = leaf.movedim((bax, sax), (0, 1))
                mask = active.view(-1, *[1] * (keep.dim() - 1))
                view[rows, at] = torch.where(mask, view[rows, at], keep)
            elif role == "state":
                shape = [1] * leaf.dim()
                shape[bax] = -1
                leaf.copy_(torch.where(active.view(shape), leaf, keep))
        pos.copy_(torch.where(active, new["pos"], pos))
        return logits

    def _acquire_slot(self, si: int) -> int:
        state = self._slots[si]
        with state.cond:
            while not state.free:
                state.cond.wait()
            return state.free.pop()

    def _try_acquire_slot(self, si: int) -> int | None:
        """Non-blocking slot acquisition -- the migration path must never
        deadlock holding its source slot while waiting on a destination
        slot, so no free slot means the steal is cancelled instead."""
        state = self._slots[si]
        with state.cond:
            if not state.free:
                return None
            return state.free.pop()

    def _release_slot(self, si: int, slot: int) -> None:
        state = self._slots[si]
        with state.cond:
            state.free.append(slot)
            state.cond.notify()

    def _slot_cache(self, state: _SlotState):
        if state.cache is None:
            state.cache = M.init_cache(self.cfg, self.max_batch, self.max_seq,
                                       device=self.device)
        return state.cache

    def _insert_slot(self, si: int, slot: int, cache, src_row: int) -> None:
        """Runs on server ``si``'s thread (serialized with its batches)."""
        state = self._slots[si]
        self._on_device(si, lambda: self._insert_impl(
            self._slot_cache(state), cache, src_row, slot))

    def _run_decode_batch(self, si: int):
        """run_batch callable for server ``si`` (masked-dense): payloads are
        (slot, token) pairs; ONE masked device call over all ``max_batch``
        rows serves them all.  The staging array is the slot state's
        preallocated scratch."""

        def run(payloads):
            state = self._slots[si]
            pack = state.pack_scratch
            pack[:] = 0
            for slot, token in payloads:
                pack[slot] = (token, 1)
            cell = (self.max_batch, 0)
            cold = bool(self._warm_decode) and cell not in self._warm_decode
            graph = state.graphs.get(("decode", *cell))

            def step():
                if graph is not None:
                    logits = graph.replay(pack)
                else:
                    logits = self._decode_masked_impl(
                        self._tensor(pack), self._slot_cache(state))
                return logits[:, -1].cpu().numpy()

            t0 = time.monotonic()
            rows = self._on_device(si, step)
            dt = time.monotonic() - t0
            self._ran_cold(self._warm_decode, cold, cell)
            self.pool.servers[si].record_meta(
                kind=self._decode_kind, rows=len(payloads),
                padded=self.max_batch, width=0, compacted=False, seconds=dt,
                cold=cold, graphed=graph is not None)
            return [rows[slot] for slot, _ in payloads]

        return run

    # -- batched decode internals (paged pools, family-generic) -------------
    def _make_pools(self, state, device=None):
        return M.init_paged_cache(self.cfg, state.mgr.num_blocks,
                                  state.mgr.block_size,
                                  num_slabs=state.mgr.num_slabs,
                                  num_segments=state.mgr.num_segments,
                                  device=device or self.device)

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

    def _decode_paged_impl(self, packed: torch.Tensor, pools, params=None):
        """One compacted paged decode step.  ``packed`` (n, 4+W) int32 rows
        are [token, length, slab, segment, block_table...] -- one header
        for every family; the columns a family does not use carry scratch
        ids and are never read.  The table width W addresses only the
        blocks the live rows need.  Rows write their new KV or state into
        their own blocks or slabs in place.  Returns the (n, 1, V) fp32
        logits.  ``params`` (default: the engine's) lets pricing run on
        meta twins of the weights."""
        cache = dict(pools)
        cache["pos"] = packed[:, 1]
        if "block" in self._cache_kinds:
            cache["block_tables"] = packed[:, 4:].contiguous()
        if "slab" in self._cache_kinds:
            cache["slab_ids"] = packed[:, 2].contiguous()
        if "segment" in self._cache_kinds:
            cache["segment_ids"] = packed[:, 3].contiguous()
        logits, _, _ = M.apply(self.cfg,
                               self.params if params is None else params,
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
        with self._mig_lock:
            self._held.setdefault(name, set()).add((si, seq_id))
        return seq_id, table, slab, seg

    def _paged_release(self, si: int, seq_id: str) -> None:
        with self._mig_lock:
            held = self._held.get(seq_id.rsplit("#", 1)[0])
            if held is not None:
                held.discard((si, seq_id))
            state = self._paged[si]
            with state.lock:
                state.mgr.free_seq(seq_id, missing_ok=True)

    # -- live cache migration (steal / consolidate / elastic drain) --------
    def _export_kv_impl(self, pools, idx: torch.Tensor) -> list:
        """Gather one stream's live cache out of every pool: ``idx`` (2+W,)
        int32 is [slab, segment, block_table...].  Block kinds gather the
        W blocks of the table (pad lanes point at the source scratch block,
        never-read content, so the width can be bucketed onto a warm cell),
        slab and segment kinds their one row.  Returns the gathered
        tensors, one per pool leaf, in ``_pool_kinds`` order."""
        slab, seg, table = idx[0:1].long(), idx[1:2].long(), idx[2:].long()
        out = []
        for key, kind in self._pool_kinds.items():
            for pool in pools[key]:
                if kind == "block":
                    out.append(pool[:, table])
                else:
                    out.append(pool.index_select(
                        1, slab if kind == "slab" else seg))
        return out

    def _import_kv_impl(self, pools, rows, idx: torch.Tensor) -> None:
        """Scatter an export into the destination pools in place (the
        destination's graphs read these tensors): block rows at the table
        of ``idx`` (the fresh blocks ``import_seq`` allocated; pad lanes
        target the destination scratch block -- duplicate scratch writes
        are benign, nothing reads it), the slab row into the fresh
        destination slab, the segment row into the destination segment
        (idempotent when the key was already resident there)."""
        slab, seg, table = idx[0:1].long(), idx[1:2].long(), idx[2:].long()
        leaves = iter(rows)
        for key, kind in self._pool_kinds.items():
            for pool in pools[key]:
                r = next(leaves).to(pool.dtype)
                if kind == "block":
                    pool[:, table] = r
                else:
                    pool.index_copy_(1, slab if kind == "slab" else seg, r)

    def _migrate_cell(self, n_blocks: int) -> tuple[int, bool]:
        """(padded gather width, cold?) for a migration of ``n_blocks`` --
        the same warm-cell bump-up as the decode hot path."""
        w = bucket_up(n_blocks, self.width_buckets)
        cold = False
        if self._warm_migrate and w not in self._warm_migrate:
            covers = [c for c in self._warm_migrate if c >= w]
            if covers:
                w = min(covers)
            else:
                cold = True
        return w, cold

    def _export_call(self, si: int, idx: np.ndarray, w: int):
        """On server ``si``'s thread: the gather (a replay of the export
        cell of width ``w`` when warm) and the one device-to-host copy of
        its output.  Returns (host tensors, seconds of the copy, graphed)."""
        state = self._paged[si]
        graph = state.graphs.get(("export", w))

        def gather():
            rows = (graph.replay(idx) if graph is not None else
                    self._export_kv_impl(state.pools, self._tensor(idx)))
            self._sync()
            t0 = time.monotonic()
            host = [t.cpu() for t in rows]
            return host, time.monotonic() - t0

        host, hop = self._on_device(si, gather)
        return host, hop, graph is not None

    def _import_call(self, si: int, idx: np.ndarray, w: int, host) -> tuple:
        """On server ``si``'s thread: one host-to-device copy of the export
        (into the import cell's static inputs when warm) and the scatter.
        Returns (seconds of the copy, graphed)."""
        state = self._paged[si]
        graph = state.graphs.get(("import", w))

        def scatter():
            if state.pools is None:
                state.pools = self._make_pools(state)
            t0 = time.monotonic()
            if graph is not None:
                graph.load(idx, *host)
            else:
                rows = [t.to(self.device) for t in host]
                dev_idx = self._tensor(idx)
            self._sync()
            hop = time.monotonic() - t0
            if graph is not None:
                graph.replay()
            else:
                self._import_kv_impl(state.pools, rows, dev_idx)
            return hop

        return self._on_device(si, scatter), graph is not None

    def _execute_migration(self, name: str, seq_id: str, src_si: int,
                           dst_si: int, prio: int):
        """Move ``seq_id``'s live cache (blocks, state slab, shared
        segment -- whatever kinds its family uses) from server ``src_si``
        to ``dst_si``; returns (new full-width block table, destination
        slab id, destination segment id).

        Two-phase commit against ``remove()``: under ``_mig_lock`` the
        destination allocation is made and both sides enter the ``_held``
        ledger; the copy runs outside the lock (a gather on the source
        server, the host hop, a scatter on the destination server -- each
        serialized with that server's own batches); the commit re-takes
        the lock, checks that the ledger still holds the entries (a
        concurrent ``remove`` frees both sides itself -- then this raises
        instead of freeing twice), and frees the source.  Any failure rolls
        the destination back, leaving the stream where it was.  The gather
        reads the source rows before the commit frees them."""
        src, dst = self._paged[src_si], self._paged[dst_si]
        with self._mig_lock:
            held = self._held.get(name)
            if held is None or (src_si, seq_id) not in held:
                raise StreamShedError(
                    f"stream {name!r} gone before migration")
            with src.lock:
                exp = src.mgr.export_seq(seq_id)
                src_alloc = src.mgr.seqs[seq_id]
                src_slab = (src_alloc.slab if src_alloc.slab is not None
                            else src.scratch_slab)
                src_seg = (src_alloc.segment
                           if src_alloc.segment is not None
                           else src.scratch_seg)
            with dst.lock:
                # OutOfBlocks -> clean: all-or-nothing across every kind
                new_blocks = dst.mgr.import_seq(exp)
                dst_alloc = dst.mgr.seqs[seq_id]
                dst_slab = (dst_alloc.slab if dst_alloc.slab is not None
                            else dst.scratch_slab)
                dst_seg = (dst_alloc.segment
                           if dst_alloc.segment is not None
                           else dst.scratch_seg)
            held.add((dst_si, seq_id))
        try:
            n = len(exp.blocks)
            w, cold = self._migrate_cell(n)
            src_idx = np.full((2 + w,), src.scratch_block, np.int32)
            src_idx[:2] = (src_slab, src_seg)
            src_idx[2:2 + n] = exp.blocks
            dst_idx = np.full((2 + w,), dst.scratch_block, np.int32)
            dst_idx[:2] = (dst_slab, dst_seg)
            dst_idx[2:2 + n] = new_blocks
            meta = dict(kind=self._migrate_kind, rows=n, padded=w,
                        width=self.kv_block_size, cold=cold)

            def gather():
                t0 = time.monotonic()
                host, hop, graphed = self._export_call(src_si, src_idx, w)
                self.pool.servers[src_si].record_meta(
                    **meta, side="export", seconds=time.monotonic() - t0,
                    hop_seconds=hop, graphed=graphed,
                    nbytes=sum(t.numel() * t.element_size() for t in host))
                return host

            host = self.pool.servers[src_si].submit(
                gather, priority=prio, name=f"{name}/migrate-export").wait()

            def scatter():
                t0 = time.monotonic()
                hop, graphed = self._import_call(dst_si, dst_idx, w, host)
                self.pool.servers[dst_si].record_meta(
                    **meta, side="import", seconds=time.monotonic() - t0,
                    hop_seconds=hop, graphed=graphed,
                    nbytes=sum(t.numel() * t.element_size() for t in host))

            self.pool.servers[dst_si].submit(
                scatter, priority=prio, name=f"{name}/migrate-import").wait()
        except BaseException:
            with self._mig_lock:
                held = self._held.get(name)
                if held is not None:
                    held.discard((dst_si, seq_id))
                with dst.lock:
                    dst.mgr.free_seq(seq_id, missing_ok=True)
            raise
        with self._mig_lock:
            held = self._held.get(name)
            if held is None or (dst_si, seq_id) not in held:
                # remove() raced the copy: it freed both sides already
                raise StreamShedError(
                    f"stream {name!r} removed mid-migration")
            held.discard((src_si, seq_id))
            with src.lock:
                src.mgr.free_seq(seq_id, missing_ok=True)
        self.migrations_completed += 1
        full = np.full((dst.nb_max,), dst.scratch_block, np.int32)
        full[:n] = new_blocks
        return full, dst_slab, dst_seg

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

            graph = self._cells(si).graphs.get(("prefill", n_pad, bucket))

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

    def _ran_cold(self, warm: set, cold: bool, cell) -> None:
        """After a cold cell ran eagerly: on the CPU later hits count as
        warm; on the card a warm cell is a captured one, and a cell is
        never captured mid-traffic, so it stays cold."""
        if cold and not self._graphs:
            warm.add(cell)

    def precompile(self, prompt_buckets: tuple[int, ...] = (), *,
                   traffic=None) -> PrecompileReport:
        """Warm batched-decode/prefill shape cells and migration widths
        before taking load.

        Every reachable decode cell ((rows, width) when paged; the one
        (max_batch, 0) masked-dense cell otherwise), each (rows, bucket)
        prefill cell of ``prompt_buckets`` (snapped up into
        ``prefill_buckets``) and, when paged, the migration gather and
        scatter of each width bucket run on every server, so their
        allocations, library heuristics and the server's stream are warm,
        and on the card each is then captured as a CUDA graph that the hot
        path replays (a capture that fails raises).  ``traffic`` -- a
        ``cost_model.TrafficModel`` or an iterable of CellKeys -- restricts
        the set to the predicted-hit cells PLUS, always, the largest cell on
        each phase: the target the hot path bumps cold cells up to.  Cells
        already warm from an earlier call are skipped.  The dummy inserts
        scribble on scratch state (a free slot's row when masked-dense), so
        never call this while streams are live.  No-op unless batching."""
        if not self.batching:
            return PrecompileReport()
        hot = None
        if traffic is not None:
            hot = (set(traffic.hot_cells())
                   if hasattr(traffic, "hot_cells") else set(traffic))
        rows_ladder = self._row_buckets
        if self.paged:
            reachable_d = [(r, w) for r in rows_ladder
                           for w in self.width_buckets]
            fb_d = (rows_ladder[-1], self.width_buckets[-1])
        else:
            # masked-dense always runs the one full-shape cell
            reachable_d = [(self.max_batch, 0)]
            fb_d = reachable_d[0]
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
        # migration gather/scatter cells: one per width bucket, so a
        # mid-traffic steal replays instead of running eagerly
        reachable_m = list(self.width_buckets) if self.paged else []
        fb_m = reachable_m[-1] if reachable_m else None
        plan_m = [w for w in reachable_m
                  if hot is None or w == fb_m
                  or (self._migrate_kind, w, self.kv_block_size) in hot]
        todo_m = [w for w in plan_m if w not in self._warm_migrate]
        captured = 0
        for si in self.pool.alive_servers():
            captured += self.pool.servers[si].submit(
                lambda si=si: self._precompile_server(si, todo_d, todo_p,
                                                      todo_m),
                name=f"precompile-{si}").wait()
        self._warm_decode.update(todo_d)
        self._warm_prefill.update(todo_p)
        self._warm_migrate.update(todo_m)
        skipped = ((len(reachable_d) - len(todo_d))
                   + (len(reachable_p) - len(todo_p))
                   + (len(reachable_m) - len(todo_m)))
        return PrecompileReport(compiled=len(todo_d) + len(todo_p)
                                + len(todo_m),
                                skipped=skipped, decode_cells=tuple(todo_d),
                                prefill_cells=tuple(todo_p),
                                migrate_cells=tuple(todo_m),
                                captured=captured)

    def _precompile_server(self, si: int, decode_cells, prefill_cells,
                           migrate_cells=()) -> int:
        """Warm the cells on server ``si`` and, on the card, capture each
        one not captured yet; returns the number of graphs captured."""
        state = self._cells(si)
        before = len(state.graphs)

        def graph(key, fn, *arrays):
            """Run ``fn`` once more, eagerly, on the server's stream, then
            capture it on that stream into the server's graph pool."""
            if not self._graphs or key in state.graphs:
                return
            inputs = [a.clone() if isinstance(a, torch.Tensor)
                      else self._tensor(a) for a in arrays]
            fn(*inputs)
            if state.graph_pool is None:
                state.graph_pool = torch.cuda.graph_pool_handle()
            state.graphs[key] = GraphCell(fn, inputs, pool=state.graph_pool)

        def warm_paged():
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
                graph(("decode", rows, w),
                      lambda p: self._decode_paged_impl(p, state.pools), pack)
            for w in migrate_cells:
                # round-trip the scratch resources through gather and
                # scatter: identical content lands back where it came from
                idx = np.full((2 + w,), state.scratch_block, np.int32)
                idx[:2] = (state.scratch_slab, state.scratch_seg)
                rows = self._export_kv_impl(state.pools, self._tensor(idx))
                self._import_kv_impl(state.pools, rows, self._tensor(idx))
                graph(("export", w),
                      lambda i: self._export_kv_impl(state.pools, i), idx)
                graph(("import", w),
                      lambda i, *r: self._import_kv_impl(state.pools, r, i),
                      idx, *rows)
                del rows
            table = np.full((state.nb_max,), state.scratch_block, np.int32)
            return lambda cache: self._insert_paged_impl(
                state.pools, cache, 0, table, state.scratch_slab,
                state.scratch_seg)

        def warm_dense():
            cache = self._slot_cache(state)
            for _cell in decode_cells:
                pack = np.zeros((self.max_batch, 2), np.int32)  # all masked
                self._decode_masked_impl(self._tensor(pack), cache)
                graph(("decode", self.max_batch, 0),
                      lambda p: self._decode_masked_impl(p, cache), pack)
            # precompile runs with no stream live: slot 0 is free scratch
            return lambda prefill: self._insert_impl(cache, prefill, 0, 0)

        def warm():
            insert = warm_paged() if self.paged else warm_dense()
            for rows, bucket in prefill_cells:
                toks = np.zeros((rows, bucket), np.int32)
                lens = np.ones((rows,), np.int32)
                _, cache = self._prefill_batch_impl(self._tensor(toks),
                                                    self._tensor(lens))
                insert(cache)
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
            self._kv_release(seq_id)
        return res

    def _generate_batched(self, name: str, prompt: np.ndarray, *,
                          steps: int) -> GenerationResult:
        """Continuous-batching path: length-bucketed batched prefill through
        the pool, insert into a slot row (masked-dense) or the server's
        pools (paged), then submit each decode step as a batchable request
        that the server coalesces -- and, when paged, compacts -- with
        other streams' steps.

        Stream recovery: when the stream's server dies mid-job
        (``ServerFailedError`` from any segment), the per-job _RecoveryLog
        holds the retained token prefix; after degraded-mode re-admission
        routes the stream to a survivor, the attempt re-prefills that
        prefix through the same bucketed prefill path and decoding resumes
        at the failed step.  A stream shed by degraded admission raises
        StreamShedError."""
        if prompt.shape[0] != 1:
            raise ValueError("batched decode serves one sequence per stream "
                             f"job; got prompt batch {prompt.shape[0]}")
        if prompt.shape[1] + steps > self.max_seq:
            raise ValueError(f"prompt {prompt.shape[1]} + steps {steps} "
                             f"exceeds max_seq {self.max_seq}")
        res = GenerationResult()
        log = _RecoveryLog(prompt=np.asarray(prompt[0], np.int32))
        while True:
            si = self._await_server(name)
            try:
                self._attempt_batched(name, si, log, steps, res)
                return res
            except ServerFailedError:
                # the server declared itself dead (device loss, exhausted
                # transient retries) or the heartbeat monitor evicted it;
                # either way run recovery -- idempotent if already handled
                # -- then loop: re-admission has either moved us or shed us
                self._on_server_death(si)
                res.recoveries += 1

    def _await_server(self, name: str, timeout_s: float = 5.0) -> int:
        """The stream's current server index, waiting out an in-flight
        recovery (the evict happens before the re-assign, so a client can
        observe the gap); raises StreamShedError once the stream is shed or
        recovery never re-placed it."""
        deadline = time.monotonic() + timeout_s
        while True:
            if name in self._shed:
                raise StreamShedError(
                    f"stream {name!r} shed by degraded-mode admission")
            try:
                return self.pool.server_of(name)
            except KeyError:
                if time.monotonic() >= deadline:
                    raise StreamShedError(
                        f"stream {name!r} lost its server and was not "
                        "re-placed") from None
                time.sleep(0.001)

    def _attempt_batched(self, name: str, si: int, log: _RecoveryLog,
                         steps: int, res: GenerationResult) -> None:
        """One attempt on server ``si``: prefill the retained prefix, then
        decode until ``res`` holds ``steps`` tokens.  Owns its reservation
        and slot, released on any exit, so a failed attempt leaks nothing.

        Token accounting keeps recovery exact: on the first attempt the
        prefill argmax is the input of decode step 0 (recorded, not
        appended); on a recovery attempt the prefix already contains that
        token, so the re-prefill's last-position argmax is the failed
        step's output and is appended directly.  The reservation shrinks in
        step: prefix_len + remaining_feeds == prompt_len + steps always."""
        spec = self._streams[name]
        prio = self.straggler.boost(name, spec.priority)
        prefix = log.retained_prefix()
        true_len = int(prefix.shape[0])
        append_first = log.first_token is not None
        feeds = steps - len(res.tokens) - (1 if append_first else 0)
        bucket = bucket_up(true_len, self.prefill_buckets)
        if self._warm_prefill:
            # precompile warmed a subset of pad lengths: steer to the
            # smallest warm bucket that fits (padding tokens' KV lands in
            # owned blocks; per-row true lengths mask it out of attention)
            warm = sorted({b for _r, b in self._warm_prefill
                           if b >= true_len})
            if warm:
                bucket = warm[0]
        # every submit is pinned to server object ``si`` -- not routed by
        # stream name -- so if a concurrent recovery re-binds this stream
        # mid-attempt, the next segment hits the dead server and raises
        # ServerFailedError instead of running against the new server's
        # pools with this attempt's (old-server) block table
        server = self.pool.servers[si]
        table = None
        slab = seg = 0
        if self.paged:
            seq_id, table, slab, seg = self._paged_reserve(
                si, name, true_len, feeds, bucket)
        else:
            seq_id = self._kv_reserve(name, prefix[None, :], feeds)
        try:
            slot = self._acquire_slot(si)
            self._active_jobs[name] = si
            try:
                t0 = time.monotonic()
                row_logits, cache, src_row = server.submit_batch(
                    (prefix, true_len),
                    run_batch=self._run_prefill_batch(si, bucket),
                    batch_key=("prefill", si, bucket), priority=prio,
                    name=f"{name}/prefill").wait()
                if self.paged:
                    insert = (lambda: self._insert_slot_paged(
                        si, cache, src_row, table, slab, seg))
                else:
                    insert = (lambda: self._insert_slot(si, slot, cache,
                                                        src_row))
                server.submit(insert, priority=prio,
                              name=f"{name}/insert").wait()
                cache = None  # the server holds the inserted row now
                res.prefill_latency_s = time.monotonic() - t0
                self.straggler.observe(name, res.prefill_latency_s * 1e3)

                token = int(np.argmax(row_logits))
                if append_first:  # recovery attempt: resume point reached
                    res.resumed_at_monotonic.append(time.monotonic())
                    res.tokens.append(token)
                    log.generated.append(token)
                else:
                    log.first_token = token
                length = true_len
                run_batch = (self._run_paged_decode(si) if self.paged
                             else self._run_decode_batch(si))
                i = 0
                while len(res.tokens) < steps:
                    if name in self._shed:
                        raise StreamShedError(
                            f"stream {name!r} shed by degraded-mode "
                            "admission")
                    if self.paged:
                        # planned migration (steal / consolidate / drain):
                        # the stream's own thread moves its cache at this
                        # step boundary -- no decode of this stream can be
                        # in flight, so the copy sees a quiescent sequence
                        dst = self.pool.pending_migration(name)
                        if (dst is not None and dst != si
                                and dst in self.pool.alive_servers()):
                            dst_slot = self._try_acquire_slot(dst)
                            if dst_slot is None:
                                # destination full right now: abandon the
                                # steal rather than block holding our slot
                                self.pool.cancel_migration(name)
                            else:
                                try:
                                    table, slab, seg = (
                                        self._execute_migration(
                                            name, seq_id, si, dst, prio))
                                except OutOfBlocksError:
                                    self._release_slot(dst, dst_slot)
                                    self.pool.cancel_migration(name)
                                except BaseException:
                                    self._release_slot(dst, dst_slot)
                                    raise
                                else:
                                    self._release_slot(si, slot)
                                    slot, si = dst_slot, dst
                                    server = self.pool.servers[si]
                                    run_batch = self._run_paged_decode(si)
                                    self._active_jobs[name] = si
                                    self.pool.complete_migration(name)
                    payload = ((token, table, length, slab, seg)
                               if self.paged else (slot, token))
                    t1 = time.monotonic()
                    row = server.submit_batch(
                        payload, run_batch=run_batch,
                        batch_key=("decode", si), priority=prio,
                        name=f"{name}/decode{i}").wait()
                    dt = time.monotonic() - t1
                    res.decode_latencies_s.append(dt)
                    self.straggler.observe(name, dt * 1e3)
                    token = int(np.argmax(row))
                    length += 1
                    res.tokens.append(token)
                    log.generated.append(token)
                    i += 1
            finally:
                self._active_jobs.pop(name, None)
                self._release_slot(si, slot)
        finally:
            if self.paged:
                self._paged_release(si, seq_id)
            else:
                self._kv_release(seq_id)

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
        with self._mig_lock:
            self._held.setdefault(name, set()).add((None, seq_id))
        return seq_id

    def _kv_release(self, seq_id) -> None:
        if seq_id is None:
            return
        with self._mig_lock:
            held = self._held.get(seq_id.rsplit("#", 1)[0])
            if held is not None:
                held.discard((None, seq_id))
        with self._kv_lock:
            self.kv.free_seq(seq_id, missing_ok=True)

    # -- fault tolerance ----------------------------------------------------
    def enable_fault_tolerance(self, *, heartbeat_timeout_s: float = 0.5,
                               poll_s: float = 0.02, max_retries: int = 2,
                               retry_backoff_s: float = 0.005,
                               watchdog: bool = False) -> "ServeEngine":
        """Switch on failure detection + stream recovery.

        Wires the pool's HeartbeatMonitor (servers beat between device
        calls, so a call outlasting ``heartbeat_timeout_s`` is a stall --
        the monitor thread evicts the server from outside, making the
        timeout per-device-call), sets each server's transient-error retry
        budget, optionally attaches a StepTimeWatchdog, and installs
        ``_on_server_death`` as the pool's death handler so eviction flows
        into degraded-mode re-admission instead of blind re-routing.  Warm
        every cell first: an eager call longer than the timeout is taken
        for a stall.  Returns self for chaining."""
        self._ft_params = {"max_retries": max_retries,
                           "retry_backoff_s": retry_backoff_s,
                           "watchdog": watchdog}
        for s in self.pool.servers:
            s.max_retries = max_retries
            s.retry_backoff_s = retry_backoff_s
            if watchdog and s.watchdog is None:
                s.watchdog = StepTimeWatchdog()
        self.pool.enable_failure_detection(
            timeout=heartbeat_timeout_s, poll=poll_s,
            on_death=self._on_server_death)
        return self

    def _on_server_death(self, si: int, displaced=None) -> None:
        """Single recovery entry point, reached from the heartbeat monitor
        (stall), a server's own failure callback (device loss), or a client
        thread that caught ServerFailedError.  Serialized and idempotent:
        whichever caller evicts the server runs degraded-mode re-admission;
        everyone else returns once it is done.

        Surviving displaced streams are re-bound to the device degraded
        admission proved them on (with their priced recovery segment);
        unfitting streams are shed in reverse-priority order and their
        generator threads observe ``_shed`` at the next segment boundary.
        The dead server's pools and graphs are never used again."""
        with self._recovery_lock:
            if displaced is None:
                displaced = self.pool.evict_server(si, reroute=False)
            if displaced is None:
                return  # another caller already recovered this server
            # migration race window: a stream whose admission slot already
            # moved to its steal destination (admission.migrate committed,
            # pool binding not yet flipped) was displaced here but will NOT
            # be re-placed by evict_device -- re-bind it to its live
            # admission placement instead of dropping it
            for s in list(displaced):
                d = self.admission.placement.get(s)
                if d is not None and d != si and self.admission.alive[d]:
                    task = next(t for t in self.admission.devices[d].streams
                                if t.name == s)
                    self.pool.reassign(s, d, utilization=task.G / task.T,
                                       priority=task.priority)
                    displaced.pop(s)
            report = self.admission.evict_device(
                si, recovery_cost_ms=self._recovery_cost_ms)
            for s, d in report.moved.items():
                task = next(t for t in self.admission.devices[d].streams
                            if t.name == s)
                self.pool.reassign(s, d, utilization=task.G / task.T,
                                   priority=task.priority)
            for s in report.shed:
                self._shed.add(s)
            self.degraded_reports.append(report)

    def _recovery_cost_ms(self, task: Task) -> float:
        """Price a stream's recovery segment -- the re-prefill of its
        retained prefix on the surviving device.  Declared worst case is
        the stream's own prefill cost; a fitted cost model caps it at the
        predicted cost of the largest prefill bucket (never upward,
        mirroring calibrated admission's min())."""
        spec = self._streams.get(task.name)
        declared = (spec.prefill_ms if spec is not None
                    else task.segments[0].total)
        if self.cost_model is not None:
            pred = self.cost_model.predict(self._prefill_kind, 1,
                                           self.prefill_buckets[-1])
            if math.isfinite(pred):
                pred_ms = pred * getattr(self.cost_model, "safety", 1.0) * 1e3
                declared = min(declared, pred_ms) if declared > 0 else pred_ms
        return float(declared)

    # -- work stealing / consolidation / elastic scale ---------------------
    def _migration_cost_ms(self, name: str) -> float:
        """Price a steal of ``name``: gather + scatter of a full-width
        block table (worst case -- the mover pays for every lane whether
        live or scratch-padded) at the cost model's measured "migrate"
        cell, with the calibration safety margin.  0 when uncalibrated or
        unmeasured -- the depth-gap rule decides instead."""
        if not self.paged or self.cost_model is None:
            return 0.0
        w = bucket_up(self._paged[0].nb_max, self.width_buckets)
        pred = self.cost_model.predict(self._migrate_kind, w,
                                       self.kv_block_size)
        if not math.isfinite(pred):
            return 0.0
        return 2.0 * pred * getattr(self.cost_model, "safety", 1.0) * 1e3

    def _steal_profitable(self, name: str, depth_src: int, depth_dst: int,
                          mc_ms: float, min_gain_ms: float) -> bool:
        """Steal only when predicted queueing relief beats the move's cost:
        the victim's remaining decode steps each save the difference
        between a depth_src-row and a (depth_dst+1)-row batched decode
        step.  Without a cost model (or an unmeasured decode phase), fall
        back to the depth-gap >= 2 rule -- stealing across a 1-deep gap just
        thrashes."""
        if self.cost_model is None:
            return depth_src - depth_dst >= 2
        spec = self._streams.get(name)
        if spec is None:
            return False
        w = self.width_buckets[-1] if self.width_buckets else 0
        c_src = self.cost_model.predict(
            self._decode_kind, bucket_up(depth_src, self._row_buckets), w)
        c_dst = self.cost_model.predict(
            self._decode_kind, bucket_up(depth_dst + 1, self._row_buckets),
            w)
        if not (math.isfinite(c_src) and math.isfinite(c_dst)):
            return depth_src - depth_dst >= 2
        gain_ms = spec.decode_steps * max(0.0, c_src - c_dst) * 1e3
        return gain_ms - mc_ms >= min_gain_ms

    def rebalance_once(self, *, min_gain_ms: float | None = None) -> int:
        """One work-stealing pass: move queued-behind streams from the
        deepest server onto the shallowest until the depth gap closes or
        no move is profitable.  Returns the number of steals REQUESTED --
        each victim's own thread performs the copy at its next decode-step
        boundary (see _attempt_batched), so depth accounting here counts
        pending migrations at their destination to avoid over-stealing
        while copies are in flight.

        Runs on the heartbeat tick (or the fallback timer thread) and
        yields to recovery: if ``_recovery_lock`` is held the pass is
        skipped -- rebalancing mid-eviction would race degraded-mode
        re-admission."""
        if min_gain_ms is None:
            min_gain_ms = self._steal_min_gain_ms
        if not self._recovery_lock.acquire(blocking=False):
            return 0
        try:
            stolen = 0
            draining = self.pool.draining()
            live = [i for i in self.pool.alive_servers()
                    if i not in draining]
            if len(live) < 2:
                return 0
            while True:
                depths = {i: 0 for i in live}
                for nm, si in list(self._active_jobs.items()):
                    if si not in depths:
                        continue
                    pd = self.pool.pending_migration(nm)
                    depths[pd if pd in depths else si] += 1
                src = max(depths, key=lambda i: (depths[i], i))
                dst = min(depths, key=lambda i: (depths[i], -i))
                if depths[src] - depths[dst] < 2:
                    return stolen
                victims = sorted(
                    (nm for nm, si in list(self._active_jobs.items())
                     if si == src and nm in self._streams
                     and nm not in self._shed
                     and self.pool.pending_migration(nm) is None),
                    key=lambda nm: self._streams[nm].priority)
                moved_one = False
                for victim in victims:
                    mc = self._migration_cost_ms(victim)
                    if not self._steal_profitable(victim, depths[src],
                                                  depths[dst], mc,
                                                  min_gain_ms):
                        continue
                    decision, d = self.admission.migrate(
                        victim, dst, migration_cost_ms=mc)
                    if d < 0:
                        continue
                    if not self.pool.request_migration(victim, dst):
                        # stream vanished / destination became illegal
                        # between the admission move and the intent: put
                        # the admission slot back (best-effort -- if the
                        # stream is gone this is a no-op too)
                        self.admission.migrate(victim, src)
                        continue
                    stolen += 1
                    moved_one = True
                    break
                if not moved_one:
                    return stolen
        finally:
            self._recovery_lock.release()

    def enable_work_stealing(self, *, interval_s: float = 0.05,
                             min_gain_ms: float = 0.0) -> "ServeEngine":
        """Switch on periodic rebalancing.  Piggybacks on the heartbeat
        monitor's tick when fault tolerance is enabled (one thread, one
        cadence, same teardown guarantees); otherwise runs a dedicated
        daemon timer at ``interval_s``.  ``min_gain_ms`` is the minimum
        predicted net win (queueing relief minus migration cost) before a
        steal fires.  Returns self for chaining."""
        self._steal_min_gain_ms = float(min_gain_ms)

        def tick() -> None:
            try:
                self.rebalance_once()
            except Exception:  # best-effort: keep the timer/monitor alive
                logging.getLogger(__name__).exception(
                    "work-stealing pass failed")

        if self.pool._monitor is not None:
            self.pool._monitor.on_tick = tick
            return self
        stop = threading.Event()
        self._steal_stop = stop

        def loop() -> None:
            while not stop.wait(interval_s):
                tick()

        threading.Thread(target=loop, daemon=True,
                         name="steal-rebalance").start()
        return self

    def consolidate(self, si: int) -> dict[str, int]:
        """Drain server ``si`` by moving every stream it owns elsewhere:
        streams with a job in flight get a migration intent (their own
        thread moves the cache at the next step boundary); idle streams are
        re-bound directly (nothing to copy -- their next job prefills on
        the new server).  Each move is re-proven by admission first; a
        stream no destination can prove STAYS PUT and keeps running on the
        draining server (consolidation is an optimization, never a shed).
        Returns {stream: destination}.  ``remove_server`` completes the
        retirement once the server is empty."""
        self.pool.begin_drain(si)
        draining = self.pool.draining()
        dests = sorted((d for d in self.pool.alive_servers()
                        if d != si and d not in draining),
                       key=self.admission.gpu_utilization)
        moved: dict[str, int] = {}
        for name in self.pool.streams_on(si):
            active = self._active_jobs.get(name) == si
            mc = self._migration_cost_ms(name) if active else 0.0
            got = -1
            for d in dests:
                _, got = self.admission.migrate(name, d,
                                                migration_cost_ms=mc)
                if got >= 0:
                    break
            if got < 0:
                continue
            if active:
                self.pool.request_migration(name, got)
            else:
                task = next(t for t in self.admission.devices[got].streams
                            if t.name == name)
                self.pool.reassign(name, got, utilization=task.G / task.T,
                                   priority=task.priority)
            moved[name] = got
            dests.sort(key=self.admission.gpu_utilization)
        return moved

    def add_server(self) -> int:
        """Elastic scale-up: grow the pool AND the admission partition by
        one device mid-traffic; returns the new server index.  The server
        inherits the pool's fault-tolerance settings (retry budget,
        watchdog, heartbeat wiring -- the pool handles the monitor), gets
        its own CUDA stream, slot and paged state, and warms its pools on
        its own thread.  Graphs belong to one server, so every warm cell
        (decode, prefill, migration) is run and captured there while the
        other servers serve.  Until that is done the server is no steal
        destination (``rebalance_once`` yields to ``_recovery_lock``) and
        admission does not know the device, so its first request replays
        as the others' do; a recovery meanwhile waits for the capture."""
        with self._recovery_lock:
            si = self.pool.add_server()
            if self._cuda_streams is not None:
                self._cuda_streams.append(torch.cuda.Stream(self.device))
            if self.batching:
                self._slots.append(_SlotState(self.max_batch))
            if self.paged:
                self._paged.append(self._paged_state())
            s = self.pool.servers[si]
            if self._ft_params is not None:
                s.max_retries = self._ft_params["max_retries"]
                s.retry_backoff_s = self._ft_params["retry_backoff_s"]
                if self._ft_params["watchdog"] and s.watchdog is None:
                    s.watchdog = StepTimeWatchdog()
            if self.batching:
                cells = (sorted(self._warm_decode),
                         sorted(self._warm_prefill),
                         sorted(self._warm_migrate))
                s.submit(lambda: self._precompile_server(si, *cells),
                         name=f"precompile-{si}").wait()
            di = self.admission.add_device()
            if si != di:
                raise RuntimeError(
                    f"pool/admission index drift: server {si} vs device "
                    f"{di}")
        return si

    def remove_server(self, si: int, *, timeout_s: float = 10.0) -> None:
        """Elastic scale-down: drain server ``si``, migrate its streams to
        proven destinations (live cache migration for in-flight streams, a
        plain re-bind for idle ones), shed what the shrunk pool cannot
        prove, wait for the server to empty, and retire it.  Unlike
        ``consolidate`` this is a committed shrink -- admission re-proves
        the whole placement via ``drain_device`` (the machinery of failure
        eviction, priced as a cache copy instead of a re-prefill) and
        appends the resulting DegradedReport.  The retired server's pools,
        slot cache and graphs are released.  Raises TimeoutError if
        in-flight work does not clear in ``timeout_s``."""
        with self._recovery_lock:
            self.pool.begin_drain(si)
            report = self.admission.drain_device(
                si, migration_cost_ms=lambda t: self._migration_cost_ms(
                    t.name))
            for s, d in report.moved.items():
                if self._active_jobs.get(s) == si:
                    self.pool.request_migration(s, d)
                else:
                    task = next(t for t in self.admission.devices[d].streams
                                if t.name == s)
                    self.pool.reassign(s, d, utilization=task.G / task.T,
                                       priority=task.priority)
            for s in report.shed:
                self._shed.add(s)
                self.pool.remove(s)
            self.degraded_reports.append(report)
        deadline = time.monotonic() + timeout_s
        while (any(d == si for d in self._active_jobs.values())
               or self.pool.streams_on(si)):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"server {si} did not drain within {timeout_s}s")
            time.sleep(0.005)
        self.pool.retire_server(si)
        # the server's thread has joined: nothing reads its device state
        if self.batching:
            slots = self._slots[si]
            slots.cache, slots.graphs, slots.graph_pool = None, {}, None
        if self.paged:
            state = self._paged[si]
            state.pools, state.graphs, state.graph_pool = None, {}, None

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
        if self._steal_stop is not None:
            self._steal_stop.set()
        self.pool.shutdown()

    # -- static cell pricing (op_cost -> cost-model features) ---------------
    def static_cell_costs(self, cells=None) -> dict:
        """Price shape cells STATICALLY: run each cell's impl once on meta
        twins of the weights and of the pools ``_make_pools`` makes, and
        count its aten ops with ``analysis.op_cost`` for per-cell (flops,
        hbm_bytes).  Returns {CellKey: (flops, hbm_bytes)} ready for
        ``cost_model.hlo_cell_features`` -- the feed that lets a
        ``StepCostModel`` price a migration width (or any cell) it never
        measured off static analysis instead of the declared worst case.

        ``cells`` is an iterable of CellKeys (``("decode", rows, width)``,
        ``("prefill", rows, bucket)``, ``("migrate", width, block_size)``;
        family-tagged phases price alike); default: every migrate width
        bucket -- the cells a steal can hit cold.  A migrate cell is its
        export plus its import.  Pricing runs on the caller's thread,
        launches no kernel, captures no graph and touches neither the live
        pools nor the warm sets.  Paged engines only (the masked-dense
        decode has a single full-shape cell that measurement always
        covers)."""
        from repro_torch.analysis import op_cost

        if not self.paged:
            raise ValueError("static_cell_costs requires paged=True")
        if cells is None:
            cells = [(self._migrate_kind, w, self.kv_block_size)
                     for w in self.width_buckets]
        meta = torch.device("meta")
        params = _meta_twin(self.params)
        pools = self._make_pools(self._paged[0], device=meta)

        def ints(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=meta)

        out: dict[tuple, tuple[float, float]] = {}
        for cell in cells:
            phase, a, b = cell
            base = phase.split("@", 1)[0]  # family-tagged phases price alike
            if base == "migrate":
                idx = ints(2 + a)
                fg, bg = op_cost.cost_of(self._export_kv_impl, pools, idx)
                rows = self._export_kv_impl(pools, idx)
                fs, bs = op_cost.cost_of(self._import_kv_impl, pools, rows,
                                         idx)
                out[cell] = (fg + fs, bg + bs)
            elif base == "decode":
                out[cell] = op_cost.cost_of(self._decode_paged_impl,
                                            ints(a, 4 + b), pools, params)
            elif base == "prefill":
                out[cell] = op_cost.cost_of(self._prefill_batch_impl,
                                            ints(a, b), ints(a), params)
            else:
                raise ValueError(f"unknown phase in cell {cell!r}")
        return out


def _cache_batch_axes(cfg, max_seq: int) -> list[tuple]:
    """Per leaf of the dense decode cache (``_cache_leaves`` order): (batch
    axis, what one decode step writes of a row, the sequence axis or None).
    Found by diffing ``init_cache`` shapes on the meta device -- 1 and 2
    rows give the batch axis, ``max_seq`` and ``2 * max_seq`` the sequence
    axis, two encoder lengths the leaves that follow the encoder's output:

      "seq"   one position per row, at the row's ``pos`` (attention K/V);
      "read"  nothing: the cross-attention K/V, which decode only reads;
      "state" the whole row (the SSM conv window and recurrent state)."""

    def leaves(rows, seq, **change):
        c = dataclasses.replace(cfg, **change) if change else cfg
        return _cache_leaves(M.init_cache(c, rows, seq, device="meta"))

    def diff(a, b):
        return next((i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                     if x != y), None)

    out = []
    for one, two, longer, enc in zip(
            leaves(1, max_seq), leaves(2, max_seq), leaves(1, 2 * max_seq),
            leaves(1, max_seq, encoder_seq=cfg.encoder_seq + 1)):
        bax = diff(one, two)
        if bax is None:
            raise ValueError(f"no batch axis in cache leaf {tuple(one.shape)}")
        sax = diff(one, longer)
        role = ("seq" if sax is not None
                else "read" if diff(one, enc) is not None else "state")
        out.append((bax, role, sax))
    return out
