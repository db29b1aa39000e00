"""Batched accelerator dispatch: one device call for many requests.

The paper's Lemma 1 charges every GPU request 2*eps of server CPU
(receive/wake-up + completion/notify).  When several admitted streams sit
in the same phase — decode, where every step has the same shape — their
requests can ride one device call: the server pays the dispatch overhead
once per *batch*, and the accelerator runs one kernel over the stacked
inputs instead of k sequential kernels.  That is what closes the gap
between bounded-access predictability and throughput (GCAPS/RTGPU make the
same observation for fine-grain GPU sharing).

Mechanics: a batchable request carries a ``batch_key`` (shape class) and a
``payload`` instead of a closure.  When the server dequeues a batchable
head, it drains every queued request with the same key — up to
``max_batch`` — and hands all payloads to the head's ``run_batch``
callable, which performs ONE accelerator call and returns one result per
payload, in order.  Requests with different keys (or plain ``submit``
requests) are never coalesced, and dequeue order still follows the
server's ordering policy, so a batch can only *join* the head request,
never delay it: the head starts exactly when it would have unbatched.

All callers of one ``batch_key`` must supply the same ``run_batch``
semantics (the head's callable serves the whole batch).

Shape decisions stay visible: a ``run_batch`` that compacts rows, pads to a
power-of-two bucket, or narrows the KV gather to the live block-table width
reports what it chose via :meth:`BatchingServer.record_meta`; the entries
land in ``stats.batch_meta`` (each with the call's true ``rows``) so the
analysis side (and tests) can audit that compaction/bucketing only ever
SHRANK the device call — the declared per-request WCET is the full-width
call, which is what keeps the per-server bounds (Eqs (1)-(6)) sound under
both knobs.

The measurement -> fit -> admission loop rides the same channel.  Each meta
entry carries the call's timed duration (``seconds``) next to its shape
decision; ``ServerStats.record_meta`` folds it into a bounded ring buffer
plus a running per-cell aggregate keyed by ``server_runtime.cell_key`` —
``("decode", padded_rows, table_width)`` or ``("prefill", padded_rows,
len_bucket)``, the post-bucketing shape naming the jit trace that ran.
``analysis.cost_model.StepCostModel.ingest`` consumes those aggregates to
fit per-cell step-cost surfaces, which in turn drive calibrated admission
(``core.admission`` with ``cost_model=``), bucket auto-tuning
(``cost_model.autotune_buckets`` -> ``ServeEngine.tune_buckets``), and
traffic-aware precompilation (``ServeEngine.precompile(traffic=...)``).
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass
from typing import Any, Callable, Hashable

from repro_torch.core.faults import DeviceLostError
from repro_torch.core.server_runtime import AcceleratorServer, Request

__all__ = ["BatchRequest", "BatchingServer"]


@dataclass(order=False)
class BatchRequest(Request):
    """A request eligible for same-key coalescing."""

    batch_key: Hashable = None
    payload: Any = None
    run_batch: Callable[[list[Any]], list[Any]] | None = None


class BatchingServer(AcceleratorServer):
    """AcceleratorServer whose dequeue coalesces same-``batch_key`` requests
    into one device call (continuous batching for same-shape work)."""

    def __init__(self, *, ordering: str = "priority", max_batch: int = 8,
                 name: str = "batch-server"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        super().__init__(ordering=ordering, name=name)

    # -- client API ------------------------------------------------------
    def submit_batch(
        self,
        payload: Any,
        *,
        run_batch: Callable[[list[Any]], list[Any]],
        batch_key: Hashable,
        priority: int = 0,
        deadline: float | None = None,
        name: str = "",
    ) -> BatchRequest:
        """Submit a batchable request; returns a waitable Request whose
        result is ``run_batch(payloads)[i]`` for this request's position in
        whatever batch it lands in."""
        if batch_key is None:
            raise ValueError("batch_key must be hashable and non-None")
        return self._enqueue(
            BatchRequest(fn=None, priority=priority, deadline=deadline,
                         name=name, batch_key=batch_key, payload=payload,
                         run_batch=run_batch))

    def record_meta(self, **decision) -> None:
        """Called by ``run_batch`` callables (on this server's thread) to
        surface per-call shape decisions — compaction, padding bucket, KV
        gather width, measured ``seconds`` — into the bounded
        ``stats.batch_meta`` ring and the running ``stats.cell_stats``
        per-cell aggregates the cost model consumes."""
        self.stats.record_meta(decision)

    # -- internals ---------------------------------------------------------
    def _dequeue_locked(self) -> list[Request]:
        _, _, head = heapq.heappop(self._queue)
        if not isinstance(head, BatchRequest):
            return [head]
        batch = [head]
        deferred = []
        while self._queue and len(batch) < self.max_batch:
            item = heapq.heappop(self._queue)
            req = item[2]
            if isinstance(req, BatchRequest) and req.batch_key == head.batch_key:
                batch.append(req)
            else:
                deferred.append(item)
        for item in deferred:
            heapq.heappush(self._queue, item)
        return batch

    def _execute(self, batch: list[Request]) -> None:
        head = batch[0]
        if not isinstance(head, BatchRequest):
            super()._execute(batch)
            return
        start = time.monotonic()
        for r in batch:
            r.start_t = start
            self.stats.wakeup_latencies.append(start - r.submit_t)
        traced = self.stats.tracing
        if traced:
            self._trace_start(batch)
        results: list[Any] = []
        error: BaseException | None = None
        payloads = [r.payload for r in batch]
        try:
            results = self._attempt(lambda: head.run_batch(payloads))
            if len(results) != len(batch):
                raise RuntimeError(
                    f"run_batch returned {len(results)} results for a batch "
                    f"of {len(batch)}")
        except DeviceLostError as e:
            self.fail(e)  # fails the whole batch (it is in-flight)
            return
        except BaseException as e:  # noqa: BLE001 - surfaced to every client
            error = e
        with self._lock:
            t0 = time.monotonic()
            for i, r in enumerate(batch):
                if r.done:
                    continue  # a concurrent fail() already woke this client
                if error is not None:
                    r.error = error
                else:
                    r.result = results[i]
                r.end_t = t0
                r._done.set()
        self.stats.completed += len(batch)
        self.stats.batches += 1
        if traced:
            self._trace_end(batch, start)
