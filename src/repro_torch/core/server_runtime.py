"""Executable accelerator-server runtime (the paper's §5.1, with real threads).

This is the mechanism the serving engine builds on: a dedicated server thread
owns the accelerator; clients submit requests and *suspend* (wait on an
event/future) instead of busy-waiting; the server dequeues requests in task-
priority order, executes them one at a time (the accelerator is
non-preemptive: one XLA execution at a time), and notifies the client on
completion.

The request's "GPU segment" is an arbitrary callable.  For JAX use, the
callable typically performs an async dispatch plus a blocking wait
(``jax.block_until_ready``) — the *server* thread blocks (suspends in OS
terms) while the device computes, exactly like the paper's server calling
``clFinish()``.  Client threads never touch the device.

Beyond-paper extensions (used by serving; each is off by default):
  * FIFO ordering mode (the paper's own future-work suggestion, which its
    Fig. 15 identifies as preferable when periods are similar).
  * deadline-aware ordering (EDF on absolute deadlines) for straggler
    mitigation in serving.
  * per-request timing stats, so epsilon can be *measured* (overheads
    benchmark mirrors the paper's §6.2), and spans on the host clock when
    tracing is switched on (``ServerStats.set_tracing``): each dispatch
    unit, each request from submit to end, and each client's wake from a
    request's end to its return from ``wait``.
  * fault tolerance: every device call runs through :meth:`_attempt`, which
    retries ``core.faults.TransientDeviceError`` with bounded exponential
    backoff and escalates to a server-wide failure on
    ``core.faults.DeviceLostError`` (or retry exhaustion).  A failed server
    wakes every suspended client with ``ServerFailedError`` — queued AND
    in-flight — so the serving engine can recover streams onto survivors.
    ``fail()`` is also callable from OUTSIDE the server thread: that is how
    the heartbeat monitor kills a server stuck in a stalled device call
    (the per-device-call timeout — the server beats between calls, so a
    call outlasting the heartbeat timeout is declared a stall).  An
    optional ``runtime.straggler.StepTimeWatchdog`` observes every call's
    duration for slow-step (degraded-health) flagging.
"""

from __future__ import annotations

import heapq
import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

from repro_torch.core.dispatch.policy import ORDERINGS, request_key
from repro_torch.core.faults import (DeviceLostError, ServerFailedError,
                               TransientDeviceError)

__all__ = ["AcceleratorServer", "CellStats", "Request", "ServerStats", "Span",
           "cell_key", "BATCH_META_CAP", "SPAN_CAP"]

# Ring-buffer capacity of the raw per-call shape-decision log.  Sustained
# traffic makes one entry per device call, so an unbounded list is a memory
# leak; the capped ring keeps the recent window for debugging while the
# running per-cell aggregates (``ServerStats.cell_stats``) carry the full
# history the cost model consumes.
BATCH_META_CAP = 4096

# Ring capacity of one server's span records while tracing is on.  A
# traced 2 s window of a 16-stream server holds about 3,000 of them.
SPAN_CAP = 65536


class Span(NamedTuple):
    """One traced interval on the host clock (``time.monotonic``).

    Names the dispatch layer records: "call" (one dispatch unit, from its
    dequeue to the last of its clients' events being set), "request"
    (submit to end, ``call_id`` the call that ended it) and "wake" (a
    request's end to its client's return from ``wait``; the same
    ``request_id`` as its request).  A callable that runs inside a call
    records its own steps with that call's ``call_id`` (the serving
    engine's "stage", "wait", "readback" and "insert")."""

    name: str
    t0: float
    t1: float
    call_id: int | None = None
    request_id: int | None = None


def cell_key(meta: dict) -> tuple | None:
    """Canonical cost-model cell of one ``batch_meta`` entry.

    Decode calls map to ``("decode", padded_rows, table_width)`` and
    bucketed prefills to ``("prefill", padded_rows, len_bucket)`` — i.e. the
    post-bucketing shape that names the jit trace the call ran under, which
    is exactly the granularity ``analysis.cost_model`` prices.  KV-block
    migration copies (one gather or scatter of a stream's live blocks) map
    to ``("migrate", padded_table_width, block_size)`` — ``padded`` is the
    pow2-bucketed number of blocks moved, the axis that sizes the copy.
    Entries without a recognizable shape decision return None (not
    aggregated).

    Non-GQA cache families tag their kinds ``"<base>@<family>"`` (e.g.
    ``"decode@mla"``): the base kind before the ``@`` decides which shape
    fields apply, and the TAGGED kind is kept as the cell's phase — each
    family's cells stay separate in the cost model (their step costs differ:
    latent rows, state slabs, segment gathers), while plain GQA keeps the
    untagged phase for back-compat."""
    kind = meta.get("kind")
    base = kind.split("@", 1)[0] if isinstance(kind, str) else kind
    if base == "decode" and "padded" in meta and "width" in meta:
        return (kind, int(meta["padded"]), int(meta["width"]))
    if base == "prefill" and "padded" in meta and "bucket" in meta:
        return (kind, int(meta["padded"]), int(meta["bucket"]))
    if base == "migrate" and "padded" in meta and "width" in meta:
        return (kind, int(meta["padded"]), int(meta["width"]))
    return None


@dataclass
class CellStats:
    """Running aggregate of one shape cell's device calls (Welford over the
    measured call durations, when the dispatcher reports them)."""

    calls: int = 0
    rows: int = 0  # sum of TRUE (pre-padding) rows across calls
    timed: int = 0  # calls that carried a ``seconds`` measurement
    mean_s: float = 0.0
    m2_s: float = 0.0
    min_s: float = math.inf
    max_s: float = 0.0

    def add(self, meta: dict) -> None:
        self.calls += 1
        self.rows += int(meta.get("rows", 0))
        s = meta.get("seconds")
        if s is not None:
            self.timed += 1
            d = s - self.mean_s
            self.mean_s += d / self.timed
            self.m2_s += d * (s - self.mean_s)
            self.min_s = min(self.min_s, s)
            self.max_s = max(self.max_s, s)

    def merge(self, other: "CellStats") -> None:
        """Fold ``other`` into self (parallel Welford merge) — used to pool
        per-server aggregates into one cost-model input."""
        self.calls += other.calls
        self.rows += other.rows
        if other.timed:
            n1, n2 = self.timed, other.timed
            d = other.mean_s - self.mean_s
            self.timed = n1 + n2
            self.mean_s += d * n2 / self.timed
            self.m2_s += other.m2_s + d * d * n1 * n2 / self.timed
            self.min_s = min(self.min_s, other.min_s)
            self.max_s = max(self.max_s, other.max_s)

    @property
    def var_s(self) -> float:
        return self.m2_s / self.timed if self.timed > 1 else 0.0


@dataclass(order=False)
class Request:
    """One accelerator request (a GPU access segment)."""

    fn: Callable[[], Any]
    priority: int = 0  # larger = higher priority
    deadline: float | None = None  # absolute (time.monotonic) deadline, for EDF
    name: str = ""
    # filled by the server:
    result: Any = None
    error: BaseException | None = None
    submit_t: float = 0.0
    start_t: float = 0.0
    end_t: float = 0.0
    request_id: int = 0  # the server's count of submits
    call_id: int | None = None  # the traced call that served it
    _done: threading.Event = field(default_factory=threading.Event, repr=False)
    # the ring ``wait`` records the client's wake in (traced calls only)
    _spans: deque | None = field(default=None, repr=False)

    def wait(self, timeout: float | None = None) -> Any:
        """Suspend the caller until the request completes (no busy-wait)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.name!r} not done within {timeout}s")
        spans = self._spans
        if spans is not None:
            self._spans = None
            spans.append(Span("wake", self.end_t, time.monotonic(),
                              self.call_id, self.request_id))
        if self.error is not None:
            raise self.error
        return self.result

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def waiting_time(self) -> float:
        """Definition 1: release -> begin execution."""
        return self.start_t - self.submit_t

    @property
    def handling_time(self) -> float:
        return self.end_t - self.submit_t


@dataclass
class ServerStats:
    completed: int = 0
    max_queue_len: int = 0
    wakeup_latencies: list[float] = field(default_factory=list)  # submit -> dequeue
    # batch dequeue (BatchingServer): device calls made (each call's
    # coalesced rows are its ``batch_meta`` entry's ``rows``)
    batches: int = 0
    # shape decisions the run_batch callable reports per device call
    # (BatchingServer.record_meta): e.g. paged decode {rows, padded, width,
    # compacted, seconds} or bucketed prefill {rows, padded, bucket,
    # seconds}.  Capped ring buffer — the recent window only; the per-cell
    # aggregates below carry the full history.
    batch_meta: deque = field(
        default_factory=lambda: deque(maxlen=BATCH_META_CAP))
    # running per-cell aggregate keyed by ``cell_key(meta)`` — the cost
    # model's measurement input (analysis.cost_model.StepCostModel.ingest)
    cell_stats: dict = field(default_factory=dict)
    # tracing, off by default: a ring of ``Span`` records (allocated when
    # tracing is switched on) and the id of the last traced dispatch unit
    tracing: bool = False
    spans: deque | None = None
    call_id: int = 0

    def set_tracing(self, on: bool) -> None:
        """Switch span recording on (into a fresh ring of ``SPAN_CAP``) or
        off (the ring stays readable)."""
        if on and not self.tracing:
            self.spans = deque(maxlen=SPAN_CAP)
        self.tracing = on

    def span(self, name: str, t0: float, t1: float, call_id=None,
             request_id=None) -> None:
        """Record one span (only while tracing: the ring exists)."""
        self.spans.append(Span(name, t0, t1, call_id, request_id))

    def record_meta(self, meta: dict) -> None:
        """Log one device call's shape decision: append to the bounded ring
        and fold into the matching cell aggregate."""
        self.batch_meta.append(meta)
        key = cell_key(meta)
        if key is not None:
            cell = self.cell_stats.get(key)
            if cell is None:
                cell = self.cell_stats[key] = CellStats()
            cell.add(meta)


class AcceleratorServer:
    """Dedicated server thread owning one accelerator (one mesh slice)."""

    def __init__(self, *, ordering: str = "priority", name: str = "gpu-server"):
        if ordering not in ORDERINGS:
            raise ValueError(ordering)
        self.ordering = ordering
        self.name = name
        self._lock = threading.Condition()
        self._queue: list[tuple[Any, int, Request]] = []
        self._seq = 0
        self._stop = False
        self.stats = ServerStats()
        # -- fault tolerance (all optional; defaults preserve old behavior) --
        self.fault_hook: Callable[[], None] | None = None  # injection point
        self.max_retries = 2  # transient-error retries before escalation
        self.retry_backoff_s = 0.005  # base of the exponential backoff
        self.on_failure: Callable[["AcceleratorServer"], None] | None = None
        self.beat: Callable[[], None] | None = None  # heartbeat tick
        self.beat_interval_s = 0.05
        self.watchdog = None  # runtime.straggler.StepTimeWatchdog, if any
        self.failed = False
        self.fail_cause: BaseException | None = None
        self._inflight: list[Request] | None = None
        self._thread = threading.Thread(target=self._serve, name=name, daemon=True)
        self._thread.start()

    # -- client API ------------------------------------------------------
    def _enqueue(self, req: Request) -> Request:
        """Stamp, queue, and wake the server (shared by all submit paths)."""
        req.submit_t = time.monotonic()
        with self._lock:
            if self.failed:
                raise ServerFailedError(
                    f"server {self.name!r} failed: {self.fail_cause}",
                    server=self.name)
            if self._stop:
                raise RuntimeError("server stopped")
            self._seq += 1
            req.request_id = self._seq
            heapq.heappush(self._queue, (self._key(req), self._seq, req))
            self.stats.max_queue_len = max(self.stats.max_queue_len, len(self._queue))
            self._lock.notify()
        return req

    def submit(
        self,
        fn: Callable[[], Any],
        *,
        priority: int = 0,
        deadline: float | None = None,
        name: str = "",
    ) -> Request:
        return self._enqueue(
            Request(fn=fn, priority=priority, deadline=deadline, name=name))

    def call(self, fn: Callable[[], Any], *, priority: int = 0, name: str = "") -> Any:
        """Submit and suspend until completion (the common client pattern)."""
        return self.submit(fn, priority=priority, name=name).wait()

    @property
    def qlen(self) -> int:
        """Requests currently queued (not in flight) — the depth signal the
        work-stealing rebalancer reads."""
        with self._lock:
            return len(self._queue)

    def shutdown(self, *, drain: bool = True, timeout: float = 30.0) -> None:
        with self._lock:
            if not drain:
                # Wake abandoned clients instead of leaving them suspended
                # forever on a queue that will never be served.
                for _, _, req in self._queue:
                    if not req.done:
                        req.error = ServerFailedError(
                            f"server {self.name!r} shut down before serving "
                            f"request {req.name!r}", server=self.name)
                        req.end_t = time.monotonic()
                        req._done.set()
                self._queue.clear()
            self._stop = True
            self._lock.notify_all()
        self._thread.join(timeout)

    def fail(self, cause: BaseException | None = None) -> None:
        """Declare this server dead (callable from ANY thread).

        Every queued AND in-flight request completes with
        :class:`ServerFailedError`, waking suspended clients so they can run
        stream recovery; later submissions are rejected with the same error.
        Idempotent — only the first call has effect.  ``on_failure`` fires
        once, outside the lock (it may call back into the pool).

        The heartbeat monitor calls this from its own thread when the server
        misses beats (a device call stalled past the timeout); the server
        thread calls it on :class:`DeviceLostError`.  If the stalled call
        ever returns, its result is discarded — the request already
        completed with the failure error (``req.done`` guard).
        """
        with self._lock:
            if self.failed:
                return
            self.failed = True
            self.fail_cause = cause
            victims = [req for _, _, req in self._queue]
            self._queue.clear()
            if self._inflight is not None:
                victims.extend(self._inflight)
            now = time.monotonic()
            for req in victims:
                if not req.done:
                    req.error = ServerFailedError(
                        f"server {self.name!r} failed: {cause}",
                        server=self.name)
                    req.end_t = now
                    req._done.set()
            self._stop = True
            self._lock.notify_all()
        cb = self.on_failure
        if cb is not None:
            cb(self)

    def __enter__(self) -> "AcceleratorServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- internals ---------------------------------------------------------
    def _key(self, req: Request):
        return request_key(self.ordering, priority=req.priority,
                           deadline=req.deadline)

    def _dequeue_locked(self) -> list[Request]:
        """Pop the next dispatch unit (called with the lock held).  The base
        server serves one request per device call; BatchingServer overrides
        this to coalesce same-shape requests."""
        _, _, req = heapq.heappop(self._queue)
        return [req]

    def _attempt(self, fn: Callable[[], Any]) -> Any:
        """Run one device call with fault injection, bounded transient
        retry, and watchdog observation (server thread only).

        :class:`TransientDeviceError` is retried up to ``max_retries`` times
        with exponential backoff; exhaustion escalates to
        :class:`DeviceLostError` (the caller declares the server dead).
        """
        attempts = 0
        while True:
            try:
                t0 = time.monotonic()
                if self.fault_hook is not None:
                    self.fault_hook()
                result = fn()
                if self.watchdog is not None:
                    self.watchdog.observe(time.monotonic() - t0)
                return result
            except TransientDeviceError as e:
                attempts += 1
                if attempts > self.max_retries:
                    raise DeviceLostError(
                        f"transient retries exhausted after {self.max_retries}"
                        f" retries: {e}") from e
                time.sleep(self.retry_backoff_s * (2 ** (attempts - 1)))

    def _complete(self, req: Request, result: Any,
                  error: BaseException | None) -> None:
        """Finish one request, unless a concurrent ``fail()`` beat us to it
        (then the client already woke with ServerFailedError and this — e.g.
        a stalled call's eventual return — is discarded)."""
        with self._lock:
            if req.done:
                return
            req.result = result
            req.error = error
            t0 = time.monotonic()
            req.end_t = t0
            req._done.set()  # wake the client (it was suspended, not polling)
        self.stats.completed += 1

    def _trace_start(self, batch: list[Request]) -> None:
        """Give a traced dispatch unit the next call id, and its requests
        the ring their clients record their wake in."""
        stats = self.stats
        stats.call_id += 1
        for r in batch:
            r.call_id = stats.call_id
            r._spans = stats.spans

    def _trace_end(self, batch: list[Request], start: float) -> None:
        """Record a traced dispatch unit's "call" span (from ``start``, its
        dequeue, to now: every client's event is set) and its requests'
        "request" spans."""
        stats = self.stats
        end = time.monotonic()
        cid = batch[0].call_id
        stats.span("call", start, end, cid)
        for r in batch:
            stats.span("request", r.submit_t, r.end_t, cid, r.request_id)

    def _execute(self, batch: list[Request]) -> None:
        """Run one dispatch unit on the accelerator (server thread only)."""
        req = batch[0]
        req.start_t = time.monotonic()
        self.stats.wakeup_latencies.append(req.start_t - req.submit_t)
        traced = self.stats.tracing
        if traced:
            self._trace_start(batch)
        try:
            result = self._attempt(req.fn)  # non-preemptive accelerator run
            error: BaseException | None = None
        except DeviceLostError as e:
            self.fail(e)
            return
        except BaseException as e:  # noqa: BLE001 - surfaced to the client
            result, error = None, e
        self._complete(req, result, error)
        if traced:
            self._trace_end(batch, req.start_t)

    def _serve(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._stop:
                    if self.beat is not None:
                        self.beat()
                        self._lock.wait(self.beat_interval_s)
                    else:
                        self._lock.wait()  # server suspends when idle
                if not self._queue and self._stop:
                    return
                batch = self._dequeue_locked()
                self._inflight = batch
            if self.beat is not None:
                self.beat()  # last beat before a (possibly stalling) call
            self._execute(batch)
            with self._lock:
                self._inflight = None
                if self.failed:
                    return
