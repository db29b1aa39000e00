"""Discrete-event simulator for partitioned fixed-priority multicore + one
or more non-preemptive accelerators, in the access-control modes the paper
evaluates (plus the batched extension):

  * ``server`` — the paper's GPU-server approach (§5.1): clients submit a
    request and suspend; the server (highest priority on its core) dequeues
    by task priority, pays eps CPU to dispatch, busy-waits only for the
    misc (G^m) portion, suspends during the pure-GPU (G^e) portion, pays eps
    CPU to notify.  Consecutive queued requests are separated by a single
    eps, matching Figure 4.
  * ``server_fifo`` — same server, FIFO-ordered queue (the paper's §7 /
    Fig. 15 future-work variant).
  * ``server_edf`` — beyond-paper: the server dequeues by earliest absolute
    job deadline (the ``dispatch.policy`` 'edf' ordering); analyzed by the
    order-agnostic job-driven bound (``server_analysis.analyze_edf_server``).
  * ``server_batched`` — beyond-paper: the server coalesces queued
    same-shape requests (identical (G^e, G^m)) into one accelerator call of
    up to ``batch_max`` requests: G^e and G^m are paid once per batch, the
    completion eps once per batch, and one receive eps drains all arrivals
    since the server last checked its mailbox — amortizing Lemma 1's 2*eps
    per request toward 2*eps per batch.  Batching only lets requests JOIN
    the head of the queue, never delays it, so the per-request (unbatched)
    analysis bound still dominates.
  * ``mpcp``  — synchronization-based, priority-ordered mutex queue; the
    whole GPU segment busy-waits on the client's CPU at the boosted global
    priority ceiling (§4).
  * ``fmlp``  — same, FIFO-ordered mutex queue (FMLP+).

Multi-accelerator systems (``System.server_cores`` with one core per
device) run one GPU server (or one mutex) per device; each task's
``device`` attribute routes its segments, matching the partitioned
``dispatch.ServerPool`` runtime.

The simulator executes exact protocol semantics and is the ground truth the
analyses are property-tested against (analysis bound >= simulated response
time).  Time is integer nanoseconds internally; the public API is float ms.

Job structure: a task's C is split into eta+1 equal normal chunks interleaved
with its GPU segments (an explicit per-task split can be supplied for case
studies).  Within a GPU segment, misc time is split half before / half after
the pure-GPU span, matching Figure 4's depiction.

The scenario engine (``repro_torch.scenarios``) plugs in through two hooks, both
defaulting to the legacy behavior bit-for-bit:

  * ``releases`` — explicit per-task release instants (arrival models:
    sporadic slack, bursts, diurnal modulation, recorded traces) instead of
    the built-in strictly periodic release loop;
  * ``etm`` — per-job actual execution times (execution-time models: table,
    random, measured step costs) instead of every job running at its
    declared worst case.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field, replace

from .dispatch.policy import request_key
from .faults import DeviceFault
from .migration import StreamMigration
from .task_model import GpuSegment, System, Task

__all__ = ["simulate", "SimResult", "TraceSlice"]

NS_PER_MS = 1_000_000
_BOOST = 10**9  # global priority ceiling offset (pi_B)
_SERVER_PRIO = 10**12


def _ns(ms: float) -> int:
    return int(round(ms * NS_PER_MS))


@dataclass(frozen=True)
class TraceSlice:
    core: int
    name: str  # task name or "__gpu_server__"
    start_ms: float
    end_ms: float
    kind: str  # "cpu" | "gcs" (busy-wait critical section) | "server"


@dataclass
class SimResult:
    response_times: dict[str, list[float]] = field(default_factory=dict)
    deadline_misses: dict[str, int] = field(default_factory=dict)
    trace: list[TraceSlice] = field(default_factory=list)

    def wcrt(self, name: str) -> float:
        rts = self.response_times.get(name, [])
        return max(rts) if rts else 0.0

    @property
    def any_miss(self) -> bool:
        return any(v > 0 for v in self.deadline_misses.values())


# --------------------------------------------------------------------------
# threads & cores
# --------------------------------------------------------------------------


class _Thread:
    """A schedulable entity on one core (a job in a CPU phase, or the server)."""

    __slots__ = ("name", "core", "base_prio", "prio", "remaining", "kind", "on_done")

    def __init__(self, name: str, core: int, prio: int):
        self.name = name
        self.core = core
        self.base_prio = prio
        self.prio = prio
        self.remaining = 0  # ns of the current CPU burst
        self.kind = "cpu"
        self.on_done = None  # callback when current burst finishes


class _Core:
    __slots__ = ("idx", "ready", "running", "run_start", "token")

    def __init__(self, idx: int):
        self.idx = idx
        self.ready: list[_Thread] = []
        self.running: _Thread | None = None
        self.run_start = 0
        self.token = 0


class _Engine:
    def __init__(self, num_cores: int, trace: bool):
        self.now = 0
        self.events: list[tuple[int, int, object]] = []  # (time, seq, fn)
        self.seq = 0
        self.cores = [_Core(i) for i in range(num_cores)]
        self.trace_on = trace
        self.trace: list[TraceSlice] = []

    def post(self, t: int, fn) -> None:
        self.seq += 1
        heapq.heappush(self.events, (t, self.seq, fn))

    # -- CPU scheduling ----------------------------------------------------
    def _record(self, core: _Core, upto: int) -> None:
        if self.trace_on and core.running is not None and upto > core.run_start:
            th = core.running
            self.trace.append(
                TraceSlice(core.idx, th.name, core.run_start / NS_PER_MS, upto / NS_PER_MS, th.kind)
            )

    def reschedule(self, core: _Core) -> None:
        top = max(core.ready, key=lambda th: th.prio, default=None)
        cur = core.running
        if cur is top:
            return
        if cur is not None:
            cur.remaining -= self.now - core.run_start
            self._record(core, self.now)
        core.running = top
        core.run_start = self.now
        core.token += 1
        if top is not None:
            tok = core.token
            self.post(self.now + top.remaining, lambda: self._burst_end(core, tok))

    def _burst_end(self, core: _Core, tok: int) -> None:
        if core.token != tok or core.running is None:
            return  # stale event (thread was preempted or finished earlier)
        th = core.running
        self._record(core, self.now)
        th.remaining = 0
        core.ready.remove(th)
        core.running = None
        core.token += 1
        cb = th.on_done
        th.on_done = None
        if cb is not None:
            cb()
        self.reschedule(core)

    def run_burst(self, th: _Thread, dur: int, kind: str, on_done) -> None:
        """Make ``th`` ready with a CPU burst of ``dur`` ns."""
        core = self.cores[th.core]
        th.kind = kind
        th.on_done = on_done
        if dur <= 0:
            # zero-length burst: complete immediately without scheduling
            self.post(self.now, on_done)
            return
        th.remaining = dur
        core.ready.append(th)
        self.reschedule(core)

    def set_prio(self, th: _Thread, prio: int) -> None:
        th.prio = prio
        core = self.cores[th.core]
        if th in core.ready or core.running is th:
            self.reschedule(core)

    def run(self, until: int) -> None:
        while self.events and self.events[0][0] <= until:
            t, _, fn = heapq.heappop(self.events)
            self.now = t
            fn()
        self.now = until
        for core in self.cores:
            if core.running is not None:
                core.running.remaining -= self.now - core.run_start
                self._record(core, self.now)


# --------------------------------------------------------------------------
# accelerator arbitration
# --------------------------------------------------------------------------


class _GpuServer:
    """The paper's GPU server (mode='server').

    CPU accounting (reconstructed from Lemma 1 + the Figure-4 timeline):
      * every submit costs eps of server CPU (receive/wake-up) — this is what
        delays tau_h by eps at time 3 in the example;
      * every completion costs eps (notify + dequeue-next), and a chained
        next segment starts right after that single eps (Lemma 3: "the GPU
        server needs to be invoked only once between two consecutive GPU
        requests");
      * the misc portion G^m of a segment is server-core CPU, split half
        before / half after the pure-GPU span (the example's "two
        sub-segments of miscellaneous operations");
      * so extra CPU per request = receive + notify = 2*eps (Lemma 1).

    All server CPU activities are serialized through a small work queue
    (the server is one thread); segment-progress work (m1/m2/notify) takes
    precedence over receive work so an in-flight segment is never stretched
    by unrelated arrivals.

    ``batch_max > 1`` enables batched dispatch (mode='server_batched'):
    when a segment starts, every queued request with the SAME (G^e, G^m)
    signature — the simulator's proxy for "same shape" — joins the batch
    (up to batch_max); the batch runs G^e/G^m once and pays one completion
    eps.  Receive work is also coalesced: a single eps drains all requests
    that arrived since the last mailbox check, so a steady batch of b pays
    ~2*eps instead of 2*b*eps of server CPU.
    """

    def __init__(self, eng: _Engine, core: int, eps: int, *,
                 ordering: str = "priority", batch_max: int = 1,
                 name: str = "__gpu_server__"):
        self.eng = eng
        self.eps = eps
        self.ordering = ordering  # dispatch.policy key: priority | fifo | edf
        self.batch_max = batch_max
        self.queue: list[tuple[float, int, object]] = []  # (key, seq, req)
        self.seq = 0
        self.gpu_busy = False
        self.notify_pending = False  # a completion eps not yet finished
        self.recv_pending = False  # a coalesced receive eps not yet finished
        self.thread = _Thread(name, core, _SERVER_PRIO)
        self.work: list[tuple[int, int, object]] = []  # (class, seq, (dur, then))
        self.cpu_busy = False
        self.dead = False  # device died (fault injection): nothing completes
        self.inflight: list | None = None  # requests inside the current call

    # -- fault injection ---------------------------------------------------
    def kill(self) -> None:
        """The device dies mid-work: the in-flight call never completes, the
        queue freezes, and every continuation below turns into a no-op.  The
        orphaned requests stay parked until ``drain_orphans`` (the detection
        instant) hands them to the failover target."""
        self.dead = True

    def drain_orphans(self) -> list:
        """All parked requests — in-flight first (they waited longest), then
        the frozen queue in policy order — as (prio, seg_e, seg_m, cb,
        deadline)."""
        orphans = list(self.inflight or [])
        self.inflight = None
        for item in sorted(self.queue):
            _, _, req = item
            orphans.append(req)
        self.queue = []
        return orphans

    # -- serialized server CPU --------------------------------------------
    def _cpu(self, dur: int, then, *, segment_work: bool) -> None:
        if self.dead:
            return
        self.seq += 1
        heapq.heappush(self.work, (0 if segment_work else 1, self.seq, (dur, then)))
        if not self.cpu_busy:
            self._next_work()

    def _next_work(self) -> None:
        if self.dead or not self.work:
            self.cpu_busy = False
            return
        self.cpu_busy = True
        _, _, (dur, then) = heapq.heappop(self.work)

        def done():
            if self.dead:
                self.cpu_busy = False
                return
            then()
            self._next_work()

        if dur <= 0:
            self.eng.post(self.eng.now, done)
        else:
            self.eng.run_burst(self.thread, dur, "server", done)

    # -- protocol -----------------------------------------------------------
    def submit(self, prio: int, seg_e: int, seg_m: int, on_complete,
               deadline: float | None = None) -> None:
        self.seq += 1
        key = request_key(self.ordering, priority=prio, deadline=deadline)
        heapq.heappush(self.queue,
                       (key, self.seq, (prio, seg_e, seg_m, on_complete,
                                        deadline)))
        if self.dead:
            return  # parked: recovered at the detection instant
        if self.batch_max > 1:
            # coalesced receive: one eps drains every arrival since the
            # server last checked its mailbox
            if self.recv_pending:
                return
            self.recv_pending = True

            def received():
                self.recv_pending = False
                self._maybe_start()

            self._cpu(self.eps, received, segment_work=False)
        else:
            # receive/wake-up: eps of server CPU per request (Lemma 1)
            self._cpu(self.eps, self._maybe_start, segment_work=False)

    def _pop_batch(self) -> tuple[int, int, list]:
        """Pop the head request plus every same-shape request (identical
        (G^e, G^m)) up to batch_max; returns (seg_e, seg_m, batch) with
        batch entries (prio, seg_e, seg_m, on_complete, deadline)."""
        _, _, head = heapq.heappop(self.queue)
        seg_e, seg_m = head[1], head[2]
        batch = [head]
        if self.batch_max > 1 and self.queue:
            keep = []
            for item in sorted(self.queue):  # queue-policy order
                req = item[2]
                if (len(batch) < self.batch_max and req[1] == seg_e
                        and req[2] == seg_m):
                    batch.append(req)
                else:
                    keep.append(item)
            self.queue = keep
            heapq.heapify(self.queue)
        return seg_e, seg_m, batch

    def _maybe_start(self) -> None:
        if self.dead or self.gpu_busy or self.notify_pending or not self.queue:
            return
        self.gpu_busy = True
        seg_e, seg_m, batch = self._pop_batch()
        self.inflight = batch
        callbacks = [req[3] for req in batch]
        m1 = seg_m // 2
        m2 = seg_m - m1

        def after_m1():
            if self.dead:
                return
            # pure-GPU span: server suspends (no CPU demand)
            self.eng.post(self.eng.now + seg_e, after_e)

        def after_e():
            if self.dead:
                return
            self._cpu(m2, after_m2, segment_work=True)

        def after_m2():
            if self.dead:
                return
            # completion: eps of server CPU (notify client(s) + dequeue next)
            self.gpu_busy = False
            self.notify_pending = True
            self._cpu(self.eps, complete, segment_work=True)

        def complete():
            if self.dead:
                return
            self.inflight = None
            self.notify_pending = False
            for cb in callbacks:
                cb()
            self._maybe_start()  # chained segment: single eps paid (Fig. 4)

        self._cpu(m1, after_m1, segment_work=True)


class _GpuLock:
    """Synchronization-based mutex (mode='mpcp' priority queue, 'fmlp' FIFO)."""

    def __init__(self, fifo: bool):
        self.fifo = fifo
        self.holder = None
        self.queue: list[tuple[int, int, object]] = []
        self.seq = 0

    def acquire(self, prio: int, grant) -> bool:
        """Returns True if granted immediately, else queues ``grant``."""
        if self.holder is None:
            self.holder = grant
            return True
        self.seq += 1
        key = self.seq if self.fifo else -prio
        heapq.heappush(self.queue, (key, self.seq, grant))
        return False

    def release(self) -> None:
        self.holder = None
        if self.queue:
            _, _, grant = heapq.heappop(self.queue)
            self.holder = grant
            grant()


# --------------------------------------------------------------------------
# jobs
# --------------------------------------------------------------------------


class _Job:
    def __init__(self, sim: "_Sim", task: Task, release: int, index: int = 0,
                 fold: GpuSegment | None = None):
        self.sim = sim
        self.task = task
        self.release = release
        # per-job actual costs: the execution-time model prices this job
        # (declared worst case when no model is plugged in)
        if sim.etm is None:
            C_ms, self.segs = task.C, task.segments
        else:
            C_ms, self.segs = sim.etm(task, index)
        # one-time migration cost: the first job released after a planned
        # migration carries the block-copy cost folded into its first GPU
        # segment (one request, no extra server invocation — weaker than
        # the analysis, which appends a standalone segment)
        if fold is not None and fold.total > 0:
            if self.segs:
                s0 = self.segs[0]
                self.segs = (GpuSegment(s0.e + fold.e, s0.m + fold.m),
                             *tuple(self.segs)[1:])
            else:
                self.segs = (fold,)
        eta = len(self.segs)
        # normal chunks: explicit split if provided, else eta+1 equal chunks
        split = sim.splits.get(task.name)
        if split is None:
            chunk = _ns(C_ms) // (eta + 1)
            last = _ns(C_ms) - chunk * eta
            self.chunks = [chunk] * eta + [last]
        else:
            self.chunks = [_ns(c) for c in split]
        self.deadline_ms = (release + _ns(task.D)) / NS_PER_MS
        self.phase = 0  # 0..eta: index of next normal chunk
        self.thread = _Thread(task.name, task.core, task.priority)

    def start(self) -> None:
        self._run_chunk()

    def _run_chunk(self) -> None:
        self.sim.eng.run_burst(self.thread, self.chunks[self.phase], "cpu", self._chunk_done)

    def _chunk_done(self) -> None:
        if self.phase < len(self.segs):
            seg = self.segs[self.phase]
            self.phase += 1
            self.sim.gpu_access(self, seg)
        else:
            self._finish()

    def gpu_done(self) -> None:
        self._run_chunk()

    def _finish(self) -> None:
        rt = (self.sim.eng.now - self.release) / NS_PER_MS
        self.sim.result.response_times.setdefault(self.task.name, []).append(rt)
        if rt > self.task.D + 1e-9:
            self.sim.result.deadline_misses[self.task.name] = (
                self.sim.result.deadline_misses.get(self.task.name, 0) + 1
            )


class _Sim:
    def __init__(
        self,
        system: System,
        mode: str,
        horizon_ms: float,
        trace: bool,
        splits: dict[str, list[float]] | None,
        offsets: dict[str, float] | None,
        batch_max: int = 1,
        faults: list[DeviceFault] | None = None,
        releases: dict[str, list[float]] | None = None,
        etm=None,
        migrations: list[StreamMigration] | None = None,
    ):
        self.system = system
        self.mode = mode
        self.eng = _Engine(system.num_cores, trace)
        self.result = SimResult()
        self.splits = splits or {}
        self.offsets = offsets or {}
        self.releases = releases
        self.etm = etm
        self.horizon = _ns(horizon_ms)
        self.faults = sorted(faults or [], key=lambda f: f.at_ms)
        server_modes = ("server", "server_fifo", "server_edf",
                        "server_batched")
        if self.faults and mode not in server_modes:
            raise ValueError("fault injection requires a server mode")
        self.device_map = list(range(max(system.num_gpus, 1)))
        for f in self.faults:
            if not (0 <= f.device < len(self.device_map)
                    and 0 <= f.to < len(self.device_map)):
                raise ValueError(f"fault device outside pool: {f}")
        self.migrations = sorted(migrations or [], key=lambda m: m.at_ms)
        if self.migrations and mode not in server_modes:
            raise ValueError("migration replay requires a server mode")
        names = {t.name for t in system.tasks}
        self._migs_by_task: dict[str, list[StreamMigration]] = {}
        for m in self.migrations:
            if m.task not in names:
                raise ValueError(f"migration names unknown task: {m}")
            if not 0 <= m.to < len(self.device_map):
                raise ValueError(f"migration device outside pool: {m}")
            if m.core >= system.num_cores:
                raise ValueError(f"migration core outside system: {m}")
            self._migs_by_task.setdefault(m.task, []).append(m)
        if mode in server_modes:
            cores = system.server_cores
            if not cores:
                raise ValueError("server mode needs system.server_core(s) set")
            ordering = {"server_fifo": "fifo", "server_edf": "edf"}.get(
                mode, "priority")
            bmax = batch_max if mode == "server_batched" else 1
            self.servers = [
                _GpuServer(self.eng, core, _ns(system.epsilon),
                           ordering=ordering, batch_max=bmax,
                           name=f"__gpu_server_{d}__" if len(cores) > 1
                           else "__gpu_server__")
                for d, core in enumerate(cores)
            ]
            self.mode = "server"
        elif mode in ("mpcp", "fmlp"):
            self.locks = [_GpuLock(fifo=(mode == "fmlp"))
                          for _ in range(system.num_gpus)]
        else:
            raise ValueError(mode)

    def _route(self, device: int) -> int:
        """Resolve failovers transitively (a double failure chains maps)."""
        d = device
        while self.device_map[d] != d:
            d = self.device_map[d]
        return d

    def _recover(self, f: DeviceFault) -> None:
        """Detection instant of fault ``f``: re-route the dead device's
        traffic and re-submit its orphaned requests to the failover target
        with the recovery (re-prefill) cost FOLDED into each segment — one
        re-issued request, not an extra one.  That is deliberately weaker
        than the analysis (which appends a whole extra segment, paying its
        own 2*eps server handling), keeping bound >= sim."""
        self.device_map[f.device] = f.to
        target = self.servers[self._route(f.to)]
        rec_e, rec_m = _ns(f.recovery.e), _ns(f.recovery.m)
        for prio, e, m, cb, deadline in self.servers[f.device].drain_orphans():
            target.submit(prio, e + rec_e, m + rec_m, cb, deadline)

    def gpu_access(self, job: _Job, seg) -> None:
        e_ns, m_ns = _ns(seg.e), _ns(seg.m)
        if self.mode == "server":
            # client suspends; its device's server handles the segment
            server = self.servers[self._route(job.task.device)]
            server.submit(job.task.priority, e_ns, m_ns, job.gpu_done,
                          job.deadline_ms)
        else:
            th = job.thread
            lock = self.locks[job.task.device]

            def granted():
                # boosted global ceiling; whole segment busy-waits on CPU
                self.eng.set_prio(th, _BOOST + th.base_prio)
                th.kind = "gcs"
                self.eng.run_burst(th, e_ns + m_ns, "gcs", release)

            def release():
                self.eng.set_prio(th, th.base_prio)
                lock.release()
                job.gpu_done()

            if lock.acquire(job.task.priority, granted):
                granted()

    def run(self) -> SimResult:
        for f in self.faults:
            self.eng.post(_ns(f.at_ms),
                          lambda f=f: self.servers[f.device].kill())
            self.eng.post(_ns(f.at_ms + f.detect_ms),
                          lambda f=f: self._recover(f))
        for task in self.system.tasks:
            rel_list = (self.releases.get(task.name)
                        if self.releases is not None else None)
            if rel_list is None:
                # legacy strictly periodic release loop (ns accumulation)
                off = _ns(self.offsets.get(task.name, 0.0))
                rel_ns = []
                t = off
                while t < self.horizon:
                    rel_ns.append(t)
                    t += _ns(task.T)
            else:
                rel_ns = [_ns(r) for r in rel_list if _ns(r) < self.horizon]
            migs = self._migs_by_task.get(task.name, [])
            charged = [False] * len(migs)
            for idx, rel in enumerate(rel_ns):
                # job-granularity placement: jobs released at/after a
                # migration run on its destination; each migration's cost
                # is folded ONCE into the first such job's first segment
                dev, core = task.device, task.core
                fold_e = fold_m = 0.0
                for j, m in enumerate(migs):
                    if _ns(m.at_ms) <= rel:
                        dev = m.to
                        if m.core >= 0:
                            core = m.core
                        if not charged[j]:
                            charged[j] = True
                            fold_e += m.cost.e
                            fold_m += m.cost.m
                eff = (task if (dev, core) == (task.device, task.core)
                       else replace(task, device=dev, core=core))
                fold = (GpuSegment(fold_e, fold_m)
                        if fold_e or fold_m else None)
                self.eng.post(
                    rel,
                    lambda task=eff, rel=rel, idx=idx, fold=fold:
                        _Job(self, task, rel, idx, fold=fold).start())
        self.eng.run(self.horizon)
        self.result.trace = self.eng.trace
        return self.result


def simulate(
    system: System,
    *,
    mode: str,
    horizon_ms: float,
    trace: bool = False,
    splits: dict[str, list[float]] | None = None,
    offsets: dict[str, float] | None = None,
    batch_max: int = 4,
    faults: list[DeviceFault] | None = None,
    releases: dict[str, list[float]] | None = None,
    etm=None,
    migrations: list[StreamMigration] | None = None,
) -> SimResult:
    """Simulate ``system`` for ``horizon_ms`` under ``mode`` in
    {'server','server_fifo','server_edf','server_batched','mpcp','fmlp'}.
    Jobs are released periodically (synchronous release at t=0 unless
    per-task ``offsets`` are given).  ``splits`` may supply an explicit
    normal-chunk split (list of ms, length eta+1) per task name.
    ``batch_max`` caps the coalesced batch size in 'server_batched' mode
    (ignored otherwise).  Multi-accelerator systems (``System.server_cores``)
    run one server (or mutex) per device, routed by each task's ``device``.

    ``faults`` (server modes only) injects ``core.faults.DeviceFault``
    device deaths: at ``at_ms`` the device stops mid-work; at
    ``at_ms + detect_ms`` its orphaned requests re-submit to device ``to``
    with the recovery cost folded in, and its tasks re-route there for the
    rest of the run.  ``server_analysis.analyze_pool_under_faults`` prices
    the same schedule analytically; bound >= sim is property-tested.

    ``migrations`` (server modes only) replays a planned
    ``core.migration.StreamMigration`` schedule: every job of the named
    task released at or after ``at_ms`` runs on device ``to`` / core
    ``core``, and the one-time migration ``cost`` is folded into the first
    such job's first GPU segment.  Jobs in flight at the boundary keep the
    old placement — deliberately weaker than
    ``server_analysis.analyze_pool_under_migrations`` (which appends the
    cost segment to every later phase), keeping bound >= sim.

    Scenario-engine hooks (``repro_torch.scenarios`` wires both; each defaults to
    the legacy behavior exactly):

    * ``releases`` maps task name -> sorted absolute release instants (ms);
      tasks absent from the mapping release periodically.  Generators must
      respect each task's minimum inter-arrival time T for the analyses to
      stay sound.
    * ``etm(task, job_index) -> (C_ms, segments)`` prices each job's actual
      execution; costs must stay within the declared worst case, with the
      declared segment count."""
    return _Sim(system, mode, horizon_ms, trace, splits, offsets,
                batch_max=batch_max, faults=faults, releases=releases,
                etm=etm, migrations=migrations).run()
