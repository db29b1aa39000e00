"""Analysis-driven admission control (beyond-paper, built from the paper's
analysis).

A serving deployment declares each workload stream as a sporadic task
(period, deadline, CPU-side cost, device-segment costs).  A new stream is
admitted iff the server-based analysis (Eqs (1)-(6)) proves every admitted
stream still meets its deadline.  This turns the paper's offline
schedulability test into an online admission test — the GPU server has
central knowledge of all requests (paper §7 notes this enables exactly this
kind of feature).

Streams are allocated to cores (and, across pods, to per-pod servers) with
the paper's WFD-with-server packing (§5.3).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from . import server_analysis
from .allocation import allocate, allocate_pool
from .task_model import GpuSegment, Task
from .taskset_gen import assign_rm_priorities

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "DegradedReport",
    "PoolAdmissionController",
    "check_pool",
]


@dataclass
class AdmissionDecision:
    admitted: bool
    reason: str = ""
    response_times: dict[str, float] = field(default_factory=dict)


@dataclass
class DegradedReport:
    """Outcome of degraded-mode admission after a device eviction.

    ``moved`` maps each surviving displaced stream to its new device —
    re-proven schedulable there WITH its recovery segment (the priced
    re-prefill of the retained prefix) appended.  ``shed`` lists every
    stream dropped to make the shrunk pool schedulable, in the order shed —
    lowest-priority victims first (graceful degradation), a displaced
    stream itself only when no lower-priority victim was left.
    ``reasons`` keeps the last rejection message per displaced stream that
    needed shedding; ``recovery_ms`` the priced recovery cost per moved
    stream."""

    device: int
    moved: dict[str, int] = field(default_factory=dict)
    shed: list[str] = field(default_factory=list)
    reasons: dict[str, str] = field(default_factory=dict)
    recovery_ms: dict[str, float] = field(default_factory=dict)


class AdmissionController:
    """Holds the currently-admitted stream set for one accelerator (pod).

    ``min_batch`` > 1 switches on the AMORTIZED-overhead admission mode
    (``server_analysis.amortized_server_overhead``): when the dispatcher
    guarantees that every device call coalesces at least ``min_batch``
    requests (e.g. a BatchingServer fed by >= min_batch always-saturated
    decode streams), each request's share of the server invocation cost
    drops from eps to eps/min_batch, so the analysis runs with that
    effective epsilon and admits strictly more task sets.  This is an
    OPTIMISTIC mode — sound only while the batch-size guarantee holds; with
    the default min_batch=1 it is exactly the paper's unconditional bound.

    ``cost_model`` switches on CALIBRATED admission: a stream admitted with
    a shape-cell hint (``try_admit(stream, cell=...)``) has its GPU
    segments re-priced at ``min(declared, safety * predicted)`` for that
    cell (``analysis.cost_model.StepCostModel.recost``) before the
    Eqs (1)-(6) check runs.  Declared costs are the full-width worst case
    (the (max_batch, nb_max) trace); the calibrated cost is the measured/
    interpolated cost of the bucket the stream actually runs in, so
    calibrated mode admits a superset of the worst-case sets (the analysis
    is monotone in segment costs and min() never re-prices upward) while
    the per-server bounds still dominate execution that honors the
    calibrated costs.  Streams admitted without a cell keep their declared
    costs — an empty or absent model is exactly the uncalibrated mode.
    """

    def __init__(self, num_cores: int, *, epsilon_ms: float = 0.05,
                 heuristic: str = "wfd", min_batch: int = 1,
                 cost_model=None):
        if min_batch < 1:
            raise ValueError(f"min_batch must be >= 1, got {min_batch}")
        self.num_cores = num_cores
        self.epsilon = epsilon_ms
        self.heuristic = heuristic
        self.min_batch = min_batch
        self.cost_model = cost_model
        self.streams: list[Task] = []

    @property
    def effective_epsilon(self) -> float:
        """Per-request server overhead after batch amortization: every eps
        term in Eqs (1)-(6) is one server invocation charged to one request,
        so a guaranteed batch of b divides each share by b (the 2*eta*eps
        handling term becomes ``amortized_server_overhead(task, eps, b)``).
        """
        return self.epsilon / self.min_batch

    def _check(self, tasks: list[Task]) -> AdmissionDecision:
        tasks = assign_rm_priorities(tasks)
        system = allocate(
            tasks,
            self.num_cores,
            approach="server",
            epsilon=self.effective_epsilon,
            heuristic=self.heuristic,
        )
        res = server_analysis.analyze(system)
        if res.schedulable:
            return AdmissionDecision(True, "schedulable", res.response_times)
        misses = [n for n, w in res.response_times.items() if not w <= _deadline(tasks, n)]
        return AdmissionDecision(False, f"deadline miss for {misses}", res.response_times)

    def try_admit(self, stream: Task, *, cell=None) -> AdmissionDecision:
        """``cell``: the cost-model shape cell(s) this stream's GPU
        segments run in (one CellKey broadcast to every segment, or a
        per-segment sequence); only meaningful with ``cost_model`` set."""
        if any(t.name == stream.name for t in self.streams):
            return AdmissionDecision(False, f"duplicate stream name {stream.name!r}")
        if self.cost_model is not None and cell is not None:
            stream = self.cost_model.recost(stream, cell)
        decision = self._check([*self.streams, stream])
        if decision.admitted:
            # the CALIBRATED task is what was proven schedulable; later
            # admission checks must re-analyze against that pricing
            self.streams.append(stream)
        return decision

    def remove(self, name: str) -> None:
        self.streams = [t for t in self.streams if t.name != name]

    def utilization(self) -> float:
        return sum(t.U for t in self.streams)


def _deadline(tasks: list[Task], name: str) -> float:
    for t in tasks:
        if t.name == name:
            return t.D
    return float("inf")


def check_pool(tasks: list[Task], num_devices: int, cores_per_device: int,
               *, epsilon_ms: float = 0.05, heuristic: str = "wfd",
               ) -> tuple["server_analysis.PoolAnalysisResult", "object"]:
    """Offline pool schedulability check: run the device-assignment step
    (``allocation.allocate_pool``), then the per-server analysis
    (``server_analysis.analyze_pool``) on the resulting partitioned system.
    Returns (analysis, system) so callers can also simulate the placement."""
    tasks = assign_rm_priorities(tasks)
    system = allocate_pool(tasks, num_devices, cores_per_device,
                           epsilon=epsilon_ms, heuristic=heuristic)
    return server_analysis.analyze_pool(system), system


class PoolAdmissionController:
    """Online admission for a multi-accelerator ServerPool.

    A new stream is placed on a device by worst-fit on declared accelerator
    utilization (the paper's WFD discipline, applied at the device level —
    the same device-assignment order ``allocation.allocate_pool`` uses
    offline), and admitted iff the server-based analysis (Eqs (1)-(6))
    applied WITHIN that device's partition proves every stream already on
    the device still makes its deadline.  Partitioned assignment means the
    other devices' analyses are untouched by construction — admission is
    O(one partition), and an admitted stream's device is stable for its
    lifetime (the dispatch.ServerPool router pins it).
    """

    def __init__(self, num_devices: int, *, cores_per_device: int = 2,
                 epsilon_ms: float = 0.05, heuristic: str = "wfd",
                 min_batch: int = 1, cost_model=None):
        # kept for add_device(): an elastically-joined device gets a
        # controller built exactly like the originals
        self.cores_per_device = cores_per_device
        self.epsilon_ms = epsilon_ms
        self.heuristic = heuristic
        self.min_batch = min_batch
        self.cost_model = cost_model
        self.devices = [
            AdmissionController(cores_per_device, epsilon_ms=epsilon_ms,
                                heuristic=heuristic, min_batch=min_batch,
                                cost_model=cost_model)
            for _ in range(num_devices)
        ]
        self.placement: dict[str, int] = {}
        self.alive = [True] * num_devices

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    def gpu_utilization(self, device: int) -> float:
        return sum(t.G / t.T for t in self.devices[device].streams)

    def device_of(self, name: str) -> int:
        return self.placement[name]

    def try_admit(self, stream: Task, *,
                  cell=None) -> tuple[AdmissionDecision, int]:
        """Returns (decision, device); device is -1 when rejected.
        ``cell`` is the calibrated-admission shape hint, forwarded to the
        per-device controller (see ``AdmissionController.try_admit``)."""
        if stream.name in self.placement:
            return (AdmissionDecision(
                False, f"duplicate stream name {stream.name!r}"), -1)
        order = sorted((d for d in range(self.num_devices) if self.alive[d]),
                       key=self.gpu_utilization)
        last = AdmissionDecision(False, "no surviving devices")
        for d in order:
            decision = self.devices[d].try_admit(stream, cell=cell)
            if decision.admitted:
                self.placement[stream.name] = d
                return decision, d
            last = decision
        return last, -1

    def remove(self, name: str) -> None:
        d = self.placement.pop(name, None)
        if d is not None:
            self.devices[d].remove(name)

    # -- planned migration / elastic membership ----------------------------
    def migrate(self, name: str, dst: int | None = None, *,
                migration_cost_ms: float = 0.0,
                ) -> tuple[AdmissionDecision, int]:
        """Re-prove an admitted stream on another device before moving it.

        The candidate is the stream's admitted task with the priced
        migration segment appended — one extra GPU request of
        ``migration_cost_ms`` (the gather/copy/scatter of its live KV
        blocks), which also pays the server's 2*eps handling share, so the
        move enters Eqs (1)-(6) exactly like
        ``analyze_pool_under_migrations`` prices it.  With ``dst`` given,
        only that device is tried (work stealing names its target);
        otherwise worst-fit order over the other live devices
        (consolidation lets admission choose).  On success the stream's
        admission slot moves atomically: removed from the source
        controller, the augmented task admitted at the destination —
        keeping the cost segment in the destination's stream set is
        deliberately conservative, matching the analysis side appending it
        to every later phase.  Returns (decision, device); device is -1
        when no destination can prove it (the stream stays put, nothing
        changes)."""
        src = self.placement.get(name)
        if src is None:
            return AdmissionDecision(False, f"unknown stream {name!r}"), -1
        task = next(t for t in self.devices[src].streams if t.name == name)
        mc = float(migration_cost_ms)
        cand = (replace(task, segments=(*task.segments,
                                        GpuSegment(e=0.9 * mc, m=0.1 * mc)))
                if mc > 0 else task)
        if dst is not None:
            order = [dst]
            if not (0 <= dst < self.num_devices) or not self.alive[dst]:
                return AdmissionDecision(False,
                                         f"device {dst} is not alive"), -1
            if dst == src:
                return AdmissionDecision(False, "already there"), -1
        else:
            order = sorted((d for d in range(self.num_devices)
                            if self.alive[d] and d != src),
                           key=self.gpu_utilization)
        last = AdmissionDecision(False, "no destination device")
        for d in order:
            decision = self.devices[d].try_admit(cand)
            if decision.admitted:
                self.devices[src].remove(name)
                self.placement[name] = d
                return decision, d
            last = decision
        return last, -1

    def add_device(self) -> int:
        """Grow the pool by one admission partition (elastic scale-up);
        returns its device index.  The new device starts empty and
        immediately participates in worst-fit placement."""
        self.devices.append(AdmissionController(
            self.cores_per_device, epsilon_ms=self.epsilon_ms,
            heuristic=self.heuristic, min_batch=self.min_batch,
            cost_model=self.cost_model))
        self.alive.append(True)
        return len(self.devices) - 1

    def drain_device(self, device: int, *, migration_cost_ms=0.0,
                     ) -> DegradedReport:
        """Elastic scale-down: re-prove every stream of ``device`` on the
        remaining devices and mark the device gone.  This is exactly
        ``evict_device`` with the extra segment priced as a migration copy
        instead of a recovery re-prefill — a planned drain moves live KV
        blocks (cheap) where a failure re-prefills (expensive); the
        displacement, shedding, and schedulability machinery is identical.
        """
        return self.evict_device(device, recovery_cost_ms=migration_cost_ms)

    # -- degraded-mode admission (device failure) --------------------------
    def evict_device(self, device: int, *, recovery_cost_ms=0.0,
                     ) -> DegradedReport:
        """Re-run admission for a shrunk pool after device ``device`` died.

        Its streams are displaced and re-admitted on the survivors in
        DECREASING priority order, each with a recovery segment appended —
        one extra GPU request of ``recovery_cost_ms`` (a float, or a
        ``Task -> float`` callable so the engine can price each stream's
        re-prefill via the calibrated cost model).  The appended segment
        also pays the server's per-request 2*eps handling share, so the
        recovery delay enters Eqs (1)-(6) exactly like any other segment.

        When a displaced stream fails admission everywhere, the globally
        LOWEST-priority admitted stream (strictly below the displaced one)
        is shed and the admission retried; only when no such victim
        remains is the displaced stream itself shed.  Idempotent: evicting
        an already-dead device reports nothing new."""
        if not (0 <= device < self.num_devices):
            raise ValueError(f"device {device} outside pool of "
                             f"{self.num_devices}")
        report = DegradedReport(device=device)
        if not self.alive[device]:
            return report
        self.alive[device] = False
        ctrl = self.devices[device]
        displaced = sorted(ctrl.streams, key=lambda t: -t.priority)
        ctrl.streams = []
        for t in displaced:
            self.placement.pop(t.name, None)
        price = (recovery_cost_ms if callable(recovery_cost_ms)
                 else (lambda _t, _rc=float(recovery_cost_ms): _rc))
        for t in displaced:
            rc = float(price(t))
            report.recovery_ms[t.name] = rc
            cand = (replace(t, segments=(*t.segments, GpuSegment(e=rc, m=0.0)))
                    if rc > 0 else t)
            while True:
                decision, d = self.try_admit(cand)
                if decision.admitted:
                    report.moved[t.name] = d
                    break
                report.reasons[t.name] = decision.reason
                victim = self._lowest_priority_admitted(below=t.priority)
                if victim is None:
                    report.shed.append(t.name)
                    break
                self.remove(victim.name)
                report.shed.append(victim.name)
        return report

    def _lowest_priority_admitted(self, *, below: int) -> Task | None:
        cands = [t for d in range(self.num_devices) if self.alive[d]
                 for t in self.devices[d].streams if t.priority < below]
        return min(cands, key=lambda t: t.priority) if cands else None


class MultiPodAdmission(PoolAdmissionController):
    """Historical alias (§7 future work, pod vocabulary): one GPU server
    per pod/accelerator, worst-fit placement — exactly
    :class:`PoolAdmissionController` with pod-flavored names."""

    def __init__(self, num_pods: int, *, cores_per_pod: int = 2,
                 epsilon_ms: float = 0.05):
        super().__init__(num_pods, cores_per_device=cores_per_pod,
                         epsilon_ms=epsilon_ms)

    @property
    def pods(self) -> list[AdmissionController]:
        return self.devices
