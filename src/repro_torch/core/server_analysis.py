"""Schedulability analysis for the server-based approach (Kim et al. 2017, §5.2).

Implements, exactly as in the paper:

  Lemma 1   each GPU request costs at most 2*eps of extra CPU time.
  Lemma 2 / Eq (1)   B_i^gpu = B_i^w + G_i + 2*eta_i*eps          (eta_i > 0)
  Eq (2)    B_i^w = min(B_i^rd, B_i^jd)        (the "improved" double bound)
  Lemma 3 / Eq (3)   request-driven per-request waiting bound (recurrence)
  Lemma 4 / Eq (4)   job-driven waiting bound (uses the response time W_i)
  Eq (5)    response time, task on a different core than the GPU server
  Eq (6)    response time, task on the same core as the GPU server
  Lemma 5   (Bletsas et al.) self-suspension jitter form used in (5)/(6)

Conventions: larger ``priority`` = higher priority; times in ms; a response
time of ``math.inf`` means the recurrence exceeded the deadline (task deemed
unschedulable, matching how the paper's experiments count schedulability).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

from .faults import DeviceFault
from .migration import StreamMigration
from .task_model import System, Task, ceil_div

__all__ = [
    "request_driven_bound",
    "job_driven_bound",
    "waiting_bound",
    "fifo_waiting_bound",
    "edf_waiting_bound",
    "gpu_handling_time",
    "response_time",
    "analyze",
    "analyze_fifo_server",
    "analyze_edf_server",
    "analyze_pool",
    "analyze_pool_under_faults",
    "analyze_pool_under_migrations",
    "amortized_server_overhead",
    "AnalysisResult",
    "FaultedAnalysisResult",
    "MigratedAnalysisResult",
    "PoolAnalysisResult",
]

_MAX_ITERS = 10_000


def _lp_max_segment(system: System, task: Task) -> float:
    """max_{pi_l < pi_i, 1<=k<=eta_l} (G_{l,k} + eps): the longest GPU segment
    (plus one server invocation) among lower-priority tasks.  Zero when no
    lower-priority task uses the GPU (max over the empty set)."""
    eps = system.epsilon
    vals = [
        seg.total + eps
        for t in system.lower_prio(task)
        for seg in t.segments
    ]
    return max(vals, default=0.0)


def _hp_interference(system: System, task: Task, window: float) -> float:
    """sum_{pi_h > pi_i, 1<=k<=eta_h} (ceil(window/T_h) + 1) * (G_{h,k} + eps).

    Carry-in '+1' per Lemmas 3/4.  Applies to *all* higher-priority tasks in
    the system regardless of core: the server's queue is ordered by task
    priority globally.
    """
    eps = system.epsilon
    total = 0.0
    for h in system.higher_prio(task):
        if not h.uses_gpu:
            continue
        n_jobs = ceil_div(window, h.T) + 1
        total += n_jobs * sum(seg.total + eps for seg in h.segments)
    return total


def request_driven_bound(system: System, task: Task, *, horizon: float) -> float:
    """B_{i,j}^{rd} via the recurrence of Eq (3).

    The bound is identical for every j (Eq (3) does not depend on j), so the
    total request-driven bound is  B_i^rd = eta_i * B_{i,j}^rd.
    Returns ``inf`` if the recurrence exceeds ``horizon``.
    """
    if not task.uses_gpu:
        return 0.0
    first = _lp_max_segment(system, task)
    b = first  # B^{rd,0}: the first term of the equation (paper, Lemma 3)
    for _ in range(_MAX_ITERS):
        nxt = first + _hp_interference(system, task, b)
        if nxt > horizon:
            return math.inf
        if nxt <= b + 1e-12:
            return nxt
        b = nxt
    return math.inf


def job_driven_bound(system: System, task: Task, W_i: float) -> float:
    """B_i^{jd} per Eq (4): job-level waiting bound over a window of W_i.

      B_i^jd = eta_i * max_{lp}(G_{l,k}+eps)
             + sum_{hp h,k} (ceil(W_i/T_h)+1) (G_{h,k}+eps)
    """
    if not task.uses_gpu:
        return 0.0
    if math.isinf(W_i):
        return math.inf
    return task.eta * _lp_max_segment(system, task) + _hp_interference(system, task, W_i)


def waiting_bound(system: System, task: Task, W_i: float, *, horizon: float) -> float:
    """B_i^w = min(B_i^rd, B_i^jd)  (Eq (2), the improved double bound)."""
    if not task.uses_gpu:
        return 0.0
    b_rd = request_driven_bound(system, task, horizon=horizon)
    total_rd = task.eta * b_rd if not math.isinf(b_rd) else math.inf
    b_jd = job_driven_bound(system, task, W_i)
    return min(total_rd, b_jd)


def gpu_handling_time(system: System, task: Task, W_i: float, *, horizon: float) -> float:
    """B_i^gpu per Eq (1)."""
    if not task.uses_gpu:
        return 0.0
    b_w = waiting_bound(system, task, W_i, horizon=horizon)
    if math.isinf(b_w):
        return math.inf
    return b_w + task.G + 2 * task.eta * system.epsilon


def _server_interference(system: System, task: Task, window: float) -> float:
    """Last term of Eq (6): CPU demand of the GPU server on its own core.

      sum_{tau_j != tau_i, eta_j > 0}
          ceil((W + (D_j - (G_j^m + 2 eta_j eps))) / T_j) * (G_j^m + 2 eta_j eps)

    The (D_j - exec) term is the Lemma-5 self-suspension jitter of the server
    work generated by tau_j (the server suspends during CPU-inactive spans).
    """
    eps = system.epsilon
    total = 0.0
    for t in system.tasks:
        if t is task or not t.uses_gpu:
            continue
        exec_j = t.Gm + 2 * t.eta * eps
        jitter = max(t.D - exec_j, 0.0)
        total += ceil_div(window + jitter, t.T) * exec_j
    return total


def response_time(
    system: System,
    task: Task,
    hp_response: dict[str, float],
    *,
    use_deadline_jitter: bool = False,
) -> float:
    """Worst-case response time of ``task`` per Eq (5) (different core than the
    server) or Eq (6) (same core as the server).

    ``hp_response`` maps task name -> already-computed response time W_h for
    every higher-priority task (analysis proceeds in decreasing priority
    order).  Per the note under Lemma 5, D_h may be used instead of W_h; we do
    so when ``use_deadline_jitter`` or when W_h did not converge.
    """
    on_server_core = task.core == system.server_core
    horizon = task.D

    def jitter(h: Task) -> float:
        # (W_h - C_h) accounts for "the self-suspending effect of
        # higher-priority GPU-using tasks" (paper, proof of Thm 1).  A
        # CPU-only task never self-suspends, so it carries no jitter
        # (classic RTA; also the Chen et al. correction's scope).
        if not h.uses_gpu:
            return 0.0
        w_h = hp_response.get(h.name, math.inf)
        if use_deadline_jitter or math.isinf(w_h):
            w_h = h.D
        return max(w_h - h.C, 0.0)

    local_hp = [h for h in system.higher_prio(task, same_core=True)]

    w = task.C + gpu_handling_time(system, task, task.C, horizon=horizon)
    if math.isinf(w):
        return math.inf
    for _ in range(_MAX_ITERS):
        b_gpu = gpu_handling_time(system, task, w, horizon=horizon)
        if math.isinf(b_gpu):
            return math.inf
        nxt = task.C + b_gpu
        for h in local_hp:
            nxt += ceil_div(w + jitter(h), h.T) * h.C
        if on_server_core:
            nxt += _server_interference(system, task, w)
        if nxt > horizon:
            return math.inf
        if nxt <= w + 1e-12:
            return nxt
        w = nxt
    return math.inf


def fifo_waiting_bound(system: System, task: Task, W_i: float) -> float:
    """Beyond-paper (the paper's §7/Fig-15 future-work suggestion): the
    waiting bound when the GPU server's queue is FIFO-ordered instead of
    priority-ordered.

    Request-driven: when a request of tau_i enqueues, at most one earlier
    request of EVERY other task is ahead (later arrivals queue behind):
        B^rd = eta_i * sum_{x != i} max_k (G_{x,k} + eps)
    Job-driven: other tasks' total GPU demand during W_i bounds the same
    quantity; take the min (Eq (2)'s double-bound idea applies verbatim).
    """
    if not task.uses_gpu:
        return 0.0
    eps = system.epsilon
    others = [t for t in system.tasks if t is not task and t.uses_gpu]
    rd_one = sum(max((s.total + eps for s in t.segments), default=0.0)
                 for t in others)
    b_rd = task.eta * rd_one
    if math.isinf(W_i):
        return b_rd
    b_jd = sum((ceil_div(W_i, t.T) + 1) * sum(s.total + eps for s in t.segments)
               for t in others)
    return min(b_rd, b_jd)


def edf_waiting_bound(system: System, task: Task, W_i: float) -> float:
    """Beyond-paper: waiting bound for an EDF-ordered server queue (the
    ``dispatch.policy`` 'edf' ordering serving is already wired for).

    Only the ORDER-AGNOSTIC job-driven argument survives EDF: a request of
    tau_i can be overtaken by any request with an earlier absolute deadline,
    including ones that arrive after it, so the FIFO "at most one earlier
    request per other task" count does not hold.  What does hold for any
    work-conserving single-server queue: while tau_i's request waits, the
    server only serves requests of OTHER tasks that arrived inside tau_i's
    response window (plus one carry-in each) — the job-driven term of Eq (4)
    with eps per segment, exactly ``fifo_waiting_bound``'s second leg."""
    if not task.uses_gpu:
        return 0.0
    if math.isinf(W_i):
        return math.inf
    eps = system.epsilon
    return sum((ceil_div(W_i, t.T) + 1) * sum(s.total + eps for s in t.segments)
               for t in system.tasks if t is not task and t.uses_gpu)


def _analyze_ordered_server(system: System, waiting) -> "AnalysisResult":
    """Shared response-time recurrence for the non-priority server queue
    orderings; ``waiting(system, task, w)`` supplies the ordering-specific
    B_i^w term, everything else is Eqs (5)/(6) verbatim."""
    res = AnalysisResult()
    for task in sorted(system.tasks, key=lambda t: -t.priority):
        horizon = task.D
        local_hp = system.higher_prio(task, same_core=True)
        on_server_core = task.core == system.server_core

        def jitter(h: Task) -> float:
            if not h.uses_gpu:
                return 0.0
            w_h = res.response_times.get(h.name, math.inf)
            return max((h.D if math.isinf(w_h) else w_h) - h.C, 0.0)

        w = task.C
        converged = False
        for _ in range(_MAX_ITERS):
            b_w = waiting(system, task, w)
            b_gpu = (b_w + task.G + 2 * task.eta * system.epsilon
                     if task.uses_gpu else 0.0)
            nxt = task.C + b_gpu
            for h in local_hp:
                nxt += ceil_div(w + jitter(h), h.T) * h.C
            if on_server_core:
                nxt += _server_interference(system, task, w)
            if nxt > horizon:
                break
            if nxt <= w + 1e-12:
                converged = True
                w = nxt
                break
            w = nxt
        res.response_times[task.name] = w if converged else math.inf
        res.gpu_handling[task.name] = (
            waiting(system, task, res.response_times[task.name])
            + task.G + 2 * task.eta * system.epsilon
            if task.uses_gpu and converged else
            (math.inf if task.uses_gpu else 0.0))
        if not converged:
            res.schedulable = False
    return res


def analyze_fifo_server(system: System) -> "AnalysisResult":
    """Full-system analysis with the FIFO-ordered server: identical response
    time recurrences, FIFO waiting bound."""
    return _analyze_ordered_server(system, fifo_waiting_bound)


def analyze_edf_server(system: System) -> "AnalysisResult":
    """Full-system analysis with the EDF-ordered server: identical response
    time recurrences, order-agnostic (job-driven-only) waiting bound."""
    return _analyze_ordered_server(system, edf_waiting_bound)


@dataclass
class AnalysisResult:
    """Outcome of a full-system analysis."""

    response_times: dict[str, float] = field(default_factory=dict)
    gpu_handling: dict[str, float] = field(default_factory=dict)
    schedulable: bool = True

    def wcrt(self, name: str) -> float:
        return self.response_times[name]


def analyze(system: System, *, use_deadline_jitter: bool = False) -> AnalysisResult:
    """Analyze every task (decreasing priority order) under the server-based
    approach.  The system is schedulable iff every W_i <= D_i."""
    res = AnalysisResult()
    for task in sorted(system.tasks, key=lambda t: -t.priority):
        w = response_time(
            system, task, res.response_times, use_deadline_jitter=use_deadline_jitter
        )
        res.response_times[task.name] = w
        res.gpu_handling[task.name] = gpu_handling_time(
            system, task, w if not math.isinf(w) else task.D, horizon=task.D
        )
        if math.isinf(w) or w > task.D + 1e-9:
            res.schedulable = False
    return res


@dataclass
class PoolAnalysisResult:
    """Per-device analyses of a multi-accelerator pool, plus the merged
    view (stream names are globally unique, so the merge is a plain union)."""

    per_device: dict[int, AnalysisResult] = field(default_factory=dict)
    response_times: dict[str, float] = field(default_factory=dict)
    gpu_handling: dict[str, float] = field(default_factory=dict)
    schedulable: bool = True

    def wcrt(self, name: str) -> float:
        return self.response_times[name]


def analyze_pool(system: System, *,
                 use_deadline_jitter: bool = False) -> PoolAnalysisResult:
    """Per-server schedulability analysis of a multi-accelerator pool.

    Because stream-to-server assignment is partitioned (dispatch.ServerPool;
    ``allocation.allocate_pool`` builds core-disjoint device partitions),
    each server's queue contains only its own tasks and Eqs (1)-(6) apply
    verbatim WITHIN each device partition: ``System.subsystem(d)`` carves
    out device d's tasks plus its server core (and raises if a core is
    shared across partitions, which would invalidate the decomposition).
    The pool is schedulable iff every partition is.

    The bounds are also sound for the *batched* dispatcher (runtime
    ``dispatch.BatchingServer``, simulator mode 'server_batched'): batching
    only lets same-shape requests join the head request's device call —
    G^e/G^m and the 2*eps overhead are paid at most once per request, never
    more — so every per-request term in Eqs (1)-(6) still upper-bounds its
    batched counterpart (see ``amortized_server_overhead`` for the tighter
    overhead when a minimum batch size is guaranteed).

    CALIBRATED admission (``core.admission`` with a
    ``analysis.cost_model.StepCostModel``) re-prices each stream's GPU
    segments at ``min(declared, predicted-for-its-bucket)`` before this
    analysis runs.  Soundness is unchanged because every equation here is
    monotone non-decreasing in the G^e/G^m inputs: the bounds computed on
    calibrated costs dominate any execution whose device calls run within
    those calibrated costs, exactly as the declared-cost bounds dominate
    executions within declared costs.  What calibration changes is only
    WHICH cost vector is being promised — the measured per-bucket cost of
    the trace the stream actually runs in, rather than the full-width
    worst case (property-tested in tests/test_cost_model.py).
    """
    res = PoolAnalysisResult()
    for d in range(system.num_gpus):
        sub = analyze(system.subsystem(d),
                      use_deadline_jitter=use_deadline_jitter)
        res.per_device[d] = sub
        res.response_times.update(sub.response_times)
        res.gpu_handling.update(sub.gpu_handling)
        res.schedulable = res.schedulable and sub.schedulable
    return res


@dataclass
class FaultedAnalysisResult:
    """Recovery-augmented pool analysis under a device-fault schedule.

    ``phases[k]`` is the plain ``analyze_pool`` result of phase system S_k
    (S_0 = the original partitioned system; S_{k+1} applies fault k:
    every task of the dead device migrates to the failover target with the
    fault's recovery segment appended).  ``response_times`` carries the
    per-task recovery-augmented bound; ``recovery_delay`` its excess over
    the fault-free phase-0 bound."""

    phases: list[PoolAnalysisResult] = field(default_factory=list)
    response_times: dict[str, float] = field(default_factory=dict)
    recovery_delay: dict[str, float] = field(default_factory=dict)
    schedulable: bool = True

    def wcrt(self, name: str) -> float:
        return self.response_times[name]


def analyze_pool_under_faults(
    system: System, faults: list[DeviceFault], *,
    use_deadline_jitter: bool = False,
) -> FaultedAnalysisResult:
    """Per-task response-time bounds that survive a device-fault schedule.

    Failure model (``core.faults.DeviceFault``): at ``at_ms`` a device dies
    mid-work; ``detect_ms`` later every task assigned to it migrates to the
    single surviving target ``to``, and each migrated task pays one extra
    GPU request — the ``recovery`` segment, the re-prefill of its retained
    token prefix (priced by the calibrated cost model at the serving
    layer).  The single-target migration keeps the post-failure device
    partitions core-disjoint, so ``analyze_pool``'s per-server
    decomposition applies verbatim to every phase system.

    The bound for task tau_i is

        W_i^ft  =  sum_k W_i(S_k)  +  sum_{faults f that migrate tau_i} detect(f)

    which dominates any execution under the schedule: a job wholly inside
    phase k finishes within W_i(S_k); a job straddling the k -> k+1
    boundary waited at most W_i(S_k) before the fault, then the detection
    gap, and its residual work — re-issued on the target including the
    recovery re-prefill — is no more than a fresh job of the *augmented*
    task, which S_{k+1} bounds by W_i(S_{k+1}).  Each phase term appears at
    most once per job, so the sum (plus the detection gaps this task
    actually suffers) covers every case.  It is deliberately conservative
    — the price of keeping Eqs (1)-(6) untouched inside each phase.

    The companion simulator (``core.simulator.simulate(..., faults=)``)
    replays the same schedule with strictly *weaker* semantics (recovery
    cost folded into the re-submitted segment, no extra server invocation),
    so this bound must dominate simulated WCRT — property-tested in
    tests/test_simulator_property.py.
    """
    res = FaultedAnalysisResult()
    phase_tasks: list[list[Task]] = [list(system.tasks)]
    detect = {t.name: 0.0 for t in system.tasks}
    for f in sorted(faults, key=lambda f: f.at_ms):
        nxt = []
        for t in phase_tasks[-1]:
            if t.device == f.device:
                segs = ((*t.segments, f.recovery) if f.recovery.total > 0
                        else t.segments)
                nxt.append(replace(t, device=f.to, segments=segs))
                detect[t.name] += f.detect_ms
            else:
                nxt.append(t)
        phase_tasks.append(nxt)
    for pt in phase_tasks:
        res.phases.append(analyze_pool(
            replace(system, tasks=list(pt)),
            use_deadline_jitter=use_deadline_jitter))
    for t in system.tasks:
        total = detect[t.name]
        for ph in res.phases:
            total += ph.response_times.get(t.name, 0.0)
        res.response_times[t.name] = total
        res.recovery_delay[t.name] = (
            total - res.phases[0].response_times.get(t.name, 0.0))
        if math.isinf(total) or total > t.D + 1e-9:
            res.schedulable = False
    return res


@dataclass
class MigratedAnalysisResult:
    """Migration-augmented pool analysis under a planned-migration schedule.

    ``phases[k]`` is the plain ``analyze_pool`` result of phase system S_k
    (S_0 = the original partitioned system; S_{k+1} applies migration k:
    the one named task moves to its destination device/core with the
    migration-cost segment appended).  ``response_times`` carries the
    per-task migration-augmented bound; ``migration_delay`` its excess
    over the migration-free phase-0 bound."""

    phases: list[PoolAnalysisResult] = field(default_factory=list)
    response_times: dict[str, float] = field(default_factory=dict)
    migration_delay: dict[str, float] = field(default_factory=dict)
    schedulable: bool = True

    def wcrt(self, name: str) -> float:
        return self.response_times[name]


def analyze_pool_under_migrations(
    system: System, migrations: list[StreamMigration], *,
    use_deadline_jitter: bool = False,
) -> MigratedAnalysisResult:
    """Per-task response-time bounds that survive a planned-migration
    schedule (work stealing / consolidation / elastic drain).

    Migration model (``core.migration.StreamMigration``): at ``at_ms`` one
    task is reassigned to device ``to`` on destination core ``core``
    (``-1`` keeps its current core), and its next job additionally pays the
    one-time ``cost`` segment — the gather/copy/scatter of its live KV
    blocks.  Unlike a fault there is no detection gap (the move is
    initiated by the pool, not discovered), and only the named task moves.
    The event carries its destination core so the phase partitions stay
    core-disjoint and ``analyze_pool``'s per-server decomposition applies
    verbatim to every phase system.

    The bound for task tau_i is

        W_i^mig  =  sum_k W_i(S_k)

    which dominates any execution under the schedule, by the same
    straddle-job argument ``analyze_pool_under_faults`` documents: a job
    wholly inside phase k finishes within W_i(S_k); a job of the migrated
    task straddling the k -> k+1 boundary waited at most W_i(S_k) before
    the move, and its remaining work — resumed on the destination with the
    migration copy folded in — is no more than a fresh job of the
    *augmented* task, which S_{k+1} bounds by W_i(S_{k+1}).  For a
    non-migrated task at the SOURCE server, the straddling job's residual
    interference is within the carry-in terms Eqs (3)/(4) already charge
    (one extra request per interfering task, and the lower-priority
    blocking term eta_i * lp_max present in both legs of Eq (2)); at the
    destination the augmented task is a member of S_{k+1} outright.
    Appending the cost segment to every later phase (rather than one job)
    is deliberately conservative, mirroring the recovery-segment treatment
    in the faults analysis.

    The companion simulator (``core.simulator.simulate(..., migrations=)``)
    replays the same schedule with strictly *weaker* semantics (job-
    granularity placement, cost folded once into the first post-move job),
    so this bound must dominate simulated WCRT — property-tested in
    tests/test_migration.py.
    """
    res = MigratedAnalysisResult()
    phase_tasks: list[list[Task]] = [list(system.tasks)]
    for m in sorted(migrations, key=lambda m: m.at_ms):
        nxt = []
        for t in phase_tasks[-1]:
            if t.name == m.task:
                segs = ((*t.segments, m.cost) if m.cost.total > 0
                        else t.segments)
                core = m.core if m.core >= 0 else t.core
                nxt.append(replace(t, device=m.to, core=core,
                                   segments=segs))
            else:
                nxt.append(t)
        phase_tasks.append(nxt)
    for pt in phase_tasks:
        res.phases.append(analyze_pool(
            replace(system, tasks=list(pt)),
            use_deadline_jitter=use_deadline_jitter))
    for t in system.tasks:
        total = 0.0
        for ph in res.phases:
            total += ph.response_times.get(t.name, 0.0)
        res.response_times[t.name] = total
        res.migration_delay[t.name] = (
            total - res.phases[0].response_times.get(t.name, 0.0))
        if math.isinf(total) or total > t.D + 1e-9:
            res.schedulable = False
    return res


def amortized_server_overhead(task: Task, epsilon: float,
                              min_batch: int = 1) -> float:
    """Lemma 1's per-job server overhead, 2*eta_i*eps, amortized by batched
    dispatch: when the dispatcher guarantees every request of tau_i rides a
    device call coalescing >= ``min_batch`` requests, the per-request share
    drops to 2*eps/min_batch.  With min_batch=1 (no guarantee) this is
    exactly the term Eq (1) uses — the default, and the only value that is
    sound unconditionally; larger values are an OPTIMISTIC what-if for
    capacity planning, not a schedulability bound."""
    if min_batch < 1:
        raise ValueError(f"min_batch must be >= 1, got {min_batch}")
    return 2.0 * task.eta * epsilon / min_batch
