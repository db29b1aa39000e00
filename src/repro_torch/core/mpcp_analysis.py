"""Schedulability analysis for the synchronization-based approach under MPCP.

The paper (§6.3) evaluates the synchronization-based baseline with the MPCP
analysis of Lakshmanan et al. [28] ("Coordinated task scheduling, allocation
and synchronization on multiprocessors", RTSS'09), modified per the
self-suspension corrections of Chen et al. [13].

Model recap (paper §4): the GPU is a single mutex; a GPU access segment is a
critical section executed *entirely on the CPU* (busy-wait) at the boosted
global priority ceiling pi_B + pi_i.  Waiting for the lock itself is
suspension-based (footnote 2).  Hence:

  * CPU demand of tau_i on its own core:  C_i + G_i  (busy-wait).
  * Remote blocking (lock wait) per request: priority-queued with
    non-preemptive lower-priority holder — the same recurrence structure as
    the paper's Eq (3) with eps = 0:

        B^{w,0}   = max_{pi_l < pi_i, k} G_{l,k}
        B^{w,n+1} = max_{pi_l < pi_i, k} G_{l,k}
                    + sum_{pi_h > pi_i} sum_k (ceil(B^{w,n}/T_h) + 1) G_{h,k}

    The total is request-driven only: B_i^remote = eta_i * B^w.  (The paper
    observes this is exactly where [28] is pessimistic: "it computes an upper
    bound by the sum of the maximum per-request delay, similarly to the
    request-driven analysis shown in Eq. 3" — we keep that pessimism to stay
    faithful to the baseline used in the paper.)
  * Local blocking: lower-priority tasks on tau_i's core execute their GPU
    critical sections at boosted priority (> any normal priority), so every
    such gcs instance in the window preempts tau_i:

        B_i^local = sum_{l in P(i), pi_l < pi_i} (ceil(W/T_l) + 1) * G_l

    (G_l is all-CPU busy-wait time under this model.)
  * Higher-priority interference on the local core, with the Chen/Bletsas
    suspension-aware jitter (hp tasks suspend while waiting for the lock):
    ceil((W + (D_h - (C_h + G_h))) / T_h) * (C_h + G_h).

Fidelity note (also in DESIGN.md §4): a clause-by-clause reconstruction of
[28] is not possible from the paper text alone; the above is the standard
form of that analysis with the paper's stated corrections, and is validated
against the discrete-event simulator (analysis bound >= simulated response
time) in tests/test_simulator_property.py.
"""

from __future__ import annotations

import math

from .server_analysis import AnalysisResult
from .task_model import System, Task, ceil_div

__all__ = ["remote_blocking_per_request", "response_time", "analyze"]

_MAX_ITERS = 10_000


def remote_blocking_per_request(system: System, task: Task, *, horizon: float) -> float:
    """Per-request lock-waiting bound under MPCP (priority-ordered queue)."""
    if not task.uses_gpu:
        return 0.0
    first = max(
        (seg.total for t in system.lower_prio(task) for seg in t.segments),
        default=0.0,
    )
    b = first
    for _ in range(_MAX_ITERS):
        hp = 0.0
        for h in system.higher_prio(task):
            if h.uses_gpu:
                hp += (ceil_div(b, h.T) + 1) * h.G
        nxt = first + hp
        if nxt > horizon:
            return math.inf
        if nxt <= b + 1e-12:
            return nxt
        b = nxt
    return math.inf


def _local_boost_blocking(system: System, task: Task, window: float) -> float:
    """Boosted-priority gcs preemptions by local lower-priority tasks."""
    total = 0.0
    for l in system.lower_prio(task, same_core=True):
        if l.uses_gpu:
            total += (ceil_div(window, l.T) + 1) * l.G
    return total


def response_time(system: System, task: Task, *, use_deadline_jitter: bool = True) -> float:
    """WCRT of ``task`` under the synchronization-based approach with MPCP."""
    horizon = task.D
    b_remote_one = remote_blocking_per_request(system, task, horizon=horizon)
    if math.isinf(b_remote_one):
        return math.inf
    b_remote = task.eta * b_remote_one

    local_hp = system.higher_prio(task, same_core=True)

    w = task.C + task.G + b_remote
    if w > horizon:
        return math.inf
    for _ in range(_MAX_ITERS):
        nxt = task.C + task.G + b_remote + _local_boost_blocking(system, task, w)
        for h in local_hp:
            demand = h.C + h.G  # busy-wait: gcs consumes CPU
            # suspension-aware jitter (Chen et al.) — only GPU-using tasks
            # self-suspend (while waiting for the lock)
            jitter = max(h.D - demand, 0.0) if h.uses_gpu else 0.0
            nxt += ceil_div(w + jitter, h.T) * demand
        if nxt > horizon:
            return math.inf
        if nxt <= w + 1e-12:
            return nxt
        w = nxt
    return math.inf


def analyze(system: System) -> AnalysisResult:
    res = AnalysisResult()
    for task in sorted(system.tasks, key=lambda t: -t.priority):
        w = response_time(system, task)
        res.response_times[task.name] = w
        if math.isinf(w) or w > task.D + 1e-9:
            res.schedulable = False
    return res
