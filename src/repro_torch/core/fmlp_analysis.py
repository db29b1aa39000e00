"""Schedulability analysis for the synchronization-based approach under FMLP+.

The paper evaluates FMLP+ with "the FMLP+ analysis for preemptive partitioned
fixed-priority scheduling given in Section 6.4.3 of [10]" (Brandenburg's
thesis), corrected per Chen et al. [13].

FMLP+ model: the GPU mutex queue is FIFO; the lock holder runs its critical
section with (restricted) priority boosting; GPU critical sections busy-wait
on the CPU (paper §4.2); waiting for the lock suspends.

Blocking bounds implemented:

  * Remote blocking, request-driven: under FIFO, when a request of tau_i is
    enqueued, at most ONE earlier request of EVERY other task can be ahead of
    it (later requests queue behind).  Hence per request:

        B^{rd-one} = sum_{x != i, eta_x > 0} max_k G_{x,k}
        B_i^{rd}   = eta_i * B^{rd-one}

  * Remote blocking, job-driven: over the whole response window W_i, the
    GPU work other tasks can generate is bounded by their job arrivals:

        B_i^{jd} = sum_{x != i, eta_x > 0} (ceil(W_i/T_x) + 1) * G_x

    We take min(B_i^rd, B_i^jd) — the same double-bounding idea the paper
    applies to its own server analysis (Eq (2)); Brandenburg's holistic
    analysis subsumes both, and taking the min keeps the baseline from being
    strawmanned (the paper notes FMLP+ generally beats MPCP, which this
    reproduces).

  * Local blocking: boosted lower-priority critical sections on tau_i's core,
    identical in form to the MPCP case.

  * Higher-priority local interference with suspension-aware jitter,
    (C_h + G_h) demand (busy-wait), as under MPCP.

Fidelity note: see DESIGN.md §4 — validated against the discrete-event
simulator property tests.
"""

from __future__ import annotations

import math

from .server_analysis import AnalysisResult
from .task_model import System, Task, ceil_div

__all__ = ["response_time", "analyze"]

_MAX_ITERS = 10_000


def _fifo_request_driven(system: System, task: Task) -> float:
    one = sum(
        max((seg.total for seg in t.segments), default=0.0)
        for t in system.tasks
        if t is not task and t.uses_gpu
    )
    return task.eta * one


def _fifo_job_driven(system: System, task: Task, window: float) -> float:
    total = 0.0
    for t in system.tasks:
        if t is task or not t.uses_gpu:
            continue
        total += (ceil_div(window, t.T) + 1) * t.G
    return total


def _local_boost_blocking(system: System, task: Task, window: float) -> float:
    total = 0.0
    for l in system.lower_prio(task, same_core=True):
        if l.uses_gpu:
            total += (ceil_div(window, l.T) + 1) * l.G
    return total


def response_time(system: System, task: Task) -> float:
    """WCRT of ``task`` under the synchronization-based approach with FMLP+."""
    horizon = task.D
    b_rd = _fifo_request_driven(system, task)
    local_hp = system.higher_prio(task, same_core=True)

    w = task.C + task.G
    if w > horizon:
        return math.inf
    for _ in range(_MAX_ITERS):
        b_remote = min(b_rd, _fifo_job_driven(system, task, w)) if task.uses_gpu else 0.0
        nxt = task.C + task.G + b_remote + _local_boost_blocking(system, task, w)
        for h in local_hp:
            demand = h.C + h.G
            # suspension-aware jitter only for tasks that self-suspend
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
