"""Pluggable CPU schedulers: how are task priorities assigned?

The execution substrate is partitioned fixed-priority scheduling (the
paper's setting), so a "scheduler" here is a priority-assignment policy
over the generated taskset; the server's QUEUE ordering (priority / FIFO /
EDF) is the protocol's axis and reuses ``dispatch.policy.request_key``
verbatim — one definition of request order across the runtime, the
simulator, and the scenario engine.

Registering a new policy::

    @SCHEDULERS.register("my_order")
    class MyOrder:
        def assign(self, tasks) -> list[Task]: ...   # unique priorities
"""

from __future__ import annotations

from repro_torch.core.dispatch.policy import ORDERINGS
from repro_torch.core.task_model import Task
from repro_torch.core.taskset_gen import assign_rm_priorities

from .registry import Registry

__all__ = ["SCHEDULERS", "ORDERINGS"]

SCHEDULERS = Registry("scheduler")


@SCHEDULERS.register("rm")
class RateMonotonic:
    """Rate-Monotonic: shorter period = higher priority (the paper's
    assignment, arbitrary tie-break by index)."""

    def assign(self, tasks: list[Task]) -> list[Task]:
        return assign_rm_priorities(tasks)


@SCHEDULERS.register("dm")
class DeadlineMonotonic:
    """Deadline-Monotonic: shorter relative deadline = higher priority
    (optimal for constrained deadlines; coincides with RM when D = T)."""

    def assign(self, tasks: list[Task]) -> list[Task]:
        order = sorted(range(len(tasks)), key=lambda k: (tasks[k].D, k))
        out = list(tasks)
        n = len(tasks)
        for rank, k in enumerate(order):
            out[k] = out[k].with_priority(n - rank)
        return out


@SCHEDULERS.register("given")
class AsGiven:
    """Keep the priorities the taskset already carries (case studies with
    hand-assigned priorities); validates uniqueness."""

    def assign(self, tasks: list[Task]) -> list[Task]:
        prios = [t.priority for t in tasks]
        if len(set(prios)) != len(prios):
            raise ValueError("scheduler 'given' needs unique task priorities")
        return list(tasks)
