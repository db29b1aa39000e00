"""Pluggable execution-time models: what does each released job cost?

A model prices one job of a task — its normal-segment CPU time ``C`` and
its GPU segments — given the task's DECLARED worst case.  The invariant
every registered model MUST keep (and :func:`check_within_declared`
verifies): per-job costs never exceed the declared WCET, segment by
segment, and the segment count is unchanged.  The analyses price the
declared worst case, and Eqs (1)-(6) are monotone non-decreasing in every
C/G input, so any execution within declared costs is dominated by the
declared-cost bound — exactly the argument calibrated admission already
leans on (``analysis/cost_model.StepCostModel.recost``).

The ``measured`` model closes the loop to real timings: it prices each GPU
segment from a :class:`~repro_torch.analysis.cost_model.StepCostModel` cell
surface — the per-shape-cell Welford aggregates of real timed device calls
— at ``min(declared, safety * predicted)``, so simulated executions run at
the speeds the hardware was actually measured at while the declared bound
stays a sound ceiling.

Registering a new model::

    @ETM.register("my_etm")
    class MyEtm:
        def __init__(self, **config_params): ...
        def costs(self, task, job_index, rng) -> tuple[float, tuple[GpuSegment, ...]]: ...
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Mapping, Sequence

from repro_torch.core.task_model import GpuSegment, Task

from .registry import Registry

__all__ = ["ETM", "check_within_declared"]

ETM = Registry("execution-time model")


def check_within_declared(task: Task, C: float,
                          segments: Sequence[GpuSegment]) -> None:
    """Raise if a job's costs exceed the task's declared worst case."""
    if C > task.C + 1e-9:
        raise ValueError(f"{task.name}: job C={C} > declared {task.C}")
    if len(segments) != task.eta:
        raise ValueError(
            f"{task.name}: {len(segments)} segments != declared eta={task.eta}")
    for k, (got, decl) in enumerate(zip(segments, task.segments)):
        if got.e > decl.e + 1e-9 or got.m > decl.m + 1e-9:
            raise ValueError(
                f"{task.name} segment {k}: job ({got.e}, {got.m}) exceeds "
                f"declared ({decl.e}, {decl.m})")


def _scaled(task: Task, scale: float) -> tuple[float, tuple[GpuSegment, ...]]:
    if not (0.0 < scale <= 1.0):
        raise ValueError(f"{task.name}: ETM scale {scale} outside (0, 1]")
    if scale == 1.0:
        return task.C, task.segments
    return (task.C * scale,
            tuple(replace(s, e=s.e * scale, m=s.m * scale)
                  for s in task.segments))


@ETM.register("constant")
class Constant:
    """Every job runs exactly at the declared WCET (the paper's §6.3
    experiments; the legacy simulator's only behavior)."""

    def costs(self, task: Task, job_index: int, rng):
        return task.C, task.segments


@ETM.register("table")
class Table:
    """Per-task scale table: job cost = declared * scales[name] (clamped to
    (0, 1]); tasks absent from the table run at ``default`` scale."""

    def __init__(self, scales: Mapping[str, float] | None = None,
                 default: float = 1.0):
        self.scales = dict(scales or {})
        self.default = default

    def costs(self, task: Task, job_index: int, rng):
        return _scaled(task, self.scales.get(task.name, self.default))


@ETM.register("uniform")
class Uniform:
    """Per-job random scale drawn U[frac]: actual execution times vary
    between ``frac[0]`` and ``frac[1]`` of the declared worst case."""

    def __init__(self, frac: tuple[float, float] = (0.5, 1.0)):
        lo, hi = frac
        if not (0.0 < lo <= hi <= 1.0):
            raise ValueError(f"need 0 < lo <= hi <= 1, got {frac}")
        self.frac = (lo, hi)

    def costs(self, task: Task, job_index: int, rng):
        return _scaled(task, rng.uniform(*self.frac))


@ETM.register("measured")
class Measured:
    """GPU segments priced from MEASURED step costs: each segment runs at
    ``min(declared, safety * cost_model.predict(cell))`` — the same
    calibrated re-pricing rule as ``StepCostModel.recost`` — so the
    simulated trace executes at the speeds real timed device calls ran at
    (committed in BENCH_cost_model.json or ingested live from
    ``ServerPool.cell_stats()``).

    ``cell`` names the shape cell every segment of every task maps to;
    ``cells`` optionally overrides per task name.  An unmeasured phase
    predicts ``inf`` and degrades to the declared cost — an empty model is
    exactly the ``constant`` ETM.  Normal-segment CPU time stays declared
    (the cost model prices device calls, not client CPU)."""

    def __init__(self, cost_model=None, cell: Sequence = ("decode", 4, 64),
                 cells: Mapping[str, Sequence] | None = None,
                 safety: float = 1.2):
        if cost_model is None:
            raise ValueError(
                "etm 'measured' needs a StepCostModel: pass cost_model= to "
                "scenario build()/run() (e.g. ingested from "
                "ServerPool.cell_stats() or loaded from BENCH_cost_model.json)")
        self.cost_model = cost_model
        self.cell = tuple(cell)
        self.cells = {k: tuple(v) for k, v in (cells or {}).items()}
        self.safety = safety

    def costs(self, task: Task, job_index: int, rng):
        if not task.segments:
            return task.C, task.segments
        cell = self.cells.get(task.name, self.cell)
        pred_ms = self.cost_model.predict(*cell) * self.safety * 1e3
        segs = []
        for seg in task.segments:
            if not pred_ms < seg.total or not math.isfinite(pred_ms):
                segs.append(seg)
                continue
            scale = pred_ms / seg.total
            segs.append(replace(seg, e=seg.e * scale, m=seg.m * scale))
        return task.C, tuple(segs)
