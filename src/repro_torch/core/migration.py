"""Planned (non-failure) stream migration: the analysis/simulator-level
description of a live cross-server move.

This is the performance twin of :mod:`repro_torch.core.faults`: where a
:class:`~repro_torch.core.faults.DeviceFault` describes an *involuntary* loss of
a device (detection gap, re-prefill recovery, every resident task
displaced), a :class:`StreamMigration` describes a *voluntary* move of ONE
task — work stealing, consolidation, or an elastic drain — with no
detection gap and a one-time migration cost (the gather→host→scatter copy
of its live KV blocks).

Three layers consume this module:

  * the RUNTIME (``serving.engine`` + ``core.dispatch.pool``) performs the
    real move: ``ServeEngine._execute_migration`` copies the blocks,
    ``ServerPool`` rebinds the stream, decode resumes on the destination
    bit-identically;
  * the SIMULATOR (``core.simulator`` via ``migrations=``) replays a
    schedule at job granularity: every job of the migrated task released
    at or after ``at_ms`` runs on device ``to`` / core ``core``, and the
    ``cost`` segment is folded into the first such job once;
  * the ANALYSIS (``core.server_analysis.analyze_pool_under_migrations``)
    prices the same schedule into a migration-delay-augmented bound that
    is property-tested to dominate the simulated WCRT.

The destination CPU core is part of the event itself (not chosen
independently by each consumer) so simulator and analysis agree on
placement and the post-move partitions stay core-disjoint — the same
discipline ``DeviceFault.to`` follows for the failover target.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from .task_model import GpuSegment, System

__all__ = ["StreamMigration", "seeded_stream_migrations"]


@dataclass(frozen=True)
class StreamMigration:
    """One planned migration event for the simulator/analysis pair.

    At ``at_ms`` task ``task`` is reassigned from its current device to
    device ``to``; its next job (the first released at or after ``at_ms``)
    additionally carries the one-time ``cost`` segment — the block
    gather/copy/scatter the runtime performs before decode resumes.

    ``core`` is the destination CPU core for the task's normal segments
    (``-1`` keeps its current core, legal only when that core already
    belongs to the destination partition).  Carrying the core in the event
    keeps simulated and analyzed placement identical.
    """

    task: str
    at_ms: float
    to: int
    cost: GpuSegment = field(default_factory=lambda: GpuSegment(0.0, 0.0))
    core: int = -1

    def __post_init__(self) -> None:
        if self.at_ms < 0:
            raise ValueError("at_ms must be >= 0")
        if self.to < 0:
            raise ValueError("to must be a valid device index")


def _dest_core(system: System, placement: dict[str, tuple[int, int]],
               dest: int) -> int:
    """Least-loaded CPU core of the destination partition (ties by index):
    the cores of tasks currently placed on ``dest`` plus its server core."""
    cores = {c for _, (d, c) in placement.items() if d == dest}
    cores.add(system.server_cores[dest])
    load = {c: 0.0 for c in cores}
    for t in system.tasks:
        d, c = placement[t.name]
        if c in load:
            load[c] += t.C / t.T
    return min(sorted(load), key=lambda c: (load[c], c))


def seeded_stream_migrations(system: System, seed: int, *,
                             num_migrations: int = 1, horizon_ms: float,
                             cost_scale: float = 0.25
                             ) -> list[StreamMigration]:
    """Deterministic random migration schedule for a multi-device system:
    move ``num_migrations`` GPU-using tasks to seeded-random other devices
    at seeded-random instants, each landing on the least-loaded CPU core
    of its destination partition (so the post-move system stays
    core-disjoint and ``analyze_pool`` still decomposes).  The migration
    cost is priced at ``cost_scale`` x the largest single GPU segment in
    the system — a stand-in for the gather/copy/scatter of the longest
    live block list, which is far cheaper than a re-prefill."""
    rng = random.Random(seed)
    if system.num_gpus < 2:
        raise ValueError("migration needs at least 2 devices")
    placement = {t.name: (t.device, t.core) for t in system.tasks}
    seg_max = max((s.total for t in system.tasks for s in t.segments),
                  default=0.0)
    cost = GpuSegment(e=0.9 * seg_max * cost_scale,
                      m=0.1 * seg_max * cost_scale)
    migrations: list[StreamMigration] = []
    t_ms = 0.0
    for _ in range(num_migrations):
        cand = sorted(t.name for t in system.tasks if t.uses_gpu)
        if not cand:
            break
        victim = rng.choice(cand)
        src = placement[victim][0]
        dest = rng.choice([d for d in range(system.num_gpus) if d != src])
        core = _dest_core(system, placement, dest)
        t_ms += rng.uniform(0.1, 0.4) * horizon_ms / max(num_migrations, 1)
        migrations.append(StreamMigration(task=victim, at_ms=t_ms, to=dest,
                                          cost=cost, core=core))
        placement[victim] = (dest, core)
    return migrations
