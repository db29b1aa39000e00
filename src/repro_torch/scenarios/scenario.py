"""The frozen :class:`Scenario` config and its build()/run() entry points.

A scenario fully describes one experiment as DATA — registry keys plus
parameters — instead of a code path:

    Scenario(
        name="flash_crowd",
        seed=7,
        taskset={"num_cores": 2, "num_tasks": (4, 8)},     # GenParams kwargs
        arrivals=("bursty", {"p_enter": 0.05, "p_exit": 0.2}),
        etm=("uniform", {"frac": (0.6, 1.0)}),
        overheads="constant",
        protocol="server_batched",
        scheduler="rm",
        num_devices=2, cores_per_device=2,
        allocator="wfd",                                    # or "lp"
    )

``build()`` resolves every key through its registry and returns a
:class:`BuiltScenario` (system + release trace + per-job cost hooks +
analysis); ``run()`` additionally simulates and pairs every task's
analysis bound with its simulated WCRT.  All randomness — taskset
generation, arrival gaps, per-job execution times, fault instants — is
derived from the scenario's single ``seed`` through named sub-streams, so
the same config + seed replays a bit-identical trace (property-tested).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

from repro_torch.core import server_analysis, simulator
from repro_torch.core.allocation import allocate, allocate_pool
from repro_torch.core.faults import DeviceFault, seeded_device_faults
from repro_torch.core.migration import StreamMigration, seeded_stream_migrations
from repro_torch.core.task_model import GpuSegment, System, Task
from repro_torch.core.taskset_gen import GenParams, generate_taskset

from .arrivals import ARRIVALS, check_min_separation
from .etm import ETM, check_within_declared
from .lp_alloc import allocate_lp
from .overheads import OVERHEADS
from .protocols import PROTOCOLS, Protocol
from .registry import RegistryError
from .schedulers import SCHEDULERS

__all__ = ["Scenario", "BuiltScenario", "ScenarioResult", "build", "run",
           "rng_stream"]

Spec = tuple[str, dict]

# registry entries that receive the build-time cost model automatically
_NEEDS_COST_MODEL = {"measured"}


def rng_stream(seed: int, label: str) -> random.Random:
    """One named deterministic sub-stream of the scenario seed.  String
    seeding is version-stable in CPython, so every consumer (taskset
    generation, each task's arrivals, each task's per-job costs, faults)
    draws from its own reproducible stream regardless of call order."""
    return random.Random(f"{seed}/{label}")


def _spec(x: Any) -> Spec:
    """Normalize a registry spec: "key" or (key, params) -> (key, dict)."""
    if isinstance(x, str):
        return (x, {})
    key, params = x
    return (str(key), dict(params or {}))


@dataclass(frozen=True)
class Scenario:
    """A complete, declarative description of one run.

    Fields (all registry keys resolve at ``build()`` time):

    * ``taskset`` — ``GenParams`` kwargs for the §6.3 generator.
    * ``arrivals`` / ``etm`` / ``overheads`` — registry key or
      ``(key, params)`` pairs.
    * ``protocol`` — access-control protocol (simulator mode + analysis +
      allocation approach in lockstep).
    * ``scheduler`` — priority-assignment policy.
    * ``num_devices`` / ``cores_per_device`` — pool shape (sync protocols
      are single-device; ``cores_per_device=None`` uses the generator's
      ``num_cores``).
    * ``allocator`` — packing heuristic ("wfd"/"ffd"/"bfd") or "lp" (the
      LP-relaxation baseline).
    * ``num_faults`` — replayed device-death schedule (server protocols,
      pools only), seeded from the scenario seed.
    * ``num_migrations`` — replayed planned-migration schedule (work
      stealing / consolidation at the analysis level; server protocols,
      pools only), seeded from the scenario seed;
      ``migration_cost_scale`` prices each move relative to the largest
      GPU segment (see ``core.migration.seeded_stream_migrations``).
    """

    name: str
    seed: int = 0
    taskset: Mapping[str, Any] = field(default_factory=dict)
    arrivals: Any = "periodic"
    etm: Any = "constant"
    overheads: Any = "constant"
    protocol: str = "server"
    scheduler: str = "rm"
    num_devices: int = 1
    cores_per_device: int | None = None
    allocator: str = "wfd"
    horizon_periods: float = 3.0
    batch_max: int = 4
    num_faults: int = 0
    fault_detect_ms: float = 1.0
    fault_recovery_scale: float = 1.0
    num_migrations: int = 0
    migration_cost_scale: float = 0.25
    trace: bool = False

    def __post_init__(self) -> None:
        object.__setattr__(self, "taskset", dict(self.taskset))
        for fld in ("arrivals", "etm", "overheads"):
            object.__setattr__(self, fld, _spec(getattr(self, fld)))
        for registry, key in ((ARRIVALS, self.arrivals[0]),
                              (ETM, self.etm[0]),
                              (OVERHEADS, self.overheads[0]),
                              (PROTOCOLS, self.protocol),
                              (SCHEDULERS, self.scheduler)):
            if key not in registry:
                raise RegistryError(
                    f"scenario {self.name!r}: unknown {registry.kind} "
                    f"{key!r}; available: {registry.available()}")
        if self.num_devices < 1:
            raise ValueError(f"{self.name}: num_devices must be >= 1")
        if self.num_faults < 0:
            raise ValueError(f"{self.name}: num_faults must be >= 0")
        if self.num_faults >= self.num_devices and self.num_faults > 0:
            raise ValueError(
                f"{self.name}: cannot kill {self.num_faults} of "
                f"{self.num_devices} devices")
        if self.num_migrations < 0:
            raise ValueError(f"{self.name}: num_migrations must be >= 0")
        if self.num_migrations and self.num_devices < 2:
            raise ValueError(
                f"{self.name}: migration replay needs >= 2 devices")
        if self.num_migrations and self.num_faults:
            raise ValueError(
                f"{self.name}: fault and migration replay are separate "
                "phase systems; use one per scenario")

    def config(self) -> dict:
        """JSON-able echo of the full config (the BENCH_*.json convention)."""
        return {
            "name": self.name,
            "seed": self.seed,
            "taskset": {k: list(v) if isinstance(v, tuple) else v
                        for k, v in self.taskset.items()},
            "arrivals": [self.arrivals[0], self.arrivals[1]],
            "etm": [self.etm[0],
                    {k: v for k, v in self.etm[1].items()
                     if k != "cost_model"}],
            "overheads": [self.overheads[0],
                          {k: v for k, v in self.overheads[1].items()
                           if k != "cost_model"}],
            "protocol": self.protocol,
            "scheduler": self.scheduler,
            "num_devices": self.num_devices,
            "cores_per_device": self.cores_per_device,
            "allocator": self.allocator,
            "horizon_periods": self.horizon_periods,
            "batch_max": self.batch_max,
            "num_faults": self.num_faults,
            "fault_detect_ms": self.fault_detect_ms,
            "num_migrations": self.num_migrations,
            "migration_cost_scale": self.migration_cost_scale,
        }


@dataclass
class BuiltScenario:
    """Everything needed to simulate and analyze one scenario."""

    scenario: Scenario
    protocol: Protocol
    system: System
    horizon_ms: float
    releases: dict[str, list[float]]
    etm: Callable[[Task, int], tuple[float, tuple[GpuSegment, ...]]]
    faults: list[DeviceFault]
    migrations: list[StreamMigration] = field(default_factory=list)

    def simulate(self, *, trace: bool | None = None) -> simulator.SimResult:
        return simulator.simulate(
            self.system,
            mode=self.protocol.sim_mode,
            horizon_ms=self.horizon_ms,
            trace=self.scenario.trace if trace is None else trace,
            batch_max=self.scenario.batch_max,
            faults=self.faults or None,
            migrations=self.migrations or None,
            releases=self.releases,
            etm=self.etm,
        )

    def analyze(self):
        """The protocol's response-time bounds; a replayed-fault scenario
        prices the recovery-augmented bound, a replayed-migration scenario
        the migration-delay-augmented one."""
        if self.faults:
            return server_analysis.analyze_pool_under_faults(
                self.system, self.faults)
        if self.migrations:
            return server_analysis.analyze_pool_under_migrations(
                self.system, self.migrations)
        return self.protocol.analyze(self.system)


@dataclass
class ScenarioResult:
    """One run's outcome: per-task analysis bound vs simulated WCRT."""

    scenario: Scenario
    system: System
    analysis: object
    sim: simulator.SimResult
    bounds: dict[str, float]
    wcrt: dict[str, float]
    schedulable: bool
    any_miss: bool

    def summary(self) -> dict:
        """One JSON cell for BENCH_scenarios.json: config echo + per-task
        bound/WCRT pairs (ms)."""
        per_task = [
            {"task": name,
             "device": next(t.device for t in self.system.tasks
                            if t.name == name),
             "bound_ms": None if math.isinf(b) else round(b, 6),
             "wcrt_ms": round(self.wcrt.get(name, 0.0), 6)}
            for name, b in sorted(self.bounds.items())
        ]
        finite = [(b["bound_ms"], b["wcrt_ms"]) for b in per_task
                  if b["bound_ms"] is not None]
        return {
            "scenario": self.scenario.name,
            "config": self.scenario.config(),
            "num_tasks": len(self.system.tasks),
            "schedulable": self.schedulable,
            "any_miss": self.any_miss,
            "max_wcrt_ms": round(max(self.wcrt.values(), default=0.0), 6),
            "min_bound_slack_ms": (
                round(min(b - w for b, w in finite), 6) if finite else None),
            "per_task": per_task,
        }


def build(scenario: Scenario, *, tasks: list[Task] | None = None,
          cost_model=None) -> BuiltScenario:
    """Resolve every registry key and construct the runnable scenario.

    ``tasks`` overrides the generated taskset (case studies); ``cost_model``
    is injected into 'measured' ETM/overhead specs (a
    ``analysis.cost_model.StepCostModel``, e.g. ingested from
    ``ServerPool.cell_stats()`` or loaded from BENCH_cost_model.json).
    """
    params = GenParams(**scenario.taskset)
    if tasks is None:
        tasks = generate_taskset(params, rng_stream(scenario.seed, "taskset"))
    tasks = SCHEDULERS.create(scenario.scheduler).assign(list(tasks))
    proto: Protocol = PROTOCOLS.create(scenario.protocol)

    ov_key, ov_params = scenario.overheads
    if ov_key in _NEEDS_COST_MODEL:
        ov_params = {"cost_model": cost_model, **ov_params}
    epsilon = OVERHEADS.create(ov_key, **ov_params).epsilon(params.epsilon_ms)

    if proto.approach == "sync":
        if scenario.num_devices != 1:
            raise ValueError(
                f"{scenario.name}: protocol {proto.name!r} models one global "
                f"mutex; num_devices must be 1")
        system = allocate(tasks, params.num_cores, approach="sync")
    else:
        cores = scenario.cores_per_device or params.num_cores
        if scenario.num_devices > 1 and not proto.pool_capable:
            raise ValueError(
                f"{scenario.name}: protocol {proto.name!r} is not pool-capable")
        if scenario.allocator == "lp":
            system = allocate_lp(tasks, scenario.num_devices, cores,
                                 epsilon=epsilon)
        elif scenario.num_devices > 1:
            system = allocate_pool(tasks, scenario.num_devices, cores,
                                   epsilon=epsilon,
                                   heuristic=scenario.allocator)
        else:
            system = allocate(tasks, cores, approach="server",
                              epsilon=epsilon, heuristic=scenario.allocator)

    horizon_ms = scenario.horizon_periods * max(t.T for t in system.tasks)

    arr_key, arr_params = scenario.arrivals
    arrival_model = ARRIVALS.create(arr_key, **arr_params)
    releases: dict[str, list[float]] = {}
    for t in system.tasks:
        rel = arrival_model.releases(
            t, horizon_ms, rng_stream(scenario.seed, f"arrivals/{t.name}"))
        check_min_separation(t, rel)  # guard custom models too
        releases[t.name] = rel

    etm_key, etm_params = scenario.etm
    if etm_key in _NEEDS_COST_MODEL:
        etm_params = {"cost_model": cost_model, **etm_params}
    etm_model = ETM.create(etm_key, **etm_params)
    etm_rngs = {t.name: rng_stream(scenario.seed, f"etm/{t.name}")
                for t in system.tasks}

    def etm_fn(task: Task, job_index: int):
        C, segs = etm_model.costs(task, job_index, etm_rngs[task.name])
        check_within_declared(task, C, segs)
        return C, segs

    faults: list[DeviceFault] = []
    if scenario.num_faults:
        if proto.approach != "server":
            raise ValueError(
                f"{scenario.name}: fault replay needs a server protocol")
        faults = seeded_device_faults(
            system, scenario.seed, num_faults=scenario.num_faults,
            horizon_ms=horizon_ms, detect_ms=scenario.fault_detect_ms,
            recovery_scale=scenario.fault_recovery_scale)

    migrations: list[StreamMigration] = []
    if scenario.num_migrations:
        if proto.approach != "server":
            raise ValueError(
                f"{scenario.name}: migration replay needs a server protocol")
        migrations = seeded_stream_migrations(
            system, scenario.seed, num_migrations=scenario.num_migrations,
            horizon_ms=horizon_ms, cost_scale=scenario.migration_cost_scale)

    return BuiltScenario(
        scenario=scenario, protocol=proto, system=system,
        horizon_ms=horizon_ms, releases=releases, etm=etm_fn, faults=faults,
        migrations=migrations)


def run(scenario: Scenario, *, tasks: list[Task] | None = None,
        cost_model=None) -> ScenarioResult:
    """Build, analyze, and simulate one scenario; pair every task's bound
    with its simulated WCRT."""
    built = build(scenario, tasks=tasks, cost_model=cost_model)
    analysis = built.analyze()
    sim = built.simulate()
    bounds = {t.name: analysis.wcrt(t.name) for t in built.system.tasks}
    wcrt = {t.name: sim.wcrt(t.name) for t in built.system.tasks}
    return ScenarioResult(
        scenario=scenario, system=built.system, analysis=analysis, sim=sim,
        bounds=bounds, wcrt=wcrt,
        schedulable=bool(getattr(analysis, "schedulable", False)),
        any_miss=sim.any_miss)
