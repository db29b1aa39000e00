"""Registry-driven scenario engine: a scenario is a config, not a code path.

This package turns every axis the simulator/analysis pair used to hard-code
into a string-keyed registry (ROADMAP item 4, modeled on the rtos_sim
exemplar):

  =============  =====================================  ========================
  axis           registry (module)                      built-in keys
  =============  =====================================  ========================
  arrivals       ``ARRIVALS``   (:mod:`.arrivals`)      periodic, sporadic,
                                                        bursty, diurnal, trace
  exec times     ``ETM``        (:mod:`.etm`)           constant, table,
                                                        uniform, measured
  overheads      ``OVERHEADS``  (:mod:`.overheads`)     constant, zero, scaled,
                                                        measured
  protocols      ``PROTOCOLS``  (:mod:`.protocols`)     server, server_fifo,
                                                        server_edf,
                                                        server_batched,
                                                        mpcp, fmlp
  schedulers     ``SCHEDULERS`` (:mod:`.schedulers`)    rm, dm, given
  scenarios      ``SCENARIOS``  (:mod:`.matrix`)        the CI matrix presets
  =============  =====================================  ========================

WRITING A SCENARIO
------------------

1. Describe the run as data — a frozen :class:`Scenario`::

       from repro_torch.scenarios import Scenario, run

       scn = Scenario(
           name="my_experiment",
           seed=42,
           taskset={"num_cores": 4, "num_tasks": (8, 12)},  # GenParams kwargs
           arrivals=("bursty", {"p_enter": 0.1, "idle_factor": 4.0}),
           etm=("uniform", {"frac": (0.6, 1.0)}),
           protocol="server_batched",
           scheduler="rm",
           num_devices=2, cores_per_device=2,
           allocator="lp",            # or "wfd"/"ffd"/"bfd"
       )
       result = run(scn)              # -> ScenarioResult
       result.schedulable, result.any_miss
       result.bounds["tau3"], result.wcrt["tau3"]   # bound >= wcrt, always

   Registry specs are either a bare key (``"periodic"``) or
   ``(key, params)``; unknown keys fail at construction with the list of
   alternatives.  Every random draw derives from ``seed`` through named
   sub-streams, so the same config + seed replays bit-identically.

2. Or reuse a preset from the CI matrix::

       from repro_torch.scenarios import SCENARIOS
       scn = SCENARIOS.create("flash_crowd", seed=3)

3. ADDING A GENERATOR: register a class under the axis's registry and keep
   that axis's one invariant (each module's docstring states it)::

       from repro_torch.scenarios import ARRIVALS

       @ARRIVALS.register("pareto")
       class Pareto:
           def __init__(self, alpha=1.5): self.alpha = alpha
           def releases(self, task, horizon_ms, rng) -> list[float]:
               ...  # consecutive gaps MUST stay >= task.T

   Invariants (what keeps the property tests meaningful):

   * arrivals: inter-release gaps >= T — the sporadic contract the
     analyses assume (``check_min_separation`` enforces it at build).
   * etm: per-job costs <= the declared WCET, same segment count — the
     bounds are monotone in costs, so declared-cost analysis dominates
     (``check_within_declared`` enforces it per job).
   * protocols: the simulator mode and the analysis must describe the SAME
     semantics; new protocols need a bound-dominance property test.

4. CLI: ``python -m benchmarks.run --scenario flash_crowd`` resolves the
   name through the registry; ``benchmarks/scenario_matrix.py`` prices the
   whole matrix into BENCH_scenarios.json; ``make test-scenarios`` runs
   the CI-sized property pass (bound >= simulated WCRT on every cell).
"""

from .arrivals import ARRIVALS
from .etm import ETM
from .lp_alloc import allocate_lp, lp_pack
from .matrix import CI_MATRIX, SCENARIOS, default_cost_model
from .overheads import OVERHEADS
from .protocols import PROTOCOLS, Protocol
from .registry import Registry, RegistryError
from .scenario import (
    BuiltScenario,
    Scenario,
    ScenarioResult,
    build,
    rng_stream,
    run,
)
from .schedulers import SCHEDULERS

__all__ = [
    "ARRIVALS",
    "ETM",
    "OVERHEADS",
    "PROTOCOLS",
    "SCENARIOS",
    "SCHEDULERS",
    "CI_MATRIX",
    "BuiltScenario",
    "Protocol",
    "Registry",
    "RegistryError",
    "Scenario",
    "ScenarioResult",
    "allocate_lp",
    "build",
    "default_cost_model",
    "lp_pack",
    "rng_stream",
    "run",
]
