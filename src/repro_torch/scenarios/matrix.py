"""Named scenario presets and the CI scenario matrix.

Each entry is a factory returning a :class:`Scenario`; ``**overrides``
replace any field (``SCENARIOS.create("flash_crowd", seed=3)``).  The CI
matrix (``CI_MATRIX``) is the set `make test-scenarios` property-tests and
``benchmarks/scenario_matrix.py`` prices into BENCH_scenarios.json:

  * ``diurnal_load`` — sinusoidally modulated arrivals over the horizon.
  * ``flash_crowd`` — MMPP bursts: long idle dwell, then back-to-back
    legal arrivals, under the batched server.
  * ``adversarial_long_context`` — heavy-tailed GPU segment splits (one
    dominant long-context segment per task) at high GPU ratio: maximizes
    the lower-priority blocking term the server bound charges.
  * ``multi_tenant_inversion`` — bimodal utilizations, wide period spread:
    big low-RM-priority tenants park long segments in front of
    latency-sensitive tasks — the priority-inversion attempt the
    priority-ordered server queue (and its Eq (3) blocking term) absorbs.
  * ``replayed_fault`` — a seeded device death mid-horizon on a 3-device
    pool; the recovery-augmented bound prices it.
  * ``replayed_migration`` — a seeded work-stealing/consolidation schedule
    on a 3-device pool; the migration-delay-augmented bound prices it.
  * ``trace_replay`` — arrivals replayed from the checked-in JSONL corpus
    (``scenarios/traces/``), dealt round-robin onto the generated taskset
    and normalized to each task's T.
  * ``measured_costs`` — per-job GPU costs priced from the committed
    BENCH_cost_model.json cell surfaces (real timings) instead of
    declared worst cases.
  * ``edf_server`` / ``fifo_server`` — the alternative queue orderings.
  * ``sync_mpcp`` / ``sync_fmlp`` — the synchronization-based baselines as
    first-class cells.
  * ``lp_allocated`` — the LP-relaxation allocation baseline on a pool.
"""

from __future__ import annotations

import json
import pathlib

from .registry import Registry
from .scenario import Scenario

__all__ = ["SCENARIOS", "CI_MATRIX", "default_cost_model"]

SCENARIOS = Registry("scenario")

# small-but-nonempty tasksets: CI cells simulate in well under a second each
_SMALL = {"num_cores": 2, "num_tasks": (4, 7), "epsilon_ms": 0.05,
          "pct_gpu_tasks": (0.3, 0.6)}
_POOL = {"num_cores": 2, "num_tasks": (6, 10), "epsilon_ms": 0.05,
         "pct_gpu_tasks": (0.3, 0.6)}


def _preset(name: str, **defaults):
    def factory(**overrides):
        return Scenario(**{"name": name, **defaults, **overrides})

    SCENARIOS.register(name, factory)
    return factory


_preset(
    "diurnal_load",
    taskset=_SMALL,
    arrivals=("diurnal", {"cycles": 2.0, "amplitude": 2.0}),
    etm=("uniform", {"frac": (0.7, 1.0)}),
    protocol="server",
)

_preset(
    "flash_crowd",
    taskset=_POOL,
    arrivals=("bursty", {"p_enter": 0.08, "p_exit": 0.25, "idle_factor": 5.0}),
    protocol="server_batched",
    num_devices=2, cores_per_device=2,
)

_preset(
    "adversarial_long_context",
    taskset={**_SMALL, "gpu_ratio": (0.25, 0.3), "num_segments": (1, 2),
             "seg_split": "heavy"},
    arrivals=("sporadic", {"slack": (0.0, 0.2)}),
    protocol="server",
)

_preset(
    "multi_tenant_inversion",
    taskset={**_SMALL, "period_ms": (20.0, 800.0),
             "bimodal_large_fraction": 0.3, "util_large": (0.2, 0.4),
             "gpu_ratio": (0.2, 0.3)},
    arrivals="periodic",
    protocol="server",
)

_preset(
    "replayed_fault",
    taskset=_POOL,
    protocol="server_batched",
    num_devices=3, cores_per_device=2,
    num_faults=1, fault_detect_ms=1.0,
)

_preset(
    "replayed_migration",
    taskset=_POOL,
    protocol="server_batched",
    num_devices=3, cores_per_device=2,
    num_migrations=2, migration_cost_scale=0.25,
)

_preset(
    "trace_replay",
    taskset=_POOL,
    arrivals=("trace", {"path": "bursty_pool.jsonl",
                        "assign": "round_robin", "normalize": True}),
    protocol="server_batched",
    num_devices=2, cores_per_device=2,
)

_preset(
    "measured_costs",
    taskset=_SMALL,
    etm=("measured", {"cell": ("decode", 4, 64), "safety": 1.2}),
    protocol="server",
)

_preset(
    "edf_server",
    taskset=_SMALL,
    arrivals=("sporadic", {"slack": (0.0, 0.3)}),
    protocol="server_edf",
    scheduler="dm",
)

_preset(
    "fifo_server",
    taskset=_SMALL,
    protocol="server_fifo",
)

_preset(
    "sync_mpcp",
    taskset=_SMALL,
    protocol="mpcp",
)

_preset(
    "sync_fmlp",
    taskset=_SMALL,
    protocol="fmlp",
)

_preset(
    "lp_allocated",
    taskset=_POOL,
    protocol="server",
    num_devices=2, cores_per_device=2,
    allocator="lp",
)

CI_MATRIX = (
    "diurnal_load",
    "flash_crowd",
    "adversarial_long_context",
    "multi_tenant_inversion",
    "replayed_fault",
    "replayed_migration",
    "trace_replay",
    "measured_costs",
    "edf_server",
    "fifo_server",
    "sync_mpcp",
    "sync_fmlp",
    "lp_allocated",
)


def default_cost_model(path: str | None = None):
    """A ``StepCostModel`` for 'measured' cells: loads the committed
    BENCH_cost_model.json measured-cell surfaces (real timings from the
    calibration benchmark) when available, else falls back to a small
    synthetic surface so the matrix runs everywhere."""
    from repro_torch.analysis.cost_model import StepCostModel

    model = StepCostModel()
    candidates = ([pathlib.Path(path)] if path else [
        pathlib.Path(__file__).resolve().parents[3]
        / "benchmarks" / "BENCH_cost_model.json",
        pathlib.Path("benchmarks/BENCH_cost_model.json"),
    ])
    for p in candidates:
        try:
            data = json.loads(p.read_text())
        except (OSError, ValueError):
            continue
        for cell in data.get("cells", ()):
            key = tuple(cell["cell"])
            for _ in range(max(int(cell.get("timed", 1)), 1)):
                model.observe(key, float(cell["measured_s"]))
        if model.cells:
            return model
    # synthetic fallback: a plausible CPU-JAX-shaped surface
    for rows in (1, 2, 4, 8):
        for width in (1, 4, 16, 64):
            model.observe(("decode", rows, width),
                          8e-4 + 2e-5 * rows + 1e-6 * rows * width)
    return model
