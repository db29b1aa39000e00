"""The port's copies of the paper's analyses, simulator and scenario engine
(``repro_torch.core.{simulator, mpcp_analysis, fmlp_analysis}``,
``repro_torch.scenarios``) against the reference package on the same
seeds: every result is equal, field for field.

The copies are pinned byte for byte by test_torch_imports.py; this file
holds what they compute, so that a copy which imports a module of the port
that drifted from its source shows here.  Cases are drawn from
test_simulator.py (Figures 2 and 4, the legacy modes, the fault path),
test_baseline_analyses.py (MPCP and FMLP+ on Figure 2 and on generated
tasksets) and test_scenarios.py (every ``CI_MATRIX`` preset, the
protocol x arrival matrix).
"""

import dataclasses
import math
import random

import pytest

from repro.core import fmlp_analysis as j_fmlp
from repro.core import mpcp_analysis as j_mpcp
from repro.core import simulator as j_sim
from repro.core import task_model as j_tm
from repro.core.allocation import allocate as j_allocate
from repro.core.allocation import allocate_pool as j_allocate_pool
from repro.core.faults import seeded_device_faults as j_faults
from repro.core.taskset_gen import GenParams as JGenParams
from repro.core.taskset_gen import generate_taskset as j_generate
from repro import scenarios as j_scn
from repro_torch import scenarios as t_scn
from repro_torch.core import fmlp_analysis as t_fmlp
from repro_torch.core import mpcp_analysis as t_mpcp
from repro_torch.core import simulator as t_sim
from repro_torch.core import task_model as t_tm
from repro_torch.core.allocation import allocate as t_allocate
from repro_torch.core.allocation import allocate_pool as t_allocate_pool
from repro_torch.core.faults import seeded_device_faults as t_faults
from repro_torch.core.taskset_gen import GenParams as TGenParams
from repro_torch.core.taskset_gen import generate_taskset as t_generate

SEEDS = (0, 1, 2, 3)
REF = dict(sim=j_sim, mpcp=j_mpcp, fmlp=j_fmlp, tm=j_tm, allocate=j_allocate,
           allocate_pool=j_allocate_pool, faults=j_faults,
           params=JGenParams, generate=j_generate, scn=j_scn)
PORT = dict(sim=t_sim, mpcp=t_mpcp, fmlp=t_fmlp, tm=t_tm, allocate=t_allocate,
            allocate_pool=t_allocate_pool, faults=t_faults,
            params=TGenParams, generate=t_generate, scn=t_scn)


def _plain(x):
    """Dataclasses as dicts of their fields, recursively; NaN as a string:
    what two packages' results are compared by."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def _both(fn):
    """``fn`` run with the reference's modules and with the port's."""
    return _plain(fn(REF)), _plain(fn(PORT))


def _figure_system(m, eps: float, misc: float = 2.0):
    GpuSegment, Task = m["tm"].GpuSegment, m["tm"].Task
    tasks = [Task("tau_h", C=2, T=100, D=100, priority=3, core=1,
                  segments=(GpuSegment(e=1.0, m=misc),)),
             Task("tau_m", C=2, T=100, D=100, priority=2, core=1,
                  segments=(GpuSegment(e=1.0, m=misc),)),
             Task("tau_l", C=2, T=100, D=100, priority=1, core=2,
                  segments=(GpuSegment(e=2.0, m=misc),))]
    return m["tm"].System(tasks=tasks, num_cores=3, epsilon=eps,
                          server_core=1)


OFFSETS = {"tau_l": 0.0, "tau_m": 2.0, "tau_h": 3.0}
SPLITS = {t: [1.0, 1.0] for t in OFFSETS}


@pytest.mark.parametrize("mode,eps,misc", [("mpcp", 0.0, 2.0),
                                           ("fmlp", 0.0, 2.0),
                                           ("server", 0.05, 0.1)])
def test_simulator_figures_2_and_4(mode, eps, misc):
    ref, port = _both(lambda m: m["sim"].simulate(
        _figure_system(m, eps, misc), mode=mode, horizon_ms=50,
        splits=SPLITS, offsets=OFFSETS, trace=True))
    assert port == ref
    if mode == "mpcp":  # Figure 2: tau_h responds in exactly 9
        assert port["response_times"]["tau_h"] == [pytest.approx(9.0)]


def _generated(m, seed: int, *, pool: bool = False):
    tasks = m["generate"](m["params"](num_cores=2, num_tasks=(4, 7),
                                      pct_gpu_tasks=(0.3, 0.6)),
                          random.Random(seed))
    if pool:
        return m["allocate_pool"](tasks, 2, 2, epsilon=0.05)
    return m["allocate"](tasks, 2, approach="server", epsilon=0.05)


@pytest.mark.parametrize("mode", ["server", "server_batched"])
@pytest.mark.parametrize("seed", SEEDS)
def test_simulator_generated_tasksets(mode, seed):
    def sim(m):
        system = _generated(m, seed)
        horizon = 3.0 * max(t.T for t in system.tasks)
        return system, m["sim"].simulate(system, mode=mode,
                                         horizon_ms=horizon, trace=True)

    ref, port = _both(sim)
    assert port == ref
    assert port[1]["response_times"]


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_simulator_fault_path(seed):
    def sim(m):
        system = _generated(m, seed, pool=True)
        horizon = 3.0 * max(t.T for t in system.tasks)
        faults = m["faults"](system, seed, num_faults=1, horizon_ms=horizon)
        return faults, m["sim"].simulate(system, mode="server",
                                         horizon_ms=horizon, faults=faults,
                                         trace=True)

    ref, port = _both(sim)
    assert port == ref


@pytest.mark.parametrize("analysis", ["mpcp", "fmlp"])
def test_baseline_analyses_figure_2(analysis):
    ref, port = _both(lambda m: m[analysis].analyze(_figure_system(m, 0.0)))
    assert port == ref
    assert port["response_times"]["tau_h"] >= 9.0


@pytest.mark.parametrize("analysis", ["mpcp", "fmlp"])
@pytest.mark.parametrize("seed", SEEDS)
def test_baseline_analyses_generated(analysis, seed):
    def analyze(m):
        tasks = m["generate"](m["params"](num_cores=4, num_tasks=(4, 8)),
                              random.Random(seed))
        system = m["allocate"](tasks, 4, approach="sync", epsilon=0.0)
        return system, m[analysis].analyze(system)

    ref, port = _both(analyze)
    assert port == ref


@pytest.mark.parametrize("name", j_scn.CI_MATRIX)
@pytest.mark.parametrize("seed", [0, 3])
def test_ci_matrix_equals_reference(name, seed):
    """Each CI preset: the same system, bounds, simulated response times
    and trace.  ``measured_costs`` prices off ``default_cost_model()``,
    which both packages load from the reference's CPU
    ``benchmarks/BENCH_cost_model.json``."""
    def run(m):
        scn = m["scn"]
        return scn.run(scn.SCENARIOS.create(name, seed=seed),
                       cost_model=scn.default_cost_model())

    ref, port = _both(run)
    assert port == ref
    assert port["bounds"] and port["sim"]["response_times"]


@pytest.mark.parametrize("protocol", ["server", "server_fifo", "server_edf",
                                      "server_batched", "mpcp", "fmlp"])
@pytest.mark.parametrize("arrivals", [("periodic", {}),
                                      ("sporadic", {"slack": (0.0, 0.3)})],
                         ids=["periodic", "sporadic"])
def test_protocol_matrix_equals_reference(protocol, arrivals):
    def run(m):
        scn = m["scn"]
        return scn.run(scn.Scenario(
            name=f"cell_{protocol}_{arrivals[0]}", seed=1,
            taskset=dict(num_cores=2, num_tasks=(3, 6), epsilon_ms=0.05,
                         pct_gpu_tasks=(0.3, 0.6)),
            arrivals=arrivals, protocol=protocol))

    ref, port = _both(run)
    assert port == ref
    for name, bound in port["bounds"].items():  # the paper's property
        if math.isfinite(bound):
            assert port["wcrt"][name] <= bound + 1e-6


def test_trace_corpus_is_the_ports_own():
    """The port's trace arrivals read its own copy of the corpus."""
    import pathlib

    import repro_torch.scenarios.arrivals as t_arrivals
    root = pathlib.Path(t_arrivals.__file__).parent / "traces"
    assert sorted(p.name for p in root.iterdir()) == [
        "README.md", "bursty_pool.jsonl", "diurnal_ramp.jsonl"]
