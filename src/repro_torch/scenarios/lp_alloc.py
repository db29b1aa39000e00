"""LP-based allocation baseline (the rtos_sim ``planning/lp_solver`` idea).

``core.allocation.allocate_pool`` packs greedily (worst-fit decreasing at
the device level, WFD/FFD/BFD at the core level).  This module solves the
same two-level assignment as a makespan LP instead:

    minimize  z
    s.t.      sum_b x[i,b] = 1                for every item i
              sum_i u_i * x[i,b] <= z         for every bin b
              0 <= x[i,b] <= 1

relaxed to fractional x, solved with ``scipy.optimize.linprog`` (HiGHS),
then rounded deterministically: items in decreasing utilization go to
their largest-fraction bin, followed by a local-search repair (move the
smallest movable item off the most-loaded bin while that lowers the max
load).  The LP optimum ``z*`` is a true lower bound on ANY integral
packing's max load, so the benchmark can report how far both the heuristic
and the rounded-LP packing sit from optimal — the comparison
``BENCH_scenarios.json`` carries.

scipy is gated: when unavailable, :func:`lp_pack` falls back to worst-fit
decreasing (flagged via ``HAVE_SCIPY`` and the returned ``PackResult``)
so the scenario engine degrades instead of importing-erroring.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.allocation import SERVER_NAME, AllocationError
from repro_torch.core.task_model import System, Task, server_utilization

try:  # gated: the container may lack scipy; degrade to the WFD heuristic
    from scipy.optimize import linprog

    HAVE_SCIPY = True
except ImportError:  # pragma: no cover - exercised only without scipy
    linprog = None
    HAVE_SCIPY = False

__all__ = ["HAVE_SCIPY", "PackResult", "lp_pack", "allocate_lp"]


@dataclass(frozen=True)
class PackResult:
    """One bin-packing outcome: assignment plus the LP lower bound."""

    assignment: dict[str, int]   # item name -> bin
    max_load: float              # achieved max bin load
    lp_bound: float              # fractional optimum z* (<= any packing)
    used_lp: bool                # False = WFD fallback (scipy missing)


def _wfd(items: list[tuple[str, float]], num_bins: int) -> dict[str, int]:
    load = [0.0] * num_bins
    out: dict[str, int] = {}
    for name, u in sorted(items, key=lambda kv: (-kv[1], kv[0])):
        b = min(range(num_bins), key=lambda c: load[c])
        load[b] += u
        out[name] = b
    return out


def _loads(items: list[tuple[str, float]], assignment: dict[str, int],
           num_bins: int) -> list[float]:
    load = [0.0] * num_bins
    for name, u in items:
        load[assignment[name]] += u
    return load


def _repair(items: list[tuple[str, float]], assignment: dict[str, int],
            num_bins: int) -> None:
    """Deterministic local search: while moving one item from the most
    loaded bin to the least loaded strictly lowers the max load, do it
    (smallest sufficient item first)."""
    util = dict(items)
    for _ in range(4 * len(items) + 4):
        load = _loads(items, assignment, num_bins)
        hi = max(range(num_bins), key=lambda b: (load[b], -b))
        lo = min(range(num_bins), key=lambda b: (load[b], b))
        if load[hi] - load[lo] <= 1e-12:
            return
        movable = sorted(
            (name for name, b in assignment.items() if b == hi),
            key=lambda n: (util[n], n))
        for name in movable:
            if max(load[hi] - util[name], load[lo] + util[name]) < load[hi] - 1e-12:
                assignment[name] = lo
                break
        else:
            return


def lp_pack(items: list[tuple[str, float]], num_bins: int) -> PackResult:
    """Pack (name, utilization) items onto ``num_bins`` bins, minimizing the
    max bin load via the LP relaxation + deterministic rounding."""
    if num_bins < 1:
        raise AllocationError(f"need >= 1 bin, got {num_bins}")
    if not items:
        return PackResult({}, 0.0, 0.0, used_lp=HAVE_SCIPY)
    names = [n for n, _ in items]
    if len(set(names)) != len(names):
        raise AllocationError("duplicate item names in packing input")
    if num_bins == 1 or not HAVE_SCIPY:
        assignment = ({n: 0 for n in names} if num_bins == 1
                      else _wfd(items, num_bins))
        load = _loads(items, assignment, num_bins)
        bound = (sum(u for _, u in items) / num_bins if num_bins == 1
                 else max(sum(u for _, u in items) / num_bins,
                          max(u for _, u in items)))
        return PackResult(assignment, max(load), bound, used_lp=False)

    n, m = len(items), num_bins
    # variables: x[i*m + b] for each item/bin, then z last
    nvar = n * m + 1
    c = [0.0] * (n * m) + [1.0]
    a_eq, b_eq = [], []
    for i in range(n):
        row = [0.0] * nvar
        for b in range(m):
            row[i * m + b] = 1.0
        a_eq.append(row)
        b_eq.append(1.0)
    a_ub, b_ub = [], []
    for b in range(m):
        row = [0.0] * nvar
        for i, (_, u) in enumerate(items):
            row[i * m + b] = u
        row[-1] = -1.0
        a_ub.append(row)
        b_ub.append(0.0)
    bounds = [(0.0, 1.0)] * (n * m) + [(0.0, None)]
    res = linprog(c, A_ub=a_ub, b_ub=b_ub, A_eq=a_eq, b_eq=b_eq,
                  bounds=bounds, method="highs")
    if not res.success:  # pragma: no cover - LP above is always feasible
        assignment = _wfd(items, m)
        load = _loads(items, assignment, m)
        return PackResult(assignment, max(load), 0.0, used_lp=False)

    lp_bound = float(res.x[-1])
    # deterministic rounding: decreasing utilization, largest fraction wins,
    # ties to the emptier bin
    assignment: dict[str, int] = {}
    load = [0.0] * m
    order = sorted(range(n), key=lambda i: (-items[i][1], items[i][0]))
    for i in order:
        name, u = items[i]
        fracs = res.x[i * m:(i + 1) * m]
        b = max(range(m), key=lambda bb: (fracs[bb], -(load[bb] + u)))
        assignment[name] = b
        load[b] += u
    _repair(items, assignment, m)
    return PackResult(assignment, max(_loads(items, assignment, m)),
                      lp_bound, used_lp=True)


def allocate_lp(
    tasks: list[Task],
    num_devices: int,
    cores_per_device: int,
    *,
    epsilon: float = 0.0,
) -> System:
    """Two-level LP allocation for a multi-accelerator server pool — the
    drop-in baseline for ``core.allocation.allocate_pool`` (same System
    shape out: core-disjoint device partitions, one server core each).

    Level 1 packs GPU-using tasks onto devices by accelerator utilization
    G_i/T_i via :func:`lp_pack`, then spreads CPU-only tasks across devices
    by CPU utilization the same way.  Level 2 LP-packs each device's tasks
    plus its Eq (8) server pseudo-task onto its private core group.
    """
    if num_devices < 1:
        raise AllocationError(f"need >= 1 device, got {num_devices}")
    gpu = [t for t in tasks if t.uses_gpu]
    cpu_only = [t for t in tasks if not t.uses_gpu]

    dev_pack = lp_pack([(t.name, t.G / t.T) for t in gpu], num_devices)
    by_device: list[list[Task]] = [[] for _ in range(num_devices)]
    dev_cpu_load = [0.0] * num_devices
    for t in gpu:
        d = dev_pack.assignment[t.name]
        by_device[d].append(t)
        dev_cpu_load[d] += t.C / t.T
    for t in sorted(cpu_only, key=lambda t: (-(t.C / t.T), t.name)):
        d = min(range(num_devices), key=lambda i: (dev_cpu_load[i], i))
        dev_cpu_load[d] += t.C / t.T
        by_device[d].append(t)

    placed: list[Task] = []
    server_cores: list[int] = []
    for d in range(num_devices):
        mine = by_device[d]
        items = [(t.name, t.C / t.T) for t in mine]
        items.append((SERVER_NAME, server_utilization(mine, epsilon)))
        pack = lp_pack(items, cores_per_device)
        offset = d * cores_per_device
        placed.extend(
            t.with_core(pack.assignment[t.name] + offset).with_device(d)
            for t in mine)
        server_cores.append(pack.assignment[SERVER_NAME] + offset)
    return System(
        tasks=placed,
        num_cores=num_devices * cores_per_device,
        epsilon=epsilon,
        server_cores=tuple(server_cores),
    )
