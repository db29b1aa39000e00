"""Random taskset generation per Table 2 of the paper (§6.3).

Base parameters (each taskset draws from these ranges):

  Number of CPU cores N_P                    : 4 or 8
  Number of tasks n                          : U[2*N_P, 5*N_P]
  Task utilization U_i                       : U[0.05, 0.2]
  Task period/deadline T_i = D_i             : U[30, 500] ms
  Percentage of GPU-using tasks              : U[10, 30] %
  Ratio of GPU segment length to normal WCET : U[10, 30] %   (G_i / C_i)
  Number of GPU segments per task eta_i      : U{1, 2, 3}
  Ratio of misc ops in a segment             : U[10, 20] %   (G^m / G_{i,j})
  GPU server overhead eps                    : 50 us

Construction (paper text): U_i = (C_i + G_i)/T_i.  CPU-only: C_i = U_i*T_i,
G_i = 0.  GPU-using: the drawn ratio r = G_i/C_i fixes C_i = U_i*T_i/(1+r)
and G_i = C_i*r; G_i is split into eta_i random-sized pieces; each piece is
split into (G^e, G^m) by the misc ratio, assuming G_{i,j} = G^e + G^m.
Priorities are Rate-Monotonic with arbitrary tie-breaking.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from .task_model import GpuSegment, Task

__all__ = ["GenParams", "generate_taskset", "assign_rm_priorities"]


@dataclass
class GenParams:
    num_cores: int = 4
    num_tasks: tuple[int, int] | None = None  # default [2*N_P, 5*N_P]
    util: tuple[float, float] = (0.05, 0.2)
    period_ms: tuple[float, float] = (30.0, 500.0)
    pct_gpu_tasks: tuple[float, float] = (0.10, 0.30)
    gpu_ratio: tuple[float, float] = (0.10, 0.30)  # G_i / C_i
    num_segments: tuple[int, int] = (1, 3)
    misc_ratio: tuple[float, float] = (0.10, 0.20)  # G^m_{i,j} / G_{i,j}
    epsilon_ms: float = 0.050
    # bimodal utilization experiment (Fig. 12): fraction of tasks drawn from
    # the "large" range; None disables bimodal mode.
    bimodal_large_fraction: float | None = None
    util_large: tuple[float, float] = (0.2, 0.5)
    # how G_i is split across the eta_i segments: "uniform" (simplex, the
    # paper's setup) or "heavy" (Pareto-weighted — one dominant long-context
    # segment per task, the adversarial blocking shape).
    seg_split: str = "uniform"

    def task_count_range(self) -> tuple[int, int]:
        if self.num_tasks is not None:
            return self.num_tasks
        return (2 * self.num_cores, 5 * self.num_cores)


def _split_random(total: float, n: int, rng: random.Random,
                  mode: str = "uniform") -> list[float]:
    """Split ``total`` into n random-sized positive pieces.  "uniform" draws
    from the uniform simplex; "heavy" draws Pareto(alpha=1.2) weights so one
    piece usually dominates (heavy-tailed segment lengths)."""
    if n == 1:
        return [total]
    if mode == "heavy":
        weights = [rng.paretovariate(1.2) for _ in range(n)]
        s = sum(weights)
        return [total * w / s for w in weights]
    if mode != "uniform":
        raise ValueError(f"unknown seg_split {mode!r}; use 'uniform' or 'heavy'")
    cuts = sorted(rng.random() for _ in range(n - 1))
    pts = [0.0, *cuts, 1.0]
    return [total * (pts[k + 1] - pts[k]) for k in range(n)]


def assign_rm_priorities(tasks: list[Task]) -> list[Task]:
    """Rate-Monotonic: shorter period = higher priority; unique priorities
    (arbitrary tie-break by index, per the paper)."""
    order = sorted(range(len(tasks)), key=lambda k: (tasks[k].T, k))
    out = list(tasks)
    n = len(tasks)
    for rank, k in enumerate(order):
        out[k] = out[k].with_priority(n - rank)  # larger = higher priority
    return out


def generate_taskset(params: GenParams, rng: random.Random | int) -> list[Task]:
    if isinstance(rng, int):  # int seed accepted for deterministic replay
        rng = random.Random(rng)
    lo, hi = params.task_count_range()
    n = rng.randint(lo, hi)
    pct_gpu = rng.uniform(*params.pct_gpu_tasks)
    n_gpu = round(n * pct_gpu)
    gpu_idx = set(rng.sample(range(n), n_gpu))

    tasks: list[Task] = []
    for i in range(n):
        T = rng.uniform(*params.period_ms)
        if params.bimodal_large_fraction is not None and rng.random() < params.bimodal_large_fraction:
            u = rng.uniform(*params.util_large)
        else:
            u = rng.uniform(*params.util)
        if i in gpu_idx:
            r = rng.uniform(*params.gpu_ratio)
            C = u * T / (1.0 + r)
            G = C * r
            eta = rng.randint(*params.num_segments)
            segs = []
            for g in _split_random(G, eta, rng, params.seg_split):
                mr = rng.uniform(*params.misc_ratio)
                segs.append(GpuSegment(e=g * (1 - mr), m=g * mr))
            tasks.append(Task(name=f"tau{i}", C=C, T=T, D=T, segments=tuple(segs)))
        else:
            tasks.append(Task(name=f"tau{i}", C=u * T, T=T, D=T))
    return assign_rm_priorities(tasks)
