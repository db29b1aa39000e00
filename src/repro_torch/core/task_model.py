"""Task model from Kim et al. 2017, Section 3.

A sporadic task with constrained deadline is

    tau_i := (C_i, T_i, D_i, G_i, eta_i)

where C_i is the WCET of all *normal* (CPU) execution segments, T_i the
minimum inter-arrival time, D_i <= T_i the relative deadline, G_i the
accumulated worst-case duration of all GPU access segments when the task
runs alone, and eta_i the number of GPU access segments per job.

Each GPU access segment j is further decomposed (Section 3):

    G_{i,j} := (G^e_{i,j}, G^m_{i,j})

G^e is the WCET of pure accelerator operations needing no CPU intervention
(kernel execution, DMA transfers); G^m is the WCET of the miscellaneous
CPU-side operations (issuing copies, launching kernels, completion
notification).  G_{i,j} <= G^e + G^m since the two need not lie on the same
control path and may overlap in asynchronous mode.

Utilization: U_i = (C_i + G_i) / T_i.

All times are in milliseconds (float).  Priorities are integers; following
the paper, *larger value = higher priority* and priorities are unique.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

__all__ = [
    "GpuSegment",
    "Task",
    "System",
    "server_utilization",
]


@dataclass(frozen=True)
class GpuSegment:
    """One GPU access segment G_{i,j} = (G^e, G^m)."""

    e: float  # G^e_{i,j}: pure accelerator time (no CPU intervention)
    m: float  # G^m_{i,j}: miscellaneous CPU-side time

    def __post_init__(self) -> None:
        if self.e < 0 or self.m < 0:
            raise ValueError(f"negative GPU segment components: {self}")

    @property
    def total(self) -> float:
        """G_{i,j}.  We take the paper's conservative synchronous-mode value
        G_{i,j} = G^e + G^m (the paper's generator also assumes this:
        'assuming G_{i,j} = G^e_{i,j} + G^m_{i,j}', Section 6.3)."""
        return self.e + self.m


@dataclass(frozen=True)
class Task:
    """Sporadic task tau_i.  ``segments`` has length eta_i."""

    name: str
    C: float  # total WCET of normal execution segments
    T: float  # minimum inter-arrival time (period)
    D: float  # relative deadline, D <= T
    segments: tuple[GpuSegment, ...] = ()
    priority: int = 0  # unique; larger = higher priority
    core: int = -1  # CPU core (partitioned scheduling); -1 = unassigned
    device: int = 0  # accelerator index (multi-GPU pools; 0 when single)

    def __post_init__(self) -> None:
        if self.C < 0:
            raise ValueError(f"{self.name}: negative C")
        if self.T <= 0:
            raise ValueError(f"{self.name}: non-positive T")
        if not (0 < self.D <= self.T):
            raise ValueError(f"{self.name}: need 0 < D <= T, got D={self.D} T={self.T}")

    # -- paper notation ------------------------------------------------
    @property
    def eta(self) -> int:
        """eta_i: number of GPU access segments."""
        return len(self.segments)

    @property
    def G(self) -> float:
        """G_i = sum_j G_{i,j}."""
        return sum(s.total for s in self.segments)

    @property
    def Gm(self) -> float:
        """G^m_i = sum_j G^m_{i,j} (misc CPU ops across all segments)."""
        return sum(s.m for s in self.segments)

    @property
    def Ge(self) -> float:
        """G^e_i = sum_j G^e_{i,j}."""
        return sum(s.e for s in self.segments)

    @property
    def U(self) -> float:
        """U_i = (C_i + G_i) / T_i."""
        return (self.C + self.G) / self.T

    @property
    def uses_gpu(self) -> bool:
        return self.eta > 0

    def with_core(self, core: int) -> "Task":
        return replace(self, core=core)

    def with_priority(self, priority: int) -> "Task":
        return replace(self, priority=priority)

    def with_device(self, device: int) -> "Task":
        return replace(self, device=device)


def server_utilization(tasks: list[Task], epsilon: float) -> float:
    """Eq. (8): U_server = sum_{tau_i: eta_i > 0} (G^m_i + 2 eta_i eps)/T_i."""
    return sum((t.Gm + 2 * t.eta * epsilon) / t.T for t in tasks if t.uses_gpu)


@dataclass
class System:
    """A partitioned system: tasks pinned to cores, one or more accelerators.

    ``epsilon`` is the GPU-server overhead bound (only meaningful for the
    server-based approach).  ``server_core`` is the core hosting the GPU
    server task (single-accelerator server-based approach).  A multi-
    accelerator pool sets ``server_cores`` (one server core per device);
    each task's ``device`` attribute names the accelerator its segments run
    on.  ``server_core``/``server_cores`` are kept consistent: for a
    single-device system either spelling works.
    """

    tasks: list[Task]
    num_cores: int
    epsilon: float = 0.0
    server_core: int = -1
    server_cores: tuple[int, ...] = ()

    def __post_init__(self) -> None:
        prios = [t.priority for t in self.tasks]
        if len(set(prios)) != len(prios):
            raise ValueError("task priorities must be unique")
        for t in self.tasks:
            if not (0 <= t.core < self.num_cores):
                raise ValueError(f"{t.name}: core {t.core} outside 0..{self.num_cores - 1}")
        if not self.server_cores and self.server_core >= 0:
            self.server_cores = (self.server_core,)
        if self.server_cores and self.server_core < 0:
            self.server_core = self.server_cores[0]
        for t in self.tasks:
            if not (0 <= t.device < max(self.num_gpus, 1)):
                raise ValueError(
                    f"{t.name}: device {t.device} outside 0..{self.num_gpus - 1}")

    @property
    def num_gpus(self) -> int:
        return max(len(self.server_cores), 1)

    def device_tasks(self, device: int) -> list[Task]:
        return [t for t in self.tasks if t.device == device]

    def subsystem(self, device: int) -> "System":
        """The single-accelerator System of one device partition (its tasks
        plus its server core), for per-server analysis.  Core indices stay
        global.  Raises if the partition shares a core with another device
        (then per-device analysis would miss CPU interference)."""
        mine = {t.core for t in self.device_tasks(device)}
        for t in self.tasks:
            if t.device != device and t.core in mine:
                raise ValueError(
                    f"core {t.core} shared across devices {device} and "
                    f"{t.device}; partition is not core-disjoint")
        return System(
            tasks=[t.with_device(0) for t in self.device_tasks(device)],
            num_cores=self.num_cores,
            epsilon=self.epsilon,
            server_core=self.server_cores[device] if self.server_cores else -1,
        )

    # -- helpers used by every analysis ---------------------------------
    def local_tasks(self, core: int) -> list[Task]:
        return [t for t in self.tasks if t.core == core]

    def higher_prio(self, task: Task, *, same_core: bool | None = None) -> list[Task]:
        out = [t for t in self.tasks if t.priority > task.priority]
        if same_core is True:
            out = [t for t in out if t.core == task.core]
        elif same_core is False:
            out = [t for t in out if t.core != task.core]
        return out

    def lower_prio(self, task: Task, *, same_core: bool | None = None) -> list[Task]:
        out = [t for t in self.tasks if t.priority < task.priority]
        if same_core is True:
            out = [t for t in out if t.core == task.core]
        elif same_core is False:
            out = [t for t in out if t.core != task.core]
        return out

    def gpu_tasks(self) -> list[Task]:
        return [t for t in self.tasks if t.uses_gpu]

    @property
    def server_utilization(self) -> float:
        return server_utilization(self.tasks, self.epsilon)

    def core_utilization(self, core: int, *, approach: str) -> float:
        """CPU utilization of ``core``.

        Under the synchronization-based approach GPU segments busy-wait, so
        they consume CPU on the task's core: U = (C+G)/T.  Under the
        server-based approach the task suspends; only C/T is consumed on the
        task's core, while G^m + 2*eta*eps per period lands on the server's
        core.
        """
        u = 0.0
        for t in self.local_tasks(core):
            if approach == "sync":
                u += (t.C + t.G) / t.T
            elif approach == "server":
                u += t.C / t.T
            else:
                raise ValueError(approach)
        if approach == "server" and core == self.server_core:
            u += self.server_utilization
        return u


# Ceiling with a guard against float fuzz: ceil(x) where x is a ratio of
# millisecond floats. Without the guard, 3.0000000000000004 would ceil to 4
# and silently inflate interference terms.
def ceil_div(a: float, b: float) -> int:
    if b <= 0:
        raise ValueError("non-positive divisor")
    x = a / b
    c = math.ceil(x)
    if c - x > 1 - 1e-9 and c - 1 >= x - 1e-9:
        c -= 1
    return max(c, 0)
