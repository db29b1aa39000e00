"""Task allocation (paper §5.3): bin-packing heuristics with the GPU server.

Under partitioned scheduling the allocation problem is bin-packing
(NP-complete), so the paper uses decreasing-utilization heuristics.  Under
the server-based approach the GPU server is a first-class schedulable entity
whose utilization is Eq (8):

    U_server = sum_{tau_i : eta_i > 0} (G_i^m + 2 eta_i eps) / T_i

and it is sorted/allocated together with regular tasks (the paper's
experiments use worst-fit decreasing, WFD).

Packing utilizations reflect where CPU demand actually lands:
  * sync approach   : task occupies (C_i + G_i)/T_i on its own core
                      (busy-wait through the whole GPU segment).
  * server approach : task occupies C_i/T_i; the server pseudo-task carries
                      U_server (Eq (8)) onto whichever core it is packed.

Multi-accelerator pools add a device-assignment level above the core level:
:func:`allocate_pool` first packs GPU-using tasks onto devices by
accelerator utilization (WFD at the device level), then runs the per-device
core allocation above within each device's private core group.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from .task_model import System, Task, server_utilization

__all__ = ["allocate", "allocate_pool", "AllocationError"]

SERVER_NAME = "__gpu_server__"


class AllocationError(RuntimeError):
    pass


def _pack(items: list[tuple[str, float]], num_cores: int, heuristic: str) -> dict[str, int]:
    """Pack (name, util) items onto cores.  Returns name -> core."""
    items = sorted(items, key=lambda kv: -kv[1])  # decreasing utilization
    load = [0.0] * num_cores
    out: dict[str, int] = {}
    for name, u in items:
        if heuristic == "wfd":  # worst-fit: emptiest core
            core = min(range(num_cores), key=lambda c: load[c])
        elif heuristic == "ffd":  # first-fit: first core that stays <= 1
            core = next((c for c in range(num_cores) if load[c] + u <= 1.0 + 1e-12), None)
            if core is None:
                core = min(range(num_cores), key=lambda c: load[c])
        elif heuristic == "bfd":  # best-fit: fullest core that still fits
            fits = [c for c in range(num_cores) if load[c] + u <= 1.0 + 1e-12]
            core = max(fits, key=lambda c: load[c]) if fits else min(
                range(num_cores), key=lambda c: load[c]
            )
        else:
            raise ValueError(f"unknown heuristic {heuristic!r}")
        load[core] += u
        out[name] = core
    return out


def allocate(
    tasks: list[Task],
    num_cores: int,
    *,
    approach: str,
    epsilon: float = 0.0,
    heuristic: str = "wfd",
) -> System:
    """Allocate tasks (and, for the server-based approach, the GPU server) to
    cores and return the resulting ``System``."""
    if approach == "sync":
        items = [(t.name, (t.C + t.G) / t.T) for t in tasks]
        placement = _pack(items, num_cores, heuristic)
        placed = [t.with_core(placement[t.name]) for t in tasks]
        return System(tasks=placed, num_cores=num_cores, epsilon=0.0, server_core=-1)
    if approach == "server":
        items = [(t.name, t.C / t.T) for t in tasks]
        u_server = server_utilization(tasks, epsilon)
        items.append((SERVER_NAME, u_server))
        placement = _pack(items, num_cores, heuristic)
        placed = [t.with_core(placement[t.name]) for t in tasks]
        return System(
            tasks=placed,
            num_cores=num_cores,
            epsilon=epsilon,
            server_core=placement[SERVER_NAME],
        )
    raise ValueError(f"unknown approach {approach!r}")


def allocate_pool(
    tasks: list[Task],
    num_devices: int,
    cores_per_device: int,
    *,
    epsilon: float = 0.0,
    heuristic: str = "wfd",
    device_heuristic: str = "wfd",
) -> System:
    """Two-level allocation for a multi-accelerator server pool.

    Level 1 — device assignment (the pool's routing step): GPU-using tasks
    are packed onto devices by decreasing accelerator utilization G_i/T_i
    (worst-fit decreasing by default, the paper's WFD discipline applied at
    the device level); CPU-only tasks are then spread across the devices'
    core groups by CPU utilization the same way.

    Level 2 — per-device core allocation: within each device's private core
    group of ``cores_per_device`` cores, tasks plus that device's GPU-server
    pseudo-task are packed exactly as in :func:`allocate` (server approach).

    The result is ONE ``System`` with ``num_devices * cores_per_device``
    cores, core-disjoint device partitions (each task's ``device`` set), and
    one server core per device — the shape ``server_analysis.analyze_pool``
    and ``simulator.simulate`` (server modes) consume.
    """
    if num_devices < 1:
        raise AllocationError(f"need >= 1 device, got {num_devices}")
    gpu = sorted((t for t in tasks if t.uses_gpu), key=lambda t: -(t.G / t.T))
    cpu_only = sorted((t for t in tasks if not t.uses_gpu),
                      key=lambda t: -(t.C / t.T))
    dev_gpu_load = [0.0] * num_devices
    dev_cpu_load = [0.0] * num_devices
    by_device: list[list[Task]] = [[] for _ in range(num_devices)]
    for t in gpu:
        if device_heuristic == "wfd":
            d = min(range(num_devices), key=lambda i: dev_gpu_load[i])
        elif device_heuristic == "ffd":
            d = next((i for i in range(num_devices)
                      if dev_gpu_load[i] + t.G / t.T <= 1.0 + 1e-12),
                     min(range(num_devices), key=lambda i: dev_gpu_load[i]))
        else:
            raise ValueError(f"unknown device heuristic {device_heuristic!r}")
        dev_gpu_load[d] += t.G / t.T
        dev_cpu_load[d] += t.C / t.T
        by_device[d].append(t)
    for t in cpu_only:
        d = min(range(num_devices), key=lambda i: dev_cpu_load[i])
        dev_cpu_load[d] += t.C / t.T
        by_device[d].append(t)

    placed: list[Task] = []
    server_cores: list[int] = []
    for d in range(num_devices):
        sub = allocate(by_device[d], cores_per_device, approach="server",
                       epsilon=epsilon, heuristic=heuristic)
        offset = d * cores_per_device
        placed.extend(t.with_core(t.core + offset).with_device(d)
                      for t in sub.tasks)
        server_cores.append(sub.server_core + offset)
    return System(
        tasks=placed,
        num_cores=num_devices * cores_per_device,
        epsilon=epsilon,
        server_cores=tuple(server_cores),
    )
