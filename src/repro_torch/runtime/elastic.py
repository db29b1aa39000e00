"""Elastic scaling: the serving pool's size controller, and the mesh plan
after device loss.

Counterpart of ``repro/runtime/elastic.py``.  Its host-side parts are
copied word for word (``tests/test_torch_imports.py`` pins their text to
the source's): ``plan_after_failure`` and ``degraded_throughput_fraction``
(the data axis that survives a failure), ``LoadTrajectory`` and
``ElasticPoolController`` (``ServeEngine.add_server`` / ``remove_server``
toward a target pool size mid-traffic, with live cache migration).
``MeshPlan`` keeps its fields; ``build`` lays its shape over ranks of the
current process group as a ``DeviceMesh`` (``checkpoint.restore`` takes
shardings on it, so a restore onto the shrunk mesh is the same path).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    devices_used: int

    def build(self, devices=None):
        """A ``DeviceMesh`` of ``shape`` and ``axes`` over ``devices`` (the
        global ranks to use, in order; default the first ones of the
        process group), on ``cuda`` under NCCL and ``cpu`` under gloo."""
        n = math.prod(self.shape)
        ranks = list(devices) if devices is not None else list(range(n))
        if len(ranks) < n:
            raise ValueError(f"mesh {self.shape} needs {n} ranks, got "
                             f"{len(ranks)}")
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return DeviceMesh(kind, torch.tensor(ranks[:n]).reshape(self.shape),
                          mesh_dim_names=self.axes)


def plan_after_failure(total_devices: int, *, model: int, global_batch: int,
                       pod: int = 1) -> MeshPlan:
    """Largest data axis with data*model*pod <= total_devices, data | batch."""
    if total_devices < model:
        raise ValueError(f"cannot keep model axis {model} on {total_devices} devices")
    max_data = total_devices // (model * pod)
    data = max_data
    while data > 1 and (global_batch % data):
        data -= 1
    data = max(data, 1)
    if pod > 1:
        return MeshPlan((pod, data, model), ("pod", "data", "model"),
                        pod * data * model)
    return MeshPlan((data, model), ("data", "model"), data * model)


def degraded_throughput_fraction(old: MeshPlan, new: MeshPlan) -> float:
    return new.devices_used / old.devices_used


# -- serving-pool elasticity (live KV migration; see serving.engine) --------
@dataclass(frozen=True)
class LoadTrajectory:
    """Piecewise-constant pool-size plan: ``points`` are (at_s, target)
    pairs, sorted by time; ``target_at(t)`` is the last target at or before
    ``t`` (the first target before the first point).  Drives
    ``ElasticPoolController`` through a scripted ramp in benchmarks and
    tests — the serving analogue of a traffic forecast."""

    points: tuple[tuple[float, int], ...]

    def __post_init__(self):
        pts = tuple(sorted((float(a), int(n)) for a, n in self.points))
        if not pts:
            raise ValueError("LoadTrajectory needs at least one point")
        object.__setattr__(self, "points", pts)

    def target_at(self, t_s: float) -> int:
        tgt = self.points[0][1]
        for at, n in self.points:
            if at <= t_s:
                tgt = n
            else:
                break
        return tgt


class ElasticPoolController:
    """Scale a ServeEngine's server pool toward a target size mid-traffic.

    Scale-up adds servers (``engine.add_server``: pool + admission grow in
    lockstep, pools warmed off the hot path).  Scale-down retires the
    LEAST-utilized live servers (by admission GPU utilization, ties to the
    highest index so elastically-added servers leave first) via
    ``engine.remove_server`` — live-KV migration for in-flight streams,
    degraded-mode admission proving the shrunk placement.  A server whose
    drain times out is left alone (scale-down is best-effort; the next
    ``scale_to`` retries)."""

    def __init__(self, engine, *, min_servers: int = 1,
                 max_servers: int = 8):
        if min_servers < 1 or max_servers < min_servers:
            raise ValueError(f"bad bounds [{min_servers}, {max_servers}]")
        self.engine = engine
        self.min_servers = min_servers
        self.max_servers = max_servers
        self.events: list[tuple[str, int]] = []  # ("add"|"remove", si)

    def live(self) -> list[int]:
        drain = self.engine.pool.draining()
        return [i for i in self.engine.pool.alive_servers()
                if i not in drain]

    def scale_to(self, n: int, *, timeout_s: float = 10.0) -> list[int]:
        """Add/remove servers until the live count hits ``n`` (clamped to
        the controller's bounds); returns the live server list after."""
        n = max(self.min_servers, min(self.max_servers, int(n)))
        while len(self.live()) < n:
            si = self.engine.add_server()
            self.events.append(("add", si))
        while len(self.live()) > n:
            victim = min(self.live(),
                         key=lambda i: (self.engine.admission
                                        .gpu_utilization(i), -i))
            try:
                self.engine.remove_server(victim, timeout_s=timeout_s)
            except TimeoutError:
                break  # busy server: leave it; a later scale_to retries
            self.events.append(("remove", victim))
        return self.live()
