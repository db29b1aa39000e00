"""Pluggable accelerator-access protocols: how is the GPU arbitrated?

One registry entry couples the three faces of a protocol that must stay in
lockstep for property tests to mean anything:

  * the SIMULATOR mode executing its exact semantics
    (``core.simulator.simulate(mode=...)``),
  * the ANALYSIS producing the response-time bound the simulation is
    property-tested against (bound >= simulated WCRT),
  * the ALLOCATION approach ("server" packs C/T plus the Eq (8) server
    pseudo-task; "sync" packs (C+G)/T busy-wait demand).

The server family's queue ordering reuses ``dispatch.policy`` keys
(priority / fifo / edf) — the same single definition of request order the
executable runtime uses.  The synchronization-based baselines
(``core.mpcp_analysis`` / ``core.fmlp_analysis``) are first-class entries,
so every sweep and matrix cell compares the paper's approach against them
through one code path.

Multi-accelerator systems decompose per device partition exactly as
``server_analysis.analyze_pool`` argues (partitioned routing keeps each
server's queue private); sync protocols model one global mutex and are
single-device only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core import fmlp_analysis, mpcp_analysis, server_analysis
from repro_torch.core.task_model import System

from .registry import Registry

__all__ = ["PROTOCOLS", "Protocol"]

PROTOCOLS = Registry("protocol")


def _per_device(analyze_one: Callable[[System], server_analysis.AnalysisResult]):
    """Lift a single-accelerator analysis to a pool: analyze each device's
    core-disjoint subsystem and merge (the ``analyze_pool`` decomposition;
    ``System.subsystem`` raises if partitions share a core)."""

    def analyze(system: System):
        if system.num_gpus <= 1:
            return analyze_one(system)
        res = server_analysis.PoolAnalysisResult()
        for d in range(system.num_gpus):
            sub = analyze_one(system.subsystem(d))
            res.per_device[d] = sub
            res.response_times.update(sub.response_times)
            res.gpu_handling.update(sub.gpu_handling)
            res.schedulable = res.schedulable and sub.schedulable
        return res

    return analyze


@dataclass(frozen=True)
class Protocol:
    """One registered protocol: simulator mode + analysis + allocation."""

    name: str
    approach: str          # "server" | "sync" (allocation/packing semantics)
    sim_mode: str          # core.simulator mode string
    ordering: str          # dispatch.policy queue-ordering key
    pool_capable: bool     # multi-accelerator partitions supported?
    analyze: Callable[[System], object] = field(repr=False)

    def __post_init__(self) -> None:
        if self.approach not in ("server", "sync"):
            raise ValueError(f"unknown approach {self.approach!r}")


def _register(name: str, **kw):
    proto = Protocol(name=name, **kw)
    PROTOCOLS.register(name, lambda proto=proto: proto)
    return proto


_register(
    "server",
    approach="server", sim_mode="server", ordering="priority",
    pool_capable=True,
    analyze=lambda system: (server_analysis.analyze_pool(system)
                            if system.num_gpus > 1
                            else server_analysis.analyze(system)),
)

_register(
    "server_fifo",
    approach="server", sim_mode="server_fifo", ordering="fifo",
    pool_capable=True,
    analyze=_per_device(server_analysis.analyze_fifo_server),
)

_register(
    "server_edf",
    approach="server", sim_mode="server_edf", ordering="edf",
    pool_capable=True,
    analyze=_per_device(server_analysis.analyze_edf_server),
)

# Batched dispatch: same per-request analysis — coalescing only lets
# same-shape requests JOIN the head's device call, so the unbatched bound
# still dominates (see analyze_pool's soundness note).
_register(
    "server_batched",
    approach="server", sim_mode="server_batched", ordering="priority",
    pool_capable=True,
    analyze=lambda system: (server_analysis.analyze_pool(system)
                            if system.num_gpus > 1
                            else server_analysis.analyze(system)),
)

_register(
    "mpcp",
    approach="sync", sim_mode="mpcp", ordering="priority",
    pool_capable=False,
    analyze=mpcp_analysis.analyze,
)

_register(
    "fmlp",
    approach="sync", sim_mode="fmlp", ordering="fifo",
    pool_capable=False,
    analyze=fmlp_analysis.analyze,
)
