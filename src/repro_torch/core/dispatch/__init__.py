"""Multi-accelerator dispatch subsystem.

The paper's GPU server (§5.1) arbitrates ONE accelerator.  This package
grows that spine into a multi-server dispatch layer, the two pieces the
paper's §7 generalization note calls for:

  * :mod:`repro_torch.core.dispatch.policy` — the queue-ordering policy
    (priority / FIFO / EDF keys) extracted out of ``AcceleratorServer`` so
    the executable runtime and the discrete-event simulator share one
    definition of "who goes first".
  * :mod:`repro_torch.core.dispatch.pool` — ``ServerPool``: one
    ``AcceleratorServer`` per device / mesh slice, with a priority-aware
    router that *partitions* streams across servers (like the paper's
    per-core task partitioning, so each server's queue can be analyzed in
    isolation by ``server_analysis.analyze_pool``).  Partitions are
    SEMI-partitioned, not frozen: a two-phase migration protocol
    (``request_migration``/``complete_migration``) re-homes a live stream
    between decode steps — the engine's work stealer drains deep queues
    onto idle devices, ``consolidate()`` packs mostly-idle devices so
    they can retire, and ``add_server``/``retire_server`` grow and shrink
    the pool mid-traffic.  Each move is priced by the StepCostModel and
    re-proved by ``PoolAdmissionController``, and the analysis side
    charges it via ``server_analysis.analyze_pool_under_migrations``'s
    per-phase migration-delay term.
  * :mod:`repro_torch.core.dispatch.batching` — ``BatchingServer``: coalesces
    same-shape requests (one ``batch_key``) from multiple admitted streams
    into one device call, amortizing the paper's 2*eps-per-request server
    overhead (Lemma 1) to 2*eps-per-batch.

Imports are lazy to keep ``policy`` importable from
``core.server_runtime`` without a cycle (pool/batching import the runtime).
"""

_EXPORTS = {
    "request_key": "repro_torch.core.dispatch.policy",
    "ORDERINGS": "repro_torch.core.dispatch.policy",
    "BatchRequest": "repro_torch.core.dispatch.batching",
    "BatchingServer": "repro_torch.core.dispatch.batching",
    "ServerPool": "repro_torch.core.dispatch.pool",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
