"""Queue-ordering policy for accelerator servers.

One definition of request order, shared by the executable runtime
(``core.server_runtime.AcceleratorServer``) and the discrete-event
simulator (``core.simulator._GpuServer``): a request is dequeued by
ascending ``(request_key(...), arrival_seq)``, so ties always break FIFO.

  * ``priority`` — the paper's §5.1 server: task-priority order
    (larger priority value = served first).
  * ``fifo``     — the paper's §7 / Fig. 15 future-work variant: arrival
    order (key is constant; the arrival sequence number decides).
  * ``edf``      — beyond-paper: earliest absolute deadline first, used by
    serving for straggler mitigation; requests without a deadline sort
    last.
"""

from __future__ import annotations

import math

__all__ = ["ORDERINGS", "request_key"]

ORDERINGS = ("priority", "fifo", "edf")


def request_key(ordering: str, *, priority: int = 0,
                deadline: float | None = None) -> float:
    """Heap key for one request under ``ordering`` (smaller = served first)."""
    if ordering == "priority":
        return -priority
    if ordering == "edf":
        return deadline if deadline is not None else math.inf
    if ordering == "fifo":
        return 0.0
    raise ValueError(f"unknown ordering {ordering!r}; expected one of {ORDERINGS}")
