"""Core layer of the port: the paper's task model, the server-based
schedulability analysis (§5.2), allocation, admission control and the
executable server runtime.

Every module here is a host-side copy of its counterpart in the reference
package (only the package name differs); the simulator and the
synchronization-based baselines (MPCP, FMLP+) are not part of the port yet.

  * task_model       — τ_i = (C,T,D,G,η) with (G^e, G^m) segments (§3)
  * server_analysis  — the server-based schedulability analysis (§5.2)
  * taskset_gen      — Table-2 random taskset generator
  * allocation       — WFD/FFD/BFD packing with the GPU server (§5.3, Eq 8)
  * server_runtime   — executable server (threads; used by repro_torch.serving)
  * admission        — analysis-driven admission control (beyond paper)
"""

from . import (  # noqa: F401
    admission,
    allocation,
    server_analysis,
    taskset_gen,
)
from .server_runtime import AcceleratorServer, Request  # noqa: F401
from .task_model import GpuSegment, System, Task, server_utilization  # noqa: F401
