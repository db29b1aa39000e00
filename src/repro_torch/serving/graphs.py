"""One warm cell of the serving engine as a CUDA graph.

The reference compiles each (rows, width) decode cell and (rows, bucket)
prefill cell once with ``jax.jit`` and calls the compiled program from
then on.  The port's counterpart is a CUDA graph per cell: the cell's
device work is captured once, and a call copies its host inputs into the
graph's static input tensors and replays the graph -- one launch from the
host instead of one per op.

A :class:`GraphCell`'s outputs are static too: every replay writes the same
tensors, so a caller reads (or copies) them before the next replay of any
graph that shares the cell's memory pool.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from repro_torch.kernels import _build


class GraphCell:
    """``fn(*inputs)`` captured as a CUDA graph on the current stream.

    ``inputs`` are device tensors that ``fn`` reads and that every replay
    refills; ``pool`` is the memory pool shared with the caller's other
    cells (``torch.cuda.graph_pool_handle()``).  The caller runs ``fn``
    eagerly on the same stream first, so library handles and workspaces,
    kernel attributes and the allocator are set up before the capture.  A
    capture that fails raises.  The kernel launches that the capture
    records are kept in :attr:`launches` and counted at every replay."""

    def __init__(self, fn, inputs, *, pool=None):
        self.inputs = tuple(inputs)
        self.launches: Counter = Counter()
        self.graph = torch.cuda.CUDAGraph()
        torch.cuda.current_stream().synchronize()
        with _build.count_into(self.launches):
            # thread_local: other servers' threads may allocate meanwhile
            self.graph.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
            try:
                self.outputs = fn(*self.inputs)
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:  # the capture is already invalid
                    pass
                raise
            self.graph.capture_end()

    def load(self, *arrays) -> None:
        """Copy ``arrays`` (numpy arrays or tensors) into the static inputs:
        one copy each, on the current stream."""
        for dst, src in zip(self.inputs, arrays, strict=True):
            dst.copy_(src if isinstance(src, torch.Tensor)
                      else torch.from_numpy(np.ascontiguousarray(src)))

    def replay(self, *arrays):
        """:meth:`load` ``arrays`` when given, replay the graph on the
        current stream and return its static outputs."""
        if arrays:
            self.load(*arrays)
        self.graph.replay()
        _build.add_launches(self.launches)
        return self.outputs
