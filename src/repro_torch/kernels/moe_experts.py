"""Routed experts of a MoE decode call: CUDA kernel
(``csrc/moe_routed_experts.cu``), plain version and wrapper.

Replaces no TPU kernel: the reference's ``moe_dense``
(``repro/models/moe.py``) runs every token through every expert in jnp and
multiplies the products of the experts a token did not choose by a zero
combine weight.  The port keeps that path for training and prefill
(``models/moe.py``); a decode step (``models/moe.py::moe_route``) runs here
the experts its rows chose, and reads only their weights.  What bounds the
kernel on the card, and what its design does about it, is in the source's
note: bytes, the chosen experts' weights over 3.35 TB/s.

Given x (T, D), the router's idx (T, K) and weights (T, K) and the expert
stacks w_gate / w_up (E, D, F) and w_down (E, F, D), each (row t, choice k)
slot gets y[t, k] = (silu(x[t] w_gate[e]) * (x[t] w_up[e])) w_down[e] with
e = idx[t, k], rounded where ``moe_dense`` rounds, and out[t] = sum over k
of weights[t, k] y[t, k], summed in fp32 and rounded once.

Two kernel routes, picked by :func:`moe_experts_route` before any launch:
"tensor_cores" for bf16 whose D and F are whole :data:`TILE`-column tiles
with 16-byte aligned operands, "scalar" otherwise (fp32; the reduced
configs' widths).  Each of the two expert kernels runs a persistent grid
of :data:`BLOCKS_PER_SM` blocks a streaming multiprocessor, fixed per
device, so a CUDA graph captures it.

The mechanism's counter: each device holds one (2,) int64 tensor
(:func:`experts_counter`) to which every call adds, on the device, the
experts its rows chose and E, the experts it could have read; their ratio
is the share of the routed experts' weights read.  The plain version adds
the same on the CPU.  A copy of it made on the current stream (the
engine's, where tracing switches) needs no host sync.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

# the tensor-core route's column tile (csrc/moe_routed_experts.cu kBN, kBK)
TILE = 64
# slots of one expert a row tile holds (csrc/moe_routed_experts.cu
# kRowTile): each tile streams its expert's weights, so past an average of
# one tile an expert the kernel reads more than moe_dense, and a call takes
# this route only while T * K <= ROW_TILE * E (models/moe.py::moe_route:
# 170 rows at E 64 / K 6, 115 at E 72 / K 10)
ROW_TILE = 16
# route codes of csrc/moe_routed_experts.cu
ROUTES = {"scalar": 0, "tensor_cores": 1}
# persistent blocks a streaming multiprocessor, in each expert kernel:
# three of the tensor-core route's 3-stage rings (62 KB gate/up, 35 KB
# down) share one (csrc/moe_routed_experts.cu)
BLOCKS_PER_SM = 3
# the most (row, choice) slots a call takes: the routing table each block
# builds in shared memory (about 9 bytes a slot) must fit beside its ring
MAX_SLOTS = 8192

_counters: dict[torch.device, torch.Tensor] = {}
_counters_lock = threading.Lock()


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def experts_counter(device) -> torch.Tensor:
    """The (2,) int64 counter of ``device``: [experts read, experts that
    could have been read], summed over every routed call on it since the
    process started.  Made at first use, which must not be inside a CUDA
    graph capture (the engine runs each cell eagerly before capturing it)."""
    device = _device(device)
    with _counters_lock:
        counter = _counters.get(device)
        if counter is None:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("moe_routed_experts: run once eagerly before "
                                   "a CUDA graph captures it (its counter "
                                   "is made at first use)")
            with torch.inference_mode(False):
                counter = torch.zeros(2, dtype=torch.int64, device=device)
            if device.type == "cuda":  # zeroed before any stream adds to it
                torch.cuda.current_stream(device).synchronize()
            _counters[device] = counter
        return counter


def moe_routed_experts_plain(x, idx, weights, w_gate, w_up, w_down):
    """x (T, D); idx (T, K) int64; weights (T, K) in x's dtype; w_gate /
    w_up (E, D, F); w_down (E, F, D) -> (T, D) in x's dtype, by a loop over
    the experts some row chose: an expert's slots, in slot order, through
    its SwiGLU in x's dtype (``moe_dense``'s ops), then each row's K
    outputs weighted and summed in fp32 (float64 for float64 inputs) and
    rounded once.  Adds to the counter of x's device."""
    t, k = idx.shape
    flat = idx.reshape(-1)
    y = x.new_zeros((t * k, x.shape[-1]))
    hit = torch.unique(flat).tolist()
    for e in hit:
        slots = torch.nonzero(flat == e)[:, 0]
        xe = x[slots // k]
        h = F.silu(torch.matmul(xe, w_gate[e])) * torch.matmul(xe, w_up[e])
        y[slots] = torch.matmul(h, w_down[e])
    acc = torch.promote_types(x.dtype, torch.float32)
    out = (weights.to(acc)[..., None] * y.view(t, k, -1).to(acc)).sum(dim=1)
    counter = experts_counter(x.device)
    counter.add_(torch.tensor([len(hit), w_gate.shape[0]], dtype=torch.int64,
                              device=counter.device))
    return out.to(x.dtype)


def moe_experts_route(x, w_gate, w_up, w_down) -> str:
    """The kernel route: "tensor_cores" for bf16 whose D and F (w_gate's
    last two axes) are whole :data:`TILE`-column tiles, with x and the
    stacks 16-byte aligned; "scalar" otherwise."""
    d, f = w_gate.shape[1:]
    if (x.dtype == torch.bfloat16 and d % TILE == 0 and f % TILE == 0
            and all(_build.is_aligned(t) for t in (x, w_gate, w_up, w_down))):
        return "tensor_cores"
    return "scalar"


def moe_routed_experts(x, idx, weights, w_gate, w_up, w_down):
    """x (T, D); idx (T, K) int64; weights (T, K); w_gate / w_up (E, D, F);
    w_down (E, F, D) -> (T, D) in x's dtype.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if _build.on_cpu(x, idx, weights, w_gate, w_up, w_down):
        return moe_routed_experts_plain(x, idx, weights, w_gate, w_up, w_down)
    dtype = _build.kernel_dtype(x, weights, w_gate, w_up, w_down)
    _check(x, idx, weights, w_gate, w_up, w_down)
    t, d = x.shape
    e, _, f = w_gate.shape
    k = idx.shape[1]
    out = torch.empty((t, d), dtype=x.dtype, device=x.device)
    if not t:
        return out
    route = moe_experts_route(x, w_gate, w_up, w_down)
    h = torch.empty((t * k, f), dtype=x.dtype, device=x.device)
    y = torch.empty((t * k, d), dtype=x.dtype, device=x.device)
    counter = experts_counter(x.device)
    grid = BLOCKS_PER_SM * _build.sm_count(x.device)
    _build.launch("moe_routed_experts", "moe_routed_experts_launch",
                  x.data_ptr(), idx.data_ptr(), weights.data_ptr(),
                  w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
                  h.data_ptr(), y.data_ptr(), out.data_ptr(),
                  counter.data_ptr(), t, k, e, d, f, grid, dtype,
                  ROUTES[route], _build.stream_of(x))
    return out


def _check(x, idx, weights, w_gate, w_up, w_down) -> None:
    t, d = x.shape
    e, _, f = w_gate.shape
    k = idx.shape[-1]
    if (tuple(idx.shape) != (t, k) or tuple(weights.shape) != (t, k)
            or tuple(w_gate.shape) != (e, d, f)
            or tuple(w_up.shape) != (e, d, f)
            or tuple(w_down.shape) != (e, f, d)):
        raise ValueError(
            "moe_routed_experts takes x (T, D), idx and weights (T, K), "
            "w_gate and w_up (E, D, F), w_down (E, F, D); got x "
            f"{tuple(x.shape)}, idx {tuple(idx.shape)}, weights "
            f"{tuple(weights.shape)}, w_gate {tuple(w_gate.shape)}, w_up "
            f"{tuple(w_up.shape)}, w_down {tuple(w_down.shape)}")
    if idx.dtype != torch.int64:
        raise ValueError(f"moe_routed_experts: idx must be int64, got {idx.dtype}")
    if not all(a.is_contiguous() for a in (x, idx, weights, w_gate, w_up,
                                           w_down)):
        raise ValueError("moe_routed_experts takes contiguous tensors")
    if t * k > MAX_SLOTS:
        raise ValueError(f"moe_routed_experts: {t} rows of {k} choices "
                         f"exceed the kernel's {MAX_SLOTS} slots")
