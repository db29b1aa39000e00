"""Mamba-2 SSD kernels: the intra-chunk prefill kernel (``csrc/ssd_intra.cu``)
and the slab-addressed decode step (``csrc/ssd_slab_decode.cu``), each with
its plain version and wrapper.

Counterpart of ``repro/kernels/ssd_scan.py``, with two differences of
contract, both following the model path (``repro/models/ssm.py``):

* ``ssd_intra`` returns y in fp32: ``ssd_chunked`` adds the inter-chunk
  term to the fp32 intra-chunk output and casts once, where the Pallas
  kernel casts y itself.  In fp32 the two agree to summation order; in
  bf16 the Pallas kernel's extra rounding of y differs by up to 2e-2.
* both take strided views (the model's permuted activations and the
  ``xBC`` split slices) without a copy; the last axis must be unit-stride.

``dt``, ``dA`` and ``A`` are fp32 (the model computes them in fp32 whatever
its dtype); ``x``, ``B`` and ``C`` share one dtype, fp32 or bf16.

``ssd_intra`` has two kernels, picked by :func:`ssd_intra_route` from dtype,
widths and alignment before any launch: bf16 at the (P, N) widths in
:data:`SSD_TENSOR_CORE_WIDTHS` with 16-byte aligned operands runs on the
tensor cores (its scores and scaled inputs enter the products as a pair of
bf16 values, and agree with the plain version to the bf16 tolerance); fp32,
and bf16 at other widths, run on the CUDA cores (fp32 to 1e-5).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_CHUNK = 256  # longest chunk ssd_intra takes (the model's chunk size)
MAX_HEAD_DIM = 128
# (P, N) pairs the bf16 tensor-core kernel is instantiated for
# (csrc/ssd_intra.cu): mamba2-780m (64, 128) and zamba2-7b (64, 64)
SSD_TENSOR_CORE_WIDTHS = frozenset({(64, 128), (64, 64)})


# --------------------------------------------------------------------------
# kernel 6: intra-chunk SSD
# --------------------------------------------------------------------------


def ssd_intra_plain(x, dt, dA, B, C):
    """x (M,H,Q,P); dt/dA (M,H,Q); B/C (M,Q,N) -> y (M,H,Q,P) fp32 (the
    intra-chunk output), s (M,H,N,P) fp32 (the chunk's end state)."""
    seg = torch.cumsum(dA.float(), dim=-1)  # (M,H,Q)
    q = x.shape[2]
    idx = torch.arange(q, device=x.device)
    causal = idx[:, None] >= idx[None, :]
    L = torch.exp(torch.where(causal, seg[..., :, None] - seg[..., None, :],
                              NEG_INF))
    cb = torch.einsum("min,mjn->mij", C.float(), B.float())  # (M,Q,Q)
    w = cb[:, None] * L  # (M,H,Q,Q)
    xdt = x.float() * dt.float()[..., None]
    y = torch.einsum("mhij,mhjp->mhip", w, xdt)
    dte = torch.exp(seg[..., -1:] - seg) * dt.float()  # (M,H,Q)
    bd = B.float()[:, None] * dte[..., None]  # (M,H,Q,N)
    s = torch.einsum("mhqn,mhqp->mhnp", bd, x.float())
    return y, s


def _fp32(name: str, *tensors: torch.Tensor) -> None:
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} takes fp32 dt, dA and A; got "
                        f"{[str(t.dtype) for t in tensors]}")


def ssd_intra_route(x, B, C) -> str:
    """The kernel route for x (M,H,Q,P), B/C (M,Q,N): "tensor_cores" for
    bf16 at an (P, N) in :data:`SSD_TENSOR_CORE_WIDTHS` whose x, B and C are
    16-byte aligned (base and strides), "cuda_cores" otherwise."""
    widths = (x.shape[-1], B.shape[-1])
    if (x.dtype == torch.bfloat16 and widths in SSD_TENSOR_CORE_WIDTHS
            and all(_build.is_aligned(t) for t in (x, B, C))):
        return "tensor_cores"
    return "cuda_cores"


def ssd_intra(x, dt, dA, B, C):
    """x (M,H,Q,P); dt/dA (M,H,Q) fp32; B/C (M,Q,N) -> y (M,H,Q,P) fp32,
    s (M,H,N,P) fp32.  CPU tensors take the plain version; CUDA tensors
    launch the kernel of :func:`ssd_intra_route`, which takes any Q <= 256
    and strided views (y comes back as a (M,H,Q,P) view of a (M,Q,H,P)
    buffer: the model's layout).  The kernel has no backward yet: on the
    card, a call whose inputs require grad raises ``ValueError`` rather
    than return an output autograd cannot see through."""
    if _build.on_cpu(x, dt, dA, B, C):
        return ssd_intra_plain(x, dt, dA, B, C)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, dA, B, C)):
        raise ValueError("ssd_intra has no backward kernel yet: SSM and "
                         "hybrid training on the card wait for ROADMAP A12")
    dtype = _build.kernel_dtype(x, B, C)
    _fp32("ssd_intra", dt, dA)
    m, h, q, p = x.shape
    n = B.shape[-1]
    if (tuple(dt.shape) != (m, h, q) or tuple(dA.shape) != (m, h, q)
            or tuple(B.shape) != (m, q, n) or tuple(C.shape) != (m, q, n)
            or not 1 <= q <= MAX_CHUNK or not 1 <= p <= MAX_HEAD_DIM):
        raise ValueError(
            f"ssd_intra: x (M,H,Q,P) with Q <= {MAX_CHUNK}, P <= "
            f"{MAX_HEAD_DIM}, dt/dA (M,H,Q), B/C (M,Q,N); got x "
            f"{tuple(x.shape)}, dt {tuple(dt.shape)}, dA {tuple(dA.shape)}, "
            f"B {tuple(B.shape)}, C {tuple(C.shape)}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        _build.check_unit_stride(f"ssd_intra {name}", t)
    y = torch.empty((m, q, h, p), dtype=torch.float32,
                    device=x.device).permute(0, 2, 1, 3)
    s = torch.empty((m, h, n, p), dtype=torch.float32, device=x.device)
    if m == 0:
        return y, s
    tensor_cores = ssd_intra_route(x, B, C) == "tensor_cores"
    # the CUDA-core kernels keep C B^T in an fp32 (M,Q,Q) scratch
    cb = None if tensor_cores else torch.empty((m, q, q), dtype=torch.float32,
                                               device=x.device)
    cb_ptr = None if cb is None else cb.data_ptr()
    strides = (ctypes.c_longlong * 16)(
        *x.stride()[:3], *dt.stride(), *dA.stride(), *B.stride()[:2],
        *C.stride()[:2], *y.stride()[:3])
    _build.launch("ssd_intra", "ssd_intra_launch", x.data_ptr(),
                  dt.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
                  y.data_ptr(), s.data_ptr(), cb_ptr, m, h, q, p, n, strides,
                  dtype, int(tensor_cores), _build.stream_of(x))
    return y, s


# --------------------------------------------------------------------------
# kernel 7: slab-addressed decode step
# --------------------------------------------------------------------------


def ssd_slab_decode_plain(state_pool, slab_ids, x, dt, A, B, C):
    """state_pool (NS,H,P,N) fp32; slab_ids (B,); x (B,H,P); dt (B,H);
    A (H,); B/C (B,G,N) -> y (B,H,P) x.dtype, states (B,H,P,N) fp32."""
    hg = x.shape[1] // B.shape[1]
    state = state_pool[slab_ids.long()].float()
    dtf = dt.float()
    dec = torch.exp(dtf * A)  # (B,H)
    Bh = B.repeat_interleave(hg, dim=1).float()  # (B,H,N)
    Ch = C.repeat_interleave(hg, dim=1).float()
    upd = (dtf[..., None] * x.float())[..., None] * Bh[:, :, None, :]
    state = dec[..., None, None] * state + upd
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y.to(x.dtype), state


def ssd_slab_decode(state_pool, slab_ids, x, dt, A, B, C):
    """One recurrent SSD step with each row's state read through
    ``slab_ids``: state_pool (NS,H,P,N) fp32 contiguous, slab_ids (B,)
    int32, x (B,H,P), dt (B,H) fp32, A (H,) fp32, B/C (B,G,N) -> y (B,H,P)
    x.dtype, states (B,H,P,N) fp32, gathered in row order.  The caller
    scatters the states back (``pool.index_copy_(0, slab_ids, states)``):
    rows may repeat a slab id (padding, warm-up), so the kernel never
    writes the pool.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if _build.on_cpu(state_pool, slab_ids, x, dt, A, B, C):
        return ssd_slab_decode_plain(state_pool, slab_ids, x, dt, A, B, C)
    dtype = _build.kernel_dtype(x, B, C)
    _fp32("ssd_slab_decode", state_pool, dt, A)
    rows, h, p = x.shape
    ns, n = state_pool.shape[0], state_pool.shape[-1]
    g = B.shape[1]
    if (tuple(state_pool.shape) != (ns, h, p, n) or tuple(dt.shape) != (rows, h)
            or tuple(A.shape) != (h,) or tuple(B.shape) != (rows, g, n)
            or tuple(C.shape) != (rows, g, n) or h % g
            or not state_pool.is_contiguous() or not A.is_contiguous()):
        raise ValueError(
            f"ssd_slab_decode: contiguous state_pool (NS,H,P,N), x (B,H,P), "
            f"dt (B,H), A (H,), B/C (B,G,N) with G | H; got pool "
            f"{tuple(state_pool.shape)}, x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(B.shape)}, "
            f"C {tuple(C.shape)}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        _build.check_unit_stride(f"ssd_slab_decode {name}", t)
    _build.check_index("ssd_slab_decode slab_ids", slab_ids, (rows,))
    y = torch.empty((rows, h, p), dtype=x.dtype, device=x.device)
    states = torch.empty((rows, h, p, n), dtype=torch.float32,
                         device=x.device)
    if rows:
        _build.launch(
            "ssd_slab_decode", "ssd_slab_decode_launch",
            state_pool.data_ptr(), slab_ids.data_ptr(), x.data_ptr(),
            dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), states.data_ptr(), rows, ns, h, p, n, g,
            *x.stride()[:2], *dt.stride(), *B.stride()[:2], *C.stride()[:2],
            dtype, _build.stream_of(x))
    return y, states
