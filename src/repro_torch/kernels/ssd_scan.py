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

The backward of ``ssd_intra`` (``csrc/ssd_intra_bwd.cu``; the reference has
none of its own: XLA differentiates its jnp path) recomputes C B^T and the
decay from the saved inputs and gives dx, ddt, ddA, dB and dC for both
cotangents, dy and ds, on the CUDA cores in fp32 (bf16 inputs are widened
as they are read).  :func:`ssd_intra` goes through :class:`SSDIntraFunction`
only when grad is enabled and an input requires grad: under ``no_grad`` or
``inference_mode`` (the serving path, its CUDA graphs) the call is the
forward launch alone.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_CHUNK = 256  # longest chunk ssd_intra takes (the model's chunk size)
MAX_HEAD_DIM = 128
MAX_STATE_BWD = 128  # widest N the backward kernel takes (mamba2-780m's)
# (P, N) pairs the bf16 tensor-core kernel is instantiated for
# (csrc/ssd_intra.cu): mamba2-780m (64, 128) and zamba2-7b (64, 64)
SSD_TENSOR_CORE_WIDTHS = frozenset({(64, 128), (64, 64)})


# --------------------------------------------------------------------------
# kernel 6: intra-chunk SSD
# --------------------------------------------------------------------------


def ssd_intra_plain(x, dt, dA, B, C):
    """x (M,H,Q,P); dt/dA (M,H,Q); B/C (M,Q,N) -> y (M,H,Q,P) fp32 (the
    intra-chunk output), s (M,H,N,P) fp32 (the chunk's end state); float64
    throughout for float64 inputs (the CPU gradient checks)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, dtf, Bf, Cf = (t.to(acc) for t in (x, dt, B, C))
    seg = torch.cumsum(dA.to(acc), dim=-1)  # (M,H,Q)
    q = x.shape[2]
    idx = torch.arange(q, device=x.device)
    causal = idx[:, None] >= idx[None, :]
    L = torch.exp(torch.where(causal, seg[..., :, None] - seg[..., None, :],
                              NEG_INF))
    cb = torch.einsum("min,mjn->mij", Cf, Bf)  # (M,Q,Q)
    w = cb[:, None] * L  # (M,H,Q,Q)
    xdt = xf * dtf[..., None]
    y = torch.einsum("mhij,mhjp->mhip", w, xdt)
    dte = torch.exp(seg[..., -1:] - seg) * dtf  # (M,H,Q)
    bd = Bf[:, None] * dte[..., None]  # (M,H,Q,N)
    s = torch.einsum("mhqn,mhqp->mhnp", bd, xf)
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


def _check_shapes(name, x, dt, dA, B, C, max_n=None):
    m, h, q, p = x.shape
    n = B.shape[-1]
    if (tuple(dt.shape) != (m, h, q) or tuple(dA.shape) != (m, h, q)
            or tuple(B.shape) != (m, q, n) or tuple(C.shape) != (m, q, n)
            or not 1 <= q <= MAX_CHUNK or not 1 <= p <= MAX_HEAD_DIM
            or (max_n is not None and not 1 <= n <= max_n)):
        raise ValueError(
            f"{name}: x (M,H,Q,P) with Q <= {MAX_CHUNK}, P <= "
            f"{MAX_HEAD_DIM}, dt/dA (M,H,Q), B/C (M,Q,N)"
            + ("" if max_n is None else f" with N <= {max_n}")
            + f"; got x {tuple(x.shape)}, dt {tuple(dt.shape)}, dA "
            f"{tuple(dA.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}")
    for nm, t in (("x", x), ("B", B), ("C", C)):
        _build.check_unit_stride(f"{name} {nm}", t)


def ssd_intra(x, dt, dA, B, C):
    """x (M,H,Q,P); dt/dA (M,H,Q) fp32; B/C (M,Q,N) -> y (M,H,Q,P) fp32,
    s (M,H,N,P) fp32.  CPU tensors take the plain version; CUDA tensors
    launch the kernel of :func:`ssd_intra_route`, which takes any Q <= 256
    and strided views (y comes back as a (M,H,Q,P) view of a (M,Q,H,P)
    buffer: the model's layout).  With grad enabled and an input that
    requires grad, the call goes through :class:`SSDIntraFunction`."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, dA, B, C)):
        return SSDIntraFunction.apply(x, dt, dA, B, C)
    return _ssd_intra_forward(x, dt, dA, B, C)


def _ssd_intra_forward(x, dt, dA, B, C):
    if _build.on_cpu(x, dt, dA, B, C):
        return ssd_intra_plain(x, dt, dA, B, C)
    dtype = _build.kernel_dtype(x, B, C)
    _fp32("ssd_intra", dt, dA)
    _check_shapes("ssd_intra", x, dt, dA, B, C)
    m, h, q, p = x.shape
    n = B.shape[-1]
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


def ssd_intra_bwd_plain(x, dt, dA, B, C, dy, ds):
    """(dx, ddt, ddA, dB, dC) of :func:`ssd_intra_plain` for the cotangents
    dy (M,H,Q,P) of y and ds (M,H,N,P) of s, by the backward kernel's
    explicit formula, in fp32 (float64 for float64 inputs).  Per (chunk,
    head), with seg = cumsum(dA), L_ij = exp(seg_i - seg_j) for i >= j,
    G = C B^T, u = x dt, W = G o L and e_j = exp(seg_last - seg_j) dt_j:

        dW = dy u^T (lower triangle), du = W^T dy, dG = dW o L,
        dC = (sum_h dG) B, dB = (sum_h dG)^T C + sum_h e_j ds x_j,
        dx = du dt + e_j ds^T B_j,
        ddt = rowsum(du o x) + v_j exp(seg_last - seg_j),
        dseg = rowsum(R) - colsum(R) - v o e, plus sum(v o e) at the last
        position, where R = dW o W and v_j = B_j . ds x_j;
        ddA = the reverse cumsum of dseg.

    dx in x's dtype, dB and dC in B's, ddt and ddA in dt's."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, dtf, dAf, Bf, Cf, dyf, dsf = (t.to(acc)
                                      for t in (x, dt, dA, B, C, dy, ds))
    seg = torch.cumsum(dAf, dim=-1)  # (M,H,Q)
    q = x.shape[2]
    idx = torch.arange(q, device=x.device)
    causal = idx[:, None] >= idx[None, :]
    L = torch.exp(torch.where(causal, seg[..., :, None] - seg[..., None, :],
                              NEG_INF))  # (M,H,Q,Q), 0 above the diagonal
    W = torch.einsum("min,mjn->mij", Cf, Bf)[:, None] * L
    dW = torch.einsum("mhip,mhjp->mhij", dyf, xf * dtf[..., None]) * causal
    du = torch.einsum("mhij,mhip->mhjp", W, dyf)
    dgs = (dW * L).sum(1)  # (M,Q,Q): dG summed over the heads
    decay = torch.exp(seg[..., -1:] - seg)  # (M,H,Q)
    e = decay * dtf
    dsx = torch.einsum("mhnp,mhjp->mhjn", dsf, xf)  # ds x_j, (M,H,Q,N)
    dsb = torch.einsum("mhnp,mjn->mhjp", dsf, Bf)  # ds^T B_j, (M,H,Q,P)
    dC = torch.einsum("mij,mjn->min", dgs, Bf)
    dB = (torch.einsum("mij,min->mjn", dgs, Cf)
          + torch.einsum("mhj,mhjn->mjn", e, dsx))
    dx = du * dtf[..., None] + e[..., None] * dsb
    v = (dsb * xf).sum(-1)  # (M,H,Q)
    ddt = (du * xf).sum(-1) + v * decay
    R = dW * W
    ve = v * e
    dseg = R.sum(-1) - R.sum(-2) - ve
    dseg[..., -1] += ve.sum(-1)
    ddA = torch.flip(torch.cumsum(torch.flip(dseg, (-1,)), -1), (-1,))
    return (dx.to(x.dtype), ddt.to(dt.dtype), ddA.to(dA.dtype),
            dB.to(B.dtype), dC.to(C.dtype))


def ssd_intra_bwd(x, dt, dA, B, C, dy, ds):
    """(dx, ddt, ddA, dB, dC) of :func:`ssd_intra` from its inputs and the
    cotangents dy (M,H,Q,P) fp32 of y and ds (M,H,N,P) fp32 of s.  CPU
    tensors take the plain version; CUDA tensors launch the backward
    kernel (on the tensor cores on :func:`ssd_intra_route`'s tensor-core
    route, else on the CUDA cores), which takes Q <= 256, P <= 128, N <= 128
    and strided x, B, C and dy with a unit-stride last axis, and raises
    ``ValueError`` (or
    ``TypeError`` for a dtype) before any launch for anything else.  dx
    comes back as a (M,H,Q,P) view of a (M,Q,H,P) buffer (x's layout in
    the model), ddt and ddA fp32, dB and dC in B's dtype."""
    if _build.on_cpu(x, dt, dA, B, C, dy, ds):
        return ssd_intra_bwd_plain(x, dt, dA, B, C, dy, ds)
    dtype = _build.kernel_dtype(x, B, C)
    _fp32("ssd_intra_bwd", dt, dA, dy, ds)
    _check_shapes("ssd_intra_bwd", x, dt, dA, B, C, max_n=MAX_STATE_BWD)
    m, h, q, p = x.shape
    n = B.shape[-1]
    if tuple(dy.shape) != (m, h, q, p) or tuple(ds.shape) != (m, h, n, p):
        raise ValueError(
            f"ssd_intra_bwd: dy (M,H,Q,P), ds (M,H,N,P); got dy "
            f"{tuple(dy.shape)}, ds {tuple(ds.shape)} for x {tuple(x.shape)}, "
            f"B {tuple(B.shape)}")
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    ds = ds.contiguous()
    dev = x.device
    dx = torch.empty((m, q, h, p), dtype=x.dtype, device=dev).permute(0, 2, 1, 3)
    ddt = torch.empty((m, h, q), dtype=torch.float32, device=dev)
    ddA = torch.empty((m, h, q), dtype=torch.float32, device=dev)
    dB = torch.empty((m, q, n), dtype=B.dtype, device=dev)
    dC = torch.empty((m, q, n), dtype=C.dtype, device=dev)
    if m == 0:
        return dx, ddt, ddA, dB, dC
    route = ssd_intra_route(x, B, C)
    # fp32 scratch: seg, R's column sums, v e (M,H,Q each); R's row sums
    # per 64-wide tile pair (M,H,ceil(Q/64),Q); C B^T and dG summed over the
    # heads (M,Q,Q each); on the tensor cores also dy's and ds's bf16 pairs
    # (M,H,P,Q+N in floats), the dB head term (M,Q,N) and the partial sums
    # of G = min(H, 8) head groups (G (M,Q,Q + M,Q,N)), each region 16-byte
    # aligned
    size = m * h * q * (3 + -(-q // 64)) + 2 * m * q * q
    if route == "tensor_cores":
        groups = min(h, 8)
        size += (m * h * p * (q + n) + m * q * n * (1 + groups)
                 + groups * m * q * q + 16)
    scratch = torch.empty(size, dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 19)(
        *x.stride()[:3], *dt.stride(), *dA.stride(), *B.stride()[:2],
        *C.stride()[:2], *dy.stride()[:3], *dx.stride()[:3])
    _build.launch("ssd_intra_bwd", "ssd_intra_bwd_launch", x.data_ptr(),
                  dt.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
                  dy.data_ptr(), ds.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                  ddA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                  scratch.data_ptr(), m, h, q, p, n, strides, dtype,
                  int(route == "tensor_cores"), _build.stream_of(x))
    return dx, ddt, ddA, dB, dC


class SSDIntraFunction(torch.autograd.Function):
    """ssd_intra with its backward kernel.  Saves x, dt, dA, B and C: the
    backward recomputes C B^T and the decay, never the (M,H,Q,Q)
    weights."""

    @staticmethod
    def forward(ctx, x, dt, dA, B, C):
        y, s = _ssd_intra_forward(x, dt, dA, B, C)
        ctx.save_for_backward(x, dt, dA, B, C)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        return ssd_intra_bwd(*ctx.saved_tensors, dy, ds)


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
