"""Causal or full GQA prefill attention: CUDA kernel
(``csrc/flash_attention.cu``), plain version and wrapper.

Counterpart of ``repro/kernels/flash_attention.py``, in the model's
(B, S, N, H) layout (the kernel reads it through strides; nothing is
transposed).  The value width may differ from the query/key width: MLA
prefill attends with H = qk_nope + qk_rope and Hv = v_head_dim.  Full
(``causal=False``) attention may take a key/value length Sk of its own:
enc-dec cross-attention attends from the decoder's S tokens to the
encoder's Sk frames.  The plain version is the model's ``_sdpa``
(``repro/models/layers.py:118``): it rounds the normalised softmax
probabilities to the value dtype before the PV product.  The kernel has
two versions, chosen by dtype: fp32 runs on the CUDA cores and keeps the
probabilities in fp32 (agreeing with the plain version to 1e-5); bf16 runs
on the tensor cores and rounds the unnormalised probabilities to bf16
(agreeing to the bf16 tolerance), for the head widths in
:data:`TENSOR_CORE_WIDTHS` only and with 16-byte aligned operands.

The backward (``csrc/flash_attention_bwd.cu``; the reference has none of
its own: XLA differentiates the jnp path) is FlashAttention-2's recompute
backward from the forward's row log-sum-exp, which the forward kernel
writes when asked (natural log, fp32, (B, Nq, S)).  It takes every training
shape of the registry -- causal or full, a key length Sk of its own when
full, a value width Hv of its own -- at the (H, Hv) pairs in
:data:`BWD_WIDTHS` (bf16 on the tensor cores, with 16-byte aligned operands
as the forward; fp32 on the CUDA cores), and :class:`FlashAttentionFunction`
refuses any other width on the card before any launch; its plain version
takes every shape.  :func:`flash_attention` goes through the Function only
when grad is enabled and an input requires grad: under ``no_grad`` or
``inference_mode`` (the serving path, its CUDA graphs) the call is the
forward launch alone, with no lse.

DTensor inputs (a sharded step) run under ``local_map``: batch shards
stay, the heads split where both head counts divide, every other shard
is gathered, and the wrapper -- its Function and launches included --
sees the local tensors only.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import Shard

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import _build

# (H, Hv) pairs the bf16 tensor-core kernel is instantiated for
# (csrc/flash_attention.cu): the repo's attention configs' head widths --
# internlm2, llama3, granite, qwen (128), whisper (64), zamba2 (112) and
# MLA prefill (192 / 128) -- and the reduced configs' 16, which the serving
# launcher (launch/serve.py) runs
_CONFIG_WIDTHS = frozenset({(64, 64), (112, 112), (128, 128), (192, 128)})
TENSOR_CORE_WIDTHS = _CONFIG_WIDTHS | {(16, 16)}
# (H, Hv) pairs the backward kernel is instantiated for, by dtype
# (csrc/flash_attention_bwd.cu): in bf16 on the tensor cores, the configs'
# pairs; in fp32 on the CUDA cores, those and the reduced configs' 16, 32
# and MLA's (24, 16)
BWD_WIDTHS = {
    torch.float32: _CONFIG_WIDTHS | {(16, 16), (24, 16), (32, 32)},
    torch.bfloat16: _CONFIG_WIDTHS}


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32, or float64 for float64 inputs (the CPU gradient checks)."""
    return torch.promote_types(dtype, torch.float32)


def sdpa(q, k, v, *, mask, scale: float):
    """q (B,Sq,Nq,H); k/v (B,Sk,Nkv,H); grouped heads; fp32 softmax.
    ``mask`` broadcasts against (B, Nkv, g, Sq, Sk)."""
    b, sq, nq, h = q.shape
    nkv = k.shape[2]
    hv = v.shape[-1]
    g = nq // nkv
    acc = _acc_dtype(q.dtype)
    qg = q.reshape(b, sq, nkv, g, h)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.to(acc), k.to(acc)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype).to(acc),
                       v.to(acc))
    return out.reshape(b, sq, nq, hv).to(v.dtype)


def _causal_mask(s: int, device):
    idx = torch.arange(s, device=device)
    return (idx[None, :] <= idx[:, None])[None, None, None]


def _lse(q, k, mask, scale):
    """Row log-sum-exp of the scaled scores, (B, Nq, S) fp32 (or float64)."""
    b, sq, nq, h = q.shape
    nkv = k.shape[2]
    acc = _acc_dtype(q.dtype)
    qg = q.reshape(b, sq, nkv, nq // nkv, h)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.to(acc), k.to(acc)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    return torch.logsumexp(logits, dim=-1).reshape(b, nq, sq)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float | None = None, with_lse: bool = False):
    """q (B,S,Nq,H); k (B,Sk,Nkv,H); v (B,Sk,Nkv,Hv) -> (B,S,Nq,Hv); Sk = S
    when ``causal``.  With ``with_lse`` returns (out, lse), lse (B,Nq,S)
    the rows' natural-log log-sum-exp of the scaled scores in fp32."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    mask = _causal_mask(q.shape[1], q.device) if causal else None
    out = sdpa(q, k, v, mask=mask, scale=scale)
    return (out, _lse(q, k, mask, scale)) if with_lse else out


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              scale: float | None = None):
    """(dq, dk, dv) of :func:`flash_attention_plain` from its output ``o``,
    row log-sum-exp ``lse`` (B,Nq,S) and the output gradient ``do``, by
    the backward kernel's formula in fp32: P = exp(scale * QK^T - lse)
    (masked to 0), D = rowsum(do * o), dS = P * (do V^T - D); dv = P^T do,
    dq = scale * dS K, dk = scale * dS^T Q, grouped heads summed.  Every
    shape the forward takes (Hv != H, Sk != S when not causal)."""
    b, sq, nq, h = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    scale = scale if scale is not None else h ** -0.5
    acc = _acc_dtype(q.dtype)
    qg = q.reshape(b, sq, nkv, g, h).to(acc)
    dog = do.reshape(b, sq, nkv, g, -1).to(acc)
    kf, vf = k.to(acc), v.to(acc)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, kf) * scale
    p = torch.exp(logits - lse.reshape(b, nkv, g, sq, 1).to(acc))
    if causal:
        p = torch.where(_causal_mask(sq, q.device), p, 0.0)
    delta = (do.to(acc) * o.to(acc)).sum(-1)  # (B, S, Nq)
    delta = delta.reshape(b, sq, nkv, g).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bskgh,btkh->bkgst", dog, vf)
    ds = p * (dp - delta)
    dv = torch.einsum("bkgst,bskgh->btkh", p, dog)
    dq = torch.einsum("bkgst,btkh->bskgh", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qg) * scale
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """q (B,S,Nq,H); k (B,Sk,Nkv,H); v (B,Sk,Nkv,Hv) -> (B,S,Nq,Hv) in q's
    dtype, Sk = S when ``causal``.  CPU tensors take the plain version;
    CUDA tensors launch the kernel, which in bf16 raises ``ValueError`` for
    an (H, Hv) outside :data:`TENSOR_CORE_WIDTHS` or an operand whose base
    or strides are not 16-byte aligned.  With grad enabled and an input
    that requires grad, the call goes through
    :class:`FlashAttentionFunction`."""
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    mesh = shd.mesh_of(q, k, v)
    if mesh is not None:
        return _flash_sharded(mesh, q, k, v, causal, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, scale)
    return _flash_forward(q, k, v, causal, scale, with_lse=False)


def _flash_sharded(mesh, q, k, v, causal: bool, scale: float):
    """:func:`flash_attention` on DTensors: per mesh dim, q's batch shard,
    else the heads where Nq and Nkv both divide, for q, k and v alike,
    anything else gathered; the call runs on the local shards."""
    q, k, v = (shd.as_dtensor(t, mesh) for t in (q, k, v))
    plan = shd.kernel_plan(mesh, q, (q.shape[2], k.shape[2]))
    pl = shd.plan_placements(plan, batch=Shard(0), heads=Shard(2))

    def local(q, k, v):
        return flash_attention(q, k, v, causal=causal, scale=scale)

    return shd.local_call(local, (q, k, v), (pl, pl, pl), pl)


def _flash_forward(q, k, v, causal: bool, scale: float, *, with_lse: bool):
    """The forward: out, or (out, lse) with ``with_lse``."""
    if _build.on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     with_lse=with_lse)
    dtype = _build.kernel_dtype(q, k, v)
    b, s, nq, h = q.shape
    sk, nkv, hv = k.shape[1], k.shape[2], v.shape[-1]
    if (tuple(k.shape) != (b, sk, nkv, h)
            or tuple(v.shape) != (b, sk, nkv, hv) or nq % nkv or sk < 1
            or (causal and sk != s)):
        raise ValueError(
            f"flash_attention: q (B,S,Nq,H), k (B,Sk,Nkv,H), v (B,Sk,Nkv,Hv), "
            f"Sk >= 1 and Sk = S when causal; got q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, causal={causal}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_unit_stride(f"flash_attention {name}", t)
        if q.dtype == torch.bfloat16:
            _build.check_aligned(f"flash_attention {name}", t)
    if q.dtype == torch.bfloat16 and (h, hv) not in TENSOR_CORE_WIDTHS:
        raise ValueError(
            f"flash_attention: no bf16 kernel for head widths (H, Hv) = "
            f"({h}, {hv}); instantiated: {sorted(TENSOR_CORE_WIDTHS)}")
    out = torch.empty((b, s, nq, hv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, nq, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b and s:
        _build.launch(
            "flash_attention", "flash_attention_launch", q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, s, sk, nq, nkv, h,
            hv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal), scale, dtype,
            _build.stream_of(q))
    return (out, lse) if with_lse else out


def check_backward(q, k, v, causal: bool) -> None:
    """Raises ``ValueError`` unless the backward kernel takes these shapes
    (CUDA tensors only: the plain backward takes every shape): an (H, Hv)
    pair of :data:`BWD_WIDTHS` for the dtype, and Sk = S when causal."""
    if _build.on_cpu(q, k, v):
        return
    h, hv, s, sk = q.shape[-1], v.shape[-1], q.shape[1], k.shape[1]
    widths = BWD_WIDTHS.get(q.dtype, frozenset())
    if (h, hv) not in widths or (causal and sk != s):
        raise ValueError(
            f"flash_attention's backward kernel takes (H, Hv) in "
            f"{sorted(widths)} for {q.dtype}, and Sk = S when causal; got "
            f"H={h}, Hv={hv}, S={s}, Sk={sk}, causal={causal}")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        scale: float | None = None):
    """(dq, dk, dv) in q's dtype from the forward's ``o`` and ``lse`` and
    the output gradient ``do`` (q, o, do (B,S,Nq,.), k, v (B,Sk,Nkv,.), lse
    (B,Nq,S) fp32).  CPU tensors take the plain version; CUDA tensors
    launch the backward kernel (three kernels: D = rowsum(do * o), then
    dk/dv, then dq; bf16 on the tensor cores, fp32 on the CUDA cores),
    which raises ``ValueError`` for shapes outside :func:`check_backward`
    and, in bf16, for an operand whose base is not 16-byte aligned."""
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if _build.on_cpu(q, k, v, o, lse, do):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         scale=scale)
    check_backward(q, k, v, causal)
    dtype = _build.kernel_dtype(q, k, v, o, do)
    b, s, nq, h = q.shape
    sk, nkv, hv = k.shape[1], k.shape[2], v.shape[-1]
    if (tuple(k.shape) != (b, sk, nkv, h) or tuple(v.shape) != (b, sk, nkv, hv)
            or tuple(o.shape) != (b, s, nq, hv)
            or tuple(do.shape) != (b, s, nq, hv)
            or tuple(lse.shape) != (b, nq, s) or lse.dtype != torch.float32
            or nq % nkv):
        raise ValueError(
            f"flash_attention_bwd: q (B,S,Nq,H), k (B,Sk,Nkv,H), v "
            f"(B,Sk,Nkv,Hv), o/do (B,S,Nq,Hv), lse (B,Nq,S) fp32; got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, o "
            f"{tuple(o.shape)}, do {tuple(do.shape)}, lse "
            f"{tuple(lse.shape)} {lse.dtype}")
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
            _build.check_aligned(f"flash_attention_bwd {name}", t)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, nq, s), dtype=torch.float32, device=q.device)
    if b and s:
        _build.launch(
            "flash_attention_bwd", "flash_attention_bwd_launch", q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, s, sk, nq, nkv, h, hv, int(causal), scale,
            dtype, _build.stream_of(q))
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """flash_attention with its backward kernel: the forward also writes
    the rows' lse; saves q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        check_backward(q, k, v, causal)
        out, lse = _flash_forward(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None
