"""Mamba-2 block of the port (SSD -- state-space duality, arXiv:2405.21060).

Counterpart of ``repro/models/ssm.py``.  Prefill runs the chunked SSD
algorithm with its intra-chunk part on the ``ssd_intra`` kernel and the
O(num_chunks) inter-chunk recurrence in torch ops, as the reference leaves
it to XLA.  Decode runs one recurrent step on the ``ssd_slab_decode``
kernel: slab-paged decode through the engine's slab ids, dense decode with
ids 0..B-1 over its own state, so both do the same arithmetic per row.
Decode caches and slab pools are updated in place.  The ``perf`` flags are
read where the reference reads them: ``split_ssm_proj`` in
:func:`init_mamba2` (three projections instead of the fused ``in_proj``)
and ``ssd_chunk`` in :func:`_chunk` (the intra-chunk length).  On
DTensors (a sharded prefill or decode step) the kernels run on local
shards, and the decode caches are written in place in their own layouts.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Shard

from repro_torch.distributed import sharding as shd
from repro_torch.kernels.ssd_scan import ssd_intra, ssd_slab_decode
from repro_torch.models import perf
from repro_torch.models.layers import Params, dense_init, rms_norm


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state_dim


def init_mamba2(cfg, generator, dtype, device) -> Params:
    """The reference's distributions; ``A_log``, ``dt_bias`` and ``ssm_D``
    are fp32 whatever ``dtype``.  Under ``perf`` flag ``split_ssm_proj``
    the fused ``in_proj`` is three projections, ``z_proj`` (d, d_in),
    ``xbc_proj`` (d, cdim) and ``dt_proj`` (d, H), as in the reference."""
    d, d_in, h = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    cdim = conv_dim(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    if perf.current().split_ssm_proj:
        proj = {"z_proj": dense_init(generator, (d, d_in), dtype, device),
                "xbc_proj": dense_init(generator, (d, cdim), dtype, device),
                "dt_proj": dense_init(generator, (d, h), dtype, device)}
    else:
        proj = {"in_proj": dense_init(generator, (d, d_in + cdim + h), dtype,
                                      device)}
    return {
        **proj,
        "conv_w": dense_init(generator, (cfg.conv_width, cdim), dtype, device,
                             scale=1.0 / math.sqrt(cfg.conv_width)),
        "conv_b": torch.zeros((cdim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "dt_bias": torch.zeros((h,), **f32),
        "ssm_D": torch.ones((h,), **f32),
        "gate_norm": torch.ones((d_in,), dtype=dtype, device=device),
        "out_proj": dense_init(generator, (d_in, d), dtype, device),
    }


def _in_projections(cfg, p: Params, x):
    """-> (z (B,S,d_in), xBC (B,S,cdim), dt_raw (B,S,H)), views of one
    fused projection or three split ones."""
    d_in = cfg.d_inner
    cdim = conv_dim(cfg)
    if "in_proj" in p:
        return torch.split(shd.dense(x, p["in_proj"]),
                           [d_in, cdim, cfg.ssm_nheads], dim=-1)
    return (shd.dense(x, p["z_proj"]), shd.dense(x, p["xbc_proj"]),
            shd.dense(x, p["dt_proj"]))


def _causal_conv(x, w, b):
    """Depthwise causal conv1d as a sum of shifted slices (not F.conv1d,
    which runs fp32 through cuDNN in TF32).  x (B,S,C), w (W,C) ->
    (B,S,C).  On DTensors it runs on local shards: rows where x's batch
    is sharded, channels where they divide, the sequence whole."""
    mesh = shd.mesh_of(x, w, b)
    if mesh is not None:
        plan = shd.kernel_plan(mesh, x, (x.shape[-1],))
        xp = shd.plan_placements(plan, batch=Shard(0), heads=Shard(2))
        wp = shd.plan_placements(plan, heads=Shard(1))
        bp = shd.plan_placements(plan, heads=Shard(0))
        gp = [shd.plan_placements(plan, batch=Partial(), heads=p)
              for p in (Shard(1), Shard(0))]
        args = [shd.as_dtensor(t, mesh) for t in (x, w, b)]
        return shd.local_call(_causal_conv, args, (xp, wp, bp), xp,
                              (xp, *gp))
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    s = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[:, i:i + s, :] * w[i]
    return out + b


def _split_xbc(cfg, xbc):
    """(B,S,cdim) -> views x (B,S,H,P), B (B,S,G,N), C (B,S,G,N)."""
    d_in, g, n = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state_dim
    b, s = xbc.shape[:2]
    # a DTensor's split columns are gathered first: the split's bounds
    # need not fall on its shards' (whole_heads lays the parts out again)
    xs, B, C = torch.split(shd.whole_rows(xbc), [d_in, g * n, g * n], dim=-1)
    h = cfg.ssm_nheads
    return (shd.whole_heads(xs, h).view(b, s, h, cfg.ssm_head_dim),
            shd.whole_heads(B, g).view(b, s, g, n),
            shd.whole_heads(C, g).view(b, s, g, n))


def _chunk(s: int, chunk: int | None = None) -> int:
    """The reference's chunk choice: min(``chunk``, or ``perf`` flag
    ``ssd_chunk``, S), halved until it divides S."""
    cq = min(chunk or perf.current().ssd_chunk, s)
    while s % cq:
        cq //= 2
    return max(cq, 1)


def ssd_chunked(x, dt, A, B, C, *, chunk: int):
    """Chunked SSD scan.

    x  (B,S,H,P)   per-head inputs
    dt (B,S,H)     positive step sizes (softplus applied by the caller)
    A  (H,)        negative per-head decay rates
    B  (B,S,1,N)   input projections (one group: ssd_intra's contract)
    C  (B,S,1,N)   output projections
    returns y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32
    """
    mesh = shd.mesh_of(x, dt, A, B, C)
    if mesh is not None:
        return _chunked_sharded(mesh, x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if g != 1 or s % chunk:
        raise ValueError(f"ssd_chunked takes one group and whole chunks; "
                         f"got ngroups={g}, S={s}, chunk={chunk}")
    nc, m = s // chunk, b * (s // chunk)
    dtc = dt.float().reshape(b, nc, chunk, h)
    dA = dtc * A  # (B,NC,Q,H), negative

    # intra-chunk part and chunk states on the kernel (views: chunks merge
    # into the leading axis, heads move before Q)
    y, s_c = ssd_intra(x.reshape(m, chunk, h, p).permute(0, 2, 1, 3),
                       dtc.reshape(m, chunk, h).permute(0, 2, 1),
                       dA.reshape(m, chunk, h).permute(0, 2, 1),
                       B.reshape(m, chunk, n), C.reshape(m, chunk, n))
    y = y.permute(0, 2, 1, 3).reshape(b, nc, chunk, h, p)
    s_c = s_c.reshape(b, nc, h, n, p).transpose(-1, -2)  # (B,NC,H,P,N)

    # inter-chunk: h_c = exp(seg_last) h_{c-1} + S_c, sequential over NC;
    # chunk 0 enters with a zero state, so it adds nothing to y
    final = s_c[:, 0]
    if nc > 1:
        seg = torch.cumsum(dA, dim=2)  # (B,NC,Q,H)
        chunk_decay = torch.exp(seg[:, :, -1, :])  # (B,NC,H)
        Cc = C.float().reshape(b, nc, chunk, 1, n)
        inter = []
        for c in range(1, nc):
            ch = Cc[:, c] * torch.exp(seg[:, c])[..., None]  # (B,Q,H,N)
            inter.append(torch.einsum("bihn,bhpn->bihp", ch, final))
            final = chunk_decay[:, c, :, None, None] * final + s_c[:, c]
        y = torch.cat([y[:, :1], y[:, 1:] + torch.stack(inter, dim=1)], dim=1)
    return y.reshape(b, s, h, p).to(x.dtype), final


def _chunked_sharded(mesh, x, dt, A, B, C, chunk: int):
    """:func:`ssd_chunked` on DTensors, on local shards -- the kernel and
    the inter-chunk recurrence alike, so its per-chunk loop runs as local
    ops: per mesh dim x's rows where they are sharded, else its heads
    where they divide, else gathered."""
    plan = shd.kernel_plan(mesh, x, (x.shape[2],))
    xp = shd.plan_placements(plan, batch=Shard(0), heads=Shard(2))
    ap = shd.plan_placements(plan, heads=Shard(0))
    bp = shd.plan_placements(plan, batch=Shard(0))
    fp = shd.plan_placements(plan, batch=Shard(0), heads=Shard(1))
    grads = (xp, xp, shd.plan_placements(plan, batch=Partial(), heads=Shard(0)),
             *[shd.plan_placements(plan, batch=Shard(0), heads=Partial())] * 2)
    args = [shd.as_dtensor(t, mesh) for t in (x, dt, A, B, C)]
    return shd.local_call(functools.partial(ssd_chunked, chunk=chunk), args,
                          (xp, xp, ap, bp, bp), (xp, fp), grads)


def ssd_decode_step(state, x, dt, A, B, C):
    """One recurrent step over a dense state: the slab kernel with slab ids
    0..B-1.  state (B,H,P,N) fp32; x (B,H,P); dt (B,H); B,C (B,G,N).
    Returns (y (B,H,P), state') -- state' is new; the caller stores it."""
    mesh = shd.mesh_of(state, x, dt, B, C)
    if mesh is not None:
        return _decode_step_sharded(mesh, state, x, dt, A, B, C)
    rows = torch.arange(state.shape[0], dtype=torch.int32,
                        device=state.device)
    return ssd_slab_decode(state, rows, x, dt, A, B, C)


def _decode_step_sharded(mesh, state, x, dt, A, B, C):
    """:func:`ssd_decode_step` on DTensors, on local shards: per mesh dim
    the state's rows where they are sharded, else its heads where they
    (and the groups, unless there is one) divide, else gathered; each
    rank's slab ids are its own rows."""
    g = B.shape[1]
    plan = shd.kernel_plan(mesh, state,
                           (state.shape[1],) + ((g,) if g > 1 else ()))
    hp = shd.plan_placements(plan, batch=Shard(0), heads=Shard(1))
    ap = shd.plan_placements(plan, heads=Shard(0))
    bp = (hp if g > 1 else shd.plan_placements(plan, batch=Shard(0)))
    args = [shd.as_dtensor(t, mesh) for t in (state, x, dt, A, B, C)]
    return shd.local_call(ssd_decode_step, args, (hp, hp, hp, ap, bp, bp),
                          (hp, hp))


def _gate_out(cfg, p: Params, y, z):
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def mamba2_block(cfg, p: Params, x, *, layer_cache=None,
                 chunk: int | None = None):
    """Full Mamba-2 mixer.  Returns (out, new_layer_cache).  ``chunk``
    overrides the intra-chunk length of train / prefill (:func:`_chunk`).

    layer_cache None: train / prefill over the whole sequence (no cache).
    Dense decode: (conv_cache (B,W-1,C), state (B,H,P,N) fp32, pos),
    updated in place.  Slab-paged decode: (conv_stack (L,NS,W-1,C),
    state_stack (L,NS,H,P,N) fp32, lidx, slabs (B,) int32) -- each row
    gathers its slab's conv window, steps the recurrence on the kernel
    (which reads the state through the slab ids), and the new state and
    window are scattered back into the pools in place."""
    b, s, _ = x.shape
    d_in = cfg.d_inner
    z, xBC, dt = _in_projections(cfg, p, x)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])  # (H,)

    if layer_cache is None:
        xBC = F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
        xs, B, C = _split_xbc(cfg, xBC)
        y, _ = ssd_chunked(xs, dt, A, B, C, chunk=_chunk(s, chunk))
        y = y + xs * p["ssm_D"].to(xs.dtype)[:, None]
        return shd.shard_hidden(_gate_out(cfg, p, shd.merge_heads(y, 2), z)), None

    paged = len(layer_cache) == 4
    if paged:
        conv_stack, state_stack, lidx, slabs = layer_cache
        conv_pool, state = conv_stack[lidx], state_stack[lidx]
        conv_cache = conv_pool[slabs.long()]  # (B,W-1,C)
    else:
        conv_cache, state, _pos = layer_cache  # (B,W-1,C), (B,H,P,N)
    win = torch.cat([conv_cache.to(xBC.dtype), xBC], dim=1)  # (B,W,C)
    conv_out = (win * p["conv_w"]).sum(dim=1) + p["conv_b"]
    xs, B, C = _split_xbc(cfg, F.silu(conv_out)[:, None])
    xs, B, C = xs[:, 0], B[:, 0], C[:, 0]
    if paged:
        y, new_state = ssd_slab_decode(state, slabs, xs, dt[:, 0], A, B, C)
        idx = slabs.long()
        state.index_copy_(0, idx, new_state)
        conv_pool.index_copy_(0, idx, win[:, 1:].to(conv_pool.dtype))
        new_cache = (conv_stack, state_stack)
    else:
        y, new_state = ssd_decode_step(state, xs, dt[:, 0], A, B, C)
        shd.assign(state, new_state)
        shd.assign(conv_cache, win[:, 1:])
        new_cache = (conv_cache, state)
    y = y + xs * p["ssm_D"].to(xs.dtype)[:, None]
    return shd.shard_hidden(_gate_out(cfg, p, shd.merge_heads(y, 1)[:, None], z)), new_cache


def prefill_mamba_cache(cfg, p: Params, x, *, lengths=None):
    """Run the block over the prompt AND build the decode cache: returns
    (out, (conv_cache (B,W-1,C), state (B,H,P,N) fp32)).

    ``lengths`` (B,) makes a padded (length-bucketed) prefill exact: dt is
    forced to 0 past each row's true length, so padded positions add
    identity decay and a zero input term (the final state is the state at
    the true length), and the conv tail is gathered per row ending at its
    true length."""
    b, s, _ = x.shape
    d_in = cfg.d_inner
    z, xBC_raw, dt = _in_projections(cfg, p, x)
    dt = F.softplus(dt.float() + p["dt_bias"])
    if lengths is not None:
        valid = (torch.arange(s, device=x.device)[None, :]
                 < lengths.long()[:, None])  # (B,S)
        dt = torch.where(valid[..., None], dt, 0.0)
    A = -torch.exp(p["A_log"])
    xBC = F.silu(_causal_conv(xBC_raw, p["conv_w"], p["conv_b"]))
    xs, B, C = _split_xbc(cfg, xBC)
    y, final = ssd_chunked(xs, dt, A, B, C, chunk=_chunk(s))
    y = y + xs * p["ssm_D"].to(xs.dtype)[:, None]
    out = _gate_out(cfg, p, shd.merge_heads(y, 2), z)
    w = cfg.conv_width
    if lengths is None:
        conv_cache = (xBC_raw[:, -(w - 1):] if s >= w - 1
                      else F.pad(xBC_raw, (0, 0, w - 1 - s, 0)))
    else:
        # the W-1 raw conv inputs ENDING at each true length (front-padded
        # with W-1 zeros, so short rows read what the causal conv saw)
        padded = F.pad(xBC_raw, (0, 0, w - 1, 0))
        idx = lengths.long()[:, None] + torch.arange(w - 1, device=x.device)
        conv_cache = padded[torch.arange(b, device=x.device)[:, None], idx]
    return shd.shard_hidden(out), (conv_cache, final)
