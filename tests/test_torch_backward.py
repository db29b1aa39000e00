"""The plain backward versions of the port's training kernels against JAX,
and each autograd Function against torch.autograd.gradcheck.

* ``flash_attention_bwd_plain`` (dq, dk, dv from the forward's output and
  row lse) against ``jax.vjp`` of ``repro.kernels.ref.flash_attention_ref``
  (layout (B, N, S, H): transposed here), causal at group sizes 1 and 2,
  and, on the attention that only the plain backward takes, non-causal
  with Sk != S and the value width Hv != H against ``jax.vjp`` of the
  model's ``_sdpa``; the lse ``flash_attention_plain`` returns against
  ``jax.nn.logsumexp`` of the scaled scores.
* ``rmsnorm_bwd_plain`` (dx, dw) against ``jax.vjp`` of
  ``repro.models.layers.rms_norm``, in fp32 and bf16.
* ``FlashAttentionFunction`` and ``RMSNormFunction`` against
  ``torch.autograd.gradcheck`` in float64 on the CPU (their backward is the
  plain formula there).

Inputs come from numpy with a seed.  fp32 gradients agree within 1e-5 of
the reference gradient's max |.| (the two sum in other orders); bf16 within
2e-2 (the plain backward treats the forward's casts as the identity, where
jax.vjp differentiates the bf16 products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import (FlashAttentionFunction,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import (RMSNormFunction, rmsnorm_bwd_plain,
                                         rmsnorm_plain)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close_to_max(got, want, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _j(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,nq,nkv,h", [(2, 11, 4, 2, 16), (1, 40, 4, 4, 8),
                                          (2, 33, 6, 2, 32)])
def test_flash_backward_plain_against_jax_vjp(dtype, b, s, nq, nkv, h):
    q, k, v, do = _np(0, (b, s, nq, h), (b, s, nkv, h), (b, s, nkv, h),
                      (b, s, nq, h))
    tq, tk, tv, tdo = (_t(a, dtype) for a in (q, k, v, do))
    out, lse = flash_attention_plain(tq, tk, tv, with_lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo)

    # the reference's (B, N, S, H) layout
    def ref(q, k, v):
        return flash_attention_ref(q, k, v, causal=True)

    jt = [_j(a, dtype).transpose(0, 2, 1, 3) for a in (q, k, v, do)]
    _, vjp = jax.vjp(ref, *jt[:3])
    want = [np.asarray(g.astype(jnp.float32)).transpose(0, 2, 1, 3)
            for g in vjp(jt[3])]
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        _close_to_max(g, w, TOL[dtype])


@pytest.mark.parametrize("causal,sk,hv", [(True, 13, 16), (False, 13, 16),
                                          (False, 20, 8), (True, 13, 24)])
def test_flash_backward_plain_every_shape(causal, sk, hv):
    """What only the plain backward takes: Sk != S (full attention) and
    Hv != H (MLA), against jax.vjp of the model's _sdpa in fp32."""
    b, s, nq, nkv, h = 2, 13, 4, 2, 16
    q, k, v, do = _np(1, (b, s, nq, h), (b, sk, nkv, h), (b, sk, nkv, hv),
                      (b, s, nq, hv))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash_attention_plain(tq, tk, tv, causal=causal, with_lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, causal=causal)
    mask = None
    if causal:
        idx = jnp.arange(s)
        mask = (idx[None, :] <= idx[:, None])[None, None, None]

    def ref(q, k, v):
        return JL._sdpa(q, k, v, mask=mask, scale=h ** -0.5)

    _, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(do))):
        assert tuple(g.shape) == w.shape
        _close_to_max(g, np.asarray(w), TOL["float32"])


@pytest.mark.parametrize("causal", [True, False])
def test_plain_lse_is_the_rows_logsumexp(causal):
    b, s, nq, nkv, h = 2, 9, 4, 2, 8
    q, k, v = _np(2, (b, s, nq, h), (b, s, nkv, h), (b, s, nkv, h))
    _, lse = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal, with_lse=True)
    qg = q.reshape(b, s, nkv, nq // nkv, h)
    logits = jnp.einsum("bskgh,btkh->bkgst", qg, k) * h ** -0.5
    if causal:
        idx = jnp.arange(s)
        logits = jnp.where(idx[None, :] <= idx[:, None], logits, -jnp.inf)
    want = jax.nn.logsumexp(logits, axis=-1).reshape(b, nq, s)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 100), (2, 1, 37),
                                   (2, 7168), (3, 3584)])
def test_rmsnorm_backward_plain_against_jax_vjp(dtype, shape):
    x, w, dy = _np(3, shape, shape[-1:], shape)
    x = x * 3.0
    w = w * 0.1 + 1.0
    got = rmsnorm_bwd_plain(_t(x, dtype), _t(w, dtype), _t(dy, dtype), 1e-5)
    _, vjp = jax.vjp(lambda x, w: JL.rms_norm(x, w, 1e-5), _j(x, dtype),
                     _j(w, dtype))
    for g, want in zip(got, vjp(_j(dy, dtype))):
        assert g.dtype == getattr(torch, dtype)
        _close_to_max(g, np.asarray(want.astype(jnp.float32)), TOL[dtype])


def test_rmsnorm_plain_forward_unchanged_in_fp32_and_bf16():
    """The plain forward computes in fp32 for fp32 and bf16 inputs, bit for
    bit as before it took float64 (for the gradient checks)."""
    x, w = _np(4, (4, 64), (64,))
    for dtype in ("float32", "bfloat16"):
        tx, tw = _t(x, dtype), _t(w, dtype)
        xf = tx.float()
        want = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True)
                                 + 1e-5)).to(tx.dtype) * tw
        assert torch.equal(rmsnorm_plain(tx, tw, 1e-5), want)


@pytest.fixture
def one_thread():
    """One intra-op thread for a gradcheck: it runs thousands of tiny
    float64 ops, and with a worker thread per core in each of several test
    processes at once the workers spin against each other (six such
    flash gradchecks at once took 466 s each on 8 cores, 2.5 s each on one
    thread) and starve every other test on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("causal,sk,hv", [(True, 6, 8), (False, 9, 8),
                                          (True, 6, 5)])
def test_flash_function_gradcheck(one_thread, causal, sk, hv):
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((2, 6, 4, 8), generator=gen, dtype=torch.float64)
    k = torch.randn((2, sk, 2, 8), generator=gen, dtype=torch.float64)
    v = torch.randn((2, sk, 2, hv), generator=gen, dtype=torch.float64)
    for t in (q, k, v):
        t.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttentionFunction.apply(q, k, v, causal, 0.3),
        (q, k, v))


@pytest.mark.parametrize("shape", [(3, 5, 16), (4, 7)])
def test_rmsnorm_function_gradcheck(one_thread, shape):
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    w = torch.randn(shape[-1:], generator=gen, dtype=torch.float64)
    x.requires_grad_(True)
    w.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x, w: RMSNormFunction.apply(x, w, 1e-5), (x, w))


def test_functions_only_under_grad():
    """The wrappers take the Functions only when grad is enabled and an
    input requires grad."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm

    q = torch.randn((1, 4, 2, 8), requires_grad=True)
    x = torch.randn((3, 8), requires_grad=True)
    w = torch.ones(8)
    assert type(flash_attention(q, q, q).grad_fn).__name__ == \
        "FlashAttentionFunctionBackward"
    assert type(rmsnorm(x, w, 1e-5).grad_fn).__name__ == "RMSNormFunctionBackward"
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            assert flash_attention(q, q, q).grad_fn is None
            assert rmsnorm(x, w, 1e-5).grad_fn is None
    q2 = q.detach()
    assert flash_attention(q2, q2, q2).grad_fn is None
