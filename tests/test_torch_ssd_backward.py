"""The backward of the port's ``ssd_intra`` on the CPU, against JAX.

* ``ssd_intra_bwd_plain`` (dx, ddt, ddA, dB, dC from the forward's inputs
  and the cotangents of y and of the chunk state s) against ``jax.vjp`` of
  ``repro.kernels.ref.ssd_intra_ref`` at Q 1, 5 and 64, (P, N) (8, 16) and
  (16, 8), H 1 and 3, with the cotangent on y alone, on s alone and on
  both, in fp32 (1e-5 of the reference gradient's max |.|: the two sum in
  other orders) and bf16 (2e-2: x, B and C and their gradients in bf16;
  the reference's y is bf16, so dy is rounded to bf16 for both).
* ``SSDIntraFunction`` against ``torch.autograd.gradcheck`` in float64 (its
  backward is the plain formula on the CPU).
* ``ssd_intra`` takes the Function only when grad is enabled and an input
  requires grad.
* ``repro_torch.models.ssm.ssd_chunked``'s gradients (through the
  Function, dA = dt A, and the inter-chunk recurrence in torch ops) against
  ``jax.grad`` of ``repro.models.ssm.ssd_chunked`` at two chunks, fp32.

Inputs come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_intra_ref
from repro.models import ssm as JS
from repro_torch.kernels import ssd_scan as S
from repro_torch.models import ssm as TS

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, m, h, q, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, h, q, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((m, h, q)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    da = (dt * a[None, :, None]).astype(np.float32)
    b = rng.standard_normal((m, q, n)).astype(np.float32)
    c = rng.standard_normal((m, q, n)).astype(np.float32)
    dy = rng.standard_normal((m, h, q, p)).astype(np.float32)
    ds = rng.standard_normal((m, h, n, p)).astype(np.float32)
    return x, dt, da, b, c, dy, ds


def _close_to_max(got, want, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q", [1, 5, 64])
@pytest.mark.parametrize("p,n", [(8, 16), (16, 8)])
@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("cot", ["y", "s", "both"])
def test_plain_backward_against_jax_vjp(dtype, q, p, n, h, cot):
    x, dt, da, b, c, dy, ds = _inputs(q * 100 + p * 10 + h, 2, h, q, p, n)
    if cot == "y":
        ds = np.zeros_like(ds)
    elif cot == "s":
        dy = np.zeros_like(dy)
    jdt = getattr(jnp, dtype)
    jx, jb, jc = (jnp.asarray(a).astype(jdt) for a in (x, b, c))
    (y, s), vjp = jax.vjp(ssd_intra_ref, jx, jnp.asarray(dt), jnp.asarray(da),
                          jb, jc)
    dyj = jnp.asarray(dy).astype(y.dtype)
    want = vjp((dyj, jnp.asarray(ds)))
    tdt = getattr(torch, dtype)
    tx, tb, tc = (torch.from_numpy(a).to(tdt) for a in (x, b, c))
    got = S.ssd_intra_bwd_plain(
        tx, torch.from_numpy(dt), torch.from_numpy(da), tb, tc,
        torch.from_numpy(np.array(dyj.astype(jnp.float32))),
        torch.from_numpy(ds))
    for name, g, w, want_dtype in zip(
            ("dx", "ddt", "ddA", "dB", "dC"), got, want,
            (tdt, torch.float32, torch.float32, tdt, tdt)):
        assert g.dtype == want_dtype, name
        _close_to_max(g, np.asarray(w.astype(jnp.float32)), TOL[dtype])


@pytest.fixture
def one_thread():
    """One intra-op thread for a gradcheck (thousands of tiny float64 ops;
    see tests/test_torch_backward.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("m,h,q,p,n", [(2, 3, 7, 5, 4), (1, 2, 1, 3, 2)])
def test_function_gradcheck(one_thread, m, h, q, p, n):
    x, dt, da, b, c, _, _ = _inputs(7, m, h, q, p, n)
    ts = [torch.from_numpy(a).double().requires_grad_(True)
          for a in (x, dt, da, b, c)]
    assert torch.autograd.gradcheck(S.SSDIntraFunction.apply, tuple(ts))


def test_ssd_intra_takes_the_function_only_under_grad():
    x, dt, da, b, c, _, _ = _inputs(8, 2, 3, 6, 4, 4)
    ts = [torch.from_numpy(a) for a in (x, dt, da, b, c)]
    want = S.ssd_intra_plain(*ts)
    y, s = S.ssd_intra(*ts)  # nothing requires grad
    assert y.grad_fn is None
    ts[3].requires_grad_(True)
    y, s = S.ssd_intra(*ts)
    assert type(y.grad_fn).__name__ == "SSDIntraFunctionBackward"
    assert torch.equal(y, want[0]) and torch.equal(s, want[1])
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            y, _ = S.ssd_intra(*ts)
        assert y.grad_fn is None


@pytest.mark.parametrize("nc", [1, 2])
def test_ssd_chunked_gradients_against_jax(nc):
    """Chunks of 8 at P 4, N 6, 3 heads, batch 2; the loss weighs y and the
    final state with fixed random weights."""
    chunk, bsz, h, p, n = 8, 2, 3, 4, 6
    s = nc * chunk
    rng = np.random.default_rng(11 + nc)
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    b = rng.standard_normal((bsz, s, 1, n)).astype(np.float32)
    c = rng.standard_normal((bsz, s, 1, n)).astype(np.float32)
    wy = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    wf = rng.standard_normal((bsz, h, p, n)).astype(np.float32)

    def jloss(*args):
        y, final = JS.ssd_chunked(*args, chunk=chunk)
        return (y * wy).sum() + (final * wf).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(t) for t in (x, dt, a, b, c)))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (x, dt, a, b, c)]
    y, final = TS.ssd_chunked(*ts, chunk=chunk)
    loss = (y * torch.from_numpy(wy)).sum() + (final * torch.from_numpy(wf)).sum()
    got = torch.autograd.grad(loss, ts)
    for name, g, w in zip(("x", "dt", "A", "B", "C"), got, want):
        _close_to_max(g.detach(), np.asarray(w), 1e-5)
