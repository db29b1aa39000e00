"""The port's layers (repro_torch.models.layers) against
repro.models.layers on the same weights and inputs.

Config: internlm2-1.8b reduced, fp32.  Weights come from the reference's
init and cross over through the numpy bridge; inputs are numpy draws from a
seed.  Tolerance 1e-5 (fp32 1e-5 of test_kernels.py; the sums run in
another order on each side).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config
from repro.models import layers as JL
from repro.models import perf
from repro_torch.models import layers as TL
from repro_torch.params import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config("internlm2_1_8b").reduced(),
                              dtype="float32")
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    jp = {"attn": JL.init_attention(cfg, ks[0], jnp.float32),
          "mlp": JL.init_mlp(cfg, ks[1], jnp.float32)}
    gelu_cfg = dataclasses.replace(cfg, mlp_type="gelu")
    jp["gelu"] = JL.init_mlp(gelu_cfg, ks[2], jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, gelu_cfg, jp, tp


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    x, w = _rand(1, 2, 5, 64), _rand(2, 64) * 0.1 + 1.0
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).to(getattr(torch, dtype))
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    _close(TL.rms_norm(xt, wt, 1e-5), JL.rms_norm(xj, wj, 1e-5), tol)


def test_rope():
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [7, 9, 11, 13, 15, 17, 500]],
                   np.int32)
    cj, sj = JL.rope_cos_sin(jnp.asarray(pos), 16, 1e6)
    ct, st = TL.rope_cos_sin(torch.from_numpy(pos), 16, 1e6)
    _close(ct, cj)
    _close(st, sj)
    x = _rand(3, 2, 7, 4, 16)
    _close(TL.apply_rope(torch.from_numpy(x), ct, st),
           JL.apply_rope(jnp.asarray(x), cj, sj))


@pytest.mark.parametrize("cache", [None, "build"])
def test_causal_attention(setup, cache):
    cfg, _, jp, tp = setup
    x = _rand(4, 2, 9, cfg.d_model)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    oj, cj = JL.attention(cfg, jp["attn"], jnp.asarray(x),
                          positions=jnp.asarray(pos), cache=cache)
    ot, ct = TL.attention(cfg, tp["attn"], torch.from_numpy(x),
                          positions=torch.from_numpy(pos.copy()), cache=cache)
    _close(ot, oj)
    if cache is None:
        assert cj is None and ct is None
    else:
        _close(ct[0], cj[0])
        _close(ct[1], cj[1])


@pytest.mark.parametrize("mode", ["where", "scatter"])
def test_dense_decode_attention(setup, mode):
    """The reference writes the new token by a full-cache select or a
    scatter (perf.cache_update); both give the values the port writes in
    place."""
    cfg, _, jp, tp = setup
    b, smax, nkv, h = 2, 16, cfg.num_kv_heads, cfg.head_dim
    x = _rand(5, b, 1, cfg.d_model)
    kc, vc = _rand(6, b, smax, nkv, h), _rand(7, b, smax, nkv, h)
    pos = np.array([3, 15], np.int32)
    with perf.use_flags(perf.PerfFlags(cache_update=mode)):
        oj, (kj, vj) = JL.attention(
            cfg, jp["attn"], jnp.asarray(x), positions=jnp.asarray(pos[:, None]),
            layer_cache=(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos)))
    kt, vt = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ot, (kt2, vt2) = TL.attention(
        cfg, tp["attn"], torch.from_numpy(x),
        positions=torch.from_numpy(pos[:, None].copy()),
        layer_cache=(kt, vt, torch.from_numpy(pos)))
    assert kt2 is kt and vt2 is vt  # written in place
    _close(ot, oj)
    _close(kt, kj)
    _close(vt, vj)


def test_paged_decode_attention(setup):
    """Paged branch: the new token lands in the row's tail block of layer
    ``lidx`` in place, then attention reads each row's blocks through its
    table (lanes past the live blocks point at scratch block 0)."""
    cfg, _, jp, tp = setup
    n_l, nb, bs, nkv, h = 2, 9, 4, cfg.num_kv_heads, cfg.head_dim
    x = _rand(8, 2, 1, cfg.d_model)
    ks, vs = _rand(9, n_l, nb, bs, nkv, h), _rand(10, n_l, nb, bs, nkv, h)
    tables = np.array([[3, 5, 0], [7, 1, 4]], np.int32)
    pos = np.array([5, 10], np.int32)
    oj, (kj, vj) = JL.attention(
        cfg, jp["attn"], jnp.asarray(x), positions=jnp.asarray(pos[:, None]),
        layer_cache=(jnp.asarray(ks), jnp.asarray(vs), jnp.int32(1),
                     jnp.asarray(tables), jnp.asarray(pos)))
    kt, vt = torch.from_numpy(ks.copy()), torch.from_numpy(vs.copy())
    ot, _ = TL.attention(
        cfg, tp["attn"], torch.from_numpy(x),
        positions=torch.from_numpy(pos[:, None].copy()),
        layer_cache=(kt, vt, 1, torch.from_numpy(tables), torch.from_numpy(pos)))
    _close(ot, oj)
    _close(kt, kj)
    _close(vt, vj)


def test_mlp(setup):
    cfg, gelu_cfg, jp, tp = setup
    x = _rand(11, 2, 3, cfg.d_model)
    _close(TL.mlp(cfg, tp["mlp"], torch.from_numpy(x)),
           JL.mlp(cfg, jp["mlp"], jnp.asarray(x)))
    _close(TL.mlp(gelu_cfg, tp["gelu"], torch.from_numpy(x)),
           JL.mlp(gelu_cfg, jp["gelu"], jnp.asarray(x)))


def test_init_distributions(setup):
    """Native init draws the reference's shapes, dtypes and scales."""
    cfg, _, jp, _ = setup
    gen = torch.Generator().manual_seed(0)
    tp = {"attn": TL.init_attention(cfg, gen, torch.float32, "cpu"),
          "mlp": TL.init_mlp(cfg, gen, torch.float32, "cpu")}
    for part in ("attn", "mlp"):
        for name, w in tp[part].items():
            ref = np.asarray(jp[part][name])
            assert tuple(w.shape) == ref.shape and w.dtype == torch.float32
            assert abs(float(w.std()) / float(ref.std()) - 1) < 0.2, name
    assert torch.equal(TL.init_rms_norm(8, torch.float32, "cpu")["scale"],
                       torch.ones(8))
