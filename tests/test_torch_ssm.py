"""The port's Mamba-2 stack (repro_torch.models.ssm and the SSM family of
repro_torch.models.transformer) against repro.models on the same weights:
the causal conv, the chunked scan, the block in prefill, dense decode and
slab-paged decode, the cache built by a ragged prefill, logits of
``apply`` in every mode, greedy tokens over 16 steps, and the weight
bridge's fp32 leaves.

Config: mamba2-780m reduced (2 layers, d 64, 8 SSM heads of P=16, N=16),
fp32.  Values agree to 1e-4 (atol and rtol): both sides compute in fp32,
but every matmul, reduction and cumulative sum runs in its own order, and
the differences grow through the layers and the unembedding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch.configs.registry import get_config
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.params import FP32_LEAVES, params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)

# the reference's functions, jitted once (cfg is static): eager JAX
# dispatches op by op and dominates the file's time
_jax_block = jax.jit(JS.mamba2_block, static_argnums=0)
_jax_prefill_cache = jax.jit(JS.prefill_mamba_cache, static_argnums=0)
_jax_apply = jax.jit(JM.apply, static_argnums=0, static_argnames="mode")
_jax_init = jax.jit(JM.init_params, static_argnums=0)
_jax_chunked = jax.jit(JS.ssd_chunked, static_argnames="chunk")


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_config("mamba2_780m").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("mamba2_780m").reduced(),
                               dtype="float32")
    jp = _jax_init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _tlayer0(tree):
    if isinstance(tree, dict):
        return {k: _tlayer0(v) for k, v in tree.items()}
    return tree[0]


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 128, shape, dtype=np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# --------------------------------------------------------------------------
# the block's pieces
# --------------------------------------------------------------------------


def test_causal_conv(setup):
    jcfg, _, jp, tp = setup
    x = _normal(0, 2, 9, TS.conv_dim(jcfg))
    pj, pt = _layer0(jp["layers"]["mamba"]), _tlayer0(tp["layers"]["mamba"])
    want = JS._causal_conv(jnp.asarray(x), pj["conv_w"], pj["conv_b"])
    _close(TS._causal_conv(torch.from_numpy(x), pt["conv_w"], pt["conv_b"]),
           want)


def test_ssd_chunked_four_chunks(setup):
    """S = 64 in chunks of 16: the intra-chunk kernel's plain version plus
    the inter-chunk recurrence in torch ops, against the jnp oracle."""
    b, s, h, p, g, n = 2, 64, 4, 8, 1, 16
    x, dt_raw = _normal(1, b, s, h, p), _normal(2, b, s, h)
    dt = np.logaddexp(dt_raw, 0.0).astype(np.float32)
    a = -np.linspace(0.2, 1.0, h).astype(np.float32)
    bb, cc = _normal(3, b, s, g, n), _normal(4, b, s, g, n)
    jy, jf = _jax_chunked(*map(jnp.asarray, (x, dt, a, bb, cc)), chunk=16)
    ty, tf = TS.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bb, cc)),
                            chunk=16)
    _close(ty, jy)
    _close(tf, jf)


def test_ssd_chunked_takes_one_group(setup):
    """ssd_intra's contract is one group of B and C (as the Pallas
    kernel's): more groups raise instead of computing something else."""
    x, dt = torch.zeros(1, 32, 4, 8), torch.full((1, 32, 4), 0.3)
    bb = torch.zeros(1, 32, 2, 8)
    with pytest.raises(ValueError, match="one group"):
        TS.ssd_chunked(x, dt, -torch.ones(4), bb, bb, chunk=16)


def test_block_prefill_and_dense_decode(setup):
    jcfg, tcfg, jp, tp = setup
    pj, pt = _layer0(jp["layers"]["mamba"]), _tlayer0(tp["layers"]["mamba"])
    x = _normal(8, 2, 12, jcfg.d_model)
    jo, _ = _jax_block(jcfg, pj, jnp.asarray(x))
    to, tc = TS.mamba2_block(tcfg, pt, torch.from_numpy(x))
    assert tc is None
    _close(to, jo)
    conv = _normal(9, 2, jcfg.conv_width - 1, TS.conv_dim(jcfg))
    state = _normal(10, 2, jcfg.ssm_nheads, jcfg.ssm_head_dim,
                    jcfg.ssm_state_dim)
    xt = _normal(11, 2, 1, jcfg.d_model)
    pos = jnp.zeros((2,), jnp.int32)
    jo, (jconv, jstate) = _jax_block(
        jcfg, pj, jnp.asarray(xt),
        layer_cache=(jnp.asarray(conv), jnp.asarray(state), pos))
    tconv, tstate = torch.from_numpy(conv.copy()), torch.from_numpy(state.copy())
    to, (oc, os_) = TS.mamba2_block(tcfg, pt, torch.from_numpy(xt),
                                    layer_cache=(tconv, tstate, pos))
    assert oc is tconv and os_ is tstate  # updated in place
    _close(to, jo)
    _close(tconv, jconv)
    _close(tstate, jstate)


def test_block_slab_paged_decode(setup):
    """Two rows on distinct, non-adjacent slabs of layer 1's pools: the
    outputs and pools equal the reference's, and every other slab and
    layer keeps its bits."""
    jcfg, tcfg, jp, tp = setup
    lidx, slabs, ns = jnp.int32(1), np.array([5, 2], np.int32), 7
    pj = jax.tree.map(lambda a: a[1], jp["layers"]["mamba"])
    pt = {k: v[1] for k, v in tp["layers"]["mamba"].items()}
    conv = _normal(12, 2, ns, jcfg.conv_width - 1, TS.conv_dim(jcfg))
    state = _normal(13, 2, ns, jcfg.ssm_nheads, jcfg.ssm_head_dim,
                    jcfg.ssm_state_dim)
    xt = _normal(14, 2, 1, jcfg.d_model)
    jo, (jconv, jstate) = _jax_block(
        jcfg, pj, jnp.asarray(xt),
        layer_cache=(jnp.asarray(conv), jnp.asarray(state), lidx,
                     jnp.asarray(slabs)))
    tconv, tstate = torch.from_numpy(conv.copy()), torch.from_numpy(state.copy())
    to, _ = TS.mamba2_block(tcfg, pt, torch.from_numpy(xt),
                            layer_cache=(tconv, tstate, 1,
                                         torch.from_numpy(slabs)))
    _close(to, jo)
    _close(tconv, jconv)
    _close(tstate, jstate)
    rest = [i for i in range(ns) if i not in slabs]
    assert np.array_equal(tstate[:, rest].numpy(), state[:, rest])
    assert np.array_equal(tstate[0].numpy(), state[0])
    assert np.array_equal(tconv[:, rest].numpy(), conv[:, rest])


def test_prefill_cache_ragged_lengths(setup):
    """Padded rows with true lengths 12, 5 and 2: the final state and the
    conv tail (front-padded for the row shorter than W-1) per row."""
    jcfg, tcfg, jp, tp = setup
    pj, pt = _layer0(jp["layers"]["mamba"]), _tlayer0(tp["layers"]["mamba"])
    x = _normal(15, 3, 12, jcfg.d_model)
    lengths = np.array([12, 5, 2], np.int32)
    jo, (jconv, jstate) = _jax_prefill_cache(
        jcfg, pj, jnp.asarray(x), lengths=jnp.asarray(lengths))
    to, (tconv, tstate) = TS.prefill_mamba_cache(
        tcfg, pt, torch.from_numpy(x), lengths=torch.from_numpy(lengths))
    _close(to, jo)
    _close(tconv, jconv)
    _close(tstate, jstate)
    # the padded row's state equals the exact-length prefill's
    _, (conv1, state1) = TS.prefill_mamba_cache(tcfg, pt,
                                                torch.from_numpy(x[1:2, :5]))
    _close(tstate[1:2], state1, dict(rtol=1e-6, atol=1e-6))
    torch.testing.assert_close(tconv[1:2], conv1, rtol=0, atol=0)


# --------------------------------------------------------------------------
# the stack through apply
# --------------------------------------------------------------------------


def _prefill(setup, toks, lengths):
    jcfg, tcfg, jp, tp = setup
    jl, jc, _ = _jax_apply(jcfg, jp, {"tokens": toks,
                                    "lengths": jnp.asarray(lengths)},
                         mode="prefill")
    tl, tc, _ = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                    "lengths": torch.from_numpy(lengths)},
                         mode="prefill")
    return (jl, jc), (tl, tc)


def test_train_logits(setup):
    jcfg, tcfg, jp, tp = setup
    toks = _tokens(0, 2, 20)
    jl, _, _ = _jax_apply(jcfg, jp, {"tokens": toks}, mode="train")
    tl, tc, _ = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                         mode="train")
    assert tc is None
    _close(tl, jl)


def test_prefill_logits_and_cache(setup):
    toks = _tokens(1, 3, 16)
    lengths = np.array([16, 7, 11], np.int32)
    (jl, jc), (tl, tc) = _prefill(setup, toks, lengths)
    _close(tl, jl)
    for t, j in zip(tc["layers"], jc["layers"]):
        assert tuple(t.shape) == j.shape  # no sequence axis, no padding
        _close(t, j)
    np.testing.assert_array_equal(tc["pos"].numpy(), lengths)


def test_dense_decode_logits(setup):
    jcfg, tcfg, jp, tp = setup
    toks = _tokens(2, 2, 9)
    (_, jc), (_, tc) = _prefill(setup, toks, np.array([9, 4], np.int32))
    for step in range(3):
        nxt = _tokens(10 + step, 2, 1)
        jl, jc, _ = _jax_apply(jcfg, jp, {"tokens": nxt}, mode="decode", cache=jc)
        tl, tc, _ = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(nxt)},
                             mode="decode", cache=tc)
        _close(tl, jl)
    for t, j in zip(tc["layers"], jc["layers"]):
        _close(t, j)


def test_slab_paged_decode_logits(setup):
    """Both sides decode from the same slab pools (the port's prefill cache
    copied into slabs 3 and 1 of 5) and must agree on the logits and pools;
    the port's paged decode equals its own dense decode bit for bit."""
    jcfg, tcfg, jp, tp = setup
    toks = _tokens(3, 2, 10)
    lengths = np.array([10, 6], np.int32)
    _, (_, tc) = _prefill(setup, toks, lengths)
    slabs, ns = np.array([3, 1], np.int32), 5
    pools = []
    for leaf in tc["layers"]:  # (L, B, ...)
        leaf = leaf.numpy()
        pool = np.zeros((leaf.shape[0], ns, *leaf.shape[2:]), np.float32)
        pool[:, slabs] = leaf
        pools.append(pool)
    nxt = _tokens(4, 2, 1)
    jl, jcache, _ = _jax_apply(
        jcfg, jp, {"tokens": nxt}, mode="decode",
        cache={"layers": tuple(jnp.asarray(p) for p in pools),
               "slab_ids": jnp.asarray(slabs), "pos": jnp.asarray(lengths)})
    tpools = tuple(torch.from_numpy(p.copy()) for p in pools)
    tl, tcache, _ = TM.apply(
        tcfg, tp, {"tokens": torch.from_numpy(nxt)}, mode="decode",
        cache={"layers": tpools, "slab_ids": torch.from_numpy(slabs),
               "pos": torch.from_numpy(lengths)})
    _close(tl, jl)
    assert tcache["layers"][0] is tpools[0]  # updated in place
    for t, j in zip(tpools, jcache["layers"]):
        _close(t, j)
    dl, dc, _ = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(nxt)},
                         mode="decode", cache=tc)
    torch.testing.assert_close(tl, dl, rtol=0, atol=0)
    for pool, dense in zip(tpools, dc["layers"]):
        torch.testing.assert_close(pool[:, slabs], dense, rtol=0, atol=0)


def test_greedy_tokens_match_over_16_steps(setup):
    jcfg, tcfg, jp, tp = setup
    toks = _tokens(5, 1, 7)
    jdecode = jax.jit(lambda p, t, c: _jax_apply(jcfg, p, {"tokens": t},
                                              mode="decode", cache=c))
    (jl, jc), (tl, tc) = _prefill(setup, toks, np.array([7], np.int32))
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = tl[:, -1].argmax(-1).to(torch.int32)[:, None]
    jout, tout = [], []
    for _ in range(16):
        jl, jc, _ = jdecode(jp, jtok, jc)
        tl, tc, _ = TM.apply(tcfg, tp, {"tokens": ttok}, mode="decode",
                             cache=tc)
        jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        ttok = tl[:, -1].argmax(-1).to(torch.int32)[:, None]
        jout.append(int(jtok[0, 0]))
        tout.append(int(ttok[0, 0]))
    assert tout == jout


def test_param_count_native_init_and_cache_layouts(setup):
    jcfg, tcfg, jp, _ = setup
    gen = torch.Generator().manual_seed(0)
    tp = TM.init_params(tcfg, generator=gen, device="cpu")
    leaves = jax.tree.leaves(jax.tree.map(lambda t: t, tp,
                                          is_leaf=torch.is_tensor))
    assert TM.param_count(tcfg) == JM.param_count(jcfg) == sum(
        t.numel() for t in leaves)
    assert (jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
            == jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp,
                            is_leaf=torch.is_tensor))
    jc, jpools = JM.init_cache(jcfg, 3, 32), JM.init_paged_cache(
        jcfg, 0, 16, num_slabs=6)
    tc = TM.init_cache(tcfg, 3, 32, device="cpu")
    tpools = TM.init_paged_cache(tcfg, 0, 16, num_slabs=6, device="cpu")
    for t, j in [*zip(tc["layers"], jc["layers"]), (tc["pos"], jc["pos"]),
                 *zip(tpools["layers"], jpools["layers"])]:
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        assert not t.any()
    assert TM.paged_pool_kinds(tcfg) == JM.paged_pool_kinds(jcfg) == {
        "layers": "slab"}
    assert TM.cache_family(tcfg) == JM.cache_family(jcfg) == "ssm"
    assert TM.supports_paged(tcfg)


# --------------------------------------------------------------------------
# the weight bridge
# --------------------------------------------------------------------------


def _numpy_tree(cfg, seed):
    """The reference's parameter tree for ``cfg`` -- its structure, shapes
    and dtypes, without running the init -- filled with numpy normals."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: rng.standard_normal(a.shape, dtype=np.float32).astype(
            a.dtype),
        jax.eval_shape(lambda key: JM.init_params(cfg, key),
                       jax.random.PRNGKey(0)))


def test_bridge_keeps_fp32_leaves_of_the_ssm_tree():
    """A bf16 bridge of the mamba2 tree casts every leaf but A_log,
    dt_bias and ssm_D, which the reference keeps fp32 in every config."""
    cfg = jax_config("mamba2_780m").reduced()  # dtype bfloat16
    tree = _numpy_tree(cfg, 1)
    tp = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    mamba = tp["layers"]["mamba"]
    for key, t in mamba.items():
        want = torch.float32 if key in FP32_LEAVES else torch.bfloat16
        assert t.dtype == want, key
        assert str(tree["layers"]["mamba"][key].dtype) == str(want)[6:], key
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(mamba["A_log"].numpy(),
                                  tree["layers"]["mamba"]["A_log"])


def test_bridge_casts_every_leaf_of_the_gqa_tree():
    cfg = dataclasses.replace(jax_config("internlm2_1_8b").reduced(),
                              dtype="float32")
    tp = params_from_numpy(_numpy_tree(cfg, 2), device="cpu",
                           dtype=torch.bfloat16)
    leaves = jax.tree.leaves(jax.tree.map(lambda t: t, tp,
                                          is_leaf=torch.is_tensor))
    assert leaves and all(t.dtype == torch.bfloat16 for t in leaves)
