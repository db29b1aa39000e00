"""The port's hybrid stack (repro_torch.models.hybrid) against
repro.models.hybrid on the same weights: the parameter tree and its count,
the dense and pooled cache layouts, logits of ``apply`` in train, prefill
(padded, with lengths) and dense decode, greedy tokens over 16 steps, the
paged branch (shared-attention block pools and Mamba-2 slab pools in one
call) against the dense branch, the engine's insert views, and the weight
bridge's fp32 leaves inside ``groups`` and ``tail``.

Two shapes, fp32: zamba2-7b reduced (G 2 groups of PG 1 Mamba-2 layer +
the shared block, R 1 tail layer; d 64, 4/2 heads of 16, 8 SSM heads of
P=16, N=16), and the same with 8 layers every 3rd shared (G 2, PG 2, R 2),
where the flat Mamba-2 index gidx*PG + j differs from the group index.
Values agree to 1e-4 (atol and rtol): both sides compute in fp32, but
every matmul, reduction and cumulative sum runs in its own order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import hybrid as JH
from repro.models import model as JM
from repro_torch.configs.registry import get_config
from repro_torch.models import hybrid as TH
from repro_torch.models import model as TM
from repro_torch.params import FP32_LEAVES, params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_SEQ = 32
SHAPES = {"reduced": {}, "pg2_r2": dict(num_layers=8, attn_every=3)}

_jax_apply = jax.jit(JM.apply, static_argnums=0, static_argnames="mode")
_jax_init = jax.jit(JM.init_params, static_argnums=0)
_jax_prefill = jax.jit(  # max_seq fixes a shape: closed over, not traced
    lambda cfg, p, toks, lengths: JM.apply(
        cfg, p, {"tokens": toks, "max_seq": MAX_SEQ, "lengths": lengths},
        mode="prefill"), static_argnums=0)


def _configs(shape, dtype="float32"):
    return tuple(dataclasses.replace(get(
        "zamba2_7b").reduced(), dtype=dtype, **SHAPES[shape])
        for get in (jax_config, get_config))


@pytest.fixture(scope="module", params=sorted(SHAPES))
def setup(request):
    jcfg, tcfg = _configs(request.param)
    jp = _jax_init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 128, shape, dtype=np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(lambda t: t, tree,
                                        is_leaf=torch.is_tensor))


def _prefill(setup, toks, lengths):
    jcfg, tcfg, jp, tp = setup
    jl, jc, _ = _jax_prefill(jcfg, jp, toks, jnp.asarray(lengths))
    tl, tc, _ = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                    "max_seq": MAX_SEQ,
                                    "lengths": torch.from_numpy(lengths)},
                         mode="prefill")
    return (jl, jc), (tl, tc)


def _cache_close(tc, jc):
    """Every leaf of the port's cache against the reference's, shapes
    first."""
    assert set(tc) == set(jc)
    for t, j in zip(_leaves(tc), jax.tree.leaves(jc)):
        assert tuple(t.shape) == j.shape
        _close(t, j)


# --------------------------------------------------------------------------
# parameters and caches
# --------------------------------------------------------------------------


def test_split_puts_a_flat_index_past_the_group_index(setup):
    jcfg, tcfg, _, _ = setup
    assert TH._split(tcfg) == JH._split(jcfg)
    g, pg, r = TH._split(tcfg)
    assert (g, pg, r) in ((2, 1, 1), (2, 2, 2))


def test_param_tree_count_and_native_init(setup):
    """Native init gives the reference's tree -- keys, shapes and dtypes,
    groups stacked (G, PG, ...) and the tail (R, ...) -- and the analytical
    count agrees on both sides with the tree's."""
    jcfg, tcfg, jp, _ = setup
    tp = TM.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert (jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
            == jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp,
                            is_leaf=torch.is_tensor))
    g, pg, r = TH._split(tcfg)
    assert tp["groups"]["mamba"]["in_proj"].shape[:2] == (g, pg)
    assert tp["tail"]["ln1"]["scale"].shape == (r, tcfg.d_model)
    assert TM.param_count(tcfg) == JM.param_count(jcfg) == sum(
        t.numel() for t in _leaves(tp))
    # the ssm leaves keep the reference's values: A_log a log-spaced ramp
    np.testing.assert_allclose(tp["tail"]["mamba"]["A_log"][0].numpy(),
                               np.asarray(jp["tail"]["mamba"]["A_log"][0]),
                               rtol=1e-6)


def test_cache_layouts_and_own_storage(setup):
    """Dense and pooled caches keep the reference's keys, shapes and
    dtypes, zeroed; each group's cache is its own storage (the reference
    broadcasts one zero cache), so a write into group 0 leaves group 1."""
    jcfg, tcfg, _, _ = setup
    jc, tc = JM.init_cache(jcfg, 3, MAX_SEQ), TM.init_cache(
        tcfg, 3, MAX_SEQ, device="cpu")
    jpools = JM.init_paged_cache(jcfg, 9, 8, num_slabs=6)
    tpools = TM.init_paged_cache(tcfg, 9, 8, num_slabs=6, device="cpu")
    for t_tree, j_tree in ((tc, jc), (tpools, jpools)):
        assert set(t_tree) == set(j_tree)
        for t, j in zip(_leaves(t_tree), jax.tree.leaves(j_tree)):
            assert tuple(t.shape) == j.shape
            assert str(t.dtype).split(".")[-1] == str(j.dtype)
            assert not t.any()
    for key, lead in (("groups_mamba", 2), ("groups_attn", 1), ("tail", 1)):
        for t in tc[key]:  # an expanded (aliased) cache would fill whole
            first = t[(0,) * lead]
            first.fill_(1.0)
            assert int(t.count_nonzero()) == first.numel(), key
    assert len({t.data_ptr() for t in _leaves(tpools)}) == 4
    assert TM.paged_pool_kinds(tcfg) == JM.paged_pool_kinds(jcfg) == {
        "attn": "block", "mamba": "slab"}
    assert TM.cache_family(tcfg) == JM.cache_family(jcfg) == "hybrid"
    assert TM.supports_paged(tcfg) and JM.supports_paged(jcfg)


# --------------------------------------------------------------------------
# the stack through apply
# --------------------------------------------------------------------------


def test_train_logits(setup):
    jcfg, tcfg, jp, tp = setup
    toks = _tokens(0, 2, 20)
    jl, _, _ = _jax_apply(jcfg, jp, {"tokens": toks}, mode="train")
    tl, tc, aux = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                           mode="train")
    assert tc is None and float(aux) == 0.0
    _close(tl, jl)


def test_padded_prefill_logits_and_cache(setup):
    """Rows of 16, 7 and 11 tokens padded to 16: logits and every cache
    leaf (the shared block's KV padded to max_seq on axis 2, the Mamba-2
    caches at each row's true length) equal the reference's."""
    toks = _tokens(1, 3, 16)
    lengths = np.array([16, 7, 11], np.int32)
    (jl, jc), (tl, tc) = _prefill(setup, toks, lengths)
    _close(tl, jl)
    _cache_close(tc, jc)
    assert tc["groups_attn"][0].shape[2] == MAX_SEQ
    np.testing.assert_array_equal(tc["pos"].numpy(), lengths)


def test_unpadded_prefill_matches_padded_rows(setup):
    """A row prefilled alone at its true length gives the padded row's
    Mamba-2 state and conv window and its KV up to that length."""
    _, tcfg, _, tp = setup
    toks = _tokens(2, 2, 12)
    _, (_, tc) = _prefill(setup, toks, np.array([12, 5], np.int32))
    _, one, _ = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(toks[1:, :5])},
                         mode="prefill")
    tol = dict(rtol=1e-5, atol=1e-5)
    for pad, alone in zip(tc["groups_mamba"], one["groups_mamba"]):
        _close(pad[:, :, 1:2], alone, tol)  # (G, PG, B, ...)
    for pad, alone in zip(tc["tail"], one["tail"]):
        _close(pad[:, 1:2], alone, tol)  # (R, B, ...)
    for pad, alone in zip(tc["groups_attn"], one["groups_attn"]):
        _close(pad[:, 1:2, :5], alone, tol)  # (G, B, S, Nkv, H)


def test_dense_decode_16_greedy_steps(setup):
    """From a padded two-row prefill, 16 greedy dense decode steps: the
    tokens equal the reference's and the logits stay within 1e-4 at every
    step; the caches are updated in place."""
    jcfg, tcfg, jp, tp = setup
    toks = _tokens(3, 2, 9)
    (jl, jc), (tl, tc) = _prefill(setup, toks, np.array([9, 4], np.int32))
    jdecode = jax.jit(lambda p, t, c: JM.apply(jcfg, p, {"tokens": t},
                                              mode="decode", cache=c))
    first = np.array([8, 3])
    jtok = jnp.asarray(np.argmax(np.asarray(jl)[[0, 1], first], -1)
                       .astype(np.int32)[:, None])
    ttok = tl[[0, 1], first].argmax(-1).to(torch.int32)[:, None]
    state = tc["groups_mamba"][1]
    jout, tout = [], []
    for _ in range(16):
        jl, jc, _ = jdecode(jp, jtok, jc)
        tl, tc, _ = TM.apply(tcfg, tp, {"tokens": ttok}, mode="decode",
                             cache=tc)
        _close(tl, jl)
        jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        ttok = tl[:, -1].argmax(-1).to(torch.int32)[:, None]
        jout.append(np.asarray(jtok[:, 0]).tolist())
        tout.append(ttok[:, 0].tolist())
    assert tout == jout
    assert tc["groups_mamba"][1] is state  # updated in place
    _cache_close(tc, jc)


def _pools(tcfg, tc, lengths, tables, slabs, nb, ns, seed):
    """Block and slab pools full of noise, with each row's prefill cache
    copied into its blocks (the shared block's planes, through one table
    per row) and its slab (the flat Mamba-2 layers)."""
    rng = np.random.default_rng(seed)
    views = TM.paged_insert_views(tcfg, tc)
    bs = MAX_SEQ // tables.shape[1]
    attn = []
    for leaf in views["attn"]:  # (G, B, max_seq, Nkv, H)
        leaf = leaf.numpy()
        pool = rng.standard_normal((leaf.shape[0], nb, bs, *leaf.shape[3:]),
                                   dtype=np.float32)
        for row, blocks in enumerate(tables):
            pool[:, blocks] = leaf[:, row].reshape(leaf.shape[0], -1, bs,
                                                   *leaf.shape[3:])
        attn.append(pool)
    mamba = []
    for leaf in views["mamba"]:  # (G*PG + R, B, ...)
        leaf = leaf.numpy()
        pool = rng.standard_normal((leaf.shape[0], ns, *leaf.shape[2:]),
                                   dtype=np.float32)
        pool[:, slabs] = leaf
        mamba.append(pool)
    return attn, mamba


def test_paged_decode_equals_dense_and_the_reference(setup):
    """Rows on permuted blocks of noisy block pools and on permuted slabs
    of noisy slab pools: three paged steps give the dense branch's logits
    bit for bit and the reference's paged logits within 1e-4; the rows'
    blocks and slabs end as the dense cache, every other block and slab
    keeps its bits."""
    jcfg, tcfg, jp, tp = setup
    toks = _tokens(4, 2, 10)
    lengths = np.array([10, 6], np.int32)
    _, (_, tc) = _prefill(setup, toks, lengths)
    tables = np.array([[7, 2, 9, 4], [3, 10, 5, 1]], np.int32)
    slabs, nb, ns = np.array([5, 2], np.int32), 12, 7
    attn, mamba = _pools(tcfg, tc, lengths, tables, slabs, nb, ns, 5)
    tpools = {"attn": tuple(torch.from_numpy(p.copy()) for p in attn),
              "mamba": tuple(torch.from_numpy(p.copy()) for p in mamba)}
    jcache = {"attn": tuple(map(jnp.asarray, attn)),
              "mamba": tuple(map(jnp.asarray, mamba)),
              "block_tables": jnp.asarray(tables),
              "slab_ids": jnp.asarray(slabs), "pos": jnp.asarray(lengths)}
    pos = torch.from_numpy(lengths)
    for step in range(3):
        nxt = _tokens(10 + step, 2, 1)
        pl, pc, _ = TM.apply(
            tcfg, tp, {"tokens": torch.from_numpy(nxt)}, mode="decode",
            cache={**tpools, "block_tables": torch.from_numpy(tables),
                   "slab_ids": torch.from_numpy(slabs), "pos": pos})
        dl, tc, _ = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(nxt)},
                             mode="decode", cache=tc)
        jl, jcache, _ = _jax_apply(jcfg, jp, {"tokens": nxt}, mode="decode",
                                   cache=jcache)
        torch.testing.assert_close(pl, dl, rtol=0, atol=0)
        _close(pl, jl)
        assert pc["attn"][0] is tpools["attn"][0]  # updated in place
        pos = pc["pos"]
    views = TM.paged_insert_views(tcfg, tc)
    g, bs = TH._split(tcfg)[0], MAX_SEQ // tables.shape[1]
    for pool, noise, leaf in zip(tpools["attn"], attn, views["attn"]):
        for row, blocks in enumerate(tables):
            torch.testing.assert_close(
                pool[:, blocks].reshape(g, MAX_SEQ, *pool.shape[3:]),
                leaf[:, row], rtol=0, atol=0)
        rest = [i for i in range(nb) if i not in tables]
        assert np.array_equal(pool[:, rest].numpy(), noise[:, rest])
    for pool, noise, leaf in zip(tpools["mamba"], mamba, views["mamba"]):
        torch.testing.assert_close(pool[:, slabs], leaf, rtol=0, atol=0)
        rest = [i for i in range(ns) if i not in slabs]
        assert np.array_equal(pool[:, rest].numpy(), noise[:, rest])
    for t, j in zip((*tpools["attn"], *tpools["mamba"]),
                    (*jcache["attn"], *jcache["mamba"])):
        _close(t, j)


def test_paged_insert_views_equal_the_reference(setup):
    jcfg, tcfg, _, _ = setup
    toks = _tokens(6, 2, 8)
    (_, jc), (_, tc) = _prefill(setup, toks, np.array([8, 3], np.int32))
    jv, tv = JM.paged_insert_views(jcfg, jc), TM.paged_insert_views(tcfg, tc)
    assert set(tv) == set(jv) == {"attn", "mamba"}
    g, pg, r = TH._split(tcfg)
    assert tv["mamba"][1].shape[0] == g * pg + r
    for t, j in zip(_leaves(tv), jax.tree.leaves(jv)):
        assert tuple(t.shape) == j.shape
        _close(t, j)


# --------------------------------------------------------------------------
# the weight bridge
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bridge_keeps_fp32_leaves_in_groups_and_tail(shape):
    """A bf16 bridge of the hybrid tree casts every leaf but A_log, dt_bias
    and ssm_D, inside the (G, PG, ...) group stacks and the (R, ...)
    tail alike."""
    cfg, _ = _configs(shape, dtype="bfloat16")
    rng = np.random.default_rng(1)
    tree = jax.tree.map(
        lambda a: rng.standard_normal(a.shape, dtype=np.float32).astype(
            a.dtype),
        jax.eval_shape(lambda key: JM.init_params(cfg, key),
                       jax.random.PRNGKey(0)))
    tp = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    for stack in ("groups", "tail"):
        for key, t in tp[stack]["mamba"].items():
            want = torch.float32 if key in FP32_LEAVES else torch.bfloat16
            assert t.dtype == want, (stack, key)
            assert str(tree[stack]["mamba"][key].dtype) == str(want)[6:]
        np.testing.assert_array_equal(tp[stack]["mamba"]["ssm_D"].numpy(),
                                      tree[stack]["mamba"]["ssm_D"])
    for t in _leaves(tp["shared_attn"]):
        assert t.dtype == torch.bfloat16
