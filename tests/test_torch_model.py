"""The port's model (repro_torch.models.model) against repro.models.model on
the same weights: logits of ``apply`` in train, prefill, dense decode and
paged decode, greedy tokens over 16 steps, and the analytical parameter
count.

Config: internlm2-1.8b reduced, fp32.  Logits agree to 1e-4 (atol and
rtol): both sides compute in fp32, but every matmul and reduction sums in
its own order, and the differences grow through the layers and the
unembedding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs.registry import get_config
from repro_torch.models import model as TM
from repro_torch.params import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_SEQ = 32


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_config("internlm2_1_8b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("internlm2_1_8b").reduced(),
                               dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 128, shape, dtype=np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _prefill(setup, toks, lengths):
    jcfg, tcfg, jp, tp = setup
    jl, jc, _ = JM.apply(jcfg, jp, {"tokens": toks, "max_seq": MAX_SEQ,
                                    "lengths": jnp.asarray(lengths)},
                         mode="prefill")
    tl, tc, _ = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                    "max_seq": MAX_SEQ,
                                    "lengths": torch.from_numpy(lengths)},
                         mode="prefill")
    return (jl, jc), (tl, tc)


def test_train_logits(setup):
    jcfg, tcfg, jp, tp = setup
    toks = _tokens(0, 2, 11)
    jl, _, _ = JM.apply(jcfg, jp, {"tokens": toks}, mode="train")
    tl, tc, aux = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                           mode="train")
    assert tc is None and float(aux) == 0.0
    _close(tl, jl)


def test_prefill_logits_and_cache(setup):
    toks = _tokens(1, 3, 12)
    lengths = np.array([12, 5, 9], np.int32)
    (jl, jc), (tl, tc) = _prefill(setup, toks, lengths)
    assert tl.dtype == torch.float32
    _close(tl, jl)
    for t, j in zip(tc["layers"], jc["layers"]):
        assert tuple(t.shape) == j.shape  # (L, B, max_seq, Nkv, H)
        _close(t, j)
    np.testing.assert_array_equal(tc["pos"].numpy(), lengths)


def test_dense_decode_logits(setup):
    jcfg, tcfg, jp, tp = setup
    toks = _tokens(2, 2, 7)
    (_, jc), (_, tc) = _prefill(setup, toks, np.array([7, 4], np.int32))
    for step in range(3):
        nxt = _tokens(10 + step, 2, 1)
        jl, jc, _ = JM.apply(jcfg, jp, {"tokens": nxt}, mode="decode", cache=jc)
        tl, tc, _ = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(nxt)},
                             mode="decode", cache=tc)
        _close(tl, jl)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for t, j in zip(tc["layers"], jc["layers"]):
        _close(t, j)


def test_paged_decode_logits(setup):
    """Both sides decode from the same block pools (the prefill cache
    scattered through per-row tables, spare lanes on scratch block 0) and
    must agree on the logits and on the updated pools."""
    jcfg, tcfg, jp, tp = setup
    bs, nb = 8, 10
    toks = _tokens(3, 2, 9)
    lengths = np.array([9, 6], np.int32)
    (_, jc), _ = _prefill(setup, toks, lengths)
    tables = np.array([[4, 2, 0], [7, 0, 0]], np.int32)
    pools = []
    for leaf in jc["layers"]:  # (L, B, max_seq, Nkv, H)
        leaf = np.asarray(leaf)
        pool = np.zeros((leaf.shape[0], nb, bs, *leaf.shape[3:]), np.float32)
        for row, blocks in enumerate(tables):
            live = -(-int(lengths[row] + 1) // bs)
            for j in range(live):
                pool[:, blocks[j]] = leaf[:, row, j * bs:(j + 1) * bs]
        pools.append(pool)
    nxt = _tokens(4, 2, 1)
    jl, jcache, _ = JM.apply(
        jcfg, jp, {"tokens": nxt}, mode="decode",
        cache={"layers": tuple(jnp.asarray(p) for p in pools),
               "block_tables": jnp.asarray(tables),
               "pos": jnp.asarray(lengths)})
    tpools = tuple(torch.from_numpy(p.copy()) for p in pools)
    tl, tcache, _ = TM.apply(
        tcfg, tp, {"tokens": torch.from_numpy(nxt)}, mode="decode",
        cache={"layers": tpools, "block_tables": torch.from_numpy(tables),
               "pos": torch.from_numpy(lengths)})
    _close(tl, jl)
    assert tcache["layers"][0] is tpools[0]  # updated in place
    for t, j in zip(tpools, jcache["layers"]):
        _close(t, j)


def test_greedy_tokens_match_over_16_steps(setup):
    jcfg, tcfg, jp, tp = setup
    toks = _tokens(5, 1, 6)
    jdecode = jax.jit(lambda p, t, c: JM.apply(jcfg, p, {"tokens": t},
                                              mode="decode", cache=c))
    (jl, jc), (tl, tc) = _prefill(setup, toks, np.array([6], np.int32))
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


def test_param_count_and_native_init(setup):
    jcfg, tcfg, jp, _ = setup
    gen = torch.Generator().manual_seed(0)
    tp = TM.init_params(tcfg, generator=gen, device="cpu")
    n = sum(t.numel() for t in jax.tree.leaves(
        jax.tree.map(lambda t: t, tp, is_leaf=torch.is_tensor)))
    assert TM.param_count(tcfg) == JM.param_count(jcfg) == n
    assert (jax.tree.map(lambda a: a.shape, jp)
            == jax.tree.map(lambda t: tuple(t.shape), tp,
                            is_leaf=torch.is_tensor))
    assert get_config("internlm2_1_8b").param_count() == JM.param_count(
        jax_config("internlm2_1_8b"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_family_inits_the_reference_tree(arch):
    """Every registry entry, reduced: the port's native init builds the
    reference's tree (keys, shapes) and its analytical parameter count,
    and holds that many parameters."""
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jshapes = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    tp = TM.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    leaves = jax.tree.leaves(tp)  # dicts, lists and tuples of tensors
    assert (jax.tree.map(lambda a: a.shape, jshapes)
            == jax.tree.map(lambda t: tuple(t.shape), tp))
    assert TM.param_count(tcfg) == JM.param_count(jcfg) == sum(
        t.numel() for t in leaves)


def test_cache_layouts_match(setup):
    """Dense caches (L, B, Smax, Nkv, H) and block pools (L, NB, BS, Nkv,
    H) keep the reference's shapes and dtypes."""
    jcfg, tcfg, _, _ = setup
    jc = JM.init_cache(jcfg, 3, MAX_SEQ)
    tc = TM.init_cache(tcfg, 3, MAX_SEQ, device="cpu")
    jp = JM.init_paged_cache(jcfg, 9, 8)
    tpools = TM.init_paged_cache(tcfg, 9, 8, device="cpu")
    for t, j in [*zip(tc["layers"], jc["layers"]), (tc["pos"], jc["pos"]),
                 *zip(tpools["layers"], jp["layers"])]:
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        assert not t.any()
    assert TM.paged_pool_kinds(tcfg) == JM.paged_pool_kinds(jcfg)
    assert TM.cache_family(tcfg) == JM.cache_family(jcfg) == "gqa"
    assert TM.supports_paged(tcfg)
