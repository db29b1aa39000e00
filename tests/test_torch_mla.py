"""The port's MLA + MoE stack (repro_torch.models.layers.mla_attention,
repro_torch.models.moe and the MoE family of repro_torch.models.transformer)
against repro.models on the same weights: MLA attention in its causal,
paged and dense-decode branches, the router, the dense MoE and the MoE
layer, logits and aux of ``apply`` in every mode, greedy tokens over 16
steps, paged decode against the port's own dense decode, the cache and
pool layouts with the ``first_layers`` prefix, the parameter count and
the router's fp32 under the bridge's cast.

Configs: deepseek-v2-lite-16b reduced (2 layers: one dense prefix layer
and one MoE layer of 4 experts, top-2, one shared; MLA r 32, rope 8, nope
16, v 16) and, for the model-level cases, qwen3-moe reduced (MoE + GQA),
fp32.  Values agree to 1e-4 and the aux loss to 1e-5 (atol and rtol):
both sides compute in fp32, but every matmul and reduction sums in its
own order, and the differences grow through the layers and the
unembedding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch.configs.registry import get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.params import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
AUX_TOL = dict(rtol=1e-5, atol=1e-5)
MAX_SEQ = 32
BS = 16

# the reference's functions, jitted once (cfg is static)
_jax_init = jax.jit(JM.init_params, static_argnums=0)
_jax_apply = jax.jit(JM.apply, static_argnums=0, static_argnames="mode")
_jax_mla = jax.jit(JL.mla_attention, static_argnums=0,
                   static_argnames="cache")
_jax_router = jax.jit(JMoE.router_topk, static_argnums=0)
_jax_moe_dense = jax.jit(JMoE.moe_dense, static_argnums=0)
_jax_moe_layer = jax.jit(JMoE.moe_layer, static_argnums=0)


def _configs(arch):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    return jcfg, tcfg


def _bridged(arch, seed):
    jcfg, tcfg = _configs(arch)
    jp = _jax_init(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def setup():
    return _bridged("deepseek_v2_lite_16b", 0)


@pytest.fixture(scope="module", params=["deepseek_v2_lite_16b",
                                        "qwen3_moe_235b_a22b"])
def model(request):
    return _bridged(request.param, 1)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 128, shape, dtype=np.int32)


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def _attn0(jp, tp):
    """The prefix layer's MLA weights on both sides."""
    return jp["first_layers"][0]["attn"], tp["first_layers"][0]["attn"]


def _tlayer0(tree):
    if isinstance(tree, dict):
        return {k: _tlayer0(v) for k, v in tree.items()}
    return tree[0]


def _moe0(jp, tp):
    """The first stacked (MoE) layer's MoE weights on both sides."""
    return (jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
            _tlayer0(tp["layers"]["moe"]))


# --------------------------------------------------------------------------
# MLA attention, three branches
# --------------------------------------------------------------------------


def test_mla_causal_and_build(setup):
    jcfg, tcfg, jp, tp = setup
    jw, tw = _attn0(jp, tp)
    x = _normal(0, 2, 9, tcfg.d_model)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    jout, (jc, jr) = _jax_mla(jcfg, jw, x, positions=pos, cache="build")
    tout, (tc, tr) = TL.mla_attention(tcfg, tw, torch.from_numpy(x),
                                      positions=torch.from_numpy(pos.copy()),
                                      cache="build")
    _close(tout, jout)
    _close(tc, jc)
    _close(tr, jr)
    assert tc.is_contiguous()
    tout2, none = TL.mla_attention(tcfg, tw, torch.from_numpy(x),
                                   positions=torch.from_numpy(pos.copy()))
    assert none is None and torch.equal(tout2, tout)


def _latent_caches(tcfg, seed, b, smax):
    return (_normal(seed, b, smax, tcfg.kv_lora_rank),
            _normal(seed + 1, b, smax, tcfg.qk_rope_head_dim))


def test_mla_dense_decode(setup):
    jcfg, tcfg, jp, tp = setup
    jw, tw = _attn0(jp, tp)
    ckv, krope = _latent_caches(tcfg, 1, 3, MAX_SEQ)
    x = _normal(3, 3, 1, tcfg.d_model)
    pos = np.array([0, 7, 30], np.int32)
    jout, (jc, jr) = _jax_mla(jcfg, jw, x, positions=pos[:, None],
                              layer_cache=(ckv, krope, pos))
    tckv, tkr = torch.from_numpy(ckv.copy()), torch.from_numpy(krope.copy())
    tpos = torch.from_numpy(pos)
    tout, (tc, tr) = TL.mla_attention(tcfg, tw, torch.from_numpy(x),
                                      positions=tpos[:, None],
                                      layer_cache=(tckv, tkr, tpos))
    _close(tout, jout)
    assert tc is tckv and tr is tkr  # written in place
    _close(tc, jc)
    _close(tr, jr)


def test_mla_paged_decode(setup):
    """Latent block pools (L=2 stacks, this layer at lidx 1), ragged rows,
    table lanes past the live blocks on scratch block 0."""
    jcfg, tcfg, jp, tp = setup
    jw, tw = _attn0(jp, tp)
    nb = 8
    r, pr = tcfg.kv_lora_rank, tcfg.qk_rope_head_dim
    ckv = _normal(4, 2, nb, BS, r)
    krope = _normal(5, 2, nb, BS, pr)
    tables = np.array([[3, 0, 0], [5, 1, 6]], np.int32)
    pos = np.array([9, 40], np.int32)
    x = _normal(6, 2, 1, tcfg.d_model)
    jout, (jc, jr) = _jax_mla(jcfg, jw, x, positions=pos[:, None],
                              layer_cache=(ckv, krope, jnp.int32(1), tables,
                                           pos))
    tckv, tkr = torch.from_numpy(ckv.copy()), torch.from_numpy(krope.copy())
    tpos = torch.from_numpy(pos)
    tout, (tc, tr) = TL.mla_attention(
        tcfg, tw, torch.from_numpy(x), positions=tpos[:, None],
        layer_cache=(tckv, tkr, 1, torch.from_numpy(tables), tpos))
    _close(tout, jout)
    assert tc is tckv and tr is tkr
    _close(tc, jc)
    _close(tr, jr)
    assert torch.equal(tc[0], torch.from_numpy(ckv[0]))  # other layer kept


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------


def test_router_topk(setup):
    jcfg, tcfg, jp, tp = setup
    jw, tw = _moe0(jp, tp)
    x = _normal(7, 11, tcfg.d_model)
    jidx, jwts, jaux = _jax_router(jcfg, jw, x)
    tidx, twts, taux = TMoE.router_topk(tcfg, tw, torch.from_numpy(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert twts.dtype == torch.float32
    _close(twts, jwts)
    _close(taux, jaux, AUX_TOL)


def test_moe_dense_and_layer(setup):
    jcfg, tcfg, jp, tp = setup
    jw, tw = _moe0(jp, tp)
    assert "shared" in tw
    x = _normal(8, 2, 5, tcfg.d_model)
    jd, jdaux = _jax_moe_dense(jcfg, jw, x)
    td, tdaux = TMoE.moe_dense(tcfg, tw, torch.from_numpy(x))
    _close(td, jd)
    _close(tdaux, jdaux, AUX_TOL)
    jl, jlaux = _jax_moe_layer(jcfg, jw, x)
    tl, tlaux = TMoE.moe_layer(tcfg, tw, torch.from_numpy(x))
    _close(tl, jl)
    _close(tlaux, jlaux, AUX_TOL)
    assert not torch.allclose(tl, td)  # the shared experts add


# --------------------------------------------------------------------------
# the stack: apply in every mode
# --------------------------------------------------------------------------


def _prefill(model, toks, lengths):
    jcfg, tcfg, jp, tp = model
    # eager: the reference pads its prefill cache to the batch's max_seq,
    # which must stay a Python int
    jl, jc, jaux = JM.apply(jcfg, jp, {"tokens": toks, "max_seq": MAX_SEQ,
                                       "lengths": jnp.asarray(lengths)},
                            mode="prefill")
    tl, tc, taux = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                       "max_seq": MAX_SEQ,
                                       "lengths": torch.from_numpy(lengths)},
                            mode="prefill")
    return (jl, jc, jaux), (tl, tc, taux)


def _pools(cache, tables, lengths, nb):
    """Block pools holding a prefill cache's rows at ``tables`` (numpy, the
    same layout for both sides): ``layers`` (L, NB, BS, ...) and, with a
    prefix, ``first_layers`` (L1, NB, BS, ...)."""
    def pool(leaf):
        leaf = np.asarray(leaf)
        out = np.zeros((leaf.shape[0], nb, BS, *leaf.shape[3:]), np.float32)
        for row, blocks in enumerate(tables):
            for j in range(-(-int(lengths[row] + 1) // BS)):
                out[:, blocks[j]] = leaf[:, row, j * BS:(j + 1) * BS]
        return out

    pools = {"layers": tuple(pool(t) for t in cache["layers"])}
    if "first_layers" in cache:
        stacked = [np.stack([np.asarray(f[i]) for f in cache["first_layers"]])
                   for i in range(2)]
        pools["first_layers"] = tuple(pool(t) for t in stacked)
    return pools


def test_train_logits_and_aux(model):
    jcfg, tcfg, jp, tp = model
    toks = _tokens(9, 2, 11)
    jl, _, jaux = _jax_apply(jcfg, jp, {"tokens": toks}, mode="train")
    tl, tc, taux = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                            mode="train")
    assert tc is None and float(taux) > 0
    _close(tl, jl)
    _close(taux, jaux, AUX_TOL)


def test_prefill_logits_aux_and_cache(model):
    toks = _tokens(10, 3, 12)
    lengths = np.array([12, 5, 9], np.int32)
    (jl, jc, jaux), (tl, tc, taux) = _prefill(model, toks, lengths)
    _close(tl, jl)
    _close(taux, jaux, AUX_TOL)
    for t, j in zip(tc["layers"], jc["layers"]):
        assert tuple(t.shape) == j.shape  # (L, B, max_seq, ...)
        _close(t, j)
    assert len(tc.get("first_layers", [])) == len(jc.get("first_layers", []))
    for tf, jf in zip(tc.get("first_layers", []), jc.get("first_layers", [])):
        for t, j in zip(tf, jf):
            assert tuple(t.shape) == j.shape  # (B, max_seq, ...)
            _close(t, j)
    np.testing.assert_array_equal(tc["pos"].numpy(), lengths)


def test_dense_decode_logits(model):
    jcfg, tcfg, jp, tp = model
    toks = _tokens(11, 2, 7)
    (_, jc, _), (_, tc, _) = _prefill(model, toks, np.array([7, 4], np.int32))
    for step in range(3):
        nxt = _tokens(20 + step, 2, 1)
        jl, jc, jaux = _jax_apply(jcfg, jp, {"tokens": nxt}, mode="decode",
                                  cache=jc)
        tl, tc, taux = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(nxt)},
                                mode="decode", cache=tc)
        _close(tl, jl)
        _close(taux, jaux, AUX_TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for t, j in zip(tc["layers"], jc["layers"]):
        _close(t, j)
    for tf, jf in zip(tc.get("first_layers", []), jc.get("first_layers", [])):
        for t, j in zip(tf, jf):
            _close(t, j)


def test_paged_decode_logits(model):
    """Both sides decode one step from the same block pools (the prefill
    cache scattered through per-row tables, spare lanes on scratch block
    0; prefix layers in their own pools on the same tables) and agree on
    the logits, the aux loss and the updated pools."""
    jcfg, tcfg, jp, tp = model
    toks = _tokens(12, 2, 20)
    lengths = np.array([20, 6], np.int32)
    (_, jc, _), _ = _prefill(model, toks, lengths)
    tables = np.array([[4, 2], [7, 0]], np.int32)
    pools = _pools(jc, tables, lengths, nb=9)
    nxt = _tokens(13, 2, 1)
    jl, jcache, jaux = _jax_apply(
        jcfg, jp, {"tokens": nxt}, mode="decode",
        cache={**{k: tuple(jnp.asarray(p) for p in v) for k, v in pools.items()},
               "block_tables": jnp.asarray(tables), "pos": jnp.asarray(lengths)})
    tpools = {k: tuple(torch.from_numpy(p.copy()) for p in v)
              for k, v in pools.items()}
    tl, tcache, taux = TM.apply(
        tcfg, tp, {"tokens": torch.from_numpy(nxt)}, mode="decode",
        cache={**tpools, "block_tables": torch.from_numpy(tables),
               "pos": torch.from_numpy(lengths)})
    _close(tl, jl)
    _close(taux, jaux, AUX_TOL)
    for key, leaves in tpools.items():
        assert tcache[key] is leaves  # updated in place
        for t, j in zip(leaves, jcache[key]):
            _close(t, j)


def test_paged_decode_equals_dense_decode_exactly(model):
    """In the port, paged decode over block pools and dense decode over the
    (B, max_seq) cache do the same arithmetic per row: equal logits."""
    _, tcfg, _, tp = model
    toks = _tokens(14, 2, 17)
    lengths = np.array([17, 3], np.int32)
    _, (_, tc, _) = _prefill(model, toks, lengths)
    tables = np.array([[3, 1], [2, 4]], np.int32)  # W * BS == max_seq
    pools = {k: tuple(torch.from_numpy(p) for p in v)
             for k, v in _pools(tc, tables, lengths, nb=5).items()}
    for step in range(3):
        nxt = torch.from_numpy(_tokens(30 + step, 2, 1))
        dl, tc, _ = TM.apply(tcfg, tp, {"tokens": nxt}, mode="decode",
                             cache=tc)
        pl_, pcache, _ = TM.apply(
            tcfg, tp, {"tokens": nxt}, mode="decode",
            cache={**pools, "block_tables": torch.from_numpy(tables),
                   "pos": torch.from_numpy(lengths + step)})
        assert torch.equal(pl_, dl), step


def test_greedy_tokens_match_over_16_steps(model):
    jcfg, tcfg, jp, tp = model
    toks = _tokens(15, 1, 6)
    (jl, jc, _), (tl, tc, _) = _prefill(model, toks, np.array([6], np.int32))
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = tl[:, -1].argmax(-1).to(torch.int32)[:, None]
    jout, tout = [], []
    for _ in range(16):
        jl, jc, _ = _jax_apply(jcfg, jp, {"tokens": jtok}, mode="decode",
                               cache=jc)
        tl, tc, _ = TM.apply(tcfg, tp, {"tokens": ttok}, mode="decode",
                             cache=tc)
        jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        ttok = tl[:, -1].argmax(-1).to(torch.int32)[:, None]
        jout.append(int(jtok[0, 0]))
        tout.append(int(ttok[0, 0]))
    assert tout == jout


# --------------------------------------------------------------------------
# layouts, parameter count, the bridge
# --------------------------------------------------------------------------


def _shapes(tree):
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape)
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_cache_and_pool_layouts(model):
    """Dense caches and block pools keep the reference's shapes, dtypes
    and keys, ``first_layers`` included."""
    jcfg, tcfg, _, _ = model
    jc = JM.init_cache(jcfg, 3, MAX_SEQ)
    tc = TM.init_cache(tcfg, 3, MAX_SEQ, device="cpu")
    jp = JM.init_paged_cache(jcfg, 9, BS)
    tpools = TM.init_paged_cache(tcfg, 9, BS, device="cpu")
    assert _shapes(tc) == _shapes(jc)
    assert _shapes(tpools) == _shapes(jp)
    for t in jax.tree.leaves(jax.tree.map(lambda t: t, (tc, tpools),
                                          is_leaf=torch.is_tensor)):
        assert not t.any()
    assert TM.paged_pool_kinds(tcfg) == JM.paged_pool_kinds(jcfg)
    assert TM.cache_family(tcfg) == JM.cache_family(jcfg)
    assert TM.supports_paged(tcfg) and JM.supports_paged(jcfg)


def test_mla_pool_kinds_and_layouts(setup):
    _, tcfg, _, _ = setup
    assert TM.cache_family(tcfg) == "mla"
    assert TM.paged_pool_kinds(tcfg) == {"layers": "block",
                                         "first_layers": "block"}
    pools = TM.init_paged_cache(tcfg, 9, BS, device="cpu")
    r, pr = tcfg.kv_lora_rank, tcfg.qk_rope_head_dim
    assert _shapes(pools) == {"layers": [(1, 9, BS, r), (1, 9, BS, pr)],
                              "first_layers": [(1, 9, BS, r), (1, 9, BS, pr)]}


def test_param_count_and_native_init(model):
    jcfg, tcfg, jp, _ = model
    tp = TM.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    n = sum(t.numel() for t in jax.tree.leaves(
        jax.tree.map(lambda t: t, tp, is_leaf=torch.is_tensor)))
    assert TM.param_count(tcfg) == JM.param_count(jcfg) == n
    assert _shapes(tp) == _shapes(jax.tree.map(lambda a: a, jp))


def test_full_width_param_count():
    for arch in ("deepseek_v2_lite_16b", "qwen3_moe_235b_a22b"):
        assert TM.param_count(get_config(arch)) == JM.param_count(
            jax_config(arch))
    assert TM.param_count(get_config("deepseek_v2_lite_16b")) == 15_706_470_400


def test_router_stays_fp32(setup):
    """The reference draws the router in fp32 whatever the dtype: the
    bridge's cast and the port's native bf16 init keep it so."""
    jcfg, tcfg, jp, _ = setup
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                           dtype=torch.bfloat16)
    assert tp["layers"]["moe"]["router"].dtype == torch.float32
    assert tp["layers"]["moe"]["experts"]["w_gate"].dtype == torch.bfloat16
    assert tp["first_layers"][0]["attn"]["w_dkv"].dtype == torch.bfloat16
    native = TM.init_params(get_config("deepseek_v2_lite_16b").reduced(),
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert native["layers"]["moe"]["router"].dtype == torch.float32
    assert native["layers"]["moe"]["shared"]["w_up"].dtype == torch.bfloat16
