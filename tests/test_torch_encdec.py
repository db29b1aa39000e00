"""The port's enc-dec stack (repro_torch.models.encdec) against
repro.models.encdec on the same weights: sinusoidal positions, the
parameter tree and its count, the dense and pooled cache layouts, the
encoder, logits of ``apply`` in train, prefill (padded, with lengths) and
dense decode, greedy tokens over 16 steps, the paged branch (decoder
self-KV block pools and shared cross-attention segments) against the dense
branch, and the engine's insert views.  Also the two kernel shapes the
stack adds, on their plain versions: flash attention with Sk != S
against the model's ``_sdpa``, and decode attention through ``row_ids``
against the Pallas kernel (interpret mode) on the gathered view.

Two shapes, fp32: whisper-medium reduced (2 + 2 layers, d 64, 4/2 heads of
16, 16 frames), and the same with 20 frames (not a multiple of the
kernels' 16-position tiles) and 4/4 heads (group size 1, as at full
width).  Values agree to 1e-4 (atol and rtol): both sides compute in fp32,
but every matmul and reduction sums in its own order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs.registry import get_config
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.params import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_SEQ = 32
SHAPES = {"reduced": {}, "enc20_g1": dict(encoder_seq=20, num_kv_heads=4)}

_jax_apply = jax.jit(JM.apply, static_argnums=0, static_argnames="mode")
_jax_init = jax.jit(JM.init_params, static_argnums=0)
_jax_prefill = jax.jit(  # max_seq fixes a shape: closed over, not traced
    lambda cfg, p, toks, frames, lengths: JM.apply(
        cfg, p, {"tokens": toks, "frames": frames, "max_seq": MAX_SEQ,
                 "lengths": lengths}, mode="prefill"), static_argnums=0)


def _configs(shape):
    return tuple(dataclasses.replace(get("whisper_medium").reduced(),
                                     dtype="float32", **SHAPES[shape])
                 for get in (jax_config, get_config))


@pytest.fixture(scope="module", params=sorted(SHAPES))
def setup(request):
    jcfg, tcfg = _configs(request.param)
    jp = _jax_init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 128, shape, dtype=np.int32)


def _frames(seed, cfg, b):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(lambda t: t, tree,
                                        is_leaf=torch.is_tensor))


def _prefill(setup, toks, lengths, frames):
    jcfg, tcfg, jp, tp = setup
    jl, jc, _ = _jax_prefill(jcfg, jp, toks, frames, jnp.asarray(lengths))
    tl, tc, _ = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                    "frames": torch.from_numpy(frames),
                                    "max_seq": MAX_SEQ,
                                    "lengths": torch.from_numpy(lengths)},
                         mode="prefill")
    return (jl, jc), (tl, tc)


def _cache_close(tc, jc):
    assert set(tc) == set(jc)
    for t, j in zip(_leaves(tc), jax.tree.leaves(jc)):
        assert tuple(t.shape) == j.shape
        _close(t, j)


# --------------------------------------------------------------------------
# positions, parameters and caches
# --------------------------------------------------------------------------


@pytest.mark.parametrize("d_model", [64, 1024])
def test_sinusoidal_positions_match_the_reference(d_model):
    """Decode positions (B, 1) and prefill positions (B, S) up to the
    1500 frames of an encoder: [sin, cos] of the same fp32 angles."""
    for shape, hi in (((3, 1), 512), ((2, 1500), 1500)):
        pos = np.random.default_rng(d_model).integers(0, hi, shape)
        if shape[1] > 1:
            pos = np.broadcast_to(np.arange(shape[1]), shape)
        got = TL.sinusoidal_positions(torch.from_numpy(pos.copy()), d_model)
        want = JL.sinusoidal_positions(jnp.asarray(pos), d_model)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == want.shape == (*shape, d_model)
        # angles up to 1500 rad, where one fp32 ulp is 1.2e-4: the two
        # sides' exp may round the frequency one ulp apart
        _close(got, want, dict(rtol=0, atol=2e-4))


def test_param_tree_count_and_native_init(setup):
    """Native init gives the reference's tree -- keys, shapes and dtypes,
    the encoder and decoder stacked (L, ...) -- and the analytical count
    agrees on both sides with the tree's."""
    jcfg, tcfg, jp, _ = setup
    tp = TM.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert (jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
            == jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp,
                            is_leaf=torch.is_tensor))
    assert tp["encoder"]["attn"]["wq"].shape[0] == tcfg.encoder_layers
    assert tp["decoder"]["cross"]["wk"].shape[0] == tcfg.num_layers
    assert TM.param_count(tcfg) == JM.param_count(jcfg) == sum(
        t.numel() for t in _leaves(tp))


def test_cache_layouts_and_own_storage(setup):
    """Dense and pooled caches keep the reference's keys, shapes and
    dtypes, zeroed; every leaf is its own storage (decode writes in
    place)."""
    jcfg, tcfg, _, _ = setup
    jc, tc = JM.init_cache(jcfg, 3, MAX_SEQ), TM.init_cache(
        tcfg, 3, MAX_SEQ, device="cpu")
    jpools = JM.init_paged_cache(jcfg, 9, 8, num_segments=5)
    tpools = TM.init_paged_cache(tcfg, 9, 8, num_segments=5, device="cpu")
    for t_tree, j_tree in ((tc, jc), (tpools, jpools)):
        assert set(t_tree) == set(j_tree)
        for t, j in zip(_leaves(t_tree), jax.tree.leaves(j_tree)):
            assert tuple(t.shape) == j.shape
            assert str(t.dtype).split(".")[-1] == str(j.dtype)
            assert not t.any()
    assert tpools["cross"][0].shape[1:3] == (5, tcfg.encoder_seq)
    assert len({t.data_ptr() for t in _leaves(tc)}) == 5
    assert len({t.data_ptr() for t in _leaves(tpools)}) == 4
    assert TM.paged_pool_kinds(tcfg) == JM.paged_pool_kinds(jcfg) == {
        "self": "block", "cross": "segment"}
    assert TM.cache_family(tcfg) == JM.cache_family(jcfg) == "encdec"
    assert TM.supports_paged(tcfg) and JM.supports_paged(jcfg)


# --------------------------------------------------------------------------
# the stack through apply
# --------------------------------------------------------------------------


def test_encode(setup):
    jcfg, tcfg, jp, tp = setup
    frames = _frames(0, tcfg, 2)
    want = jax.jit(JE.encode, static_argnums=0)(jcfg, jp, frames)
    got = TE.encode(tcfg, tp, torch.from_numpy(frames))
    assert tuple(got.shape) == (2, tcfg.encoder_seq, tcfg.d_model)
    _close(got, want)


def test_train_logits(setup):
    jcfg, tcfg, jp, tp = setup
    toks, frames = _tokens(0, 2, 11), _frames(1, tcfg, 2)
    jl, _, _ = _jax_apply(jcfg, jp, {"tokens": toks, "frames": frames},
                          mode="train")
    tl, tc, aux = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                      "frames": torch.from_numpy(frames)},
                           mode="train")
    assert tc is None and float(aux) == 0.0
    _close(tl, jl)


def test_padded_prefill_logits_and_cache(setup):
    """Rows of 12, 5 and 9 tokens padded to 12: logits and every cache
    leaf (the self K/V padded to max_seq on axis 2, the cross K/V of each
    row's frames) equal the reference's."""
    _, tcfg, _, _ = setup
    toks, frames = _tokens(2, 3, 12), _frames(3, tcfg, 3)
    lengths = np.array([12, 5, 9], np.int32)
    (jl, jc), (tl, tc) = _prefill(setup, toks, lengths, frames)
    _close(tl, jl)
    _cache_close(tc, jc)
    assert tc["self"][0].shape[2] == MAX_SEQ
    assert tc["cross"][0].shape[2] == tcfg.encoder_seq
    np.testing.assert_array_equal(tc["pos"].numpy(), lengths)


def test_dense_decode_16_greedy_steps(setup):
    """From a padded two-row prefill, 16 greedy dense decode steps: the
    tokens equal the reference's and the logits stay within 1e-4 at every
    step; the caches are updated in place."""
    jcfg, tcfg, jp, tp = setup
    toks, frames = _tokens(4, 2, 9), _frames(5, tcfg, 2)
    (jl, jc), (tl, tc) = _prefill(setup, toks, np.array([9, 4], np.int32),
                                  frames)
    jdecode = jax.jit(lambda p, t, c: JM.apply(jcfg, p, {"tokens": t},
                                              mode="decode", cache=c))
    first = np.array([8, 3])
    jtok = jnp.asarray(np.argmax(np.asarray(jl)[[0, 1], first], -1)
                       .astype(np.int32)[:, None])
    ttok = tl[[0, 1], first].argmax(-1).to(torch.int32)[:, None]
    self_k = tc["self"][0]
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
    assert tc["self"][0] is self_k  # updated in place
    _cache_close(tc, jc)


def _pools(tcfg, tc, tables, segs, nb, nseg, seed):
    """Block and segment pools full of noise, with each row's self K/V
    copied into its blocks and its cross K/V into its segment (rows that
    share a segment hold the same frames, so their cross K/V agree)."""
    rng = np.random.default_rng(seed)
    views = TM.paged_insert_views(tcfg, tc)
    bs = MAX_SEQ // tables.shape[1]
    blocks, segments = [], []
    for leaf in views["self"]:  # (L, B, max_seq, Nkv, H)
        leaf = leaf.numpy()
        pool = rng.standard_normal((leaf.shape[0], nb, bs, *leaf.shape[3:]),
                                   dtype=np.float32)
        for row, blk in enumerate(tables):
            pool[:, blk] = leaf[:, row].reshape(leaf.shape[0], -1, bs,
                                                *leaf.shape[3:])
        blocks.append(pool)
    for leaf in views["cross"]:  # (L, B, T_enc, Nkv, H)
        leaf = leaf.numpy()
        pool = rng.standard_normal((leaf.shape[0], nseg, *leaf.shape[2:]),
                                   dtype=np.float32)
        pool[:, segs] = leaf
        segments.append(pool)
    return blocks, segments


def test_paged_decode_equals_dense_and_the_reference(setup):
    """Four rows on permuted blocks of noisy block pools; rows 0 and 2
    share one segment of a noisy segment pool (the same frames) and rows 1
    and 3 another (repeated ids, as when streams share an encoder output).
    Three paged steps give the dense branch's logits bit for bit and the
    reference's paged logits within 1e-4; the rows' blocks end as the
    dense self cache, every segment and every other block keep their
    bits."""
    jcfg, tcfg, jp, tp = setup
    toks = _tokens(6, 4, 10)
    lengths = np.array([10, 6, 3, 9], np.int32)
    frames = _frames(7, tcfg, 2)[[0, 1, 0, 1]]
    _, (_, tc) = _prefill(setup, toks, lengths, frames)
    tables = np.array([[7, 2, 9, 4], [3, 11, 5, 1],
                       [12, 8, 0, 13], [6, 15, 14, 10]], np.int32)
    segs, nb, nseg = np.array([4, 1, 4, 1], np.int32), 17, 6
    blocks, segments = _pools(tcfg, tc, tables, segs, nb, nseg, 8)
    tpools = {"self": tuple(torch.from_numpy(p.copy()) for p in blocks),
              "cross": tuple(torch.from_numpy(p.copy()) for p in segments)}
    jcache = {"self": tuple(map(jnp.asarray, blocks)),
              "cross": tuple(map(jnp.asarray, segments)),
              "block_tables": jnp.asarray(tables),
              "segment_ids": jnp.asarray(segs), "pos": jnp.asarray(lengths)}
    pos = torch.from_numpy(lengths)
    for step in range(3):
        nxt = _tokens(10 + step, 4, 1)
        pl, pc, _ = TM.apply(
            tcfg, tp, {"tokens": torch.from_numpy(nxt)}, mode="decode",
            cache={**tpools, "block_tables": torch.from_numpy(tables),
                   "segment_ids": torch.from_numpy(segs), "pos": pos})
        dl, tc, _ = TM.apply(tcfg, tp, {"tokens": torch.from_numpy(nxt)},
                             mode="decode", cache=tc)
        jl, jcache, _ = _jax_apply(jcfg, jp, {"tokens": nxt}, mode="decode",
                                   cache=jcache)
        torch.testing.assert_close(pl, dl, rtol=0, atol=0)
        _close(pl, jl)
        assert pc["self"][0] is tpools["self"][0]  # updated in place
        assert pc["cross"][0] is tpools["cross"][0]
        pos = pc["pos"]
    views = TM.paged_insert_views(tcfg, tc)
    nl, bs = tcfg.num_layers, MAX_SEQ // tables.shape[1]
    for pool, noise, leaf in zip(tpools["self"], blocks, views["self"]):
        for row, blk in enumerate(tables):
            torch.testing.assert_close(
                pool[:, blk].reshape(nl, MAX_SEQ, *pool.shape[3:]),
                leaf[:, row], rtol=0, atol=0)
        rest = [i for i in range(nb) if i not in tables]
        assert np.array_equal(pool[:, rest].numpy(), noise[:, rest])
    for pool, noise in zip(tpools["cross"], segments):
        assert np.array_equal(pool.numpy(), noise)  # read-only
    for t, j in zip((*tpools["self"], *tpools["cross"]),
                    (*jcache["self"], *jcache["cross"])):
        _close(t, j)


def test_paged_insert_views_equal_the_reference(setup):
    jcfg, tcfg, _, _ = setup
    toks, frames = _tokens(9, 2, 8), _frames(10, tcfg, 2)
    (_, jc), (_, tc) = _prefill(setup, toks, np.array([8, 3], np.int32),
                                frames)
    jv, tv = JM.paged_insert_views(jcfg, jc), TM.paged_insert_views(tcfg, tc)
    assert set(tv) == set(jv) == {"self", "cross"}
    for t, j in zip(_leaves(tv), jax.tree.leaves(jv)):
        assert tuple(t.shape) == j.shape
        _close(t, j)


# --------------------------------------------------------------------------
# the two kernel shapes the stack adds, on their plain versions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,sk,nq,nkv", [
    (2, 1, 16, 4, 2), (2, 8, 20, 4, 4), (1, 40, 1500, 16, 16)])
def test_flash_plain_with_sk_other_than_s_matches_model_sdpa(b, s, sk, nq,
                                                             nkv):
    """Full attention from S decoder tokens to Sk encoder frames (prompt
    buckets against whisper's 1500), no mask."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32)
               for shape in ((b, s, nq, 16), (b, sk, nkv, 16),
                             (b, sk, nkv, 16)))
    scale = 16 ** -0.5
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                          scale=scale)
    assert tuple(got.shape) == (b, s, nq, 16)
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    mask=None, scale=scale)
    _close(got, want, dict(rtol=1e-5, atol=1e-5))
    _close(got, flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                      causal=False, scale=scale), TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_ids_decode_matches_pallas_on_the_gathered_view(dtype):
    """Four rows reading permuted and repeated rows of a (6, 20, ...)
    segment pool at full length (the cross-attention's decode) and at
    ragged lengths: the plain version through ``row_ids`` equals the
    Pallas kernel (interpret mode) on the gathered copy, and the wrapper
    on the CPU takes the plain version."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    rng = np.random.default_rng(12)
    qj, kj, vj = (jnp.asarray(rng.standard_normal(shape, dtype=np.float32)
                              ).astype(jdt)
                  for shape in ((4, 4, 16), (6, 20, 2, 16), (6, 20, 2, 16)))
    q, k, v = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
               for a in (qj, kj, vj))
    ids = np.array([5, 2, 5, 0], np.int32)
    for lengths in (np.full(4, 20, np.int32), np.array([20, 1, 7, 16],
                                                      np.int32)):
        got = decode_attention(q, k, v, torch.from_numpy(lengths),
                               row_ids=torch.from_numpy(ids))
        heads = lambda a: jnp.swapaxes(a[ids], 1, 2)  # gathered, kernel layout
        want = jax_decode(qj, heads(kj), heads(vj), jnp.asarray(lengths),
                          interpret=True)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)
        torch.testing.assert_close(
            got, decode_attention_plain(q, k[ids], v[ids],
                                        torch.from_numpy(lengths)),
            rtol=0, atol=0)
