"""The port's VLM backbone (qwen2-vl-2b: M-RoPE, embedding inputs) against
``repro.models`` on the same weights and inputs.

``mrope_cos_sin`` is held against the reference's at the reduced config's
sections (16, 24, 24), which sum past head_dim/2 = 8 and so leave every
pair on the temporal stream, at (2, 3, 3), where all three streams are
live, and at sections shorter than head_dim/2, with distinct t/h/w
position streams as an image's patches have.  The model runs on reduced
qwen2-vl with sections (2, 3, 3) in fp32 on bridged weights: logits within
1e-4 (atol and rtol; both sides sum in their own order) in train, padded
prefill, dense decode and paged decode from ``embeds`` and
``mrope_positions``; teacher-forced decode equal to the full forward; 16
greedy steps from tokens, paged equal to dense bit for bit; the engine's
tokens equal unbatched ``generate``'s and the JAX engine's; the weight
bridge keeps the tied tree.
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
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.serving.engine import StreamSpec as JaxStreamSpec
from repro_torch.configs.registry import get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import ServeEngine, StreamSpec

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_SEQ = 32
SECTIONS = (2, 3, 3)


@pytest.fixture(scope="module")
def setup():
    kw = dict(dtype="float32", mrope_sections=SECTIONS)
    jcfg = dataclasses.replace(jax_config("qwen2_vl_2b").reduced(), **kw)
    tcfg = dataclasses.replace(get_config("qwen2_vl_2b").reduced(), **kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _mrope(b, s, start=0, seed=0):
    """(3, B, S) image-like position streams: the temporal stream steps
    once per 4 patches, height and width walk a 4-wide grid from a per-row
    offset, so t, h and w differ at every position."""
    off = np.random.default_rng(seed).integers(0, 5, (b, 1))
    idx = np.arange(start, start + s)[None, :] + off
    return np.stack([idx // 4, 2 * (idx // 4) + 1, idx % 4 + 3 * idx // 4]
                    ).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _both(setup, batch, mode, jcache=None, tcache=None):
    """Run the JAX and the port's ``apply`` on the same numpy batch."""
    jcfg, tcfg, jp, tp = setup
    jb = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in batch.items()}
    tb = {k: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray) else v
          for k, v in batch.items()}
    jl, jc, _ = JM.apply(jcfg, jp, jb, mode=mode, cache=jcache)
    tl, tc, _ = TM.apply(tcfg, tp, tb, mode=mode, cache=tcache)
    return (jl, jc), (tl, tc)


@pytest.mark.parametrize("sections,head_dim", [
    ((16, 24, 24), 16),  # the reduced config: all 8 pairs temporal
    ((2, 3, 3), 16),     # all three streams live
    ((1, 2, 1), 16),     # short: pairs past 4 take stream 2
    ((0, 3, 2), 16),     # no temporal pair, short
    ((16, 24, 24), 128),  # full width
])
def test_mrope_cos_sin_matches_reference(sections, head_dim):
    pos = _mrope(2, 7, seed=1)
    cj, sj = JL.mrope_cos_sin(jnp.asarray(pos), head_dim, 1e6, sections)
    ct, st = TL.mrope_cos_sin(torch.from_numpy(pos), head_dim, 1e6, sections)
    assert tuple(ct.shape) == cj.shape == (2, 7, head_dim // 2)
    _close(ct, cj, dict(rtol=1e-6, atol=1e-6))
    _close(st, sj, dict(rtol=1e-6, atol=1e-6))


def test_mrope_streams_per_pair():
    """Which stream each pair takes, read off positions that are distinct
    per stream: the reduced config's sections leave every pair temporal;
    short sections pad with stream 2."""
    pos = np.stack([np.full((1, 1), v, np.int32) for v in (3, 50, 700)])
    cos_t, _ = TL.rope_cos_sin(torch.from_numpy(pos), 16, 1e6)  # (3,1,1,8)
    for sections, want in [((16, 24, 24), [0] * 8),
                           ((2, 3, 3), [0, 0, 1, 1, 1, 2, 2, 2]),
                           ((1, 2, 1), [0, 1, 1, 2, 2, 2, 2, 2])]:
        cos, _ = TL.mrope_cos_sin(torch.from_numpy(pos), 16, 1e6, sections)
        got = [int(torch.nonzero(cos_t[:, 0, 0, d] == cos[0, 0, d])[0])
               for d in range(8)]
        assert got == want, sections


def test_mrope_needs_three_streams():
    with pytest.raises(ValueError, match=r"\(3, B, S\)"):
        TL.mrope_cos_sin(torch.zeros((2, 1, 4), dtype=torch.int32), 16, 1e6,
                         SECTIONS)


def test_bridge_keeps_the_vlm_tree(setup):
    """The weight bridge on the VLM tree: the reference's keys, shapes and
    dtypes, no ``lm_head`` (the embedding is tied), and a bf16 bridge casts
    every leaf (the VLM has none of the fp32-kept SSM or router leaves)."""
    _, tcfg, jp, tp = setup
    assert tcfg.tie_embeddings and "lm_head" not in tp
    assert (jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
            == jax.tree.map(lambda t: (tuple(t.shape),
                                       str(t.dtype).split(".")[-1]), tp))
    bf16 = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                             dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(bf16))


def test_train_logits_from_embeds(setup):
    _, tcfg, _, _ = setup
    batch = {"embeds": _rand(1, 2, 9, tcfg.d_model),
             "mrope_positions": _mrope(2, 9, seed=2)}
    (jl, _), (tl, tc) = _both(setup, batch, "train")
    assert tc is None and tl.dtype == torch.float32
    _close(tl, jl)


def test_mrope_changes_the_logits(setup):
    """The M-RoPE streams reach the attention: the same temporal stream
    with the h/w streams reversed (rope sees position differences, so a
    shift alone would change nothing) gives other logits."""
    _, tcfg, _, tp = setup
    emb = torch.from_numpy(_rand(3, 1, 6, tcfg.d_model))
    pos = _mrope(1, 6, seed=3)
    other = pos.copy()
    other[1:] = pos[1:, :, ::-1]
    a, _, _ = TM.apply(tcfg, tp, {"embeds": emb, "mrope_positions":
                                  torch.from_numpy(pos)}, mode="train")
    b, _, _ = TM.apply(tcfg, tp, {"embeds": emb, "mrope_positions":
                                  torch.from_numpy(other)}, mode="train")
    assert not torch.allclose(a, b, atol=1e-3)


def _prefill(setup, seed, lengths, s):
    _, tcfg, _, _ = setup
    b = len(lengths)
    batch = {"embeds": _rand(seed, b, s, tcfg.d_model),
             "mrope_positions": _mrope(b, s, seed=seed),
             "lengths": np.asarray(lengths, np.int32), "max_seq": MAX_SEQ}
    return _both(setup, batch, "prefill")


def test_padded_prefill_logits_and_cache(setup):
    (jl, jc), (tl, tc) = _prefill(setup, 4, [10, 6], 10)
    _close(tl, jl)
    for t, j in zip(tc["layers"], jc["layers"]):
        assert tuple(t.shape) == j.shape  # (L, B, max_seq, Nkv, H)
        _close(t, j)
    np.testing.assert_array_equal(tc["pos"].numpy(), [10, 6])


def test_dense_decode_logits(setup):
    _, tcfg, _, _ = setup
    (_, jc), (_, tc) = _prefill(setup, 5, [7, 4], 7)
    for i in range(3):
        step = {"embeds": _rand(20 + i, 2, 1, tcfg.d_model),
                "mrope_positions": _mrope(2, 1, start=7 + i, seed=20 + i)}
        (jl, jc), (tl, tc) = _both(setup, step, "decode", jc, tc)
        _close(tl, jl)
    for t, j in zip(tc["layers"], jc["layers"]):
        _close(t, j)


def test_paged_decode_logits(setup):
    """Both sides decode from the same block pools (the prefill cache
    scattered through per-row tables, spare lanes on scratch block 0) with
    embeddings and (3, B, 1) M-RoPE positions."""
    _, tcfg, _, _ = setup
    bs, nb = 8, 10
    lengths = np.array([9, 6], np.int32)
    (_, jc), _ = _prefill(setup, 6, lengths, 9)
    tables = np.array([[4, 2, 0], [7, 0, 0]], np.int32)
    pools = []
    for leaf in jc["layers"]:
        leaf = np.asarray(leaf)
        pool = np.zeros((leaf.shape[0], nb, bs, *leaf.shape[3:]), np.float32)
        for row, blocks in enumerate(tables):
            for j in range(-(-int(lengths[row] + 1) // bs)):
                pool[:, blocks[j]] = leaf[:, row, j * bs:(j + 1) * bs]
        pools.append(pool)
    step = {"embeds": _rand(7, 2, 1, tcfg.d_model),
            "mrope_positions": _mrope(2, 1, start=9, seed=7)}
    tpools = tuple(torch.from_numpy(p.copy()) for p in pools)
    (jl, jcache), (tl, _) = _both(
        setup, step, "decode",
        {"layers": tuple(jnp.asarray(p) for p in pools),
         "block_tables": jnp.asarray(tables), "pos": jnp.asarray(lengths)},
        {"layers": tpools, "block_tables": torch.from_numpy(tables),
         "pos": torch.from_numpy(lengths)})
    _close(tl, jl)
    for t, j in zip(tpools, jcache["layers"]):
        _close(t, j)


def test_teacher_forced_decode_equals_full_forward(setup):
    """As tests/test_arch_smoke.py's: prefill 4 positions, decode the
    other 4 one at a time with their embeddings and M-RoPE positions; the
    logits are the full forward's (the cache is exact)."""
    _, tcfg, _, tp = setup
    s = 8
    emb = torch.from_numpy(_rand(8, 1, s, tcfg.d_model))
    pos = torch.from_numpy(_mrope(1, s, seed=8))
    full, _, _ = TM.apply(tcfg, tp, {"embeds": emb, "mrope_positions": pos},
                          mode="train")
    _, cache, _ = TM.apply(tcfg, tp, {"embeds": emb[:, :4],
                                      "mrope_positions": pos[:, :, :4],
                                      "max_seq": s}, mode="prefill")
    outs = []
    for t in range(4, s):
        lg, cache, _ = TM.apply(tcfg, tp, {
            "embeds": emb[:, t:t + 1], "mrope_positions": pos[:, :, t:t + 1]},
            mode="decode", cache=cache)
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full[:, 4:], **TOL)


def test_sixteen_greedy_steps_paged_equal_dense(setup):
    """From tokens (the engine's input, plain rope): 16 greedy steps of
    paged decode over permuted blocks give the dense decode's logits bit
    for bit, and its tokens."""
    _, tcfg, _, tp = setup
    bs = 8
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, 128, (2, 5), dtype=np.int32))
    _, dense, _ = TM.apply(tcfg, tp, {"tokens": toks, "max_seq": MAX_SEQ},
                           mode="prefill")
    tables = torch.tensor([[3, 6, 1, 8], [5, 2, 7, 4]], dtype=torch.int32)
    pools = tuple(torch.randn((leaf.shape[0], 9, bs, *leaf.shape[3:]),
                              generator=torch.Generator().manual_seed(9))
                  for leaf in dense["layers"])
    for pool, leaf in zip(pools, dense["layers"]):
        pool[:, tables.long()] = leaf.reshape(leaf.shape[0], 2, -1, bs,
                                              *leaf.shape[3:])
    paged = {"layers": pools, "block_tables": tables,
             "pos": dense["pos"].clone()}
    tok = torch.tensor([[1], [2]], dtype=torch.int32)
    for _ in range(16):
        ld, dense, _ = TM.apply(tcfg, tp, {"tokens": tok}, mode="decode",
                                cache=dense)
        lp, paged, _ = TM.apply(tcfg, tp, {"tokens": tok}, mode="decode",
                                cache=paged)
        assert torch.equal(lp, ld)
        tok = ld[:, -1].argmax(-1).to(torch.int32)[:, None]


def _spec(name, prio, cls=StreamSpec):
    return cls(name=name, priority=prio, period_ms=8000.0, deadline_ms=8000.0,
               prefill_ms=50.0, decode_ms=5.0, decode_steps=6)


def _run(eng, prompts):
    import threading

    out = {}
    threads = [threading.Thread(target=lambda n=n: out.__setitem__(
        n, eng.generate(n, prompts[n], steps=6))) for n in prompts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return {n: r.tokens for n, r in out.items()}


def test_engine_tokens_equal_unbatched_and_the_jax_engine(setup):
    """The engine serves the VLM from tokens through GQA block pools, as the
    reference's does: 3 streams on 2 servers equal unbatched ``generate``
    and the JAX paged engine, and leak nothing."""
    jcfg, tcfg, jp, tp = setup
    prompts = {f"v{i}": np.arange(2, n + 2, dtype=np.int32)[None, :] % 128
               for i, n in enumerate([3, 6, 11])}
    ref = ServeEngine(tcfg, tp, max_seq=MAX_SEQ, device="cpu")
    try:
        want = {}
        for i, n in enumerate(prompts):
            assert ref.admit(_spec(n, 3 - i)).admitted
            want[n] = ref.generate(n, prompts[n], steps=6).tokens
    finally:
        ref.close()
    kw = dict(max_seq=MAX_SEQ, num_servers=2, batching=True, max_batch=2,
              paged=True, kv_block_size=8)
    eng = ServeEngine(tcfg, tp, device="cpu", **kw)
    jeng = JaxServeEngine(jcfg, jp, **kw)
    try:
        for i, n in enumerate(prompts):
            assert eng.admit(_spec(n, 3 - i)).admitted
            assert jeng.admit(_spec(n, 3 - i, cls=JaxStreamSpec)).admitted
        eng.precompile(prompt_buckets=(4, 8, 16))
        got = _run(eng, prompts)
        assert got == want
        assert got == _run(jeng, prompts)
        assert eng.kv_usage() == {"blocks": 0, "slabs": 0, "segments": 0}
        assert {m["kind"] for s in eng.pool.servers
                for m in s.stats.batch_meta} == {"prefill", "decode"}
    finally:
        eng.close()
        jeng.close()
