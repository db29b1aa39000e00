"""The hybrid Mamba-2 + attention + MoE stack of the port
(``models/hybrid_moe.py``, granite-4.0-h-small) on the CPU.

The bar: the config's layer types, parameter counts and input specs; a
padded prefill and dense decode steps reproduce the train logits; paged
decode through block pools and slab pools is the dense decode bit for bit;
the engine's paged batching serves the unbatched path's tokens, counts
every routed MoE layer of a decode call in the experts counter, and
records its spans and ``decoding`` counter; the softmax scale threaded
through ``layers.attention`` leaves the default as it was; ``moe_dense``
in passes equals it in one.

Config: granite-4.0-h-small reduced (mamba, mamba, attention, mamba; 8
experts top 3, shared width 48), fp32.
"""

import dataclasses
import math
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs.granite_4_0_h_small import CONFIG, HybridMoEConfig
from repro_torch.kernels import moe_experts as ME
from repro_torch.models import hybrid_moe as HM
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.serving.engine import ServeEngine, StreamSpec

STEPS = 5
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the engine's server threads and the small
    ops would otherwise each spin a worker per core against the other
    test processes' on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return dataclasses.replace(CONFIG.reduced(), dtype="float32", **kw)


def _params(cfg, seed=0):
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(seed),
                           device="cpu")
    # Mamba-2 decays and step sizes that spread, and a conv bias
    gen = torch.Generator().manual_seed(seed + 1)
    m = params["layers"]["mamba"]["mamba"]
    m["A_log"].copy_(torch.rand(m["A_log"].shape, generator=gen) * 2.0 - 1.0)
    m["dt_bias"].copy_(torch.rand(m["dt_bias"].shape, generator=gen) - 2.0)
    m["conv_b"].normal_(0.0, 0.1, generator=gen)
    return params


def _tokens(cfg, seed, *shape):
    return torch.randint(0, cfg.vocab_size, shape,
                         generator=torch.Generator().manual_seed(seed))


def test_published_layer_types_and_validation():
    assert [i for i, t in enumerate(CONFIG.layer_types)
            if t == "attention"] == [5, 15, 25, 35]
    assert CONFIG.d_inner == 8192 and CONFIG.ssm_nheads == 128
    assert CONFIG.rope_theta == 0.0 and CONFIG.tie_embeddings
    with pytest.raises(ValueError, match="layer types"):
        dataclasses.replace(CONFIG, num_layers=30)
    with pytest.raises(ValueError, match="none of"):
        dataclasses.replace(CONFIG.reduced(),
                            layer_types=("mamba", "mlp", "mamba", "mamba"))
    cut = dataclasses.replace(CONFIG, num_layers=20,
                              layer_types=list(CONFIG.layer_types[:20]))
    assert isinstance(cut, HybridMoEConfig) and cut.layer_types[15] == "attention"


@pytest.mark.parametrize("layers, total, active", [
    (40, 32.207337984e9, 8.803121664e9),
    (30, 24.25826496e9, None),
    (20, 16.309191936e9, None)])
def test_param_count(layers, total, active):
    cfg = dataclasses.replace(CONFIG, num_layers=layers,
                              layer_types=CONFIG.layer_types[:layers])
    assert M.param_count(cfg) == total
    if active is not None:
        assert M.param_count(cfg, active_only=True) == active


def test_param_count_matches_the_tree():
    cfg = _cfg()
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="meta")
    leaves = [t for t in _leaves(params)]
    assert sum(t.numel() for t in leaves) == M.param_count(cfg)
    assert set(params["layers"]) == {"mamba", "attention"}
    assert params["layers"]["mamba"]["ln1"]["scale"].shape[0] == 3
    assert params["layers"]["attention"]["moe"]["shared"]["w_gate"].shape == (
        1, cfg.d_model, cfg.shared_d_ff)
    assert params["layers"]["mamba"]["moe"]["router"].dtype == torch.float32


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_input_specs():
    from repro_torch.configs.registry import SHAPES

    specs = M.input_specs(CONFIG, SHAPES["decode_32k"])
    assert set(specs) == {"tokens"} and specs["tokens"].shape == (128, 1)
    specs = M.input_specs(CONFIG, SHAPES["train_4k"])
    assert specs["tokens"].shape == specs["labels"].shape == (256, 4096)


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_prefill_and_dense_decode_match_train(seed):
    """A padded prefill of mixed true lengths, then teacher-forced dense
    decode steps, give the train logits at every position."""
    cfg = _cfg()
    params = _params(cfg, seed % 1000)
    toks = _tokens(cfg, seed % 97, 2, 14)
    lengths = torch.tensor([6, 9], dtype=torch.int32)
    with torch.no_grad():
        want, _, _ = M.apply(cfg, params, {"tokens": toks}, mode="train")
        logits, cache, _ = M.apply(
            cfg, params, {"tokens": toks[:, :10], "lengths": lengths,
                          "max_seq": 16}, mode="prefill")
        for b in range(2):
            torch.testing.assert_close(logits[b, :lengths[b]],
                                       want[b, :lengths[b]], **TOL)
        pos = lengths.clone()
        for _ in range(4):
            nxt = toks[torch.arange(2), pos.long()][:, None]
            logits, cache, _ = M.apply(cfg, params, {"tokens": nxt},
                                       mode="decode", cache=cache)
            torch.testing.assert_close(
                logits[:, 0], want[torch.arange(2), pos.long()], **TOL)
            pos += 1
        assert torch.equal(cache["pos"], pos)


def _paged_from_dense(cfg, cache, nb, ns, bs, max_seq, gen):
    """Pools holding the dense ``cache`` rows at permuted blocks and
    slabs (noise elsewhere), with each row's table and slab id."""
    pools = M.init_paged_cache(cfg, nb, bs, num_slabs=ns, device="cpu")
    for leaf in (*pools["attn"], *pools["mamba"]):
        leaf.normal_(generator=gen)
    b = cache["pos"].shape[0]
    w = max_seq // bs
    blocks = torch.randperm(nb, generator=gen)[:b * w].view(b, w)
    slabs = torch.randperm(ns, generator=gen)[:b]
    views = M.paged_insert_views(cfg, cache)
    kinds = M.paged_pool_kinds(cfg)
    assert kinds == {"mamba": "slab", "attn": "block"}
    for key, kind in kinds.items():
        for pool, leaf in zip(pools[key], views[key]):
            for r in range(b):
                if kind == "block":
                    pool[:, blocks[r]] = leaf[:, r].reshape(
                        leaf.shape[0], w, bs, *leaf.shape[3:])
                else:
                    pool[:, slabs[r]] = leaf[:, r]
    return pools, blocks.to(torch.int32), slabs.to(torch.int32)


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_paged_decode_equals_dense_bit_for_bit(seed):
    cfg = _cfg()
    params = _params(cfg, seed % 1000)
    gen = torch.Generator().manual_seed(seed)
    toks = _tokens(cfg, seed % 89, 3, 9)
    lengths = torch.tensor([3, 9, 5], dtype=torch.int32)
    with torch.no_grad():
        _, dense, _ = M.apply(cfg, params, {"tokens": toks, "lengths": lengths,
                                            "max_seq": 16}, mode="prefill")
        pools, tables, slabs = _paged_from_dense(cfg, dense, 13, 7, 4, 16, gen)
        for step in range(5):
            nxt = _tokens(cfg, seed + step, 3, 1)
            want, dense, _ = M.apply(cfg, params, {"tokens": nxt},
                                     mode="decode", cache=dense)
            got, out, _ = M.apply(
                cfg, params, {"tokens": nxt}, mode="decode",
                cache={**pools, "pos": dense["pos"] - 1,
                       "block_tables": tables, "slab_ids": slabs})
            assert torch.equal(got, want)
            assert out["attn"] is pools["attn"] and out["mamba"] is pools["mamba"]
        for r in range(3):
            torch.testing.assert_close(pools["mamba"][1][:, slabs[r]],
                                       dense["mamba"][1][:, r], rtol=0, atol=0)


def test_attention_scale_defaults_to_the_head_width():
    cfg = _cfg(num_layers=1, layer_types=("attention",))
    p = L.init_attention(cfg, torch.Generator().manual_seed(0), torch.float32,
                         "cpu")
    x = torch.randn(2, 7, cfg.d_model, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(7).expand(2, 7)
    base, _ = L.attention(cfg, p, x, positions=pos)
    same, _ = L.attention(cfg, p, x, positions=pos,
                          scale=1.0 / math.sqrt(cfg.head_dim))
    other, _ = L.attention(cfg, p, x, positions=pos,
                           scale=cfg.attention_multiplier)
    assert torch.equal(base, same)
    assert not torch.allclose(base, other)


def _count_passes(monkeypatch):
    passes, real = [], MOE._dense_experts
    monkeypatch.setattr(MOE, "_dense_experts", lambda ex, t, c: (
        passes.append(t.shape[0]), real(ex, t, c))[1])
    return passes


def test_moe_dense_in_passes_equals_one_pass(monkeypatch):
    cfg = _cfg()
    p = HM.init_moe(cfg, torch.Generator().manual_seed(2), torch.float32, "cpu")
    x = torch.randn(3, 7, cfg.d_model, generator=torch.Generator().manual_seed(3))
    passes = _count_passes(monkeypatch)
    whole, aux = MOE.moe_dense(cfg, p, x)
    assert passes == [21]
    monkeypatch.setattr(MOE, "DENSE_PASS_BYTES",
                        5 * cfg.num_experts * cfg.d_model * 4)
    parts, aux_p = MOE.moe_dense(cfg, p, x)
    assert passes == [21, 5, 5, 5, 5, 1]
    torch.testing.assert_close(parts, whole, **TOL)
    assert aux.item() == aux_p.item()


@pytest.mark.parametrize("e,d,f,k,want", [
    (64, 2048, 1408, 6, [8192]),  # deepseek-v2-lite: one pass
    (72, 4096, 768, 10, [3640, 3640, 912]),  # granite-4.0-h-small
])
def test_dense_passes_of_the_widest_prefill(monkeypatch, e, d, f, k, want):
    """A 16 x 512-token prefill at the served widths, on meta tensors."""
    cfg = dataclasses.replace(CONFIG, num_experts=e, num_experts_per_tok=k)
    meta = dict(device="meta", dtype=torch.bfloat16)
    p = {"router": torch.empty(d, e, device="meta"),
         "experts": {"w_gate": torch.empty(e, d, f, **meta),
                     "w_up": torch.empty(e, d, f, **meta),
                     "w_down": torch.empty(e, f, d, **meta)}}
    passes = _count_passes(monkeypatch)
    out, _ = MOE.moe_dense(cfg, p, torch.empty(16, 512, d, **meta))
    assert passes == want and out.shape == (16, 512, d)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


def _spec(name):
    return StreamSpec(name=name, priority=1, period_ms=8000.0,
                      deadline_ms=8000.0, prefill_ms=50.0, decode_ms=5.0,
                      decode_steps=STEPS)


def _prompts(cfg, *lengths):
    rng = np.random.default_rng(11)
    return {f"s{i}": rng.integers(0, cfg.vocab_size, (1, n), dtype=np.int32)
            for i, n in enumerate(lengths)}


def _run_streams(eng, prompts):
    results = {}

    def worker(n):
        results[n] = eng.generate(n, prompts[n], steps=STEPS)

    threads = [threading.Thread(target=worker, args=(n,)) for n in prompts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return results


@pytest.fixture(scope="module")
def served():
    """Four streams through the paged batching engine on two servers,
    traced, and the same prompts through the unbatched engine."""
    cfg = _cfg()
    params = _params(cfg, 4)
    prompts = _prompts(cfg, 3, 6, 11, 17)
    ref = ServeEngine(cfg, params, max_seq=32, device="cpu")
    try:
        want = {}
        for n in prompts:
            assert ref.admit(_spec(n)).admitted
            want[n] = ref.generate(n, prompts[n], steps=STEPS).tokens
    finally:
        ref.close()
    eng = ServeEngine(cfg, params, max_seq=32, num_servers=2, batching=True,
                      max_batch=4, paged=True, kv_block_size=8, device="cpu")
    try:
        for n in prompts:
            assert eng.admit(_spec(n)).admitted
        before = ME.experts_counter("cpu").clone()
        eng.set_tracing(True)
        got = _run_streams(eng, prompts)
        eng.set_tracing(False)
        counted = ME.experts_counter("cpu") - before
        meta = [m for s in eng.pool.servers for m in s.stats.batch_meta]
        return {"cfg": cfg, "want": want, "got": got, "eng": eng,
                "records": eng.trace_records(), "meta": meta,
                "counted": counted, "usage": eng.kv_usage()}
    finally:
        eng.close()


def test_engine_serves_the_unbatched_tokens(served):
    eng = served["eng"]
    assert eng._family == "hybrid" and eng._cache_kinds == {"block", "slab"}
    for n, res in served["got"].items():
        assert res.tokens == served["want"][n], n
    assert served["usage"] == {"blocks": 0, "slabs": 0, "segments": 0}
    assert {m["kind"] for m in served["meta"]} == {"prefill@hybrid",
                                                   "decode@hybrid"}


def test_experts_counter_counts_every_moe_layer(served):
    """Every decode call adds E for each of its MoE layers, one a layer
    whatever its mixer; prefill takes ``moe_dense`` and adds nothing."""
    cfg = served["cfg"]
    calls = [m for m in served["meta"] if m["kind"] == "decode@hybrid"]
    read, possible = served["counted"].tolist()
    assert possible == len(calls) * cfg.num_layers * cfg.num_experts
    rows = sum(m["rows"] for m in calls)
    assert (len(calls) * cfg.num_layers * cfg.num_experts_per_tok <= read
            <= rows * cfg.num_layers * cfg.num_experts_per_tok)


def test_spans_and_decoding_are_recorded(served):
    names = {r[1] for r in served["records"]}
    assert {"call", "stage", "wait", "readback", "request", "wake",
            "insert"} <= names
    calls = [m for m in served["meta"] if m["kind"] == "decode@hybrid"]
    assert calls and all(1 <= m["decoding"] and m["rows"] <= m["decoding"] + 1
                         for m in calls)


def test_loss_gradients_with_and_without_remat():
    """``loss_fn`` (each layer checkpointed by default) gives the gradients
    of the plain forward, and every stack gets one."""
    cfg = _cfg()
    params = _params(cfg, 6)
    leaves = [t.requires_grad_() for t in _leaves(params)
              if t.is_floating_point()]
    toks = _tokens(cfg, 6, 2, 12)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    grads = []
    for remat in (True, False):
        loss, _ = M.loss_fn(cfg, params, batch, remat=remat)
        grads.append(torch.autograd.grad(loss, leaves, allow_unused=True))
    for a, b in zip(*grads):
        assert a is not None
        torch.testing.assert_close(a, b, **TOL)
    stack = params["layers"]
    for kind in ("mamba", "attention"):
        idx = next(i for i, t in enumerate(leaves)
                   if t is stack[kind]["ln1"]["scale"])
        assert grads[0][idx].abs().sum() > 0
