"""Static cell pricing of the port (``ServeEngine.static_cell_costs`` on
``analysis.op_cost``): test_migration.py's ``TestStaticPricing`` re-run on
the port, the port held against the reference's ``static_cell_costs`` on
the same reduced configs and cells, and what pricing must not touch.

The reference compiles each cell and walks its optimized HLO
(``analysis.hlo_cost``); the port runs each cell's impl once on meta twins
of the weights and pools and counts the aten ops by the same rules.  Flops
(matrix products only) agree exactly on every family but the SSM layers,
whose depthwise conv step the port writes as elementwise products
(``repro_torch/models/ssm.py:180``; the reference's einsum is a dot) and
whose first-chunk inter-chunk term it skips (its incoming state is zero;
the reference's dot at ``repro/models/ssm.py:146`` runs).  Bytes differ
by design and are pinned as ratios: the reference's CPU-compiled HLO
charges each stacked layer weight as a dynamic slice (2 x) beside the dot
that reads it, and a pool scatter as the whole pool plus layout copies of
it; the port charges one read per weight and 3 x the update per scatter.

Configs: the registry's reduced configs, fp32, ``max_seq`` 32,
``kv_block_size`` 8, 4 rows, as test_migration.py's engine.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.analysis import op_cost
from repro_torch.analysis.cost_model import StepCostModel, hlo_cell_features
from repro_torch.configs.registry import get_config
from repro_torch.kernels import _build
from repro_torch.models import model as M
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import ServeEngine, StreamSpec

FAMILIES = ("internlm2_1_8b", "deepseek_v2_lite_16b", "mamba2_780m",
            "zamba2_7b", "whisper_medium", "qwen2_vl_2b")
ENGINE = dict(max_seq=32, batching=True, max_batch=4, paged=True,
              kv_block_size=8)

# port / reference bytes per cell, measured on these configs and cells
BYTES_RATIO = {
    "internlm2_1_8b": {("decode", 2, 4): 0.440, ("decode", 4, 1): 0.423,
                       ("prefill", 1, 8): 0.580, ("prefill", 2, 16): 0.909},
    "deepseek_v2_lite_16b": {("decode@mla", 2, 4): 0.648,
                             ("decode@mla", 4, 1): 0.654,
                             ("prefill@mla", 1, 8): 0.839,
                             ("prefill@mla", 2, 16): 1.062},
}


def _cfg(name, get=get_config):
    return dataclasses.replace(get(name).reduced(), dtype="float32")


def _engine(name, **kw):
    cfg = _cfg(name)
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    return ServeEngine(cfg, params, device="cpu", **{**ENGINE, **kw})


def _cells(eng):
    """Every warm-cell shape of the engine: the reachable decode cells, two
    prefill buckets, every migrate width."""
    tag = eng._decode_kind[len("decode"):]
    return ([("decode" + tag, r, w) for r in eng._row_buckets
             for w in eng.width_buckets]
            + [("prefill" + tag, r, b) for r in eng._row_buckets
               for b in (8, 16)]
            + [("migrate" + tag, w, eng.kv_block_size)
               for w in eng.width_buckets])


@pytest.fixture(scope="module", params=["internlm2_1_8b",
                                        "deepseek_v2_lite_16b"])
def both(request):
    """(port engine, reference engine, cells, port costs, reference costs)
    for one family on the same config and weights."""
    name = request.param
    jcfg = _cfg(name, jax_config)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    eng = ServeEngine(_cfg(name), params, device="cpu", **ENGINE)
    jeng = JaxServeEngine(jcfg, jparams, **ENGINE)
    tag = eng._decode_kind[len("decode"):]
    cells = ([("migrate" + tag, w, 8) for w in eng.width_buckets]
             + [("decode" + tag, 2, 4), ("decode" + tag, 4, 1),
                ("prefill" + tag, 1, 8), ("prefill" + tag, 2, 16)])
    try:
        yield (name, eng, jeng, cells, eng.static_cell_costs(cells),
               jeng.static_cell_costs(cells))
    finally:
        eng.close()
        jeng.close()


# -- test_migration.py::TestStaticPricing on the port ----------------------

def test_static_costs_feed_unseen_migrate_cells():
    eng = _engine("internlm2_1_8b", num_servers=1)
    try:
        costs = eng.static_cell_costs()
        assert sorted(k[1] for k in costs) == list(eng.width_buckets)
        assert all(k[0] == "migrate" for k in costs)
        assert all(f >= 0 and b > 0 for f, b in costs.values())
        widths = sorted(k[1] for k in costs)
        by_w = {k[1]: v for k, v in costs.items()}
        for lo, hi in zip(widths, widths[1:]):
            assert by_w[hi][1] > by_w[lo][1]  # bytes grow with width
        model = StepCostModel(work=hlo_cell_features(costs))
        model.observe(("migrate", widths[-1], eng.kv_block_size), 4e-3)
        pred = model.predict("migrate", widths[0], eng.kv_block_size)
        assert math.isfinite(pred) and 0 < pred < 4e-3
        # a width that was never priced extrapolates off the priced ones
        assert math.isfinite(model.predict("migrate", 3, eng.kv_block_size))
    finally:
        eng.close()


def test_static_costs_price_decode_and_prefill_cells():
    eng = _engine("internlm2_1_8b", num_servers=1)
    try:
        costs = eng.static_cell_costs([("decode", 2, 4), ("prefill", 1, 8)])
        assert costs[("decode", 2, 4)][0] > 0
        assert costs[("prefill", 1, 8)][0] > 0
    finally:
        eng.close()


def test_refusals_and_tagged_phases():
    masked = _engine("internlm2_1_8b", paged=False)
    eng = _engine("internlm2_1_8b")
    try:
        with pytest.raises(ValueError, match="paged=True"):
            masked.static_cell_costs()
        with pytest.raises(ValueError, match="unknown phase"):
            eng.static_cell_costs([("insert", 1, 8)])
        got = eng.static_cell_costs([("decode", 2, 4), ("decode@mla", 2, 4),
                                     ("migrate@ssm", 2, 8)])
        assert got[("decode", 2, 4)] == got[("decode@mla", 2, 4)]
        assert got[("migrate@ssm", 2, 8)] == eng.static_cell_costs(
            [("migrate", 2, 8)])[("migrate", 2, 8)]
    finally:
        masked.close()
        eng.close()


# -- the port against the reference ----------------------------------------

def test_flops_equal_reference(both):
    name, _, _, cells, port, ref = both
    for cell in cells:
        assert port[cell][0] == pytest.approx(ref[cell][0], rel=0.01), cell
        assert (port[cell][0] > 0) == (not cell[0].startswith("migrate"))


def test_decode_and_prefill_bytes_ratio_pinned(both):
    name, _, _, cells, port, ref = both
    ratios = {c: port[c][1] / ref[c][1] for c in cells
              if not c[0].startswith("migrate")}
    print(name, {c: round(r, 3) for c, r in ratios.items()})
    for cell, pinned in BYTES_RATIO[name].items():
        assert ratios[cell] == pytest.approx(pinned, abs=0.005), cell


def test_migrate_bytes_against_reference(both):
    """The port charges a migrate cell 2 x the gathered rows + the table
    (export) and 3 x the rows (import), linear in width.  The reference's
    export agrees within 2% wherever XLA adds no layout copy of the
    gathered rows (MLA's latent pools, GQA's width 1); its import is
    compiled on the CPU as whole-pool transposes around the scatter, so it
    charges at least the pools once and the two totals cannot agree."""
    name, eng, jeng, cells, port, ref = both
    pools = eng._make_pools(eng._paged[0], device=torch.device("meta"))
    pool_bytes = sum(op_cost.tensor_bytes(t) for leaves in pools.values()
                     for t in leaves)
    for cell in (c for c in cells if c[0].startswith("migrate")):
        w = cell[1]
        idx = torch.zeros(2 + w, dtype=torch.int32, device="meta")
        rows = sum(op_cost.tensor_bytes(r)
                   for r in eng._export_kv_impl(pools, idx))
        export = op_cost.cost_of(eng._export_kv_impl, pools, idx)[1]
        # the rows, then the table's int32 -> int64 copies
        assert port[cell][1] == pytest.approx(5 * rows, rel=0.02)
        assert export == pytest.approx(2 * rows, rel=0.02)
        print(name, cell, "port / reference", port[cell][1] / ref[cell][1])
        j_export = _reference_export_bytes(jeng, w)
        if name == "deepseek_v2_lite_16b" or w == 1:
            assert export == pytest.approx(j_export, rel=0.02)
        assert ref[cell][1] - j_export >= pool_bytes


def _reference_export_bytes(jeng, w: int) -> float:
    import jax.numpy as jnp

    from repro.analysis import hlo_cost
    pools = jax.eval_shape(lambda: JM.init_paged_cache(
        jeng.cfg, jeng._num_blocks, jeng.kv_block_size,
        num_slabs=jeng._num_slabs, num_segments=jeng._num_segments))
    i = jax.ShapeDtypeStruct((), jnp.int32)
    table = jax.ShapeDtypeStruct((w,), jnp.int32)
    text = jeng._export_kv.lower(pools, table, i, i).compile().as_text()
    return hlo_cost.analyze_text(text).hbm_bytes


def test_gqa_decode_flops_analytic():
    """2 x rows x (matmul parameters) + 4 x rows x heads x head_dim x
    width x block_size: the projections, MLP and unembed, then QK and PV
    over the gathered blocks."""
    eng = _engine("internlm2_1_8b")
    cfg = eng.cfg
    try:
        rows, width = 4, 2
        flops = eng.static_cell_costs([("decode", rows, width)])[
            ("decode", rows, width)][0]
        d, hd = cfg.d_model, cfg.head_dim
        matmul_params = cfg.num_layers * (
            2 * d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
            + 3 * d * cfg.d_ff) + d * cfg.vocab_size  # layers, lm_head
        attn = (4 * rows * cfg.num_heads * cfg.head_dim * width
                * eng.kv_block_size * cfg.num_layers)
        assert flops == 2 * rows * matmul_params + attn
    finally:
        eng.close()


def test_bf16_unembed_prices_the_cards_gemm():
    """On meta a bf16 unembed takes the card's path: one GEMM of the bf16
    table with fp32 output, no fp32 copy of the table (the CPU path's)."""
    from repro_torch.models import transformer as T

    cfg = get_config("internlm2_1_8b").reduced()  # bf16
    table = torch.empty((cfg.d_model, cfg.vocab_size), dtype=torch.bfloat16,
                        device="meta")
    x = torch.empty((4, 1, cfg.d_model), dtype=torch.bfloat16, device="meta")
    flops, nbytes = op_cost.cost_of(T.unembed, cfg, {"lm_head": table}, x)
    assert flops == 2 * 4 * cfg.d_model * cfg.vocab_size
    assert nbytes == (x.numel() * 2 + table.numel() * 2
                      + 4 * cfg.vocab_size * 4)


# -- meta pricing, and what pricing leaves alone ---------------------------

@pytest.mark.parametrize("name", ["internlm2_1_8b", "zamba2_7b"])
def test_meta_pricing_equals_cpu_pricing(name):
    eng = _engine(name)
    try:
        tag = eng._decode_kind[len("decode"):]
        w = eng.width_buckets[-1]
        meta = eng.static_cell_costs([("decode" + tag, 2, w),
                                      ("prefill" + tag, 2, 8),
                                      ("migrate" + tag, w, 8)])
        pools = eng._make_pools(eng._paged[0], device=torch.device("cpu"))

        def ints(*shape):
            return torch.zeros(shape, dtype=torch.int32)

        idx = ints(2 + w)
        rows = eng._export_kv_impl(pools, idx)
        cpu = {
            ("decode" + tag, 2, w): op_cost.cost_of(
                eng._decode_paged_impl, ints(2, 4 + w), pools),
            ("prefill" + tag, 2, 8): op_cost.cost_of(
                eng._prefill_batch_impl, ints(2, 8), torch.ones(
                    2, dtype=torch.int32)),
            ("migrate" + tag, w, 8): tuple(
                a + b for a, b in zip(
                    op_cost.cost_of(eng._export_kv_impl, pools, idx),
                    op_cost.cost_of(eng._import_kv_impl, pools, rows, idx))),
        }
        assert meta == cpu
    finally:
        eng.close()


def test_pricing_leaves_the_engine_as_it_was():
    eng = _engine("internlm2_1_8b", num_servers=2)
    try:
        eng.precompile(prompt_buckets=(8,))
        spec = StreamSpec(name="s", priority=1, period_ms=8000.0,
                          deadline_ms=8000.0, prefill_ms=50.0, decode_ms=5.0,
                          decode_steps=3)
        assert eng.admit(spec).admitted
        first = eng.generate("s", np.arange(1, 6, dtype=np.int32)[None],
                             steps=3).tokens
        pools = [[(t, t.clone()) for leaves in st.pools.values()
                  for t in leaves] for st in eng._paged if st.pools]
        assert pools
        warm = (set(eng._warm_decode), set(eng._warm_prefill),
                set(eng._warm_migrate))
        graphs = [dict(st.graphs) for st in eng._paged]
        launches = dict(_build.launches)

        costs = eng.static_cell_costs(_cells(eng))
        assert len(costs) == len(_cells(eng))
        assert all(math.isfinite(f) and b > 0 for f, b in costs.values())

        assert (set(eng._warm_decode), set(eng._warm_prefill),
                set(eng._warm_migrate)) == warm
        assert [dict(st.graphs) for st in eng._paged] == graphs
        assert dict(_build.launches) == launches
        for server in pools:
            for live, before in server:
                assert live.device.type == "cpu"
                assert torch.equal(live, before)
        assert eng.generate("s", np.arange(1, 6, dtype=np.int32)[None],
                            steps=3).tokens == first
    finally:
        eng.close()


# -- every family: finite, positive, monotone ------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_every_family_prices_monotone(name):
    eng = _engine(name)
    try:
        costs = eng.static_cell_costs(_cells(eng))
        assert all(math.isfinite(f) and math.isfinite(b) and b > 0
                   for f, b in costs.values())
        tag = eng._decode_kind[len("decode"):]
        rows, widths = eng._row_buckets, eng.width_buckets
        for w in widths:
            d = [costs[("decode" + tag, r, w)] for r in rows]
            assert all(a[0] < b[0] and a[1] < b[1] for a, b in zip(d, d[1:]))
        for r in rows:
            d = [costs[("decode" + tag, r, w)] for w in widths]
            assert all(a[0] < b[0] and a[1] < b[1] for a, b in zip(d, d[1:]))
            p = [costs[("prefill" + tag, r, b)] for b in (8, 16)]
            assert 0 < p[0][0] < p[1][0] and p[0][1] < p[1][1]
        m = [costs[("migrate" + tag, w, 8)] for w in widths]
        assert all(f == 0 for f, _ in m)
        assert all(a[1] < b[1] for a, b in zip(m, m[1:]))
    finally:
        eng.close()
