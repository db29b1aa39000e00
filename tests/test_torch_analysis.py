"""The port's HLO cost walker and roofline terms
(``repro_torch.analysis.{hlo_cost, roofline}``) against the reference's on
the same HLO texts: the modules test_roofline.py compiles or writes out, a
compiled module with a dot and a module with collectives.

``roofline.analyze`` imports ``hlo_cost`` at call time, so a port without
its copy of ``hlo_cost`` raises ``ImportError`` here.  JAX only makes the
texts; the port reads them as strings.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from repro.analysis import hlo_cost as j_hlo_cost
from repro.analysis import roofline as j_roofline
from repro_torch.analysis import roofline as t_roofline

f32 = jnp.float32


def _compiled(f, *shapes):
    return jax.jit(f).lower(
        *(jax.ShapeDtypeStruct(s, f32) for s in shapes)).compile().as_text()


def _scan_tanh(x, ws):
    return jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)[0]


def _scan_dot(x, ws):
    return jax.lax.scan(lambda c, w: (c @ w, None), x, ws)[0]


def _gather(pool, tables):
    return pool[tables.astype(jnp.int32)]


COMPILED = {
    "scan_trip_count": (_scan_tanh, (256, 256), (12, 256, 256)),
    "dot": (lambda a, b: a @ b, (64, 128), (128, 32)),
    "batched_dot": (lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                    (4, 32, 64), (4, 64, 16)),
    "weights_per_iteration": (_scan_dot, (128, 128), (6, 128, 128)),
    "block_gather": (_gather, (33, 16, 8), (4, 2)),
    "mlp": (lambda x, w1, w2: jax.nn.silu(x @ w1) @ w2,
            (8, 64), (64, 256), (256, 64)),
}

WRITTEN = {
    "while_index_comments": """
HloModule m, entry_computation_layout={()->f32[2]{0}}

%body (p: (s32[], f32[2])) -> (s32[], f32[2]) {
  %p = (s32[], /*index=1*/f32[2]{0}) parameter(0)
  %g0 = s32[] get-tuple-element(%p), index=0
  %g1 = f32[2]{0} get-tuple-element(%p), index=1
  %c1 = s32[] constant(1)
  %a = s32[] add(%g0, %c1)
  %m = f32[2]{0} multiply(%g1, %g1)
  ROOT %t = (s32[], /*index=1*/f32[2]{0}) tuple(%a, %m)
}

%cond (p2: (s32[], f32[2])) -> pred[] {
  %p2 = (s32[], /*index=1*/f32[2]{0}) parameter(0)
  %g = s32[] get-tuple-element(%p2), index=0
  %c = s32[] constant(5)
  ROOT %lt = pred[] compare(%g, %c), direction=LT
}

ENTRY %main () -> f32[2] {
  %z = f32[2]{0} constant({1, 2})
  %zi = s32[] constant(0)
  %t0 = (s32[], /*index=1*/f32[2]{0}) tuple(%zi, %z)
  %w = (s32[], /*index=1*/f32[2]{0}) while(%t0), condition=%cond, body=%body, backend_config={"known_trip_count":{"n":"5"}}
  ROOT %out = f32[2]{0} get-tuple-element(%w), index=1
}
""",
    "all_reduce": """
HloModule m

ENTRY %main (x: f32[1024]) -> f32[1024] {
  %x = f32[1024]{0} parameter(0)
  ROOT %ar = f32[1024]{0} all-reduce(%x), replica_groups={}, to_apply=%add
}
""",
    "all_gather_async": """
HloModule m

ENTRY %main (x: f32[256]) -> f32[512] {
  %x = f32[256]{0} parameter(0)
  %ags = (f32[256]{0}, f32[512]{0}) all-gather-start(%x), dimensions={0}
  ROOT %agd = f32[512]{0} all-gather-done(%ags)
}
""",
    "gather_rule": """
HloModule m

ENTRY %main (pool: f32[17,8,4], tables: s32[2,4]) -> f32[2,4,8,4] {
  %pool = f32[17,8,4]{2,1,0} parameter(0)
  %tables = s32[2,4]{1,0} parameter(1)
  ROOT %g = f32[2,4,8,4]{3,2,1,0} gather(%pool, %tables), offset_dims={2,3}, collapsed_slice_dims={0}, start_index_map={0}, index_vector_dim=2, slice_sizes={1,8,4}
}
""",
    "bf16_dot": """
HloModule m

ENTRY %main (a: bf16[4096,4096], b: bf16[4096,4096]) -> bf16[4096,4096] {
  %a = bf16[4096,4096]{1,0} parameter(0)
  %b = bf16[4096,4096]{1,0} parameter(1)
  ROOT %d = bf16[4096,4096]{1,0} dot(%a, %b), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}
""",
    "dot_then_collectives": """
HloModule m

ENTRY %main (a: bf16[512,1024], b: bf16[1024,256]) -> f32[1024,256] {
  %a = bf16[512,1024]{1,0} parameter(0)
  %b = bf16[1024,256]{1,0} parameter(1)
  %d = bf16[512,256]{1,0} dot(%a, %b), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %up = f32[512,256]{1,0} convert(%d)
  %ar = f32[512,256]{1,0} all-reduce(%up), replica_groups={{0,1}}, to_apply=%add
  %rs = f32[256,256]{1,0} reduce-scatter(%ar), replica_groups={{0,1}}, dimensions={0}, to_apply=%add
  %cp = f32[256,256]{1,0} collective-permute(%rs), source_target_pairs={{0,1},{1,0}}
  ROOT %ag = f32[1024,256]{1,0} all-gather(%cp), replica_groups={{0,1,2,3}}, dimensions={0}
}
""",
}


@pytest.fixture(scope="module")
def texts():
    out = {k: _compiled(f, *shapes) for k, (f, *shapes) in COMPILED.items()}
    out.update(WRITTEN)
    return out


CASES = sorted(COMPILED) + sorted(WRITTEN)


@pytest.mark.parametrize("case", CASES)
def test_hlo_cost_equals_reference(texts, case):
    from repro_torch.analysis import hlo_cost as t_hlo_cost

    text = texts[case]
    ref = dataclasses.asdict(j_hlo_cost.analyze_text(text))
    port = dataclasses.asdict(t_hlo_cost.analyze_text(text))
    assert port == ref
    assert ref["flops"] > 0 or ref["hbm_bytes"] > 0 or any(
        ref["collective_bytes"].values())
    assert (t_hlo_cost.top_contributors(text)
            == j_hlo_cost.top_contributors(text))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("chips,model_flops", [(1, 0.0), (4, 2.0 * 64**3)])
def test_roofline_analyze_equals_reference(texts, case, chips, model_flops):
    cost = {"flops": 0.0, "bytes accessed": 0.0}
    ref = j_roofline.analyze(cost, texts[case], chips=chips,
                             model_flops=model_flops)
    port = t_roofline.analyze(cost, texts[case], chips=chips,
                              model_flops=model_flops)
    assert port.to_dict() == ref.to_dict()
    assert port.bottleneck in ("compute", "memory", "collective")


def test_the_dot_module_prices_as_the_reference_pins():
    """The collective-and-dot text: the dot's flops and every collective
    kind once, through the port alone."""
    from repro_torch.analysis import hlo_cost as t_hlo_cost

    c = t_hlo_cost.analyze_text(WRITTEN["dot_then_collectives"])
    assert c.flops == 2.0 * 512 * 256 * 1024
    assert {k for k, n in c.collective_counts.items() if n} == {
        "all-reduce", "reduce-scatter", "collective-permute", "all-gather"}
