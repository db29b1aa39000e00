"""The port's sharding rules (repro_torch.distributed.sharding,
repro_torch.training.train_step.batch_specs) against the reference's, at
full width for every registry arch, with no allocation: the port's params
on the meta device, the reference's through ``jax.eval_shape``.

* ``param_specs`` on the port's tree equals the reference's on its tree,
  leaf for leaf and path for path (the bridge keeps the reference's leaf
  names), under the (16, 16) stand-in mesh of
  ``tests/test_sharding_rules.py``, with ``expert_ff_fsdp``, and on the
  multi-pod (2, 16, 16) mesh whose batch axes are ('pod', 'data');
* ``batch_specs`` equals the reference's for every shape of the arch;
* ``axis_size`` reads a ``DeviceMesh``-like shape tuple and the stand-in's
  dict alike; ``placements`` maps a spec to DTensor placements and
  refuses a tuple of axes out of the mesh's order;
* ``use_rules`` nests and restores; the shard points are the identity
  without rules and on plain tensors under rules.
"""

import dataclasses

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs.registry import ARCH_IDS, shapes_for
from repro.configs.registry import get_config as jax_config
from repro.distributed import sharding as jshd
from repro.models import model as JM
from repro.training.train_step import batch_specs as jax_batch_specs
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.models import model as M
from repro_torch.training.train_step import batch_specs


class _FakeMesh:
    """Stands in for the 256-chip mesh (shape lookups only)."""

    shape = {"data": 16, "model": 16}


class _FakePodMesh:
    shape = {"pod": 2, "data": 16, "model": 16}


def _rules(mod, mesh, **kw):
    batch_axes = tuple(mesh.shape)[:-1]
    return mod.ShardingRules(mesh=mesh, batch_axes=batch_axes, fsdp=True, **kw)


VARIANTS = {
    "single_pod": (_FakeMesh, {}),
    "expert_ff_fsdp": (_FakeMesh, {"expert_ff_fsdp": True}),
    "multi_pod": (_FakePodMesh, {"expert_ff_fsdp": True}),
}


def _port_spec_leaves(tree, path=()):
    """(path, spec) in JAX's flatten order, a spec being a leaf."""
    if isinstance(tree, shd.PartitionSpec):
        return [(path, tuple(tree))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_spec_leaves(tree[k], (*path, str(k)))]
    return [x for i, v in enumerate(tree)
            for x in _port_spec_leaves(v, (*path, str(i)))]


def _jax_spec_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p),
             tuple(s)) for p, s in flat]


@pytest.fixture(scope="module")
def port_params():
    """Every arch's full-width params on the meta device (no allocation)."""
    return {a: M.init_params(get_config(a), generator=torch.Generator(),
                             device="meta") for a in ARCH_IDS}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, variant, port_params):
    mesh, kw = VARIANTS[variant]
    jcfg = jax_config(arch)
    shapes = jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    want = _jax_spec_leaves(jshd.param_specs(shapes, _rules(jshd, mesh, **kw)))
    got = _port_spec_leaves(shd.param_specs(port_params[arch],
                                            _rules(shd, mesh, **kw)))
    assert got == want
    # something is sharded, so the comparison means something
    assert any(any(a is not None for a in s) for _, s in got)


@pytest.mark.parametrize("variant", ["single_pod", "multi_pod"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_equal_the_reference(arch, variant):
    mesh, kw = VARIANTS[variant]
    jcfg, cfg = jax_config(arch), get_config(arch)
    for shape in shapes_for(jcfg):
        want = jax_batch_specs(jcfg, JM.input_specs(jcfg, shape),
                               _rules(jshd, mesh, **kw))
        got = batch_specs(cfg, M.input_specs(cfg, shape),
                          _rules(shd, mesh, **kw))
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}, shape.name


class _TupleMesh:
    """A DeviceMesh's shape surface: a tuple and the dims' names."""

    shape = (2, 4, 8)
    mesh_dim_names = ("pod", "data", "model")


def test_axis_size_reads_both_mesh_kinds():
    assert shd.axis_size(_TupleMesh(), "data") == 4
    assert shd.axis_size(_TupleMesh(), ("pod", "data")) == 8
    assert shd.axis_size(_FakeMesh(), "model") == 16
    assert shd.axis_size(_FakeMesh(), None) == 1


def test_placements_follow_the_spec():
    mesh = _TupleMesh()
    assert shd.placements(shd.P(("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert shd.placements(shd.P(None, "data"), mesh) == \
        [Replicate(), Shard(1), Replicate()]
    assert shd.placements(shd.P(), mesh) == [Replicate()] * 3
    # JAX splits ('data', 'pod') data-major; a DTensor always pod-major
    with pytest.raises(ValueError, match="mesh's order"):
        shd.placements(shd.P(("data", "pod")), mesh)


def test_rules_nest_and_shard_points_are_identity_without_a_mesh():
    outer = shd.ShardingRules()
    inner = dataclasses.replace(outer, shard_seq=True)
    x = torch.ones(2, 3, 4)
    with shd.use_rules(outer):
        with shd.use_rules(inner):
            assert shd.current_rules() is inner
        assert shd.current_rules() is outer
        # rules without a mesh, and plain tensors: every point is identity
        for fn, arg in ((shd.shard_hidden, x), (shd.shard_heads, x[..., None]),
                        (shd.shard_logits, x), (shd.shard_ffn, x),
                        (shd.shard_tokens, x[..., 0])):
            assert fn(arg) is arg
        assert shd.shard_cache_seq(x, batch_axis=0, seq_axis=1) is x
    assert shd.current_rules() is None
    assert shd.shard_hidden(x) is x and shd.whole_rows(x) is x
    assert shd.to_full(x) is x


def test_spec_repr_and_tuple_equality():
    spec = shd.P("data", None)
    assert spec == ("data", None) and tuple(spec) == tuple(JP("data", None))
    assert repr(spec) == "P('data', None)"
