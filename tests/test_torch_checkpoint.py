"""Checkpoints of the port (repro_torch.training.checkpoint, the
CheckpointManager and TrainSupervisor of repro_torch.runtime.fault_tolerance)
and their crossing with the reference's.

* A checkpoint written by ``repro.training.checkpoint.save`` -- reduced
  internlm2's bf16 params and AdamW state (bf16 moments, fp32 master,
  int32 step) -- restores into the port's tree with every leaf equal to
  the bridged (``params_from_numpy`` / ``opt_state_from_numpy``) one; one
  the port writes restores into the reference's tree, bf16 leaves
  included, bit for bit.
* Twins of ``tests/test_training.py::TestCheckpoint``: round trip and
  LATEST, ``keep_last``, structure and shape mismatches raise.
* ``CheckpointManager``: the interval, the async save's host snapshot (a
  copy: the in-place optimizer may change the tensors while the writer
  runs), ``restore_latest``; ``TrainSupervisor.recover``.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro_torch.params import opt_state_from_numpy, params_from_numpy
from repro_torch.runtime.fault_tolerance import (CheckpointManager,
                                                 TrainSupervisor)
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training.tree import leaves, leaves_with_paths, tree_map


@pytest.fixture(scope="module")
def jax_tree():
    cfg = jax_config("internlm2_1_8b").reduced()  # bf16
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    state = jopt.init(params, jopt.AdamWConfig())
    return params, state


def _bridged(params, state):
    host = jax.tree.map(np.asarray, (params, state))
    return (params_from_numpy(host[0], device="cpu"),
            opt_state_from_numpy(host[1], device="cpu"))


def _equal(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


def test_jax_checkpoint_restores_into_the_port(jax_tree, tmp_path):
    params, state = jax_tree
    state = {**state, "step": jnp.asarray(5, jnp.int32)}
    jckpt.save(tmp_path, 5, (params, state))
    want = _bridged(params, state)
    like = tree_map(torch.zeros_like, want)
    got, step = ckpt.restore(tmp_path, like)
    assert step == 5
    dtypes = {t.dtype for t in leaves(got)}
    assert {torch.bfloat16, torch.float32, torch.int32} <= dtypes
    assert all(_equal(a, b) for a, b in zip(leaves(got), leaves(want)))


def test_port_checkpoint_restores_into_jax(jax_tree, tmp_path):
    params, state = jax_tree
    tp, ts = _bridged(params, state)
    # make the moments non-zero so the bf16 leaves carry values
    ts["mu"] = tree_map(lambda p: (p.float() * 0.5).to(torch.bfloat16), tp)
    ckpt.save(tmp_path, 3, (tp, ts))
    like = jax.tree.map(jnp.zeros_like, (params, state))
    got, step = jckpt.restore(tmp_path, like)
    assert step == 3
    jl = jax.tree_util.tree_leaves(got)
    tl = leaves((tp, ts))
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert str(j.dtype) == str(t.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(np.asarray(j, np.float32),
                                      t.float().numpy())
    assert any(j.dtype == jnp.bfloat16 and np.abs(np.asarray(j, np.float32)).max() > 0
               for j in jax.tree_util.tree_leaves(got[1]["mu"]))


def test_leaf_paths_follow_jax_flatten_order(jax_tree):
    """``leaves_with_paths`` yields the leaves of ``leaves``, in its order,
    each named by the keys JAX's ``tree_flatten_with_path`` gives it."""
    params, state = jax_tree
    tree = _bridged(params, state)
    pairs = leaves_with_paths(tree)
    assert len(pairs) == len(leaves(tree))
    assert all(x is y for (_, x), y in zip(pairs, leaves(tree)))
    want = ["".join(f"/{k.key}" if isinstance(k, jax.tree_util.DictKey)
                    else f"[{k.idx}]" for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(
                (params, state))[0]]
    assert [p for p, _ in pairs] == want
    assert "/layers/attn/wq" in {p.removeprefix("[0]") for p in want}


class TestCheckpoint:
    def test_roundtrip_and_latest(self, jax_tree, tmp_path):
        tp, _ = _bridged(*jax_tree)
        tree = {"params": tp, "step": torch.tensor(7, dtype=torch.int32)}
        ckpt.save(tmp_path, 7, tree)
        restored, step = ckpt.restore(tmp_path, tree)
        assert step == 7
        assert ckpt.latest_step(tmp_path) == 7
        assert all(_equal(a, b) for a, b in zip(leaves(tree), leaves(restored)))

    def test_keep_last_gc(self, tmp_path):
        tree = {"p": torch.ones((4,))}
        for s in (1, 2, 3, 4, 5):
            ckpt.save(tmp_path, s, tree, keep_last=2)
        dirs = sorted(p.name for p in pathlib.Path(tmp_path).iterdir()
                      if p.name.startswith("step_"))
        assert dirs == ["step_00000004", "step_00000005"]
        assert ckpt.latest_step(tmp_path) == 5

    def test_structure_mismatch_raises(self, tmp_path):
        ckpt.save(tmp_path, 0, {"a": torch.ones((2,))})
        with pytest.raises(ValueError):
            ckpt.restore(tmp_path, {"a": torch.ones((2,)), "b": torch.ones((2,))})

    def test_shape_mismatch_raises(self, tmp_path):
        ckpt.save(tmp_path, 0, {"a": torch.ones((2,))})
        with pytest.raises(ValueError):
            ckpt.restore(tmp_path, {"a": torch.ones((3,))})

    def test_missing_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            ckpt.restore(tmp_path, {"a": torch.ones((2,))})

    def test_restore_takes_the_target_dtype_and_device(self, tmp_path):
        ckpt.save(tmp_path, 1, {"a": torch.arange(4, dtype=torch.float32)})
        got, _ = ckpt.restore(tmp_path, {"a": torch.zeros(4, dtype=torch.bfloat16,
                                                          device="meta")})
        assert got["a"].dtype == torch.bfloat16 and got["a"].device.type == "meta"


class TestManager:
    def test_interval_and_async_snapshot(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), interval=2)
        w = torch.arange(6, dtype=torch.float32)
        state = {"w": w, "step": torch.tensor(0, dtype=torch.int32)}
        assert not mgr.maybe_save(1, state)
        assert mgr.maybe_save(2, state)
        w.add_(100.0)  # the optimizer's in-place update, while the writer runs
        assert mgr.latest_step() == 2  # waits for the writer
        got, step = mgr.restore_latest({"w": torch.zeros(6),
                                        "step": torch.tensor(0, dtype=torch.int32)})
        assert step == 2 and mgr.saved_steps == [2]
        assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32))

    def test_sync_save(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), interval=1, async_save=False)
        mgr.save(4, {"a": torch.ones(3, dtype=torch.bfloat16)})
        assert ckpt.latest_step(tmp_path) == 4

    def test_restore_onto_a_mesh_is_refused(self, tmp_path):
        """``shardings`` place each leaf with ``distribute_tensor`` on its
        mesh; a None sharding leaves the leaf on its target's device (the
        restore onto a mesh of gloo ranks is in
        tests/test_torch_distributed.py)."""
        mgr = CheckpointManager(str(tmp_path), interval=1)
        mgr.save(1, {"a": torch.ones(2), "b": torch.arange(3)})
        got, step = mgr.restore_latest(
            {"a": torch.zeros(2), "b": torch.zeros(3, dtype=torch.int64)},
            shardings={"a": None, "b": None})
        assert step == 1 and torch.equal(got["a"], torch.ones(2))
        assert torch.equal(got["b"], torch.arange(3))


def test_supervisor_recovers_the_latest_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path), interval=1)
    params = {"w": torch.ones(3)}
    state = opt.init(params, opt.AdamWConfig())
    mgr.save(1, (params, state))
    seen = []
    sup = TrainSupervisor(mgr, rescale=seen.append)
    assert not sup.failure_pending
    sup.on_failure("worker-1")
    assert sup.failure_pending and sup.failures == ["worker-1"]
    like = tree_map(torch.zeros_like, (params, state))
    (got_p, got_s), step = sup.recover(like, ["worker-0"])
    assert step == 1 and seen == [["worker-0"]]
    assert not sup.failure_pending
    assert torch.equal(got_p["w"], params["w"])
    assert got_s["mu"]["w"].dtype == torch.bfloat16
