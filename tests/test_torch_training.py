"""The port's training path (repro_torch.training, repro_torch.launch.train)
against the reference's, on reduced internlm2 in fp32.

* ``optimizer.update`` on the same numpy gradients as JAX ``opt.update``,
  three updates, in both moment dtypes: params, master and moments within
  1e-6 (grad_clip off, so the gradient norm's summation order does not
  enter the moments; the schedule's cos and the bias corrections' pow may
  differ in the last bit);
* twins of ``tests/test_training.py``'s schedule, clip and master-dtype
  tests;
* three ``build_train_step`` steps against JAX's on bridged weights and
  ``opt_state_from_numpy``: losses within 1e-5 relative, params within
  ``lr`` (one step's largest move: AdamW's first steps move each weight by
  about lr times the sign of its gradient, which a gradient near zero can
  flip);
* ``_split_microbatches`` against the reference's, mrope's batch axis 1
  included; ``grad_accum=4``'s accumulated gradients against the full
  batch's, and three ``grad_accum=4`` steps against JAX's;
* ``remat=True`` equal to ``remat=False`` bit for bit for every policy;
* ``launch.train.main(... --device cpu --reduced)`` runs, and a run resumed
  from its checkpoint gives the straight run's losses bit for bit.
"""

import dataclasses
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import model as JM
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.configs.registry import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import model as TM
from repro_torch.params import opt_state_from_numpy, params_from_numpy
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts
from repro_torch.training.tree import leaves, tree_map


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jax_config("internlm2_1_8b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("internlm2_1_8b").reduced(),
                               dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp


def _bridge(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _np_batch(cfg, b=4, s=16, step=0):
    return SyntheticLM(DataConfig(cfg.vocab_size, s, b)).batch(step)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_tree_close(t_tree, j_tree, atol):
    jl, tl = jax.tree_util.tree_leaves(j_tree), leaves(t_tree)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), rtol=0,
                                   atol=atol)


class TestOptimizer:
    @pytest.mark.parametrize("moment_dtype", ["bfloat16", "float32"])
    def test_update_against_jax(self, tiny, moment_dtype):
        _, _, jp = tiny
        c = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.0,
                 moment_dtype=moment_dtype)
        jc, tc = jopt.AdamWConfig(**c), opt.AdamWConfig(**c)
        tp = _bridge(jp)
        js, tstate = jopt.init(jp, jc), opt.init(tp, tc)
        rng = np.random.default_rng(0)
        for _ in range(3):
            g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
                np.float32), jp)
            jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, jc)
            out = opt.update(_bridge(g), tstate, tp, tc)
            assert out[0] is tp and out[1] is tstate  # updated in place
            np.testing.assert_allclose(out[2]["grad_norm"].item(),
                                       float(jm["grad_norm"]), rtol=1e-6)
            np.testing.assert_allclose(out[2]["lr"].item(), float(jm["lr"]),
                                       rtol=1e-6)
        _assert_tree_close(tp, jp, 1e-6)
        for key in ("mu", "nu", "master"):
            assert all(t.dtype == getattr(torch, moment_dtype if key != "master"
                                          else "float32")
                       for t in leaves(tstate[key]))
            _assert_tree_close(tstate[key], js[key], 1e-6)
        assert int(tstate["step"]) == int(js["step"]) == 3

    def test_schedule_warmup_and_decay(self):
        c = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
        jc = jopt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                              min_lr_ratio=0.1)
        assert float(opt.schedule(c, torch.tensor(5))) == pytest.approx(0.5)
        assert float(opt.schedule(c, torch.tensor(10))) == pytest.approx(1.0, abs=1e-2)
        assert float(opt.schedule(c, torch.tensor(100))) == pytest.approx(0.1, abs=1e-3)
        for step in (0, 1, 9, 10, 11, 55, 99, 100, 150):
            assert float(opt.schedule(c, torch.tensor(step))) == pytest.approx(
                float(jopt.schedule(jc, jnp.asarray(step))), rel=1e-6, abs=1e-9)

    def test_moment_dtype_and_master(self, tiny):
        _, _, jp = tiny
        tp = _bridge(jp)
        state = opt.init(tp, opt.AdamWConfig(moment_dtype="bfloat16",
                                             master_dtype="float32"))
        assert all(l.dtype == torch.bfloat16 for l in leaves(state["mu"]))
        assert all(l.dtype == torch.float32 for l in leaves(state["master"]))
        # the master is a copy: the in-place update must not alias params
        assert all(m.data_ptr() != p.data_ptr()
                   for m, p in zip(leaves(state["master"]), leaves(tp)))
        assert "master" not in opt.init(tp, opt.AdamWConfig(master_dtype=None))

    def test_grad_clip(self, tiny):
        _, _, jp = tiny
        tp = _bridge(jp)
        before = [t.clone() for t in leaves(tp)]
        c = opt.AdamWConfig(grad_clip=1e-9, lr=1.0, warmup_steps=0)
        state = opt.init(tp, c)
        grads = tree_map(torch.ones_like, tp)
        _, _, m = opt.update(grads, state, tp, c)
        # clip to ~0 -> params ~unchanged apart from weight decay
        diff = max((a - b).abs().max().item()
                   for a, b in zip(leaves(tp), before))
        assert diff < 0.2  # weight-decay-only scale
        assert float(m["grad_norm"]) > 0


class TestTrainStep:
    def test_three_steps_against_jax(self, tiny):
        jcfg, tcfg, jp = tiny
        lr = 1e-3
        jset = jts.TrainSettings(adamw=jopt.AdamWConfig(lr=lr, warmup_steps=0))
        tset = ts.TrainSettings(adamw=opt.AdamWConfig(lr=lr, warmup_steps=0))
        js = jopt.init(jp, jset.adamw)
        tp = _bridge(jp)
        tstate = opt_state_from_numpy(jax.tree.map(np.asarray, js),
                                      device="cpu")
        assert tstate["mu"]["embed"].dtype == torch.bfloat16
        jstep = jts.build_train_step(jcfg, jset, None)
        tstep = ts.build_train_step(tcfg, tset)
        for i in range(3):
            batch = _np_batch(tcfg, step=i)
            jp, js, jm = jstep(jp, js, _j(batch))
            tp, tstate, tm = tstep(tp, tstate, _t(batch))
            np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                       rtol=1e-5)
        _assert_tree_close(tp, jp, lr)
        assert int(tstate["step"]) == 3

    def test_mesh_is_refused(self, tiny, tmp_path):
        """Rules with a mesh build the sharded step: on the (1, 1) mesh of
        a one-rank gloo group in this process, params and AdamW state
        become DTensors and three steps equal the plain step's bit for bit
        (a mesh of several ranks is held by
        tests/test_torch_distributed.py)."""
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor

        from repro_torch.launch.mesh import make_debug_mesh, make_rules

        _, tcfg, jp = tiny
        tset = ts.TrainSettings(adamw=opt.AdamWConfig(lr=1e-3,
                                                      warmup_steps=0))
        plain = ts.build_train_step(tcfg, tset, ts.shd.ShardingRules())
        dist.init_process_group("gloo", world_size=1, rank=0,
                                store=dist.FileStore(str(tmp_path / "s"), 1))
        try:
            sharded = ts.build_train_step(
                tcfg, tset, make_rules(make_debug_mesh(1, shape=(1, 1))))
            runs = []
            for step in (plain, sharded):
                tp = _bridge(jp)
                state = opt.init(tp, tset.adamw)
                losses = []
                for i in range(3):
                    tp, state, m = step(tp, state, _t(_np_batch(tcfg, step=i)))
                    losses.append(float(m["loss"]))
                runs.append((losses, tp, state))
        finally:
            dist.destroy_process_group()
        (lp, pp, _), (ls, ps, ss) = runs
        assert ls == lp
        assert all(isinstance(t, DTensor) for t in leaves(ps) + leaves(ss))
        for a, b in zip(leaves(ps), leaves(pp)):
            assert torch.equal(a.full_tensor(), b)

    def test_split_microbatches_against_jax(self):
        rng = np.random.default_rng(3)
        batch = {"tokens": rng.integers(0, 9, (8, 5), dtype=np.int32),
                 "embeds": rng.standard_normal((8, 5, 3)).astype(np.float32),
                 "mrope_positions": rng.integers(0, 9, (3, 8, 5),
                                                 dtype=np.int32)}
        want = jts._split_microbatches(_j(batch), 4)
        got = ts._split_microbatches(_t(batch), 4)
        assert tuple(got["mrope_positions"].shape) == (4, 3, 2, 5)
        for k in batch:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))

    def test_grad_accum_matches_full_batch(self, tiny):
        """The fp32 sum of 4 microbatches' gradients over 4 equals the
        full batch's gradient (the loss is linear in the batch: no label is
        masked, so the microbatches' mean is the batch's), each leaf within
        1e-5 of its max |.|."""
        _, tcfg, jp = tiny
        batch = _t(_np_batch(tcfg, b=8))
        loss_fn = ts.make_loss(tcfg, ts.TrainSettings())
        tp = _bridge(jp)
        (l1, _), g1 = ts.value_and_grad(loss_fn, tp, batch)
        (l4, _), g4 = ts.accumulated_value_and_grad(loss_fn, tp, batch, 4)
        assert l1.item() == pytest.approx(l4.item(), rel=1e-6)
        for a, b in zip(leaves(g4), leaves(g1)):
            assert a.dtype == torch.float32 and b.abs().max() > 0
            assert (a - b).abs().max() <= 1e-5 * b.abs().max()

    def test_grad_accum_steps_against_jax(self, tiny):
        """Three ``grad_accum=4`` steps against JAX's on bridged weights at
        the three-step test's tolerances, and the first moments (fp32:
        (1 - b1) times the clipped accumulated gradient after step 1) each
        leaf within 1e-4 of its max |.| after every step."""
        jcfg, tcfg, jp = tiny
        lr = 1e-3
        c = dict(lr=lr, warmup_steps=0, moment_dtype="float32")
        jset = jts.TrainSettings(adamw=jopt.AdamWConfig(**c), grad_accum=4)
        tset = ts.TrainSettings(adamw=opt.AdamWConfig(**c), grad_accum=4)
        js = jopt.init(jp, jset.adamw)
        tp = _bridge(jp)
        tstate = opt_state_from_numpy(jax.tree.map(np.asarray, js),
                                      device="cpu")
        jstep = jts.build_train_step(jcfg, jset, None)
        tstep = ts.build_train_step(tcfg, tset)
        for i in range(3):
            batch = _np_batch(tcfg, b=8, step=i)
            jp, js, jm = jstep(jp, js, _j(batch))
            tp, tstate, tm = tstep(tp, tstate, _t(batch))
            np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                       rtol=1e-5)
            for t, j in zip(leaves(tstate["mu"]),
                            jax.tree_util.tree_leaves(js["mu"])):
                j = np.asarray(j)
                assert np.abs(t.numpy() - j).max() <= 1e-4 * np.abs(j).max()
        _assert_tree_close(tp, jp, lr)
        assert int(tstate["step"]) == 3

    @pytest.mark.parametrize("policy", sorted(ts.REMAT_POLICIES))
    def test_remat_is_bit_for_bit(self, tiny, policy):
        _, tcfg, jp = tiny
        batch = _t(_np_batch(tcfg))
        out = []
        for remat in (False, True):
            s = ts.TrainSettings(adamw=opt.AdamWConfig(lr=1e-3, warmup_steps=0),
                                 remat=remat, remat_policy=policy)
            tp = _bridge(jp)
            tp, state, m = ts.build_train_step(tcfg, s)(
                tp, opt.init(tp, s.adamw), batch)
            out.append((m["loss"], leaves(tp), leaves(state["mu"])))
        (l0, p0, m0), (l1, p1, m1) = out
        assert torch.equal(l0, l1)
        assert all(torch.equal(a, b) for a, b in zip(p0 + m0, p1 + m1))

    def test_policies_save_what_the_reference_names(self):
        """``dots`` saves every product, ``dots_no_batch`` the products
        without a batch dimension only (the reference's
        ``checkpoint_dots_with_no_batch_dims``)."""
        from torch.utils.checkpoint import CheckpointPolicy

        aten = torch.ops.aten
        for name, saved in (("dots", {aten.mm, aten.addmm, aten.bmm}),
                            ("dots_no_batch", {aten.mm, aten.addmm})):
            policy = ts.REMAT_POLICIES[name]
            for op in (aten.mm, aten.addmm, aten.bmm, aten.mul, aten.exp):
                want = (CheckpointPolicy.MUST_SAVE if op in saved
                        else CheckpointPolicy.PREFER_RECOMPUTE)
                assert policy(None, op.default) == want, (name, op)

    def test_unknown_policy_raises(self, tiny):
        _, tcfg, _ = tiny
        with pytest.raises(KeyError):
            ts.make_loss(tcfg, ts.TrainSettings(remat_policy="dot"))


class TestLaunchTrain:
    ARGS = ["--arch", "internlm2_1_8b", "--reduced", "--steps", "6",
            "--global-batch", "4", "--seq-len", "16", "--device", "cpu",
            "--log-every", "1"]

    def test_runs_and_resume_is_bit_for_bit(self, tmp_path, capsys):
        ck = tmp_path / "ck"
        args = self.ARGS + ["--checkpoint-dir", str(ck),
                            "--checkpoint-interval", "3"]
        straight = launch_train.main(args)
        assert len(straight["losses"]) == 6
        assert all(math.isfinite(x) for x in straight["losses"])
        assert straight["first_loss"] == straight["losses"][0]
        assert straight["final_loss"] == straight["losses"][-1]
        assert "step     6 loss" in capsys.readouterr().out
        assert sorted(p.name for p in ck.iterdir() if p.is_dir()) == [
            "step_00000003", "step_00000006"]
        # resume from step 3
        shutil.rmtree(ck / "step_00000006")
        (ck / "LATEST").write_text("step_00000003")
        resumed = launch_train.main(args + ["--resume"])
        assert "resumed from step 3" in capsys.readouterr().out
        assert resumed["losses"] == straight["losses"][3:]
        for a, b in zip(leaves(resumed["params"]), leaves(straight["params"])):
            assert torch.equal(a, b)

    def test_params_follow_the_config(self):
        out = launch_train.main(self.ARGS[:3] + ["--steps", "1",
                                                  "--device", "cpu"])
        cfg = get_config("internlm2_1_8b").reduced()
        assert out["params"]["embed"].dtype == getattr(torch, cfg.dtype)
        assert sum(t.numel() for t in leaves(out["params"])) == \
            TM.param_count(cfg)


def test_opt_state_from_numpy_keeps_dtypes(tiny):
    _, _, jp = tiny
    js = jopt.init(jp, jopt.AdamWConfig())
    st = opt_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()
    assert all(t.dtype == torch.bfloat16 for t in leaves(st["mu"]))
    assert all(t.dtype == torch.float32 for t in leaves(st["master"]))
    cast = opt_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu",
                                dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in leaves(cast["nu"]))
