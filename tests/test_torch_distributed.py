"""The port's distributed layer on CPU gloo groups, against the reference.

Each test spawns its ranks (``torch.multiprocessing``, spawn), joined by a
gloo group initialised from a ``FileStore`` under the test's ``tmp_path``
(no port is opened, so parallel test workers never collide).  Every test
has its own time limit: the ranks are joined against a deadline and
killed past it, and the group's ``timeout=`` bounds any collective a rank
waits in.  The reference's values are computed here in the parent on the
same numpy inputs; the ranks import no JAX.

* ``named`` on a 2x2 mesh of ``launch.mesh.make_debug_mesh``: the
  placements of each spec, and a dim split over ('data', 'model') laid
  out data-major, as JAX lays it out.
* MoE on a 2x2 (data, model) mesh, reduced qwen3-moe in fp32 with
  capacity factor 8, 8 experts, top 2: the all_to_all path (S divisible by
  the model axis), the replicated path (S = 1) and ``tp_data`` (under
  ``perf.use_flags`` with ``expert_ff_fsdp``) equal JAX ``moe_dense`` on
  bridged weights within 2e-5, aux within rtol 0.25 (per-rank aux
  averaged, the GShard convention), and the gradients of sum(out^2) equal
  the dense ones within 2e-5 (``tests/test_moe_distributed.py``'s twin).
* ``pipeline_apply`` on 4 ranks: forward and backward equal the sequential
  stack on ``tests/test_pipeline.py``'s toy, and JAX's sequential result.
* ``compressed_psum_mean`` on 4 ranks with distinct gradients equals the
  scheme in numpy, bit for bit, error feedback included.
* The sharded train step on a 2x2 mesh (fsdp on), 3 steps: reduced
  internlm2 (fp32) against JAX's unsharded ``build_train_step`` (losses
  within 1e-5 relative, params within lr, as
  ``tests/test_torch_training.py``) and against the port's unsharded step
  (losses within 1e-6, the first batch's gradients within 1e-6 of each
  leaf's largest entry or 1e-5 relative, params within lr and all but 1%
  of their entries
  within 1e-6); reduced qwen3-moe at capacity factor 8, where the
  all_to_all path drops no token and equals ``moe_dense`` (its loss
  without the aux term, whose sharded value is the ranks' mean).
* A checkpoint saved from the 2x2 mesh restores onto the 1x4 mesh of
  ``plan_after_failure(...).build()``, every leaf equal.
"""

import dataclasses
import datetime
import os
import pathlib
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import Shard

RANK_TIMEOUT_S = 60  # the group's timeout: a collective waits no longer


def _entry(fn, rank, world, tmp, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    except BaseException:
        pathlib.Path(tmp, f"err{rank}.txt").write_text(traceback.format_exc())
        raise


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 150.0):
    """``fn(rank, world, *args)`` on ``world`` spawned ranks of one gloo
    group; returns each rank's result.  Fails (and kills every rank) when
    a rank fails or the ranks outlast ``timeout`` seconds."""
    tmp = str(tmp_path)
    pathlib.Path(tmp).mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, tmp, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = "\n".join(pathlib.Path(tmp, f"err{r}.txt").read_text()
                     for r in range(world)
                     if pathlib.Path(tmp, f"err{r}.txt").exists())
    assert not hung, f"ranks {hung} still running after {timeout} s\n{errs}"
    assert all(p.exitcode == 0 for p in procs), (
        f"exit codes {[p.exitcode for p in procs]}\n{errs}")
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _mesh(shape, axes):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=axes)


def _full(tree):
    from repro_torch.distributed.sharding import to_full
    from repro_torch.training.tree import tree_map
    return tree_map(lambda t: to_full(t).detach().clone(), tree)


# -- specs on a mesh ---------------------------------------------------------


def _named_rank(rank, world):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh, make_rules

    mesh = make_debug_mesh(4, shape=(2, 2))
    rules = make_rules(mesh)
    specs = {"embed": shd.P("model", "data"), "norm": shd.P(None),
             "flat": shd.P(("data", "model"), None)}
    named = shd.named(specs, rules)
    full = torch.arange(32.0).reshape(8, 4)
    local = distribute_tensor(full, mesh, named["flat"].placements).to_local()
    return {k: (v.mesh is mesh, list(v.placements)) for k, v in named.items()
            } | {"local": local, "coord": mesh.get_coordinate()}


def test_named_gives_the_placements_on_a_2x2_mesh(tmp_path):
    from torch.distributed.tensor import Replicate

    res = run_ranks(_named_rank, 4, tmp_path)
    full = torch.arange(32.0).reshape(8, 4)
    for r in res:
        assert r["embed"] == (True, [Shard(1), Shard(0)])
        assert r["norm"] == (True, [Replicate(), Replicate()])
        assert r["flat"] == (True, [Shard(0), Shard(0)])
        # ('data', 'model') on one dim: data-major, as JAX lays it out
        i, j = r["coord"]
        assert torch.equal(r["local"], full[2 * (2 * i + j):2 * (2 * i + j) + 2])


# -- MoE --------------------------------------------------------------------


def _moe_cfg():
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(
        get_config("qwen3_moe_235b_a22b").reduced(), dtype="float32",
        capacity_factor=8.0, num_experts=8, num_experts_per_tok=2)


def _moe_rank(rank, world, p_np, xs):
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe as MOE
    from repro_torch.models import perf
    from repro_torch.params import params_from_numpy
    from repro_torch.training.tree import leaves

    cfg = _moe_cfg()
    mesh = _mesh((2, 2), ("data", "model"))
    out = {}
    for name, x_np, rules, flags in (
            ("a2a", xs["a2a"],
             shd.ShardingRules(mesh=mesh, batch_axes=("data",), fsdp=False),
             None),
            ("replicated", xs["decode"],
             shd.ShardingRules(mesh=mesh, batch_axes=("data",), fsdp=False),
             None),
            ("tp_data", xs["decode"],
             shd.ShardingRules(mesh=mesh, batch_axes=("data",), fsdp=False,
                               expert_ff_fsdp=True),
             perf.PerfFlags(moe_decode="tp_data"))):
        p = params_from_numpy(p_np, device="cpu")
        ps = leaves(p)
        for t in ps:
            t.requires_grad_(True)
        x = torch.from_numpy(x_np).requires_grad_(True)
        with perf.use_flags(flags), shd.use_rules(rules):
            got, aux = MOE.moe_layer(cfg, p, x)
        loss = (got.full_tensor() ** 2).sum()
        grads = torch.autograd.grad(loss, ps + [x])
        # the dense path on the same (plain) tensors, for the gradients
        dense, _ = MOE.moe_dense(cfg, p, x)
        want = torch.autograd.grad((dense ** 2).sum(), ps + [x])
        out[name] = {"out": got.full_tensor().detach().numpy(),
                     "aux": float(aux.full_tensor()),
                     "grads": [g.numpy() for g in grads],
                     "dense_grads": [g.numpy() for g in want]}
    return out


def test_moe_expert_parallel_paths_match_dense(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config as jax_config
    from repro.models import moe as JMOE

    jcfg = dataclasses.replace(
        jax_config("qwen3_moe_235b_a22b").reduced(), dtype="float32",
        capacity_factor=8.0, num_experts=8, num_experts_per_tok=2)
    jp = JMOE.init_moe(jcfg, jax.random.PRNGKey(0), jnp.float32)
    rs = np.random.RandomState(1)
    xs = {"a2a": rs.randn(4, 8, jcfg.d_model).astype(np.float32),
          "decode": rs.randn(4, 1, jcfg.d_model).astype(np.float32)}
    p_np = jax.tree.map(np.asarray, jp)
    res = run_ranks(_moe_rank, 4, tmp_path, p_np, xs)
    for name, key in (("a2a", "a2a"), ("replicated", "decode"),
                      ("tp_data", "decode")):
        want, aux_want = JMOE.moe_dense(jcfg, jp, jnp.asarray(xs[key]))
        for r in res:
            got = r[name]
            np.testing.assert_allclose(got["out"], np.asarray(want),
                                       rtol=2e-5, atol=2e-5, err_msg=name)
            np.testing.assert_allclose(got["aux"], float(aux_want),
                                       rtol=0.25, err_msg=name)
            for g, w in zip(got["grads"], got["dense_grads"]):
                assert np.isfinite(g).all()
                np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5,
                                           err_msg=name)
    # the gradients of the dense path itself against JAX's
    jgrad = jax.grad(lambda pp: jnp.sum(JMOE.moe_dense(
        jcfg, pp, jnp.asarray(xs["a2a"]))[0] ** 2))(jp)
    for g, w in zip(res[0]["a2a"]["dense_grads"],
                    jax.tree_util.tree_leaves(jgrad)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-5, atol=2e-5)


# -- pipeline ---------------------------------------------------------------

L_, D_, MB_, BS_, P_STAGES = 8, 16, 6, 4, 4  # tests/test_pipeline.py's toy


def _layer(w, b, h):
    return torch.tanh(h @ w + b)


def _sequential(ws, bs, xs):
    out = []
    for m in range(xs.shape[0]):
        h = xs[m]
        for i in range(ws.shape[0]):
            h = _layer(ws[i], bs[i], h)
        out.append(h)
    return torch.stack(out)


def _stage_fn(sparams, h):
    ws, bs = sparams
    for i in range(ws.shape[0]):
        h = _layer(ws[i], bs[i], h)
    return h


def _pipeline_rank(rank, world, ws_np, bs_np, x_np):
    from repro_torch.distributed.pipeline import (bubble_fraction,
                                                  pipeline_apply,
                                                  stack_stages)

    mesh = _mesh((P_STAGES,), ("pipe",))
    ws = torch.from_numpy(ws_np).requires_grad_(True)
    bs = torch.from_numpy(bs_np).requires_grad_(True)
    x = torch.from_numpy(x_np)
    got = pipeline_apply(_stage_fn, stack_stages((ws, bs), P_STAGES), x,
                         mesh=mesh, axis="pipe")
    g_pipe = torch.autograd.grad((got ** 2).sum(), (ws, bs))
    want = _sequential(ws, bs, x)
    g_seq = torch.autograd.grad((want ** 2).sum(), (ws, bs))
    return {"got": got.detach().numpy(), "want": want.detach().numpy(),
            "g_pipe": [g.numpy() for g in g_pipe],
            "g_seq": [g.numpy() for g in g_seq],
            "bubble": bubble_fraction(4, 6)}


def test_pipeline_matches_sequential(tmp_path):
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(0)
    ws = jax.random.normal(key, (L_, D_, D_), jnp.float32) * (D_ ** -0.5)
    bs = jax.random.normal(jax.random.fold_in(key, 1), (L_, D_), jnp.float32)
    x = jax.random.normal(jax.random.fold_in(key, 2), (MB_, BS_, D_),
                          jnp.float32)

    def jseq(ws, bs):
        out = []
        for m in range(MB_):
            h = x[m]
            for i in range(L_):
                h = jnp.tanh(h @ ws[i] + bs[i])
            out.append(h)
        return jnp.stack(out)

    jwant = jseq(ws, bs)
    jgrad = jax.grad(lambda w, b: jnp.sum(jseq(w, b) ** 2), (0, 1))(ws, bs)
    res = run_ranks(_pipeline_rank, P_STAGES, tmp_path, np.asarray(ws),
                    np.asarray(bs), np.asarray(x))
    for r in res:
        np.testing.assert_allclose(r["got"], r["want"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["got"], np.asarray(jwant), rtol=1e-5,
                                   atol=1e-5)
        for a, b, j in zip(r["g_pipe"], r["g_seq"], jgrad):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(a, np.asarray(j), rtol=1e-4, atol=1e-4)
        assert abs(r["bubble"] - 3 / 9) < 1e-9


# -- int8 gradient all-reduce -----------------------------------------------


def _compress_rank(rank, world, grads_np, steps):
    from repro_torch.training import grad_compress as gc

    mesh = _mesh((world, 1), ("data", "model"))
    grads = {k: torch.from_numpy(v[rank]) for k, v in grads_np.items()}
    err = gc.init_error_state(grads)
    means = []
    for _ in range(steps):
        mean, err = gc.compressed_psum_mean(grads, err, mesh, ("data",))
        means.append({k: v.numpy() for k, v in mean.items()})
    return {"means": means, "err": {k: v.numpy() for k, v in err.items()}}


def _numpy_scheme(grads_np, steps):
    """The reference's scheme in numpy, over the ranks' stacked grads."""
    n = next(iter(grads_np.values())).shape[0]
    err = {k: np.zeros_like(v) for k, v in grads_np.items()}
    means = []
    for _ in range(steps):
        mean = {}
        for k, g in grads_np.items():
            corrected = g.astype(np.float32) + err[k]
            absmax = np.abs(corrected).max()  # pmax of the local absmax
            scale = np.float32(max(absmax, np.float32(1e-12))) / np.float32(127.0)
            q = np.clip(np.round(corrected / scale), -127, 127)
            total = q.astype(np.int16).sum(axis=0)
            mean[k] = (total.astype(np.float32) * scale / np.float32(n))
            err[k] = corrected - q * scale
        means.append(mean)
    return means, err


def test_compressed_psum_mean_matches_numpy(tmp_path):
    rs = np.random.RandomState(0)
    grads = {"a": rs.randn(4, 64, 32).astype(np.float32) * 1e-3,
             "b": rs.randn(4, 257).astype(np.float32)}
    res = run_ranks(_compress_rank, 4, tmp_path, grads, 3)
    want, err = _numpy_scheme(grads, 3)
    for r, res_r in enumerate(res):
        for got, w in zip(res_r["means"], want):
            for k in grads:
                np.testing.assert_array_equal(got[k], w[k])
        for k in grads:
            np.testing.assert_array_equal(res_r["err"][k], err[k][r])


# -- the sharded train step, and checkpoints across meshes --------------------


def _train_cfg(arch):
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return cfg


def _settings(arch, lr):
    """AdamW at ``lr`` with no warmup; an MoE config drops the aux term
    from the loss (its sharded aux is the ranks' mean, the GShard
    convention, which differs from the global batch's by design: the
    reference's own test bounds it at rtol 0.25), so the losses compare
    the same function."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts
    return ts.TrainSettings(adamw=opt.AdamWConfig(lr=lr, warmup_steps=0),
                            aux_weight=0.0 if "moe" in arch else 0.01)


def _grads(cfg, settings, params, batch, rules=None):
    """The first batch's gradients, under ``rules`` on the step's layout."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as shd
    from repro_torch.training import train_step as ts

    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if rules is not None:
        specs = shd.param_specs(params, rules)
        params = shd.distribute(params, specs, rules)
        bspecs = ts.batch_specs(cfg, batch, rules)
        batch = {k: shd.distribute(v, bspecs[k], rules)
                 for k, v in batch.items()}
    with shd.use_rules(rules), implicit_replication():
        _, grads = ts.value_and_grad(ts.make_loss(cfg, settings), params,
                                     batch)
    return grads


def _train_rank(rank, world, arch, p_np, s_np, batches, lr, ckpt_dir=None):
    from repro_torch.distributed import sharding as shd
    from repro_torch.params import opt_state_from_numpy, params_from_numpy
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    cfg = _train_cfg(arch)
    mesh = _mesh((2, 2), ("data", "model"))
    rules = shd.ShardingRules(mesh=mesh, fsdp=True)
    step = ts.build_train_step(cfg, _settings(arch, lr), rules)
    params = params_from_numpy(p_np, device="cpu")
    state = opt_state_from_numpy(s_np, device="cpu")
    grads = _grads(cfg, _settings(arch, lr), params, batches[0], rules)
    losses, auxes = [], []
    for b in batches:
        params, state, m = step(params, state,
                                {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        auxes.append(float(m["aux"]))
    out = {"losses": losses, "aux": auxes, "params": _full(params),
           "grads": _full(grads),
           "placements": {k: list(params[k].placements)
                          for k in ("embed", "lm_head")}}
    if ckpt_dir is not None:
        ckpt.save(ckpt_dir, 3, {"params": params, "opt": state})
        out["state"] = _full(state)
    return out


def _jax_train(arch, steps, lr, rows=4):
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config as jax_config
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models import model as JM
    from repro.training import optimizer as jopt
    from repro.training import train_step as jts

    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    if jcfg.is_moe:
        jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jset = jts.TrainSettings(adamw=jopt.AdamWConfig(lr=lr, warmup_steps=0),
                             aux_weight=0.0 if "moe" in arch else 0.01)
    js = jopt.init(jp, jset.adamw)
    p_np, s_np = jax.tree.map(np.asarray, (jp, js))
    batches = [SyntheticLM(DataConfig(jcfg.vocab_size, 16, rows)).batch(i)
               for i in range(steps)]
    jstep = jts.build_train_step(jcfg, jset, None)
    losses, auxes = [], []
    for b in batches:
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(jm["loss"]))
        auxes.append(float(jm["aux"]))
    return (p_np, s_np, batches, (losses, auxes),
            jax.tree_util.tree_leaves(jp))


def _port_train(arch, p_np, s_np, batches, lr):
    from repro_torch.params import opt_state_from_numpy, params_from_numpy
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    cfg = _train_cfg(arch)
    step = ts.build_train_step(cfg, _settings(arch, lr))
    params = params_from_numpy(p_np, device="cpu")
    state = opt_state_from_numpy(s_np, device="cpu")
    grads = _grads(cfg, _settings(arch, lr), params, batches[0])
    losses = []
    for b in batches:
        params, state, m = step(params, state,
                                {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, params, grads


@pytest.mark.parametrize("arch,rows", [
    pytest.param("internlm2_1_8b", 4, id="internlm2_1_8b"),
    pytest.param("qwen3_moe_235b_a22b", 4, id="qwen3_moe_235b_a22b"),
    # rows the data axis does not divide: batch_specs leaves them whole,
    # and no FSDP product may scatter them back over data
    pytest.param("internlm2_1_8b", 3, id="internlm2_1_8b-3rows")])
def test_sharded_train_step_matches_unsharded(arch, rows, tmp_path):
    from repro_torch.training.tree import leaves

    lr = 1e-3
    p_np, s_np, batches, (jlosses, jaux), jleaves = _jax_train(arch, 3, lr,
                                                               rows)
    res = run_ranks(_train_rank, 4, tmp_path, arch, p_np, s_np, batches, lr)
    tlosses, tparams, tgrads = _port_train(arch, p_np, s_np, batches, lr)
    for r in res:
        # against JAX's unsharded step: test_torch_training.py's bars
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5)
        np.testing.assert_allclose(r["aux"], jaux, rtol=0.25)
        for t, j in zip(leaves(r["params"]), jleaves):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                       atol=lr)
        # against the port's own unsharded step: losses within 1e-6, each
        # gradient entry within 1e-6 of its leaf's largest entry or 1e-5 of
        # itself (fp32 sums in another order).  AdamW's
        # normalised step turns the reduction order's rounding in a
        # near-cancelled gradient entry into up to ~1e-5 of a weight after
        # 3 steps, so params hold the JAX bar (lr) everywhere and 1e-6 on
        # all but 1% of their entries
        np.testing.assert_allclose(r["losses"], tlosses, rtol=1e-6)
        for g, u in zip(leaves(r["grads"]), leaves(tgrads)):
            np.testing.assert_allclose(g.numpy(), u.numpy(), rtol=1e-5,
                                       atol=1e-6 * float(u.abs().max()))
        far = total = 0
        for t, u in zip(leaves(r["params"]), leaves(tparams)):
            np.testing.assert_allclose(t.numpy(), u.numpy(), rtol=0, atol=lr)
            far += int(((t - u).abs() > 1e-6).sum())
            total += t.numel()
        assert far <= 0.01 * total, (far, total)
    # vocab over the model axis, D over data (fsdp)
    assert res[0]["placements"]["embed"] == [Shard(1), Shard(0)]
    assert res[0]["placements"]["lm_head"] == [Shard(0), Shard(1)]


def _restore_rank(rank, world, arch, ckpt_dir, like_np):
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_rules
    from repro_torch.params import opt_state_from_numpy, params_from_numpy
    from repro_torch.runtime.elastic import plan_after_failure
    from repro_torch.training import checkpoint as ckpt

    plan = plan_after_failure(4, model=4, global_batch=4)
    mesh = plan.build()
    rules = make_rules(mesh)
    like = {"params": params_from_numpy(like_np[0], device="cpu"),
            "opt": opt_state_from_numpy(like_np[1], device="cpu")}
    pspecs = shd.param_specs(like["params"], rules)
    from repro_torch.training.train_step import _opt_specs
    specs = {"params": pspecs, "opt": _opt_specs(like["opt"], pspecs)}
    tree, step = ckpt.restore(ckpt_dir, like, shardings=shd.named(specs, rules))
    return {"step": step, "shape": tuple(mesh.shape), "tree": _full(tree),
            "embed": list(tree["params"]["embed"].placements),
            "local": tuple(tree["params"]["embed"].to_local().shape)}


def test_checkpoint_restores_onto_a_shrunk_mesh(tmp_path):
    from repro_torch.training.tree import leaves

    arch, lr = "internlm2_1_8b", 1e-3
    p_np, s_np, batches, _, _ = _jax_train(arch, 3, lr)
    ckpt_dir = str(tmp_path / "ckpt")
    saved = run_ranks(_train_rank, 4, tmp_path / "train", arch, p_np, s_np,
                      batches, lr, ckpt_dir)[0]
    res = run_ranks(_restore_rank, 4, tmp_path / "restore", arch, ckpt_dir,
                    (p_np, s_np))
    want = {"params": saved["params"], "opt": saved["state"]}
    for r in res:
        assert r["step"] == 3 and r["shape"] == (1, 4)
        # vocab over the 4-way model axis; the data axis of 1 keeps D whole
        assert r["embed"] == [Shard(1), Shard(0)]
        assert r["local"] == (p_np["embed"].shape[0] // 4,
                              p_np["embed"].shape[1])
        for a, b in zip(leaves(r["tree"]), leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
