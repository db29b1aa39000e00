"""The port's step builders (repro_torch.launch.steps) against the
reference's (repro.launch.steps):

* ``cache_pspecs`` and ``logits_pspec`` equal the reference's, leaf for
  leaf, for every arch and every decode (and prefill) shape on the
  (16, 16) stand-in mesh, and on the expert / serve-2d layout of
  ``tests/test_sharding_rules.py``;
* the divisibility invariants of that file hold for the port's params,
  batches and caches (made on meta): every sharded dim divides its axes;
* on a 2 x 2 (data, model) gloo mesh of 4 spawned ranks, reduced
  internlm2 (baseline), mamba2 (``opt_ssm_q128``) and deepseek
  (``opt_moe``, its decode on the ``expert_ff_fsdp`` layout, capacity
  factor 8 so that no token is dropped) through ``build_prefill`` and two
  ``build_decode`` steps, fp32: logits and caches within 1e-5 of the
  reference's unsharded ``apply`` (computed in this process from the same
  weights) and of the port's unsharded ``apply``, each output laid out
  by its spec.  Not bit for bit on this mesh: the model axis splits the
  heads' and the FFN's sums, which then add in another order (the (1, 1)
  mesh of ``chip_smoke.py`` phase 12a is bit for bit).
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

# the ranks are spawned and import this module: JAX and the reference are
# imported inside the tests that run in this process, never at the top
from repro_torch.configs.registry import ARCH_IDS, get_config, shapes_for
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import model as TM
from repro_torch.training.train_step import batch_specs
from repro_torch.training.tree import leaves, tree_map

TOL = 1e-5
RANK_TIMEOUT_S = 60


class _FakeMesh:
    """Stands in for the 256-chip mesh (shape lookups only)."""

    shape = {"data": 16, "model": 16}


def _rules(mod, **kw):
    return dataclasses.replace(mod.ShardingRules(
        mesh=_FakeMesh(), batch_axes=("data",), fsdp=True), **kw)


LAYOUTS = {"default": {},
           "serve2d": dict(expert_ff_fsdp=True, shard_batch=False,
                           seq_axes=("data", "model"))}


def _jax_specs(tree):
    """{path: spec as a tuple} of a reference spec tree."""
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}


def _by_path(tree, prefix=()):
    """{path: leaf} of a tree of dicts, lists and tuples whose leaves are
    tensors or specs."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _by_path(sub, (*prefix, str(key))).items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, shd.P):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _by_path(sub, (*prefix, str(i))).items()}
    return {"/".join(prefix): tree}


def _port_specs(tree):
    return {k: tuple(v) for k, v in _by_path(tree).items()}


def _axis_size(name) -> int:
    return shd.axis_size(_FakeMesh(), name)


def _check_divisible(shapes, specs, what):
    flat_s = _port_specs(tree_map(lambda t: shd.P(*t.shape), shapes))
    flat_p = _port_specs(specs)
    assert flat_s.keys() == flat_p.keys(), what
    for path, shape in flat_s.items():
        for i, name in enumerate(flat_p[path]):
            assert shape[i] % _axis_size(name) == 0, (
                f"{what} {path}: dim {i} of {shape} not divisible by {name}")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_logits_specs_equal_the_references(arch, layout):
    import jax

    from repro.configs.registry import get_config as jax_config
    from repro.distributed import sharding as jshd
    from repro.launch import steps as jsteps
    from repro.models import model as JM

    jcfg, tcfg = jax_config(arch), get_config(arch)
    jrules, trules = (_rules(m, **LAYOUTS[layout]) for m in (jshd, shd))
    for shape in shapes_for(tcfg):
        b, s = shape.global_batch, shape.seq_len
        assert tuple(steps.logits_pspec(trules, batch=b,
                                        vocab=tcfg.vocab_size)) == tuple(
            jsteps.logits_pspec(jrules, batch=b, vocab=jcfg.vocab_size))
        if shape.kind != "decode":
            continue
        jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, b, s))
        tcache = TM.init_cache(tcfg, b, s, device="meta")
        want = _jax_specs(jsteps.cache_pspecs(jcache, jrules, batch=b, seq=s))
        got = _port_specs(steps.cache_pspecs(tcache, trules, batch=b, seq=s))
        assert got == want, (arch, shape.name)
        _check_divisible(tcache, steps.cache_pspecs(tcache, trules, batch=b,
                                                     seq=s),
                         f"{arch} {shape.name} {layout} cache")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_and_batches_divisible(arch, layout):
    cfg = get_config(arch)
    rules = _rules(shd, **LAYOUTS[layout])
    params = TM.init_params(cfg, generator=torch.Generator(), device="meta")
    _check_divisible(params, shd.param_specs(params, rules), f"{arch} params")
    for shape in shapes_for(cfg):
        batch = TM.input_specs(cfg, shape)
        _check_divisible(batch, batch_specs(cfg, batch, rules),
                         f"{arch} {shape.name} batch")


# -- the steps on a 2 x 2 gloo mesh --------------------------------------------

CASES = {"internlm2_1_8b": "baseline", "mamba2_780m": "opt_ssm_q128",
         "deepseek_v2_lite_16b": "opt_moe"}
BATCH, SEQ, MAX_SEQ, DECODE = 4, 8, 16, 2


def _cfg(get, arch):
    extra = {"capacity_factor": 8.0} if arch.startswith("deepseek") else {}
    return dataclasses.replace(get(arch).reduced(), dtype="float32", **extra)


def _inputs(cfg):
    g = np.random.default_rng(7)
    return (g.integers(0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int32),
            [g.integers(0, cfg.vocab_size, (BATCH, 1), dtype=np.int32)
             for _ in range(DECODE)])


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


def run_ranks(fn, world, tmp_path, *args, timeout=150.0):
    tmp = str(tmp_path)
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


def _flat(tree):
    return leaves(tree)


def _steps_rank(rank, world, arch, variant, params_np):
    from repro_torch.launch.mesh import make_debug_mesh, make_rules
    from repro_torch.models import perf
    from repro_torch.params import params_from_numpy

    cfg = _cfg(get_config, arch)
    mesh = make_debug_mesh(4, shape=(2, 2))
    flags = perf.VARIANTS[variant]
    rules = make_rules(mesh)
    drules = (dataclasses.replace(rules, expert_ff_fsdp=True)
              if flags.moe_decode == "tp_data" else rules)
    prompt, toks = (torch.from_numpy(t) if isinstance(t, np.ndarray) else
                    [torch.from_numpy(x) for x in t] for t in _inputs(cfg))
    out = {"logits": [], "plain": [], "placed": []}
    with perf.use_flags(flags), torch.inference_mode():
        params = params_from_numpy(params_np, device="cpu")
        pf = steps.build_prefill(cfg, rules, max_seq=MAX_SEQ, batch=BATCH,
                                 batch_shapes={"tokens": prompt})
        logits, cache = pf(params, {"tokens": prompt})
        plain, pcache, _ = TM.apply(cfg, params, {"tokens": prompt,
                                                  "max_seq": MAX_SEQ},
                                    mode="prefill")
        out["placed"].append(_placed(logits, pf.specs["logits"], mesh)
                             and _all_placed(cache, pf.specs["cache"], mesh))
        out["logits"].append(shd.to_full(logits))
        out["plain"].append(plain)
        dec = steps.build_decode(cfg, drules, max_seq=MAX_SEQ, batch=BATCH,
                                 batch_shapes={"tokens": toks[0]},
                                 cache_shapes=cache)
        for tok in toks:
            logits, cache = dec(params, {"tokens": tok}, cache)
            plain, pcache, _ = TM.apply(cfg, params, {"tokens": tok},
                                        mode="decode", cache=pcache)
            out["placed"].append(
                _placed(logits, dec.specs["logits"], mesh)
                and _all_placed(cache, dec.specs["cache"], mesh))
            out["logits"].append(shd.to_full(logits))
            out["plain"].append(plain)
        out["cache"] = [shd.to_full(t) for t in _flat(cache)]
        out["plain_cache"] = _flat(pcache)
    return out


def _placed(x, spec, mesh):
    return list(x.placements) == shd.placements(spec, mesh)


def _all_placed(tree, specs, mesh):
    leaves, want = _by_path(tree), _by_path(specs)
    return leaves.keys() == want.keys() and all(
        _placed(leaves[k], want[k], mesh) for k in want)


def _jax_reference(arch, variant, jp):
    """The reference's unsharded prefill and decode logits and final
    cache, jitted with the variant's flags set while they trace."""
    import jax

    from repro.configs.registry import get_config as jax_config
    from repro.models import model as JM
    from repro.models import perf as jperf

    cfg = _cfg(jax_config, arch)
    flags = jperf.VARIANTS[variant]

    def jit(fn):
        def traced(*args):
            with jperf.use_flags(flags):
                return fn(*args)
        return jax.jit(traced)

    prompt, toks = _inputs(cfg)
    logits, cache = jit(lambda p, t: JM.apply(
        cfg, p, {"tokens": t, "max_seq": MAX_SEQ}, mode="prefill")[:2])(
        jp, prompt)
    out = [logits]
    decode = jit(lambda p, t, c: JM.apply(cfg, p, {"tokens": t},
                                          mode="decode", cache=c)[:2])
    for t in toks:
        logits, cache = decode(jp, t, cache)
        out.append(logits)
    return [np.asarray(x) for x in out], cache


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch", sorted(CASES))
def test_sharded_steps_on_a_2x2_mesh(arch, tmp_path):
    import jax

    from repro.configs.registry import get_config as jax_config
    from repro.models import model as JM
    from repro.models import perf as jperf

    variant = CASES[arch]
    cfg = _cfg(jax_config, arch)
    with jperf.use_flags(jperf.VARIANTS[variant]):
        jp = jax.jit(lambda k: JM.init_params(cfg, k))(jax.random.PRNGKey(0))
    want, jcache = _jax_reference(arch, variant, jp)
    res = run_ranks(_steps_rank, 4, tmp_path, arch, variant,
                    jax.tree.map(np.asarray, jp))
    for r in res:
        assert all(r["placed"])
        for got, plain, ref in zip(r["logits"], r["plain"], want, strict=True):
            _close(got, ref)
            _close(got, plain)
        assert len(r["cache"]) == len(r["plain_cache"])
        for got, plain in zip(r["cache"], r["plain_cache"]):
            _close(got, plain)
        # the reference's cache: the same tree, leaves in the same order
        jleaves = jax.tree.leaves(jcache)
        assert len(jleaves) == len(r["cache"])
        for got, ref in zip(r["cache"], jleaves):
            _close(got, ref)
