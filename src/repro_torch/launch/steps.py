"""Step builders shared by launchers and the dry run: train / prefill /
decode steps laid out over a device mesh.

Counterpart of ``repro/launch/steps.py``.  ``cache_pspecs`` and
``logits_pspec`` keep the reference's rules line for line, on the port's
``PartitionSpec`` and ``axis_size`` (so they run on a ``DeviceMesh`` and
on a shape-only stand-in).  The reference jits each step with explicit in
and out shardings; here a step is a function that

  * lays its arguments out as those shardings say (``sharding.distribute``:
    a plain tensor is distributed, every rank passing the whole of it; a
    DTensor in another layout is redistributed): params by
    ``param_specs``, the batch by ``batch_specs``, the decode cache by
    :func:`cache_pspecs` -- place params once with ``distribute`` before a
    loop of steps;
  * runs ``model.apply`` under ``use_rules(rules)`` (plain tensors the
    model makes join DTensor ops as replicated), so the models' shard
    points lay out the activations and every kernel wrapper runs on local
    shards under ``local_map``;
  * returns the logits laid out by :func:`logits_pspec` and the cache by
    :func:`cache_pspecs`.

The reference donates the decode cache (``donate_argnums=(2,)``); here the
decode step writes the new token into the cache's shards in place, and the
caller must not reuse the cache it passed in: a plain cache was copied
into DTensors, and a DTensor cache now holds the next step's state.  The
reference's ``jax.eval_shape`` of a step's output is one call of the
unsharded step on meta tensors, which allocates nothing.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.distributed import sharding as shd
from repro_torch.models import model as M
from repro_torch.training import train_step as ts
from repro_torch.training.tree import tree_map

P = shd.PartitionSpec


def cache_pspecs(cache_shapes, rules: shd.ShardingRules, *, batch: int,
                 seq: int):
    """PartitionSpec tree for a decode cache.

    Per leaf: the sequence dim (== seq) shards over the model axis (over
    ALL axes when batch == 1, long-context); the batch dim (== batch) over
    the DP axes; state-like leaves without a sequence dim shard their first
    model-divisible channel/head dim over the model axis."""
    model_size = shd.axis_size(rules.mesh, rules.model_axis)
    batch_axes = rules.batch()

    def spec(leaf):
        shape = leaf.shape
        nd = len(shape)
        if nd <= 1:
            return P()
        out = [None] * nd
        si = next((i for i in range(1, nd) if seq > 1 and shape[i] == seq), None)
        bi = next((i for i in range(1, nd)
                   if batch > 1 and rules.shard_batch
                   and shape[i] == batch and i != si), None)
        if si is not None:
            out[si] = ((*rules.batch_axes, rules.model_axis)
                       if (batch == 1 or not rules.shard_batch)
                       else rules.seq_axes if len(rules.seq_axes) > 1
                       else rules.seq_axes[0])
        if bi is not None:
            out[bi] = batch_axes
        if si is None:
            start = (bi + 1) if bi is not None else 1
            for i in range(start, nd):
                if i != bi and shape[i] % model_size == 0 and shape[i] >= model_size:
                    out[i] = rules.model_axis
                    break
        return P(*out)

    return tree_map(spec, cache_shapes)


def logits_pspec(rules: shd.ShardingRules, *, batch: int, vocab: int):
    b = rules.batch() if batch > 1 else None
    model_size = shd.axis_size(rules.mesh, rules.model_axis)
    v = rules.model_axis if vocab % model_size == 0 else None
    return P(b, None, v)


def build_train_step(cfg, rules, settings: ts.TrainSettings, batch_shapes):
    return ts.build_train_step(cfg, settings, rules, batch_shapes)


def _meta_params(cfg):
    """The params' shapes and dtypes as meta tensors (a CPU generator: a
    meta one cannot draw)."""
    return M.init_params(cfg, generator=torch.Generator(), device="meta")


def _as_meta(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def build_prefill(cfg, rules: shd.ShardingRules, *, max_seq: int, batch: int,
                  batch_shapes):
    """``step(params, batch) -> (logits, cache)``: a prefill laid out over
    ``rules.mesh`` (see the module docstring)."""

    def fn(params, batch_):
        with shd.use_rules(rules), implicit_replication():
            logits, cache, _ = M.apply(cfg, params,
                                       {**batch_, "max_seq": max_seq},
                                       mode="prefill")
        return logits, cache

    params_shape = _meta_params(cfg)
    pspecs = shd.param_specs(params_shape, rules)
    bspecs = ts.batch_specs(cfg, batch_shapes, rules)
    with torch.inference_mode(), shd.use_rules(None):
        _, cache_shape, _ = M.apply(
            cfg, params_shape, {**_as_meta(batch_shapes), "max_seq": max_seq},
            mode="prefill")
    cspecs = cache_pspecs(cache_shape, rules, batch=batch, seq=max_seq)
    lspec = logits_pspec(rules, batch=batch, vocab=cfg.vocab_size)

    def step(params, batch_):
        logits, cache = fn(shd.distribute(params, pspecs, rules),
                           shd.distribute(batch_, bspecs, rules))
        return (shd.distribute(logits, lspec, rules),
                shd.distribute(cache, cspecs, rules))

    step.specs = {"params": pspecs, "batch": bspecs, "cache": cspecs,
                  "logits": lspec}
    return step


def build_decode(cfg, rules: shd.ShardingRules, *, max_seq: int, batch: int,
                 batch_shapes, cache_shapes):
    """``step(params, batch, cache) -> (logits, cache)``: one decode step
    laid out over ``rules.mesh`` that writes into the cache it is given
    (see the module docstring: the caller must not reuse that cache)."""

    def fn(params, batch_, cache):
        with shd.use_rules(rules), implicit_replication():
            logits, cache, _ = M.apply(cfg, params, batch_, mode="decode",
                                       cache=cache)
        return logits, cache

    pspecs = shd.param_specs(_meta_params(cfg), rules)
    bspecs = ts.batch_specs(cfg, batch_shapes, rules)
    cspecs = cache_pspecs(cache_shapes, rules, batch=batch, seq=max_seq)
    lspec = logits_pspec(rules, batch=batch, vocab=cfg.vocab_size)

    def step(params, batch_, cache):
        logits, cache = fn(shd.distribute(params, pspecs, rules),
                           shd.distribute(batch_, bspecs, rules),
                           shd.distribute(cache, cspecs, rules))
        return (shd.distribute(logits, lspec, rules),
                shd.distribute(cache, cspecs, rules))

    step.specs = {"params": pspecs, "batch": bspecs, "cache": cspecs,
                  "logits": lspec}
    return step
