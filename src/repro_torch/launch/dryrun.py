"""Multi-pod dry run: run every (architecture x input shape x mesh) cell's
step once on meta tensors over a fake process group -- nothing is
compiled, allocated or launched -- and record one rank's memory, cost and
collectives, with roofline terms under the H100's datasheet peaks.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2_1_8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]

Artifacts: artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__variant].json

Counterpart of ``repro/launch/dryrun.py``, with the same command line,
cells, flags and rules (``shard_seq`` only for train when S divides the
model axis, ``expert_ff_fsdp`` for ``moe_decode="tp_data"``,
``serve_2d``).  The reference lowers and compiles each step for 256 (512)
host devices; here :func:`main` starts a fake process group of that many
ranks (``torch.testing``'s ``FakeStore``, backend ``"fake"``: this process
is rank 0, and a collective completes at once and moves nothing), builds
``launch/mesh.make_production_mesh`` over it, and runs the cell's step from
``launch/steps.py`` once on DTensors of meta tensors.  On meta every
kernel wrapper takes its plain version (as ``analysis/op_cost.py``'s
static pricing relies on), so nothing launches and nothing is allocated.

A record keeps the reference's keys:

  * ``lower_s`` -- the seconds of the meta run; ``compile_s`` is 0;
  * ``argument_size_in_bytes`` / ``output_size_in_bytes`` -- one rank's
    local bytes of the step's arguments (laid out as the step takes them)
    and of its outputs;
  * ``temp_size_in_bytes`` -- the peak of the bytes live on one rank while
    the step runs, of the tensors it makes (``torch.distributed._tools.
    mem_tracker.MemTracker`` over the local tensors, which works on meta);
  * ``generated_code_size_in_bytes`` -- None (nothing is compiled);
  * ``cost_flops`` / ``cost_bytes`` -- one rank's flops and bytes by
    ``op_cost.CostMode``'s rules over the local shards (the reference's
    per-partition module);
  * ``collectives`` -- per kind (all-gather, all-reduce, reduce-scatter,
    all-to-all, collective-permute) the count and output bytes of the
    collectives one rank issues (DTensor's ``_c10d_functional`` ops, and
    c10d ops called directly), as ``roofline.collective_bytes`` counts a
    collective's result;
  * ``roofline`` (single-pod cells only, as in the reference) -- the
    terms of ``analysis.roofline.RooflineTerms`` from those counts under
    the H100 datasheet peaks below.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.analysis import op_cost
from repro_torch.analysis import roofline
from repro_torch.configs.registry import (ARCH_IDS, SHAPES, get_config,
                                          shapes_for)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.models import model as M
from repro_torch.models import perf
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts
from repro_torch.training.tree import leaves

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# The datasheet peaks of the NVIDIA H100 80GB HBM3 (SXM5, 700 W) -- not
# measurements: bf16 dense tensor-core FLOP/s, HBM3 bytes/s, and NVLink 4
# bytes/s per direction (900 GB/s both ways)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9

_FUNCOL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_C10D = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "collective-permute",
}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def _collective_kind(func):
    """The kind of a collective op (None for any other op) and whether it
    is a c10d op, whose result is its first argument."""
    ns = func.namespace
    name = func.overloadpacket.__name__
    if ns in ("_c10d_functional", "c10d_functional",
              "_c10d_functional_autograd"):
        return _FUNCOL.get(name), False
    if ns == "c10d":
        return _C10D.get(name), True
    return None, False


class DryRunMode(op_cost.CostMode):
    """``op_cost.CostMode`` over one rank's local tensors (DTensor ops are
    passed on, so the mode sees the local ops and the collectives they
    desugar into), counting each collective's kind, number and output
    bytes apart from the flops and bytes."""

    def __init__(self):
        super().__init__()
        self.collectives = {k: {"count": 0, "bytes": 0} for k in KINDS}

    def __enter__(self):
        from torch._guards import active_fake_mode

        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if active_fake_mode() is not self._fake_on_entry:
            # DTensor's sharding propagation: global shapes under a fake
            # mode of its own, not work of this rank
            return func(*args, **(kwargs or {}))
        kind, c10d = _collective_kind(func)
        if kind is None:
            return super().__torch_dispatch__(func, types, args, kwargs)
        out = func(*args, **(kwargs or {}))
        rec = self.collectives[kind]
        rec["count"] += 1
        rec["bytes"] += op_cost._bytes_of(args[0] if c10d else out)
        return out


def local_bytes(tree) -> int:
    """One rank's bytes of the tensors of ``tree`` (a DTensor's local
    shard)."""
    return sum(op_cost.tensor_bytes(t.to_local() if isinstance(t, DTensor)
                                    else t)
               for t in leaves(tree) if isinstance(t, torch.Tensor))


def fake_world(n: int) -> None:
    """Make the default process group a fake one of ``n`` ranks, this
    process rank 0 (a fake group of another size is replaced)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def cell_rules(cfg, shape, mesh, *, multi_pod: bool, flags: perf.PerfFlags,
               shard_seq: bool = False, fsdp: bool = True):
    """The reference's rules for one cell: (rules, shard_seq)."""
    n_model = shd.axis_size(mesh, "model")
    # sequence-parallel activations only when the seq divides the model axis
    shard_seq = ((shard_seq or flags.shard_seq) and shape.kind == "train"
                 and shape.seq_len % n_model == 0)
    rules = mesh_mod.make_rules(mesh, multi_pod=multi_pod,
                                shard_seq=shard_seq, fsdp=fsdp)
    if flags.moe_decode == "tp_data" and shape.kind == "decode" and cfg.is_moe:
        rules = dataclasses.replace(rules, expert_ff_fsdp=True)
    if flags.serve_2d and shape.kind == "decode":
        rules = dataclasses.replace(
            rules, shard_batch=False,
            seq_axes=(*rules.batch_axes, rules.model_axis))
    return rules, shard_seq


def run_step(cfg, shape, rules, *, settings: ts.TrainSettings | None = None):
    """Build the cell's step, lay its meta arguments out over
    ``rules.mesh`` and run it once under :class:`DryRunMode` and a
    ``MemTracker``; returns the measured part of a record.  The caller
    sets the ``perf`` flags."""
    from torch.distributed._tools.mem_tracker import MemTracker

    params = M.init_params(cfg, generator=torch.Generator(), device="meta")
    batch = M.input_specs(cfg, shape)
    grad = shape.kind == "train"
    if grad:
        settings = settings or ts.TrainSettings()
        step = steps_mod.build_train_step(cfg, rules, settings, batch)
        pspecs = shd.param_specs(params, rules)
        params = shd.distribute(params, pspecs, rules)
        state = opt.init(params, settings.adamw)
        args = (params, state,
                shd.distribute(batch, ts.batch_specs(cfg, batch, rules),
                               rules))
    elif shape.kind == "prefill":
        step = steps_mod.build_prefill(cfg, rules, max_seq=shape.seq_len,
                                       batch=shape.global_batch,
                                       batch_shapes=batch)
        args = (params, batch)
    else:  # decode
        cache = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                             device="meta")
        step = steps_mod.build_decode(cfg, rules, max_seq=shape.seq_len,
                                      batch=shape.global_batch,
                                      batch_shapes=batch, cache_shapes=cache)
        args = (params, batch, cache)
    mode, tracker = DryRunMode(), MemTracker()
    with torch.enable_grad() if grad else torch.inference_mode():
        if not grad:
            args = tuple(shd.distribute(a, step.specs[k], rules)
                         for a, k in zip(args, ("params", "batch", "cache")))
        t0 = time.perf_counter()
        with tracker, mode:
            out = step(*args)
        seconds = time.perf_counter() - t0
    peak = tracker.get_tracker_snapshot("peak")
    return {
        "lower_s": seconds, "compile_s": 0.0,
        "argument_size_in_bytes": local_bytes(args),
        "output_size_in_bytes": local_bytes(out),
        "temp_size_in_bytes": max((d.get("Total", 0) for d in peak.values()),
                                  default=0),
        "generated_code_size_in_bytes": None,
        "cost_flops": float(mode.flops), "cost_bytes": float(mode.bytes),
        "collectives": mode.collectives,
    }


def roofline_terms(record: dict, model_flops: float) -> roofline.RooflineTerms:
    """``RooflineTerms`` of one rank's counts under the H100 datasheet
    peaks (:data:`PEAK_FLOPS`, :data:`HBM_BW`, :data:`NVLINK_BW`)."""
    flops, bytes_ = record["cost_flops"], record["cost_bytes"]
    coll = record["collectives"]
    coll_bytes = float(sum(c["bytes"] for c in coll.values()))
    terms = {"compute": flops / PEAK_FLOPS * 1e3,
             "memory": bytes_ / HBM_BW * 1e3,
             "collective": coll_bytes / NVLINK_BW * 1e3}
    mf = model_flops / record["chips"]
    return roofline.RooflineTerms(
        compute_ms=terms["compute"], memory_ms=terms["memory"],
        collective_ms=terms["collective"],
        bottleneck=max(terms, key=terms.get), hlo_flops=flops,
        hlo_bytes=bytes_, coll_bytes=coll_bytes, model_flops=mf,
        model_flops_ratio=(mf / flops) if flops else 0.0,
        roofline_fraction=terms["compute"] / max(max(terms.values()), 1e-12),
        per_collective={**{k: c["bytes"] for k, c in coll.items()},
                        **{k + "_count": c["count"] for k, c in coll.items()}})


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               settings: ts.TrainSettings | None = None,
               shard_seq: bool = False, fsdp: bool = True,
               variant: str = "baseline", cfg=None, shape=None, mesh=None):
    """Run one cell on the production mesh of the current (fake) process
    group; returns (measured record part, cfg, shape).  ``cfg``, ``shape``
    and ``mesh`` replace the registry's config, shape and the production
    mesh (a test's small cells).

    ``variant`` names a ``perf.VARIANTS`` entry; "baseline" is the naive
    configuration."""
    flags = perf.VARIANTS[variant]
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or mesh_mod.make_production_mesh(multi_pod=multi_pod)
    rules, shard_seq = cell_rules(cfg, shape, mesh, multi_pod=multi_pod,
                                  flags=flags, shard_seq=shard_seq, fsdp=fsdp)
    with perf.use_flags(flags):
        meta = run_step(cfg, shape, rules, settings=settings)
    meta.update(chips=mesh.size(), shard_seq=shard_seq, variant=variant)
    return meta, cfg, shape


def _model_flops(cfg, shape) -> float:
    n_active = M.param_count(cfg, active_only=True)
    if shape.kind == "train":
        return roofline.train_model_flops(n_active,
                                          shape.global_batch * shape.seq_len)
    if shape.kind == "prefill":
        return roofline.prefill_model_flops(n_active,
                                            shape.global_batch * shape.seq_len)
    return roofline.decode_model_flops(n_active, shape.global_batch)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             settings=None, tag: str = "", variant: str = "baseline",
             art: pathlib.Path = ART, **override) -> dict:
    """One cell's record, written to ``art``.  Without a ``mesh`` in
    ``override`` (see :func:`lower_cell`) the cell runs on the production
    mesh over a fake process group of its size."""
    mesh_name = "multi_pod" if multi_pod else "single_pod"
    if variant != "baseline" and not tag:
        tag = f"__{variant}"
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "status": "ok", "variant": variant}
    try:
        if override.get("mesh") is None:
            fake_world(512 if multi_pod else 256)
        meta, cfg, shape = lower_cell(arch, shape_name, multi_pod=multi_pod,
                                      settings=settings, variant=variant,
                                      **override)
        record.update(meta)
        if not multi_pod:
            record["roofline"] = roofline_terms(
                record, _model_flops(cfg, shape)).to_dict()
    except Exception as e:  # noqa: BLE001 - recorded, not fatal
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    out = art / f"{arch}__{shape_name}__{mesh_name}{tag}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1, default=str))
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="")
    ap.add_argument("--shape", type=str, default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    help="perf variant (repro_torch.models.perf.VARIANTS)")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str, bool]] = []
    if args.all:
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            for shape in shapes_for(cfg):
                if not args.multi_pod_only:
                    cells.append((arch, shape.name, False))
                if not args.single_pod_only:
                    cells.append((arch, shape.name, True))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells.append((args.arch, args.shape, args.multi_pod))

    failures = 0
    try:
        for arch, shape, mp in cells:
            t0 = time.perf_counter()
            rec = run_cell(arch, shape, multi_pod=mp, variant=args.variant)
            dt = time.perf_counter() - t0
            mesh_name = "multi_pod" if mp else "single_pod"
            if rec["status"] == "ok":
                r = rec.get("roofline") or {}
                coll = sum(c["bytes"] for c in rec["collectives"].values())
                print(f"OK   {arch:24s} {shape:12s} {mesh_name:10s} "
                      f"run={rec['lower_s']:.1f}s "
                      f"flops={rec['cost_flops']:.4g} "
                      f"bytes={rec['cost_bytes']:.4g} coll={coll:.4g} "
                      f"bottleneck={r.get('bottleneck', '-'):10s} "
                      f"frac={r.get('roofline_fraction', 0):.3f} ({dt:.1f}s)")
            else:
                failures += 1
                print(f"FAIL {arch:24s} {shape:12s} {mesh_name:10s} "
                      f"{rec['error']}")
            sys.stdout.flush()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
