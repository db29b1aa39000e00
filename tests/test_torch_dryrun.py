"""The port's dry run (repro_torch.launch.dryrun) on a small mesh, as
``tests/test_dryrun_small.py`` runs the reference's: a fake process group
of 16 ranks and a (2, 8) (data, model) mesh, reduced internlm2, qwen3-moe
and mamba2 (vocab 256), a train cell (4 x 32) and a decode cell (8 rows
against a 64-position cache) each, run once on meta tensors through
``run_cell``.  In a subprocess (the fake group must not meet another
test's process group), with its own timeout.

Each record is ok, has every key of the reference's record, counts flops,
bytes and at least one collective, and is written where ``art`` says.  internlm2's per-rank train flops times 16
lie between 1 and FLOPS_SPREAD times the unsharded step's flops (by the
same ``op_cost`` rules): the mesh splits the GEMMs 16 ways, but the
reduced config's 4 heads and 2 kv heads do not split 8 ways, so attention
and its projections are computed whole on each model rank.
"""

import json
import os
import subprocess
import sys
import textwrap

from torch.distributed.tensor import Replicate, Shard

FLOPS_SPREAD = 4.0
TIMEOUT_S = 300

SCRIPT = textwrap.dedent("""
    import dataclasses, json, pathlib, sys
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.analysis import op_cost
    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    art = pathlib.Path(sys.argv[1])
    dryrun.fake_world(16)
    mesh = init_device_mesh("cpu", (2, 8), mesh_dim_names=("data", "model"))
    shapes = {"train": ShapeSpec("t", seq_len=32, global_batch=4,
                                 kind="train"),
              "decode": ShapeSpec("d", seq_len=64, global_batch=8,
                                  kind="decode")}
    out = {}
    for arch in ("internlm2_1_8b", "qwen3_moe_235b_a22b", "mamba2_780m"):
        cfg = dataclasses.replace(get_config(arch).reduced(), vocab_size=256)
        for kind, shape in shapes.items():
            rec = dryrun.run_cell(arch, kind, multi_pod=False, art=art,
                                  cfg=cfg, shape=shape, mesh=mesh)
            out[f"{arch}/{kind}"] = rec
    # the unsharded train step's flops, by the same rules
    cfg = dataclasses.replace(get_config("internlm2_1_8b").reduced(),
                              vocab_size=256)
    params = M.init_params(cfg, generator=torch.Generator(), device="meta")
    settings = ts.TrainSettings()
    state = opt.init(params, settings.adamw)
    mode = op_cost.CostMode()
    with mode:
        ts.build_train_step(cfg, settings)(
            params, state, M.input_specs(cfg, shapes["train"]))
    out["unsharded_train_flops"] = mode.flops
    print("RESULT " + json.dumps(out, default=str))
""")

# the keys of a record of repro/launch/dryrun.py (roofline: single pod)
REF_KEYS = {"arch", "shape", "mesh", "status", "variant", "chips",
            "shard_seq", "lower_s", "compile_s", "argument_size_in_bytes",
            "output_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes", "cost_flops", "cost_bytes",
            "roofline"}


def test_dryrun_pipeline_small_mesh(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                         capture_output=True, text=True, env=env,
                         timeout=TIMEOUT_S, cwd=root)
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr}"
    line = next(x for x in res.stdout.splitlines() if x.startswith("RESULT "))
    out = json.loads(line[len("RESULT "):])
    for arch in ("internlm2_1_8b", "qwen3_moe_235b_a22b", "mamba2_780m"):
        for kind in ("train", "decode"):
            rec = out[f"{arch}/{kind}"]
            assert rec["status"] == "ok", (arch, kind, rec.get("traceback"))
            assert REF_KEYS <= rec.keys(), REF_KEYS - rec.keys()
            assert rec["cost_flops"] > 0 and rec["cost_bytes"] > 0
            assert rec["compile_s"] == 0.0
            assert rec["generated_code_size_in_bytes"] is None
            assert sum(c["count"] for c in rec["collectives"].values()) > 0
            assert rec["chips"] == 16
            terms = rec["roofline"]
            assert terms["bottleneck"] in ("compute", "memory", "collective")
            assert terms["coll_bytes"] == sum(
                c["bytes"] for c in rec["collectives"].values())
            saved = json.loads((tmp_path / f"{arch}__{kind}__single_pod.json")
                               .read_text())
            assert saved["cost_flops"] == rec["cost_flops"]
    ratio = (16 * out["internlm2_1_8b/train"]["cost_flops"]
             / out["unsharded_train_flops"])
    assert 1.0 <= ratio <= FLOPS_SPREAD, ratio
    print(f"internlm2 train: 16 x per-rank flops / unsharded = {ratio:.3f}")


ROWS_SCRIPT = textwrap.dedent("""
    import dataclasses, json, pathlib, sys
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.launch import dryrun

    art = pathlib.Path(sys.argv[1])
    dryrun.fake_world(8)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    shape = ShapeSpec("t", seq_len=64, global_batch=6, kind="train")
    out = {}
    for arch in ("internlm2_1_8b", "mamba2_780m"):
        cfg = dataclasses.replace(get_config(arch).reduced(), vocab_size=256)
        out[arch] = dryrun.run_cell(arch, "train", multi_pod=False, art=art,
                                    cfg=cfg, shape=shape, mesh=mesh)
    print("RESULT " + json.dumps(out, default=str))
""")


def _run(script, *args):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", script, *map(str, args)],
                         capture_output=True, text=True, env=env,
                         timeout=TIMEOUT_S, cwd=root)
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr}"
    line = next(x for x in res.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def test_train_cell_with_rows_the_data_axis_does_not_divide(tmp_path):
    """6 rows on a (data 4, model 2) mesh of fake ranks: ``batch_specs``
    leaves them whole, and no product against a weight split over data
    (FSDP) may put them back on data -- a pointwise op reduce-scatters
    such a partial sum over the rows, unevenly, and the backward's views
    refuse it."""
    out = _run(ROWS_SCRIPT, tmp_path)
    for arch, rec in out.items():
        assert rec["status"] == "ok", (arch, rec.get("traceback"))
        assert rec["cost_flops"] > 0 and rec["chips"] == 8


LONG_SCRIPT = textwrap.dedent("""
    import json, pathlib, sys
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("mamba2_780m", "long_500k", multi_pod=True,
                          art=pathlib.Path(sys.argv[1]))

    # the layout that failed: heads over model, their width over data,
    # merged into one dim; local_call gathers the strided split first
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.distributed import sharding as shd

    mesh = init_device_mesh("cpu", (2, 16, 16),
                            mesh_dim_names=("pod", "data", "model"))
    x = DTensor.from_local(torch.zeros(1, 48, 64), mesh, [Replicate()] * 3,
                           run_check=False)
    y = x.redistribute(placements=[Replicate(), Shard(2), Shard(1)])
    y = y.flatten(1, 2)[:, None]
    z = shd._unstrided(y)
    rec["strided"] = [hasattr(p, "split_factor") for p in y.placements]
    rec["unstrided"] = [repr(p) for p in z.placements]
    rec["unstrided_local"] = list(z.to_local().shape)
    print("RESULT " + json.dumps(rec, default=str))
""")


def test_multi_pod_long_context_decode_cell(tmp_path):
    """Full-width mamba2 at long_500k on the (pod 2, data 16, model 16)
    mesh of 512 fake ranks: the state's 48 heads split over the model axis
    only, so the kernel's plan must keep that layout (splitting over pod
    first left y's heads over model and its width over data, which the
    gated norm's merged view turned into a ``_StridedShard`` that
    ``local_map`` could not gather)."""
    rec = _run(LONG_SCRIPT, tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 512
    assert sum(c["count"] for c in rec["collectives"].values()) > 0
    assert rec["strided"] == [False, True, False]
    assert rec["unstrided"] == [repr(Replicate()), repr(Replicate()),
                                repr(Shard(2))]
    assert rec["unstrided_local"] == [1, 1, 3072 // 16]
