"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Drives the PyTorch/CUDA port
(``src/repro_torch``) on the card; with no card, or fewer cards than the
cell asks for, it fails and prints no result.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` (and ``breakdown`` with ``--trace 1``), and
last ``checks``: each number compared beside its limit, which also end
standard error.  Earlier lines give each set-up step's seconds, the card's
name and power limit, and the peak device memory.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def log(msg: str) -> None:
    print(msg, flush=True)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, *,
             t_start: float, cfg=None, fault=None,
             control: bool = False) -> dict:
    """Set up, serve, measure and judge one run of ``cell``.  ``cfg``
    (default: the configuration file's) and ``fault`` (``fault(eng, rec)``
    breaks the timed path once the benchmark's wrappers are on) are for
    the tests; ``control`` adds the fp8 control's readings of the same
    sample under ``readings``, for ``control.py``."""
    import torch

    from harness import correct as C
    from harness import driver as D
    from harness import readers as R
    from harness import spec as S

    conf, traffic = cell.config, cell.traffic
    b = D.setup(cell, seed, traffic["warm_s"] + seconds, device, cfg=cfg,
                fault=fault)
    eng, rec, params, steps = b.eng, b.rec, b.params, b.steps
    if device.type == "cuda":
        log(f"set-up: peak device memory "
            f"{torch.cuda.max_memory_allocated(device)} bytes")
        torch.cuda.reset_peak_memory_stats(device)
    # the traced sub-window closes the window, 0.5 s before its end
    trace_at = None
    if trace:
        length = min(traffic["trace_s"], seconds / 3)
        trace_at = (seconds - length - 0.5, length)
    t = time.monotonic()
    served = D.serve(eng, rec, traffic, b.plans, seed, conf["vocab_size"],
                     warm_s=traffic["warm_s"], seconds=seconds,
                     trace_at=trace_at)
    steps["warm_traffic"] = served.w0 - t
    setup_s = served.w0 - t_start
    log("set-up seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in steps.items())
        + f"; setup_s {setup_s:.3f}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run = R.Run(conf=conf, traffic=traffic, seconds=seconds, served=served,
                rec=rec, setup_s=setup_s, trace=served.trace)

    # the results the readers need are in ``run``; free the program's
    # state before the reference runs beside the weights
    values = {}
    for m in cell.metrics(trace):
        v = R.finite(S.load_module("metrics", m["name"]).read(run))
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    window = run.window_jobs()
    failed = sum(not j.ok for j in window) + len(served.unfinished)
    errors = sorted({j.error for j in window if not j.ok})
    spans = rec.spans
    rec.remove()
    eng.close()
    del eng, rec, b
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    sample = C.sample(run.ok_jobs(), seed, traffic["sample_jobs"])
    t = time.monotonic()
    got = (C.reference_gaps(conf, params, sample, seed, device,
                            control=control) if sample else {})
    log(f"reference: {len(sample)} jobs, {got.get('tokens', 0)} served "
        f"tokens in {time.monotonic() - t:.2f} s")
    ok, checks = C.judge(got, cell.limits)

    result = {"correct": ok, "attempted": len(window) + len(served.unfinished),
              "failed": failed, "metrics": values,
              "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": cell.workload["chips"],
                         "memory_peak_bytes": int(peak)}}
    if served.trace is not None:
        from harness import trace as TR

        result["device"]["busy_s"] = served.trace.busy_s
        result["device"]["window_s"] = served.trace.window_s
        result["breakdown"] = {
            "device_ops": TR.device_ops(served.trace),
            "idle_gaps": TR.name_gaps(served.trace, spans)}
    if errors:
        log(f"failed jobs: {failed}; errors: {errors[:5]}")
    if control:
        result["readings"] = got
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import spec as S

    cell = S.load_cell(args.workload)
    import torch

    need = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"no result: the cell needs {need} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    log(f"card: {card_line()}")
    device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, t_start=T_START)
    log(f"peak device memory: {result['device']['memory_peak_bytes']} bytes "
        f"(torch.cuda.max_memory_allocated over the window)")
    bad = forbidden_modules()
    if bad:
        print(f"no result: modules of JAX or the JAX package are loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    out = pathlib.Path(HERE / "out")
    out.mkdir(exist_ok=True)
    with open(out / "results.jsonl", "a") as f:
        f.write(json.dumps({"workload": args.workload, "seed": args.seed,
                            "seconds": args.seconds, "trace": args.trace,
                            **result}) + "\n")
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
