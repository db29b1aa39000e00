"""The readings the limits of ``correct`` are set from, on the card.

    python3 portbench/control.py --workload <name> --seconds <s> \
        --seeds 1 2 3 ... [--faults 3]

Each seed is one whole run of the cell through ``run.run_cell``, the path
``run.py`` takes (its own set-up, weights, warm-up, a window of
``seconds`` at the cell's load, the drain and the sample), in a process
of its own, as every benchmark run is.  Its line gives the program's
readings against the plain fp32 reference (``max_gap``, ``mean_gap``,
``mismatch_pct``) and the control's (``control_*``: the reference with
every weight rounded to fp8 e4m3, the precision below the
configuration's bf16) on the same sample.  For the
first ``--faults`` seeds, each fault of ``harness/faults.py`` is then
planted under the timed path in a run of its own, and its compared
numbers and ``correct`` are printed.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import run as RUN  # puts the harness and the port on sys.path


def one(workload: str, seed: int, seconds: float, fault: str | None) -> None:
    """One run of the cell on the card, and its line."""
    import torch

    from harness import spec as S
    from harness.faults import FAULTS

    cell = S.load_cell(workload)
    dev = torch.device("cuda", 0)
    t = time.monotonic()
    res = RUN.run_cell(cell, seed, seconds, False, dev, t_start=t,
                       fault=FAULTS[fault] if fault else None,
                       control=fault is None)
    tag = f"fault {fault}" if fault else "control"
    print(f"{tag} " + json.dumps({
        "seed": seed, "correct": res["correct"],
        "attempted": res["attempted"], "failed": res["failed"],
        **res.get("readings", {}), "checks": res["checks"],
        "wall_s": time.monotonic() - t}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=0,
                    help="plant each fault in runs of this many seeds")
    ap.add_argument("--one", default=None, metavar="FAULT",
                    help="run the first seed alone in this process, with "
                         "this fault ('none': the control)")
    args = ap.parse_args(argv)

    import torch

    from harness.faults import FAULTS

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    if args.one is not None:
        one(args.workload, args.seeds[0], args.seconds,
            None if args.one == "none" else args.one)
        return 0
    print(f"card: {RUN.card_line()}", flush=True)
    runs = [(seed, "none") for seed in args.seeds]
    runs += [(seed, name) for seed in args.seeds[:args.faults]
             for name in FAULTS]
    rc = 0
    for seed, fault in runs:
        rc |= subprocess.run(
            [sys.executable, __file__, "--workload", args.workload,
             "--seconds", str(args.seconds), "--seeds", str(seed),
             "--one", fault]).returncode
    return rc


if __name__ == "__main__":
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    sys.exit(main())
