"""What the program's tracing costs on the card, and where a cell's idle
time falls.

    python3 portbench/tracing_cost.py --workload <name> --seed <n> \
        --seconds <s>

One set-up on the card, then four windows of the cell's traffic in turns,
the program's tracing off, on, on, off.  Each window closes with a
profiled sub-window placed as a ``--trace 1`` run places its traced one;
in the "on" turns the program's tracing follows the profiler, as in a
``--trace 1`` run, and in the "off" turns it is switched off
(``ServeEngine.set_tracing(False)``).  For each turn it prints the mean ``batch_meta``
seconds of the decode calls recorded inside the sub-window and, as a
control for the host's drift, of those recorded in the window before it
(no profiler, tracing off); in the "on" turns also the readers of the
program's spans, the decode calls' steps over their seconds, the share of
the idle time in which a server waited on its stream, and the ten longest
idle gaps with the spans open in them.  The cost of tracing is the "on"
turns' mean decode seconds over the "off" turns'.  Not part of a
benchmark run.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

import run as RUN  # puts the harness and the port on sys.path

TURNS = ("off", "on", "on", "off")
SPAN_METRICS = ("decode_stage_ms", "decode_wait_ms", "decode_readback_ms",
                "client_wake_ms", "decode_coalesced_share",
                "idle_in_call_share", "idle_no_request_share")


def mean_ms(values):
    return 1e3 * statistics.fmean(values) if values else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default="chiprun_out",
                    help="directory of the JSON record")
    args = ap.parse_args(argv)

    import torch

    from harness import driver as D
    from harness import readers as R
    from harness import spans as SP
    from harness import spec as S

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    card = RUN.card_line()
    print(f"card: {card}", flush=True)
    cell = S.load_cell(args.workload)
    traffic = cell.traffic
    length = min(traffic["trace_s"], args.seconds / 3)
    trace_at = (args.seconds - length - 0.5, length)
    b = D.setup(cell, args.seed, traffic["warm_s"] + args.seconds,
                torch.device("cuda", 0))
    eng, rec = b.eng, b.rec
    readers = [m["name"] for m in cell.metrics(True)
               if m["name"].rsplit(".", 1)[0] in SPAN_METRICS]
    turns = []
    try:
        for turn in TURNS:
            rec.meta.clear()
            eng.set_tracing(None if turn == "on" else False)
            served = D.serve(eng, rec, traffic, b.plans, args.seed,
                             cell.config["vocab_size"],
                             warm_s=traffic["warm_s"], seconds=args.seconds,
                             trace_at=trace_at)
            tr = served.trace
            run = R.Run(conf=cell.config, traffic=traffic,
                        seconds=args.seconds, served=served, rec=rec,
                        setup_s=0.0, trace=tr)
            decode = [(t, m["seconds"]) for t, _, m in rec.meta
                      if m["kind"].split("@")[0] == "decode"]
            inside = [x for t, x in decode if tr.t0 <= t <= tr.t1]
            out = {"turn": turn, "calls": len(inside),
                   "decode_ms_sub_window": mean_ms(inside),
                   "decode_ms_before": mean_ms(
                       [x for t, x in decode if served.w0 <= t < tr.t0]),
                   "device_idle_share": R.idle_share(run)}
            if turn == "on" and SP.records(run) is not None:
                calls = SP.decode_calls(run)
                steps = sum(sum(c["steps"].values()) for c in calls)
                secs = sum(c["meta"]["seconds"] for c in calls)
                out["traced_calls"] = len(calls)
                out["steps_over_seconds"] = steps / secs if secs else None
                out["metrics"] = {
                    n: R.finite(S.load_module("metrics", n).read(run))
                    for n in readers}
                out["idle_in_wait_share"] = SP.idle_share_in(run, ("wait",))
                out["idle_gaps_ms"] = SP.named_gaps(run)
            print(json.dumps(out), flush=True)
            turns.append(out)
    finally:
        rec.remove()
        eng.close()

    def mean(turn, key):
        return statistics.fmean(t[key] for t in turns if t["turn"] == turn)

    off, on = (mean(t, "decode_ms_sub_window") for t in ("off", "on"))
    drift = mean("on", "decode_ms_before") / mean("off", "decode_ms_before")
    summary = {"cost_pct": 100.0 * (on / off - 1),
               "cost_pct_drift_corrected": 100.0 * (on / off / drift - 1)}
    print("summary " + json.dumps(summary), flush=True)
    path = pathlib.Path(args.out)
    path.mkdir(exist_ok=True)
    with open(path / f"tracing_cost_{args.workload}_{args.seed}.json",
              "w") as f:
        json.dump({"card": card, "workload": args.workload,
                   "seed": args.seed, "seconds": args.seconds,
                   "turns": turns, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
