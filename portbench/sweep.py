"""Find a cell's knee once: the highest release rate at which at least 95%
of the jobs released in a window meet their deadline and the backlog does
not grow over it.

    python3 portbench/sweep.py --workload <name> --seed <n> --seconds <s> \
        --periods 4000 3000 2500 ...

runs on the card in one process: one set-up, then one window of the
cell's traffic (its own warm-up first) at each stream period given, each
with its deadline equal to the period.  For each it prints the jobs
released a second, the share that met the deadline, the decode tokens a
second, the p95 of job latency, first token and token gap, and the mean
lateness of job starts behind their release in the first and in the last
third of the window (a backlog that grows shows as a later third that
starts later).  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run as RUN  # puts the harness and the port on sys.path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--periods", type=float, nargs="+", required=True)
    ap.add_argument("--declared-decode-ms", type=float, default=None,
                    help="admit with this decode segment cost, so that "
                         "admission refuses no stream of the sweep")
    args = ap.parse_args(argv)

    import torch

    from harness import driver as D
    from harness import readers as R
    from harness import spec as S
    from harness import traffic as T

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {RUN.card_line()}", flush=True)
    cell = S.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    base = dict(cell.traffic)
    if args.declared_decode_ms is not None:
        base["declared"] = dict(base["declared"],
                                decode_ms=args.declared_decode_ms)
    b = D.setup(cell, args.seed, base["warm_s"] + args.seconds, dev,
                traffic=base)
    eng, rec = b.eng, b.rec
    try:
        for period in args.periods:
            traffic = dict(base, period_ms=period)
            for i in range(traffic["streams"]):
                eng.remove(f"s{i}")
            admitted = D.admit(eng, traffic, traffic["streams"])
            plans = T.plan(traffic, args.seed, traffic["warm_s"] + args.seconds)
            rec.decode_calls.clear()
            rec.prefill_calls.clear()
            rec.meta.clear()
            t = time.monotonic()
            served = D.serve(eng, rec, traffic, plans, args.seed,
                             cell.config["vocab_size"],
                             warm_s=traffic["warm_s"], seconds=args.seconds)
            run = R.Run(conf=cell.config, traffic=traffic,
                        seconds=args.seconds, served=served, rec=rec,
                        setup_s=0.0)
            jobs = run.window_jobs()
            third = args.seconds / 3
            late = [[(j.start - j.release) * 1e3 for j in jobs
                     if served.w0 + k * third <= j.release
                     < served.w0 + (k + 1) * third] for k in (0, 2)]
            row = {
                "period_ms": period,
                "admitted": sum(admitted),
                "jobs_per_s": len(jobs) / args.seconds,
                "failed": sum(not j.ok for j in jobs) + len(served.unfinished),
                "deadline_met_pct": R.deadline_met_share(run),
                "tokens_per_s": len(R.decode_tokens_in_window(run)) / args.seconds,
                "job_p95_ms": R.p95(R.job_ms(run)),
                "ttft_p95_ms": R.p95(R.ttft_ms(run)),
                "token_gap_p95_ms": R.p95(R.token_gaps_ms(run)),
                "rows_per_decode_call": R.mean([m["rows"] for m in run.meta("decode")]),
                "decode_call_ms": (R.mean([m["seconds"] for m in run.meta("decode")]) or 0) * 1e3,
                "prefill_wait_ms": (R.mean([j.prefill_wait for j in jobs if j.ok]) or 0) * 1e3,
                "prefill_calls": len(run.meta("prefill")),
                "rows_per_prefill_call": R.mean([m["rows"] for m in run.meta("prefill")]),
                "late_first_third_ms": R.mean(late[0]),
                "late_last_third_ms": R.mean(late[1]),
                "wall_s": time.monotonic() - t,
            }
            print("sweep " + json.dumps(row), flush=True)
    finally:
        rec.remove()
        eng.close()
    return 0


if __name__ == "__main__":
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    sys.exit(main())
