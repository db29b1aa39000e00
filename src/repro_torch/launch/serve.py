"""Serving driver: the paper's server-based access control, live.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2_1_8b \
        --streams 3 --requests 5 --steps 8 [--device cpu]

Counterpart of ``repro/launch/serve.py``, with its arguments and report,
plus ``--device`` (the card unless given; ``cpu`` runs the plain kernel
versions).  Starts one ServeEngine (AcceleratorServer + analysis-driven
admission) on the reduced config with ``max_seq=64`` and weights drawn
from a ``torch.Generator`` seeded 7, admits N prioritized streams, runs
their generation jobs concurrently from client threads (which suspend
between segments — never busy-wait), and reports per-stream latency
percentiles + the admission decisions.  The engine takes its defaults, as
the reference's launcher does: unbatched, so each job is a dense
``generate`` (``flash_attention`` prefill, ``decode_attention`` decode,
``rmsnorm`` around every layer).
"""

from __future__ import annotations

import argparse
import threading

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.models import model as M
from repro_torch.serving.engine import ServeEngine, StreamSpec


def main(argv=None) -> dict:
    """Returns the report: per admitted stream, its prefill p50 and decode
    p50 / p99 in ms."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--streams", type=int, default=3)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--ordering", default="priority",
                    choices=["priority", "fifo", "edf"])
    ap.add_argument("--device", type=str, default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = M.init_params(cfg, generator=torch.Generator(device).manual_seed(7),
                           device=device)
    engine = ServeEngine(cfg, params, max_seq=64, ordering=args.ordering,
                         device=device)

    results: dict[str, list] = {}
    decisions = {}
    threads = []
    for i in range(args.streams):
        name = f"stream{i}"
        spec = StreamSpec(name=name, priority=args.streams - i,
                          period_ms=500.0, deadline_ms=500.0,
                          prefill_ms=40.0, decode_ms=10.0,
                          decode_steps=args.steps)
        decisions[name] = engine.admit(spec)
        if not decisions[name].admitted:
            print(f"{name}: REJECTED ({decisions[name].reason})")
            continue

        def work(name=name, seed=i):
            rng = np.random.RandomState(seed)
            out = []
            for _ in range(args.requests):
                prompt = rng.randint(0, cfg.vocab_size, (1, 8)).astype(np.int32)
                out.append(engine.generate(name, prompt, steps=args.steps))
            results[name] = out

        threads.append(threading.Thread(target=work))

    for t in threads:
        t.start()
    for t in threads:
        t.join()

    report = {}
    for name, runs in sorted(results.items()):
        pre = [r.prefill_latency_s * 1e3 for r in runs]
        dec = [d * 1e3 for r in runs for d in r.decode_latencies_s]
        report[name] = {"prefill_p50_ms": float(np.percentile(pre, 50)),
                        "decode_p50_ms": float(np.percentile(dec, 50)),
                        "decode_p99_ms": float(np.percentile(dec, 99))}
        print(f"{name}: prefill p50 {report[name]['prefill_p50_ms']:.1f}ms  "
              f"decode p50 {report[name]['decode_p50_ms']:.1f}ms  "
              f"p99 {report[name]['decode_p99_ms']:.1f}ms")
    print(f"server completed {engine.server.stats.completed} requests, "
          f"max queue {engine.server.stats.max_queue_len}")
    engine.close()
    return report


if __name__ == "__main__":
    main()
