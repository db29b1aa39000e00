"""Training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \
        --reduced --steps 100 --global-batch 8 --seq-len 64 \
        --checkpoint-dir /tmp/ckpt [--resume] [--device cpu]

Counterpart of ``repro/launch/train.py``, with its arguments and log line,
plus ``--device`` (the card unless given; ``cpu`` runs the plain kernel
versions).  Wires together: config registry -> model (random init from a
``torch.Generator`` seeded 0) -> AdamW -> synthetic data with host
prefetch -> checkpoint manager (interval + async) -> straggler watchdog.
Every family trains on the card; at full depth and bf16 (12 bytes a
parameter with AdamW) internlm2-1.8b, mamba2-780m, qwen2-vl-2b and
whisper-medium fit on one 80 GB card, zamba2-7b (68.8 GB of params, grads
and state) and deepseek-v2-lite-16b (188.5 GB) need their depth cut, the
larger configs a mesh.  Meshes wait for ROADMAP A11.5.  The launcher feeds
``SyntheticLM`` tokens only, as the reference's does: the enc-dec stack's
``frames`` enter through ``build_train_step``'s batch.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.models import model as M
from repro_torch.runtime.fault_tolerance import CheckpointManager
from repro_torch.runtime.straggler import StepTimeWatchdog
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import TrainSettings, build_train_step


def main(argv=None) -> dict:
    """Returns ``first_loss``, ``final_loss`` and ``params``, and, for the
    callers that time or compare runs, ``losses`` and ``step_seconds`` of
    the steps this run took."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", type=str, default="")
    ap.add_argument("--checkpoint-interval", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", type=str, default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)

    settings = TrainSettings(adamw=opt.AdamWConfig(
        lr=args.lr, warmup_steps=max(args.steps // 20, 1),
        total_steps=args.steps))
    params = M.init_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                           device=device)
    state = opt.init(params, settings.adamw)
    step_fn = build_train_step(cfg, settings, None)

    start = 0
    mgr = None
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir,
                                interval=args.checkpoint_interval)
        if args.resume and mgr.latest_step() is not None:
            (params, state), start = mgr.restore_latest((params, state))
            print(f"resumed from step {start}")

    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq_len,
                                  args.global_batch))
    pf = Prefetcher(data, start_step=start)
    watchdog = StepTimeWatchdog()
    losses, seconds = [], []
    try:
        for i in range(start, args.steps):
            _, batch = pf.next()
            batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            t0 = time.perf_counter()
            params, state, metrics = step_fn(params, state, batch)
            loss = float(metrics["loss"])
            seconds.append(time.perf_counter() - t0)
            straggler = watchdog.observe(seconds[-1])
            losses.append(loss)
            if mgr is not None:
                mgr.maybe_save(i + 1, (params, state))
            if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
                print(f"step {i+1:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f}"
                      + (" [straggler]" if straggler else ""))
    finally:
        pf.close()
        if mgr is not None:
            mgr.wait()
    return {"final_loss": losses[-1] if losses else float("nan"),
            "first_loss": losses[0] if losses else float("nan"),
            "params": params, "losses": losses, "step_seconds": seconds}


if __name__ == "__main__":
    main()
