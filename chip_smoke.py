#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. card: name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from ``src/repro_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's full-width shapes, in fp32 and bf16 (ragged lengths,
   scratch-block table lanes, length 0, prefill buckets 8 and 256), then
   its median time beside the plain version's, the library call's and its
   bound;
4. main path, fp32: full-width internlm2-1.8b (random weights from a seed)
   served by ``ServeEngine(batching=True, paged=True)`` -- 4 streams on 2
   servers -- must give the greedy tokens of unbatched ``generate``, use
   both servers and leak no KV block;
5. main path, bf16 (the config's dtype): the same traffic, timed;
6. launch counts of every kernel over phases 4-5 (each must be non-zero),
   then one JSON line describing every kernel;
7. last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
BLOCK = 16          # kv_block_size of the main path
MAX_SEQ = 512
PROMPT_LENS = (5, 40, 100, 200)
STEPS = 32
BUCKETS = (8, 64, 128, 256)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py
# published H100 SXM peaks (dense): HBM bytes/s and flop/s by input type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

KERNELS = {
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:34"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:76"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:91"),
    "paged_decode_attention": (
        "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/paged_decode_attention.py:62"),
}


class SmokeFailure(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, *, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time per call of ``iters``
    back-to-back calls (for calls shorter than their host cost this is the
    host's issue rate, not the kernel's)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


class KernelChecks:
    def __init__(self, dev):
        self.dev = dev
        self.gen = torch.Generator(device=dev).manual_seed(SEED)
        self.errors: dict[str, float] = {}
        self.rows: dict[str, dict] = {}

    def randn(self, *shape, dtype=torch.float32):
        return torch.randn(shape, generator=self.gen, device=self.dev).to(dtype)

    def check(self, name: str, case: str, got, want, dtype) -> float:
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        tol = TOL[dtype]
        ok = bool(torch.isfinite(got).all()) and bool(
            ((got - want).abs() <= tol + tol * want.abs()).all())
        print(f"check {name} [{case}] {str(dtype)[6:]}: max_abs_err={err:.3e}"
              f" (tol {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"{name} [{case}] disagrees with its plain "
                               f"version: max_abs_err={err}")
        return err

    def table(self, lengths, w, nb, scratch=0):
        """Block tables with each row's live blocks drawn without
        replacement from the pool, lanes past them on the scratch block."""
        perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(
            SEED)) + 1
        tables = torch.full((len(lengths), w), scratch, dtype=torch.int32)
        used = 0
        for i, n in enumerate(lengths):
            need = -(-n // BLOCK)
            tables[i, :need] = perm[used:used + need].to(torch.int32)
            used += need
        return tables.to(self.dev)

    def run(self, cfg):
        from repro_torch.kernels.decode_attention import (
            decode_attention, decode_attention_plain)
        from repro_torch.kernels.flash_attention import (
            flash_attention, flash_attention_plain)
        from repro_torch.kernels.paged_decode_attention import (
            paged_decode_attention, paged_decode_attention_plain)
        from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

        d, nq, nkv, h = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        eps = cfg.norm_eps
        lengths = [1, 41, 101, 233]  # ragged; 233 = prompt 200 + 32 steps + 1
        nb = 4 * (MAX_SEQ // BLOCK) + 1  # engine default pool: 4 rows + scratch
        ok_len = torch.tensor(lengths, dtype=torch.int32, device=self.dev)
        zero_len = torch.tensor([0, 5], dtype=torch.int32, device=self.dev)
        dev = self.dev
        for dt in (torch.float32, torch.bfloat16):
            # rmsnorm: a 4-row decode step and a 256-token prefill
            w = (self.randn(d) * 0.1 + 1.0).to(dt)
            for shape in ((4, 1, d), (1, 256, d)):
                x = self.randn(*shape, dtype=dt)
                e = self.check("rmsnorm", f"x{shape}", rmsnorm(x, w, eps),
                               rmsnorm_plain(x, w, eps), dt)
                self.errors["rmsnorm"] = max(self.errors.get("rmsnorm", 0), e)
            # flash: prefill buckets 8 and 256, and a ragged 40 tokens
            for b, s in ((4, 8), (2, 256), (1, 40)):
                q = self.randn(b, s, nq, h, dtype=dt)
                k = self.randn(b, s, nkv, h, dtype=dt)
                v = self.randn(b, s, nkv, h, dtype=dt)
                e = self.check("flash_attention", f"B={b} S={s}",
                               flash_attention(q, k, v),
                               flash_attention_plain(q, k, v), dt)
                self.errors["flash_attention"] = max(
                    self.errors.get("flash_attention", 0), e)
            # dense decode over a (B, max_seq, Nkv, H) cache
            q = self.randn(4, nq, h, dtype=dt)
            kc = self.randn(4, MAX_SEQ, nkv, h, dtype=dt)
            vc = self.randn(4, MAX_SEQ, nkv, h, dtype=dt)
            e = self.check("decode_attention", f"lengths={lengths}",
                           decode_attention(q, kc, vc, ok_len),
                           decode_attention_plain(q, kc, vc, ok_len), dt)
            self.errors["decode_attention"] = max(
                self.errors.get("decode_attention", 0), e)
            out0 = decode_attention(q[:2], kc[:2], vc[:2], zero_len)
            self.check("decode_attention", "length 0 -> 0", out0[0],
                       torch.zeros_like(out0[0]), dt)
            # paged decode: scratch block 0 holds garbage no row may read
            kp = self.randn(nb, BLOCK, nkv, h, dtype=dt)
            vp = self.randn(nb, BLOCK, nkv, h, dtype=dt)
            kp[0], vp[0] = 1e4, -1e4
            w_max = MAX_SEQ // BLOCK
            tables = self.table(lengths, w_max, nb)
            e = self.check("paged_decode_attention",
                           f"lengths={lengths} W={w_max} scratch lanes",
                           paged_decode_attention(q, kp, vp, tables, ok_len),
                           paged_decode_attention_plain(q, kp, vp, tables,
                                                        ok_len), dt)
            self.errors["paged_decode_attention"] = max(
                self.errors.get("paged_decode_attention", 0), e)
            out0 = paged_decode_attention(q[:2], kp, vp, tables[:2], zero_len)
            self.check("paged_decode_attention", "length 0 -> 0", out0[0],
                       torch.zeros_like(out0[0]), dt)
            # paged == dense decode when the dense tile equals the block size
            kd = kp[tables.long()].reshape(4, -1, nkv, h)
            vd = vp[tables.long()].reshape(4, -1, nkv, h)
            self.check("paged_decode_attention", "equals dense decode",
                       paged_decode_attention(q, kp, vp, tables, ok_len),
                       decode_attention(q, kd, vd, ok_len, block_k=BLOCK), dt)
        self.time_all(cfg, nb)

    def time_all(self, cfg, nb):
        """Times at main-path shapes in bf16 (the config's dtype)."""
        import torch.nn.functional as F

        from repro_torch.kernels.decode_attention import (
            decode_attention, decode_attention_plain)
        from repro_torch.kernels.flash_attention import (
            flash_attention, flash_attention_plain)
        from repro_torch.kernels.paged_decode_attention import (
            paged_decode_attention, paged_decode_attention_plain)
        from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

        dt = torch.bfloat16
        el = 2
        d, nq, nkv, h = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        eps = cfg.norm_eps
        rows = {}

        # rmsnorm on one decode step of 4 rows
        x = self.randn(4, 1, d, dtype=dt)
        w = (self.randn(d) * 0.1 + 1.0).to(dt)
        n = x.numel()
        rows["rmsnorm"] = dict(
            shape=f"x (4,1,{d})",
            ms=time_ms(lambda: rmsnorm(x, w, eps)),
            plain_ms=time_ms(lambda: rmsnorm_plain(x, w, eps)),
            library_ms=time_ms(lambda: F.rms_norm(x, (d,), w, eps)),
            bound=bound_ms((2 * n + d) * el, 4 * n, dt))

        # flash on one 256-token prefill
        s = 256
        q = self.randn(1, s, nq, h, dtype=dt)
        k = self.randn(1, s, nkv, h, dtype=dt)
        v = self.randn(1, s, nkv, h, dtype=dt)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = s * (s + 1) // 2
        rows["flash_attention"] = dict(
            shape=f"q (1,{s},{nq},{h}) causal",
            ms=time_ms(lambda: flash_attention(q, k, v)),
            plain_ms=time_ms(lambda: flash_attention_plain(q, k, v)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            bound=bound_ms((2 * q.numel() + 2 * k.numel()) * el,
                           4 * nq * h * pairs, dt))

        # decode at the main path's end: lengths of 4 streams after 32 steps
        lengths = [p + STEPS + 1 for p in PROMPT_LENS]
        lens = torch.tensor(lengths, dtype=torch.int32, device=self.dev)
        live = sum(lengths)
        q = self.randn(4, nq, h, dtype=dt)
        kc = self.randn(4, MAX_SEQ, nkv, h, dtype=dt)
        vc = self.randn(4, MAX_SEQ, nkv, h, dtype=dt)
        mask = (torch.arange(MAX_SEQ, device=self.dev)[None, :]
                < lens[:, None])[:, None, None, :]
        kv_bytes = 2 * live * nkv * h * el
        q_bytes = 2 * q.numel() * el + 4 * 4
        rows["decode_attention"] = dict(
            shape=f"q (4,{nq},{h}), cache (4,{MAX_SEQ},{nkv},{h}), "
                  f"lengths {lengths}",
            ms=time_ms(lambda: decode_attention(q, kc, vc, lens)),
            plain_ms=time_ms(lambda: decode_attention_plain(q, kc, vc, lens)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)),
            bound=bound_ms(kv_bytes + q_bytes, 4 * nq * h * live, dt))

        w_cols = -(-max(lengths) // BLOCK)
        w_cols = 1 << (w_cols - 1).bit_length()  # the engine's pow2 width
        kp = self.randn(nb, BLOCK, nkv, h, dtype=dt)
        vp = self.randn(nb, BLOCK, nkv, h, dtype=dt)
        tables = self.table(lengths, w_cols, nb)
        kg = kp[tables.long()].reshape(4, -1, nkv, h).transpose(1, 2)
        vg = vp[tables.long()].reshape(4, -1, nkv, h).transpose(1, 2)
        gmask = mask[..., : w_cols * BLOCK]
        rows["paged_decode_attention"] = dict(
            shape=f"q (4,{nq},{h}), pool ({nb},{BLOCK},{nkv},{h}), "
                  f"W={w_cols}, lengths {lengths}",
            ms=time_ms(lambda: paged_decode_attention(q, kp, vp, tables, lens)),
            plain_ms=time_ms(lambda: paged_decode_attention_plain(
                q, kp, vp, tables, lens)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kg, vg, attn_mask=gmask, enable_gqa=True)),
            bound=bound_ms(kv_bytes + q_bytes + tables.numel() * 4,
                           4 * nq * h * live, dt))
        for name, r in rows.items():
            b, by = r["bound"]
            print(f"time {name} bf16 {r['shape']}: kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']:.4f} ms, bound {b:.5f} ms ({by})")
        self.rows = rows


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------


def _spec(name, prio):
    from repro_torch.serving.engine import StreamSpec

    return StreamSpec(name=name, priority=prio, period_ms=60000.0,
                      deadline_ms=60000.0, prefill_ms=50.0, decode_ms=5.0,
                      decode_steps=STEPS)


def _prompts(vocab: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(SEED)
    return {f"s{i}": rng.integers(0, vocab, size=(1, n), dtype=np.int32)
            for i, n in enumerate(PROMPT_LENS)}


def serve_batched(cfg, params, prompts, dev):
    """4 streams on 2 servers through the paged batched engine."""
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import ServeEngine

    eng = ServeEngine(cfg, params, max_seq=MAX_SEQ, num_servers=2,
                      batching=True, max_batch=4, paged=True,
                      kv_block_size=BLOCK, device=dev)
    try:
        t0 = time.monotonic()
        rep = eng.precompile(prompt_buckets=BUCKETS)
        warm_s = time.monotonic() - t0
        _build.reset_launches()  # count the traffic's launches, not warm-up's
        for i, name in enumerate(prompts):
            if not eng.admit(_spec(name, len(prompts) - i)).admitted:
                raise SmokeFailure(f"stream {name} not admitted")
        servers = {eng.pool.server_of(n) for n in prompts}
        results, errors = {}, []

        def worker(name):
            try:
                results[name] = eng.generate(name, prompts[name], steps=STEPS)
            except BaseException as e:  # surfaced below, never swallowed
                errors.append(e)

        t0 = time.monotonic()
        threads = [threading.Thread(target=worker, args=(n,)) for n in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall_s = time.monotonic() - t0
        if errors:
            raise errors[0]
        if any(t.is_alive() for t in threads):
            raise SmokeFailure("a stream did not finish")
        usage = eng.kv_usage()
        calls = [m for s in eng.pool.servers for m in s.stats.batch_meta
                 if m["kind"] == "decode"]
        return dict(results=results, servers=servers, usage=usage,
                    wall_s=wall_s, warm_s=warm_s, precompile=rep,
                    launches=dict(_build.launches), decode_calls=calls)
    finally:
        eng.close()


def serve_unbatched(cfg, params, prompts, dev):
    """The reference: each stream alone through unbatched ``generate``
    (dense cache, decode_attention).  Returns (results, launches)."""
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import ServeEngine

    eng = ServeEngine(cfg, params, max_seq=MAX_SEQ, kv_block_size=BLOCK,
                      device=dev)
    _build.reset_launches()
    try:
        out = {}
        for i, name in enumerate(prompts):
            if not eng.admit(_spec(name, len(prompts) - i)).admitted:
                raise SmokeFailure(f"stream {name} not admitted")
            out[name] = eng.generate(name, prompts[name], steps=STEPS)
        return out, dict(_build.launches)
    finally:
        eng.close()


def check_outputs(run, prompts):
    for name, res in run["results"].items():
        if len(res.tokens) != STEPS or len(res.decode_latencies_s) != STEPS:
            raise SmokeFailure(f"{name}: {len(res.tokens)} tokens, want {STEPS}")
    if run["servers"] != {0, 1}:
        raise SmokeFailure(f"streams used servers {run['servers']}, not both")
    if any(run["usage"].values()):
        raise SmokeFailure(f"leaked KV resources: {run['usage']}")


def main_path(dev, card):
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M

    base = get_config("internlm2_1_8b")
    prompts = _prompts(base.vocab_size)

    # phase 4: fp32, batched tokens must equal unbatched generate's
    cfg32 = dataclasses.replace(base, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.monotonic()
    params = M.init_params(cfg32, generator=gen, device=dev)
    torch.cuda.synchronize()
    print(f"main fp32: init {M.param_count(cfg32) / 1e9:.3f} B params in "
          f"{time.monotonic() - t0:.1f} s")
    run = serve_batched(cfg32, params, prompts, dev)
    ref, ref_launches = serve_unbatched(cfg32, params, prompts, dev)
    counts = Counter(run["launches"]) + Counter(ref_launches)
    check_outputs(run, prompts)
    for name in prompts:
        got, want = run["results"][name].tokens, ref[name].tokens
        same = got == want
        print(f"main fp32 {name} prompt {prompts[name].shape[1]}: batched "
              f"tokens {'==' if same else '!='} unbatched "
              f"(first {got[:8]})")
        if not same:
            raise SmokeFailure(f"{name}: batched {got} != unbatched {want}")
    print(f"main fp32: servers used {sorted(run['servers'])}, kv_usage "
          f"{run['usage']}, precompiled {run['precompile'].compiled} cells")
    report_latency("fp32", run, card)
    del params, run, ref
    torch.cuda.empty_cache()

    # phase 5: bf16, timed
    cfg16 = base
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init_params(cfg16, generator=gen, device=dev)
    torch.cuda.synchronize()
    run = serve_batched(cfg16, params, prompts, dev)
    counts += Counter(run["launches"])
    check_outputs(run, prompts)
    report_latency("bf16", run, card)
    for name, res in run["results"].items():
        print(f"main bf16 {name} tokens (information only): {res.tokens}")
    del run
    step_profile(cfg16, params, dev, card)
    return dict(counts)


def report_latency(tag, run, card):
    prefill = [r.prefill_latency_s * 1e3 for r in run["results"].values()]
    steps = sorted(x * 1e3 for r in run["results"].values()
                   for x in r.decode_latencies_s)
    p50 = steps[len(steps) // 2]
    p99 = steps[min(len(steps) - 1, int(round(0.99 * (len(steps) - 1))))]
    tokens = sum(len(r.tokens) for r in run["results"].values())
    print(f"main {tag} [{card}]: prefill latency ms per stream "
          f"{[round(x, 3) for x in prefill]}")
    print(f"main {tag} [{card}]: decode step latency p50 {p50:.3f} ms, "
          f"p99 {p99:.3f} ms over {len(steps)} steps")
    print(f"main {tag} [{card}]: {tokens} tokens in {run['wall_s']:.3f} s = "
          f"{tokens / run['wall_s']:.1f} tokens/s (4 streams, 2 servers, "
          f"precompile {run['warm_s']:.1f} s not counted)")
    calls = run["decode_calls"]
    dev_ms = sorted(m["seconds"] * 1e3 for m in calls)
    print(f"main {tag} [{card}]: {len(calls)} decode device calls, "
          f"{sum(m['rows'] for m in calls) / len(calls):.2f} rows per call, "
          f"device call p50 {dev_ms[len(dev_ms) // 2]:.3f} ms (server thread, "
          f"launch to stream sync)")


def step_profile(cfg, params, dev, card):
    """Where one decode step's time goes: the model's paged decode step
    alone (no engine, no threads) on 4 rows at phase 5's final lengths --
    CUDA-event time per step, host time to enqueue it, and the device time
    of each kernel from one torch.profiler window of 5 steps (the full
    table goes to chiprun_out/decode_step_profile.txt)."""
    from repro_torch.models import model as M

    nb_row = MAX_SEQ // BLOCK
    pools = M.init_paged_cache(cfg, 4 * nb_row + 1, BLOCK, device=dev)
    lengths = [p + STEPS for p in PROMPT_LENS]
    need = -(-(max(lengths) + 1) // BLOCK)
    w = 1 << (need - 1).bit_length()
    pack = np.zeros((4, 4 + w), np.int32)
    pack[:, 0] = 1
    pack[:, 1] = lengths
    pack[:, 4:] = 1 + np.arange(4)[:, None] * nb_row + np.arange(w)[None, :]
    packed = torch.as_tensor(pack, device=dev)

    def step():
        with torch.inference_mode():
            cache = dict(pools, pos=packed[:, 1],
                         block_tables=packed[:, 4:].contiguous())
            M.apply(cfg, params, {"tokens": packed[:, :1]}, mode="decode",
                    cache=cache)

    step_ms = time_ms(step, iters=10, reps=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    dev_us = lambda e: getattr(e, key)
    # device activity rows (kernels, copies) have no host time of their
    # own; operator rows repeat their kernels' device time
    kernels = sorted((e for e in events
                      if dev_us(e) > 0 and e.self_cpu_time_total == 0),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / 5
    print(f"step profile [{card}] bf16, 4 rows, W={w}, lengths {lengths}: "
          f"{step_ms:.3f} ms per step (CUDA events), host enqueue "
          f"{host_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / step_ms):.3f}")
    for e in kernels[:8]:
        print(f"step profile: {dev_us(e) / 1e3 / 5:8.4f} ms/step "
              f"{e.count // 5:5d} calls/step  {e.key[:90]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "decode_step_profile.txt").write_text(
        events.table(sort_by=key, row_limit=60))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    card = card_line()                                          # phase 1
    print(card)
    build_s = _build.build()                                    # phase 2
    _build.library()
    print(f"build: {build_s:.1f} s (one nvcc call, "
          f"{len(list(_build.CSRC.glob('*.cu')))} sources)")

    cfg = get_config("internlm2_1_8b")
    checks = KernelChecks(dev)                                  # phase 3
    checks.run(cfg)

    counts = main_path(dev, card)                               # phases 4-5

    print(f"launches over phases 4-5: {counts}")                # phase 6
    missing = [k for k in KERNELS if not counts.get(k)]
    if missing:
        raise SmokeFailure(f"kernels never launched on the main path: {missing}")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = checks.rows[name]
        b, by = r["bound"]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name], max_abs_err=checks.errors[name],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b, bound_by=by,
            library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
