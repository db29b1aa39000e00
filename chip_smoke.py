#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. card: name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, all in parallel) and, beside the build, the GQA decode pair's,
   ``ssd_intra``'s, ``rmsnorm``'s and ``flash_attention``'s sources alone to
   cubins: registers and spills (``-Xptxas -v``) and the ``HMMA`` count
   (``cuobjdump -sass``) of every kernel; a bf16 tensor-core kernel without
   ``HMMA`` fails;
3. kernels: each kernel against its plain PyTorch version on the card, at
   its path's full-width shapes, in fp32 and bf16 -- the attention kernels
   and rmsnorm at internlm2-1.8b widths (ragged lengths, scratch-block
   table lanes, length 0, prefill buckets 8 and 256; the GQA decode pair
   at lengths on both sides of every KV split boundary, and paged decode
   through tables of width 16 and 32 bit-identical to dense decode of the
   same rows; rmsnorm also at every register-resident width and on its
   vector and scalar loops), the SSD kernels at mamba2-780m widths (chunks
   of 5, 200 and 256, and N 64 in bf16; a bucketed chunk bit-identical to
   the exact-length one; slab ids permuted and repeated), the MLA decode
   kernel and flash attention with a value width of its own at
   deepseek-v2-lite-16b widths (latent pools, lengths on both sides of
   every KV split boundary, identity-table views of width 16 and 32), and
   every kernel of the hybrid path again at zamba2-7b widths (rmsnorm on
   rows of 3584 and of the gated norm's 7168, with the route each takes;
   the attention kernels at 32/32 heads of 112, group size 1; the SSD
   kernels at 112 heads of P 64, N 64), and every kernel of the enc-dec
   path at whisper-medium widths (rmsnorm at 1024 in registers; the
   attention kernels at 16/16 heads of 64; flash with no mask on the
   encoder's 1500 frames and on the cross-attention prefill, S 1, 8, 40
   and 256 against Sk 1500; dense decode over a 1500-frame cross cache;
   decode through ``row_ids`` over a pool of 6 noisy segments,
   bit-identical to dense decode of the gathered copy), and every kernel
   of the VLM path at qwen2-vl-2b widths (rmsnorm at 1536 in registers;
   the attention kernels at 12 query heads over 2 kv heads of 128, group
   size 6) -- then its median time beside the
   plain version's, the library call's (where one PyTorch call computes
   the same function) and its bound, each kernel's and library call's
   device time per call from one profiler window, a ranking by device
   time against the library call, rmsnorm's launch floor (a one-element
   add in the same profiler window), and timings for information
   (rmsnorm on a 256-token prefill, ``ssd_intra`` at the batched bucket
   of 4 rows, the GQA decode pair over a 32-block table and the whole
   cache, flash at the batched prefill bucket, the MLA kernel over a
   32-block table, every hybrid-path kernel at zamba2-7b's widths, and
   the enc-dec path's: the cross-attention prefill at bucket 256 and the
   segment decode of 4 rows on one shared segment, timed rows of their
   own, and the encoder's flash, for information; the VLM path's flash,
   decode pair and rmsnorm as timed rows of their own);
4. GQA path, fp32: full-width internlm2-1.8b (random weights from a seed)
   served by ``ServeEngine(batching=True, paged=True)`` -- 4 streams on 2
   servers, after ``precompile`` has warmed every cell and captured each
   as a CUDA graph -- must give the greedy tokens of unbatched
   ``generate``, use both servers, leak no KV block, replay a graph in
   every device call, and launch each kernel as often as the replayed
   cells' captured counts add up to;
5. GQA path, bf16 (the config's dtype): the same traffic, timed, served
   twice -- graphed, then with no cell warm, every call eager -- and a
   profile of one 4-row paged decode step run eagerly and as a replayed
   graph (the replay's logits equal to the eager step's bit for bit), and
   where the decode call's time goes beside the step;
4b. SSM path, fp32: full-width mamba2-780m served the same way through
   slab-paged decode: greedy tokens equal unbatched ``generate``'s, both
   servers used, no slab leaked, decode calls recorded as ``decode@ssm``;
5b. SSM path, bf16: the same traffic, timed, a profile of one 4-row
   slab-paged decode step and one of a 256-token prefill call
   (``chiprun_out/ssm_prefill_profile.txt``);
4c. MLA + MoE path, fp32: full-width deepseek-v2-lite-16b served the same
   way through MLA latent block pools (the dense prefix layer in pools of
   its own): greedy tokens equal unbatched ``generate``'s, both servers
   used, no block leaked, decode calls recorded as ``decode@mla``, peak
   device memory printed (the depth is cut only if the fp32 weights do not
   fit, and the cut is printed);
5c. MLA + MoE path, bf16: the same traffic at full depth, timed, and a
   profile of one 4-row paged decode step;
4d. hybrid path, fp32: full-width zamba2-7b (all 81 layers: 13 groups of
   5 Mamba-2 layers + the shared attention block, then 3 Mamba-2 layers)
   served the same way, each decode call staging the shared block's KV
   block pools and the Mamba-2 state slabs: greedy tokens equal unbatched
   ``generate``'s, both servers used, no block and no slab leaked, decode
   calls recorded as ``decode@hybrid``, peak device memory printed;
5d. hybrid path, bf16: the same traffic, timed, a profile of one 4-row
   paged decode step (``chiprun_out/hybrid_decode_step_profile.txt``) and
   one of a 256-token prefill call
   (``chiprun_out/hybrid_prefill_profile.txt``);
4e. enc-dec path, fp32: full-width whisper-medium (24 encoder + 24
   decoder layers, 1500 frames of the stubbed frontend's zeros) served the
   same way, each decode call staging the decoder's KV block pools and the
   cross-attention segment pools: greedy tokens equal unbatched
   ``generate``'s, both servers used, only ``prefill@encdec`` and
   ``decode@encdec`` calls, no block and no segment leaked, each server
   holding exactly one segment (shared by its streams) while they ran,
   peak device memory printed;
5e. enc-dec path, bf16: the same traffic, timed, a profile of one 4-row
   paged decode step (``chiprun_out/encdec_decode_step_profile.txt``) and
   one of a 256-token prefill call
   (``chiprun_out/encdec_prefill_profile.txt``);
4f. VLM path, fp32: full-width qwen2-vl-2b (28 layers, 12/2 heads of
   128, vocab 151936 tied) served from tokens through GQA block pools:
   greedy tokens equal unbatched ``generate``'s, nothing leaked, only
   ``prefill`` / ``decode`` calls; and the stack's own inputs --
   embeddings and distinct (t, h, w) M-RoPE positions -- through a
   prefill and 8 teacher-forced decode steps, within 1e-4 of the full
   forward;
5f. VLM path, bf16: the same traffic, timed, and a profile of one decode
   step, eager and graphed (``chiprun_out/vlm_decode_step_profile.txt``);
7. the engine's stream recovery, live migration, elastic pool and
   masked-dense layout, inside the phases above (every run graphed, its
   launches held to the cells' counts):
   7a. recovery, internlm2-1.8b, 2 servers with fault tolerance on: the
       server of two streams dies at its FAULT_AT_CALL-th call, then (a
       second engine) stalls for STALL_S and the 1 s heartbeat must evict
       it first; in fp32 every stream's tokens equal unbatched
       ``generate``'s, one degraded report per death, nothing leaks and
       every survivor call replays; in bf16 (and fp32) the detection time
       (fault to eviction), the resume latency (fault to the first resumed
       token), the re-prefill calls' ms and bucket against the recovery
       segment ``_recovery_cost_ms`` priced, and the memory the dead
       server keeps;
   7b. migration, in every family's fp32 phase: stream s1 moves to the
       other server after MIGRATE_AFTER decode calls of its own; tokens
       equal unbatched, both sides of the copy replayed, nothing leaks,
       and the enc-dec stream joins the destination's resident segment;
       export and import call ms, bytes moved beside the bytes / 3.35 TB/s
       bound, and the host hop's share;
   7c. elasticity, internlm2-1.8b bf16: work stealing with every stream
       pinned on server 0, ``consolidate(1)`` and ``remove_server(1)``
       mid-traffic, ``add_server()`` mid-traffic (capture count and
       seconds, device memory around it; every later call of the new
       server a replay), ``ElasticPoolController.scale_to`` 3 then 1
       mid-traffic; nothing leaks;
   7d. masked-dense (``batching=True, paged=False``, every decode call
       all 4 slot rows), in every family's fp32 phase: tokens equal
       unbatched, and the slot rows no stream held keep their bits across
       every masked step; internlm2-1.8b bf16 beside phase 5's paged run
       on the same traffic (client step p50/p99, tokens/s, decode
       launches per call);
8. launch counts of every kernel over phases 4-7 (each must be non-zero),
   then one JSON line describing every kernel;
9. static cell pricing (``ServeEngine.static_cell_costs``, on meta twins
   of the weights and pools: it launches nothing, so phase 8's counts do
   not move), inside the phases above, on each engine once its traffic
   is counted:
   9.1. each bf16 engine of phases 5-5f prices every warm decode, prefill
       and migrate cell (flops / bytes per cell, the seconds it took; the
       launch counters, the graphs and the warm sets must not change); the
       GQA decode cell's flops beside the analytic count;
   9.2. a ``StepCostModel`` with those static features and one with the
       default (rows, rows*width) ones, each scored leave one out on the
       measured cells (median and worst relative error per phase); in each
       fp32 phase, the one migrate cell phase 7b measured predicts every
       other width from its static bytes (per-cell table in
       ``chiprun_out/static_pricing.txt``);
   9.3. phase 7a's engines run with the fitted model attached (fp32: the
       model of phase 4's run; bf16: of phase 5's): ``_recovery_cost_ms``
       and ``_migration_cost_ms`` beside the measured re-prefill and
       migration and the declared 50 ms; fp32 tokens still equal
       unbatched;
   9.4. the paper's ``measured_costs`` scenario on the bf16 GQA model
       beside ``default_cost_model()``, the reference's CPU timings;

Every phase 4-5f serves graphed (phase 5 also eagerly), checks its
launches against the cells' counts, profiles its decode step both ways
and prints its peak device memory.
10. last line: ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --kernels-from TREE

builds the kernels of another checkout (for instance the parent commit,
unpacked with ``git archive``) and times its ``rmsnorm`` and ``ssd_intra``
on the same inputs as phase 3, so that two versions are compared on one
card in one call.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
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
NUM_SLABS = 2 * 4 + 2  # the engine's slab pool at max_batch 4
NUM_SEGMENTS = 4 + 2  # the engine's segment pool at max_batch 4
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
    "ssd_intra": ("src/repro_torch/csrc/ssd_intra.cu",
                  "src/repro/kernels/ssd_scan.py:66"),
    "ssd_slab_decode": ("src/repro_torch/csrc/ssd_slab_decode.cu",
                        "src/repro/kernels/ssd_scan.py:118"),
    "paged_mla_decode_attention": (
        "src/repro_torch/csrc/paged_mla_decode_attention.cu",
        "src/repro/kernels/paged_decode_attention.py:142"),
}
# device memory kept free beside the fp32 MLA weights: pools, the prefill
# activations of 4 x 256 tokens through every expert, logits
MLA_FP32_HEADROOM = 12 * 2**30


class SmokeFailure(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# sources reported in phase 2: registers and spills (ptxas -v), HMMA
# instructions (cuobjdump); their bf16 tensor-core kernels must hold HMMA
SASS_SOURCES = ("decode_attention.cu", "paged_decode_attention.cu",
                "ssd_intra.cu", "rmsnorm.cu", "flash_attention.cu")
TENSOR_CORE_KERNELS = ("decode_tc_kernel", "ssd_tc_kernel", "flash_tc_kernel")


def start_sass_report(csrc: pathlib.Path, nvcc: str):
    """Compiles each of SASS_SOURCES alone to a cubin with the build's
    target and -Xptxas -v (started, not waited for: it runs beside the
    build).  Returns the processes for :func:`sass_report`."""
    from repro_torch.kernels import _build

    out = ROOT / "chiprun_out" / "sass"
    out.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    return [(name, out / f"{name}.cubin", subprocess.Popen(
        [nvcc, *flags, "-cubin", "-Xptxas", "-v", "-o",
         str(out / f"{name}.cubin"), str(csrc / name)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name in SASS_SOURCES]


def sass_report(procs, nvcc: str) -> None:
    """Per kernel of each cubin: registers, spill bytes and HMMA count.
    Fails if a bf16 tensor-core kernel (TENSOR_CORE_KERNELS) holds no
    HMMA."""
    import re

    tools = pathlib.Path(nvcc).parent
    for name, cubin, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SmokeFailure(f"nvcc -cubin {name} failed:\n{err}")
        usage, fn = {}, None
        for line in err.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
                usage[fn] = ["?", "?", "?"]
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                usage[fn][0] = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and fn:
                usage[fn][1:] = [m.group(1), m.group(2)]
        sass = subprocess.run([str(tools / "cuobjdump"), "-sass", str(cubin)],
                              capture_output=True, text=True, check=True).stdout
        hmma, fn = Counter(), None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
            elif fn and "HMMA" in line:
                hmma[fn] += 1
        names = list(usage)
        try:
            demangled = subprocess.run([str(tools / "cu++filt"), *names],
                                       capture_output=True, text=True
                                       ).stdout.splitlines()
        except OSError:  # no demangler: the mangled names
            demangled = []
        if len(demangled) != len(names):
            demangled = names
        for fn, pretty in zip(names, demangled):
            short = pretty.replace("(int)", "").replace("<unnamed>::", "")
            short = short.removeprefix("void ").split("(")[0]
            regs, st, ld = usage[fn]
            print(f"sass {name} {short}: {hmma[fn]} HMMA, {regs} registers, "
                  f"{st} bytes spill stores, {ld} bytes spill loads")
            if any(k in fn for k in TENSOR_CORE_KERNELS) and not hmma[fn]:
                raise SmokeFailure(f"{name}: {short} holds no HMMA")


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


def device_kernels(prof):
    """The device activity rows (kernels, copies) of a torch.profiler
    window -- they have no host time of their own; operator rows repeat
    their kernels' device time -- and the attribute that holds their
    device time in microseconds."""
    events = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    rows = [e for e in events
            if getattr(e, key) > 0 and e.self_cpu_time_total == 0]
    return events, key, rows


def device_ms(fn, *, iters: int = 50, tries: int = 3) -> float:
    """Device time per call of ``fn``: the summed device time of every
    kernel that ``iters`` back-to-back calls launched, from one
    torch.profiler window (the host's issue rate does not enter).  Every
    call launches at least one kernel, so a window that recorded fewer
    than ``iters`` device activities lost some and is taken again; NaN
    (not measured) if every one of ``tries`` windows came back short."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        _, key, rows = device_kernels(prof)
        if sum(e.count for e in rows) >= iters:
            return sum(getattr(e, key) for e in rows) / 1e3 / iters
    return float("nan")


def device_ms_beside_floor(fn, *, iters: int = 50, tries: int = 3):
    """Device time per call of ``fn`` and of a one-element add (the launch
    floor: the shortest kernel the card runs), from one torch.profiler
    window in which each call of ``fn`` is followed by one add.  The add's
    kernels are told apart by name ("elementwise"); ``fn`` must launch none
    of that name.  (NaN, NaN) if every window came back short."""
    one = torch.zeros(1, device="cuda")

    def both():
        fn()
        one.add_(1.0)

    for _ in range(3):
        both()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                both()
            torch.cuda.synchronize()
        _, key, rows = device_kernels(prof)
        floor = [e for e in rows if "elementwise" in e.key]
        rest = [e for e in rows if "elementwise" not in e.key]
        if (sum(e.count for e in floor) >= iters
                and sum(e.count for e in rest) >= iters):
            return tuple(sum(getattr(e, key) for e in g) / 1e3 / iters
                         for g in (rest, floor))
    return float("nan"), float("nan")


def timed(fn, plain, library, bound, shape) -> dict:
    """One row of phase 3's timings: CUDA-event and device time of the
    kernel and of the library call, event time of the plain version."""
    return dict(shape=shape, ms=time_ms(fn), device_ms=device_ms(fn),
                plain_ms=time_ms(plain),
                library_ms=None if library is None else time_ms(library),
                library_device_ms=(None if library is None
                                   else device_ms(library)),
                bound=bound)


def print_rows(rows: dict, library_name: str, tag: str = "time") -> None:
    for name, r in rows.items():
        b_ms, by = r["bound"]
        lib = (f"library {r['library_ms']:.4f} ms event / "
               f"{r['library_device_ms']:.4f} ms device ({library_name})"
               if r["library_ms"] is not None
               else "library: no single PyTorch call")
        floor = (f", launch floor {r['floor_ms']:.4f} ms device (one-element"
                 f" add in the same window, beside {r['floor_kernel_ms']:.4f}"
                 f" ms of this kernel)" if "floor_ms" in r else "")
        print(f"{tag} {name} bf16 {r['shape']}: kernel {r['ms']:.4f} ms event"
              f" / {r['device_ms']:.4f} ms device, plain {r['plain_ms']:.4f}"
              f" ms, {lib}, bound {b_ms:.5f} ms ({by}){floor}")


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
        from repro_torch.kernels.rmsnorm import (ROW_WIDTHS, rmsnorm,
                                                 rmsnorm_plain)

        d, eps = cfg.d_model, cfg.norm_eps
        for dt in (torch.float32, torch.bfloat16):
            # rmsnorm: a 4-row decode step and a 256-token prefill
            w = (self.randn(d) * 0.1 + 1.0).to(dt)
            for shape in ((4, 1, d), (1, 256, d)):
                x = self.randn(*shape, dtype=dt)
                e = self.check("rmsnorm", f"x{shape}", rmsnorm(x, w, eps),
                               rmsnorm_plain(x, w, eps), dt)
                self.errors["rmsnorm"] = max(self.errors.get("rmsnorm", 0), e)
            # every register-resident width, and the vector and scalar loops
            for dw in (*sorted(ROW_WIDTHS), 1032, 100):
                x = self.randn(256, dw, dtype=dt) * 3.0
                ww = (self.randn(dw) * 0.1 + 1.0).to(dt)
                e = self.check("rmsnorm", f"x(256, {dw})", rmsnorm(x, ww, eps),
                               rmsnorm_plain(x, ww, eps), dt)
                self.errors["rmsnorm"] = max(self.errors["rmsnorm"], e)
            self.check_attention(cfg, dt)
        self.time_all(cfg)

    def check_attention(self, cfg, dt):
        """The three attention kernels at ``cfg``'s head widths: flash at
        prefill buckets 8, 64 and 256 and ragged 40 and 100; dense and
        paged decode at ragged lengths (paged through a table with
        scratch-block lanes full of garbage), length 0 giving 0, paged equal
        to dense decode; then the KV split edges."""
        from repro_torch.kernels.decode_attention import (
            decode_attention, decode_attention_plain)
        from repro_torch.kernels.flash_attention import (
            flash_attention, flash_attention_plain)
        from repro_torch.kernels.paged_decode_attention import (
            paged_decode_attention, paged_decode_attention_plain)

        nq, nkv, h = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        lengths = [1, 41, 101, 233]  # ragged; 233 = prompt 200 + 32 steps + 1
        nb = 4 * (MAX_SEQ // BLOCK) + 1  # engine default pool: 4 rows + scratch
        ok_len = torch.tensor(lengths, dtype=torch.int32, device=self.dev)
        zero_len = torch.tensor([0, 5], dtype=torch.int32, device=self.dev)
        # flash: prefill buckets 8, 64 and 256, ragged 40 and 100
        for b, s in ((4, 8), (4, 64), (2, 256), (1, 40), (1, 100)):
            q = self.randn(b, s, nq, h, dtype=dt)
            k = self.randn(b, s, nkv, h, dtype=dt)
            v = self.randn(b, s, nkv, h, dtype=dt)
            e = self.check("flash_attention", f"B={b} S={s} Nq={nq} H={h}",
                           flash_attention(q, k, v),
                           flash_attention_plain(q, k, v), dt)
            self.errors["flash_attention"] = max(
                self.errors.get("flash_attention", 0), e)
        # dense decode over a (B, max_seq, Nkv, H) cache
        q = self.randn(4, nq, h, dtype=dt)
        kc = self.randn(4, MAX_SEQ, nkv, h, dtype=dt)
        vc = self.randn(4, MAX_SEQ, nkv, h, dtype=dt)
        e = self.check("decode_attention", f"lengths={lengths} H={h}",
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
                       f"lengths={lengths} W={w_max} H={h} scratch lanes",
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
        self.gqa_split_edges(cfg, dt)

    def gqa_split_edges(self, cfg, dt):
        """The GQA decode pair at lengths on both sides of every KV split
        boundary of a W-16 table (splits of DECODE_TILES_PER_SPLIT blocks),
        0, 1, 15-17 and 256, against the plain versions; then paged decode
        through tables of width 16 and 32 and dense decode of the same rows
        (block_k = the block size) must give the same bits."""
        from repro_torch.kernels.decode_attention import (
            DECODE_TILES_PER_SPLIT, decode_attention, decode_attention_plain)
        from repro_torch.kernels.paged_decode_attention import (
            paged_decode_attention, paged_decode_attention_plain)

        nq, nkv, h = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        w16 = 16
        edge = BLOCK * DECODE_TILES_PER_SPLIT
        lengths = sorted({0, 1, 15, 16, 17, w16 * BLOCK} | {
            n for j in range(1, w16 // DECODE_TILES_PER_SPLIT)
            for n in (j * edge - 1, j * edge, j * edge + 1)})
        b = len(lengths)
        nb = 1 + sum(-(-n // BLOCK) for n in lengths)
        q = self.randn(b, nq, h, dtype=dt)
        kp = self.randn(nb, BLOCK, nkv, h, dtype=dt)
        vp = self.randn(nb, BLOCK, nkv, h, dtype=dt)
        kp[0], vp[0] = 1e4, -1e4  # the scratch block: no row may read it
        tables = self.table(lengths, w16, nb)
        lens = torch.tensor(lengths, dtype=torch.int32, device=self.dev)
        case = f"split edges, {b} rows, lengths {lengths[0]}..{lengths[-1]}"
        paged = paged_decode_attention(q, kp, vp, tables, lens)
        e = self.check("paged_decode_attention", case, paged,
                       paged_decode_attention_plain(q, kp, vp, tables, lens),
                       dt)
        self.errors["paged_decode_attention"] = max(
            self.errors["paged_decode_attention"], e)
        kd = kp[tables.long()].flatten(1, 2)
        vd = vp[tables.long()].flatten(1, 2)
        e = self.check("decode_attention", case,
                       decode_attention(q, kd, vd, lens, block_k=BLOCK),
                       decode_attention_plain(q, kd, vd, lens), dt)
        self.errors["decode_attention"] = max(
            self.errors["decode_attention"], e)
        for w in (w16, 2 * w16):
            lanes = torch.zeros((b, w), dtype=torch.int32, device=self.dev)
            lanes[:, :w16] = tables  # past them: the scratch block
            kd = kp[lanes.long()].flatten(1, 2)
            vd = vp[lanes.long()].flatten(1, 2)
            outs = {f"paged W={w}": paged_decode_attention(q, kp, vp, lanes,
                                                           lens),
                    f"dense Smax={w * BLOCK}": decode_attention(
                        q, kd, vd, lens, block_k=BLOCK)}
            torch.cuda.synchronize()
            for what, out in outs.items():
                if not torch.equal(out, paged):
                    raise SmokeFailure(f"GQA decode: {what} differs from "
                                       f"paged W={w16} at {case}")
            print(f"check GQA decode [{', '.join(outs)} against paged "
                  f"W={w16}, {case}] {str(dt)[6:]}: bit-identical ok")

    def time_flash(self, cfg, b, s, note=""):
        """flash in bf16 on ``b`` causal prefill rows of ``s`` tokens at
        ``cfg``'s heads, beside SDPA."""
        import torch.nn.functional as F

        from repro_torch.kernels.flash_attention import (
            flash_attention, flash_attention_plain)

        dt, el = torch.bfloat16, 2
        nq, nkv, h = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = self.randn(b, s, nq, h, dtype=dt)
        k = self.randn(b, s, nkv, h, dtype=dt)
        v = self.randn(b, s, nkv, h, dtype=dt)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = s * (s + 1) // 2
        return timed(
            lambda: flash_attention(q, k, v),
            lambda: flash_attention_plain(q, k, v),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            bound_ms((2 * q.numel() + 2 * k.numel()) * el,
                     4 * b * nq * h * pairs, dt),
            f"q ({b},{s},{nq},{h}) causal{note}")

    def time_paged(self, cfg, lengths, w_cols, note=""):
        """paged decode in bf16 on one step of len(lengths) rows over the
        engine's pool at ``cfg``'s heads through tables of ``w_cols``
        blocks, beside SDPA on the pre-gathered view."""
        import torch.nn.functional as F

        from repro_torch.kernels.paged_decode_attention import (
            paged_decode_attention, paged_decode_attention_plain)

        dt, el = torch.bfloat16, 2
        nq, nkv, h = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        rows, live = len(lengths), sum(lengths)
        nb = 4 * (MAX_SEQ // BLOCK) + 1
        lens = torch.tensor(lengths, dtype=torch.int32, device=self.dev)
        q = self.randn(rows, nq, h, dtype=dt)
        kp = self.randn(nb, BLOCK, nkv, h, dtype=dt)
        vp = self.randn(nb, BLOCK, nkv, h, dtype=dt)
        tables = self.table(lengths, w_cols, nb)
        kg = kp[tables.long()].reshape(rows, -1, nkv, h).transpose(1, 2)
        vg = vp[tables.long()].reshape(rows, -1, nkv, h).transpose(1, 2)
        mask = (torch.arange(w_cols * BLOCK, device=self.dev)[None, :]
                < lens[:, None])[:, None, None, :]
        kv_bytes = 2 * live * nkv * h * el
        q_bytes = 2 * q.numel() * el + 4 * rows
        return timed(
            lambda: paged_decode_attention(q, kp, vp, tables, lens),
            lambda: paged_decode_attention_plain(q, kp, vp, tables, lens),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True),
            bound_ms(kv_bytes + q_bytes + tables.numel() * 4,
                     4 * nq * h * live, dt),
            f"q ({rows},{nq},{h}), pool ({nb},{BLOCK},{nkv},{h}), "
            f"W={w_cols}, lengths {lengths}{note}")

    def time_decode(self, cfg, lengths, note=""):
        """dense decode in bf16 on one step of len(lengths) rows over a
        (rows, max_seq) cache at ``cfg``'s heads, beside masked SDPA."""
        import torch.nn.functional as F

        from repro_torch.kernels.decode_attention import (
            decode_attention, decode_attention_plain)

        dt, el = torch.bfloat16, 2
        nq, nkv, h = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        rows, live = len(lengths), sum(lengths)
        lens = torch.tensor(lengths, dtype=torch.int32, device=self.dev)
        q = self.randn(rows, nq, h, dtype=dt)
        kc = self.randn(rows, MAX_SEQ, nkv, h, dtype=dt)
        vc = self.randn(rows, MAX_SEQ, nkv, h, dtype=dt)
        mask = (torch.arange(MAX_SEQ, device=self.dev)[None, :]
                < lens[:, None])[:, None, None, :]
        kv_bytes = 2 * live * nkv * h * el
        q_bytes = 2 * q.numel() * el + 4 * rows
        return timed(
            lambda: decode_attention(q, kc, vc, lens),
            lambda: decode_attention_plain(q, kc, vc, lens),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=mask, enable_gqa=True),
            bound_ms(kv_bytes + q_bytes, 4 * nq * h * live, dt),
            f"q ({rows},{nq},{h}), cache ({rows},{MAX_SEQ},{nkv},{h}), "
            f"lengths {lengths}{note}")

    def time_all(self, cfg):
        """Times at main-path shapes in bf16 (the config's dtype)."""
        rows = {"rmsnorm": self.time_rmsnorm(cfg),
                "flash_attention": self.time_flash(cfg, 1, 256)}
        # decode at the main path's end: lengths of 4 streams after 32 steps
        lengths = [p + STEPS + 1 for p in PROMPT_LENS]
        rows["decode_attention"] = self.time_decode(cfg, lengths)
        w_cols = -(-max(lengths) // BLOCK)
        w_cols = 1 << (w_cols - 1).bit_length()  # the engine's pow2 width
        rows["paged_decode_attention"] = self.time_paged(cfg, lengths, w_cols)
        print_rows({k: v for k, v in rows.items() if k != "rmsnorm"}, "SDPA")
        self.rows.update(rows)

        # information only: the decode pair over a 32-block table and the
        # whole (4, 512) cache, lengths to 512
        lengths = [130, 260, 390, MAX_SEQ]
        print_rows({"paged_decode_attention": self.time_paged(
            cfg, lengths, MAX_SEQ // BLOCK, " (information only)"),
            "decode_attention": self.time_decode(
                cfg, lengths, " (information only)")}, "SDPA")

        # information only: flash at the batched prefill bucket (4, 256)
        print_rows({"flash_attention": self.time_flash(
            cfg, 4, 256, " (information only)")}, "SDPA")

    def time_rmsnorm(self, cfg, tag: str = "time") -> dict:
        """rmsnorm in bf16 on one decode step of 4 rows (its table row,
        with the launch floor measured in the same profiler window), and
        for information on one 256-token prefill row."""
        import torch.nn.functional as F

        from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

        dt, el, d, eps = torch.bfloat16, 2, cfg.d_model, cfg.norm_eps
        w = (self.randn(d) * 0.1 + 1.0).to(dt)
        rows = {}
        for shape in ((4, 1, d), (256, d)):
            x = self.randn(*shape, dtype=dt)
            n = x.numel()
            rows[shape] = timed(
                lambda: rmsnorm(x, w, eps), lambda: rmsnorm_plain(x, w, eps),
                lambda: F.rms_norm(x, (d,), w, eps),
                bound_ms((2 * n + d) * el, 4 * n, dt),
                f"x ({','.join(map(str, shape))})"
                + ("" if shape[0] == 4 else " (information only)"))
            rows[shape]["floor_kernel_ms"], rows[shape]["floor_ms"] = (
                device_ms_beside_floor(lambda: rmsnorm(x, w, eps)))
            print_rows({"rmsnorm": rows[shape]}, "F.rms_norm", tag)
        return rows[(4, 1, d)]

    # -- the MLA kernels at deepseek-v2-lite-16b widths -----------------------
    def mla_inputs(self, cfg, lengths, dtype, w):
        """q_lat/q_rope of one decode step and latent pools of the engine's
        size, scratch block 0 full of garbage no row may read, tables with
        each row's live blocks drawn without replacement."""
        nq, r, pr = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
        nb = 4 * (MAX_SEQ // BLOCK) + 1
        b = len(lengths)
        ckv = self.randn(nb, BLOCK, r, dtype=dtype)
        krope = self.randn(nb, BLOCK, pr, dtype=dtype)
        ckv[0], krope[0] = 1e4, -1e4
        return (self.randn(b, nq, r, dtype=dtype),
                self.randn(b, nq, pr, dtype=dtype), ckv, krope,
                self.table(lengths, w, nb),
                torch.tensor(lengths, dtype=torch.int32, device=self.dev))

    def run_mla(self, cfg):
        from repro_torch.kernels.flash_attention import (
            flash_attention, flash_attention_plain)
        from repro_torch.kernels.paged_decode_attention import (
            MLA_TILES_PER_SPLIT, paged_mla_decode_attention,
            paged_mla_decode_attention_plain)

        nq, r, pr = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
        hk, hv = cfg.qk_nope_head_dim + pr, cfg.v_head_dim
        scale = hk ** -0.5
        lengths = [p + STEPS + 1 for p in PROMPT_LENS]  # 38 .. 233
        w_max = 1 << (-(-max(lengths) // BLOCK) - 1).bit_length()  # W 16
        name = "paged_mla_decode_attention"
        for dt in (torch.float32, torch.bfloat16):
            ql, qr, ckv, krope, tables, lens = self.mla_inputs(cfg, lengths,
                                                               dt, w_max)
            got = paged_mla_decode_attention(ql, qr, ckv, krope, tables, lens,
                                             scale=scale)
            e = self.check(name, f"lengths={lengths} W={w_max} scratch lanes",
                           got, paged_mla_decode_attention_plain(
                               ql, qr, ckv, krope, tables, lens, scale=scale),
                           dt)
            self.errors[name] = max(self.errors.get(name, 0), e)
            zero = torch.tensor([0, 5], dtype=torch.int32, device=self.dev)
            out0 = paged_mla_decode_attention(ql[:2], qr[:2], ckv, krope,
                                              tables[:2], zero, scale=scale)
            self.check(name, "length 0 -> 0", out0[0],
                       torch.zeros_like(out0[0]), dt)
            # lengths on both sides of every KV split boundary of a W-16
            # table (splits of MLA_TILES_PER_SPLIT blocks), 1, 15-17, 256
            edge = BLOCK * MLA_TILES_PER_SPLIT
            edges = sorted({1, 15, 16, 17, w_max * BLOCK} | {
                n for j in range(1, w_max // MLA_TILES_PER_SPLIT)
                for n in (j * edge - 1, j * edge, j * edge + 1)})
            for lo in range(0, len(edges), 4):
                part = edges[lo:lo + 4]
                args = self.mla_inputs(cfg, part, dt, w_max)
                e = self.check(name, f"split edges lengths={part}",
                               paged_mla_decode_attention(*args, scale=scale),
                               paged_mla_decode_attention_plain(
                                   *args, scale=scale), dt)
                self.errors[name] = max(self.errors[name], e)
            # the dense cache of unbatched decode, viewed as a block pool
            # with the identity table, must give the paged result exactly,
            # at the batched width 16 and at the unbatched cache's 32
            b = len(lengths)
            for w in (w_max, 2 * w_max):
                lanes = torch.zeros((b, w), dtype=torch.int32,
                                    device=self.dev)
                lanes[:, :w_max] = tables  # past them: the scratch block
                ident = (torch.arange(b, device=self.dev)[:, None] * w
                         + torch.arange(w, device=self.dev)[None, :]
                         ).to(torch.int32)
                dense = paged_mla_decode_attention(
                    ql, qr, ckv[lanes.long()].reshape(-1, BLOCK, r),
                    krope[lanes.long()].reshape(-1, BLOCK, pr), ident, lens,
                    scale=scale)
                torch.cuda.synchronize()
                case = f"identity-table dense view W={w}"
                if not torch.equal(dense, got):
                    raise SmokeFailure(f"{name}: {case} differs from the "
                                       "paged result")
                print(f"check {name} [{case}] {str(dt)[6:]}: bit-identical ok")
            # MLA prefill: flash with q/k of width 192, v of width 128
            for bq, s in ((4, 8), (4, 64), (2, 256), (1, 100)):
                q = self.randn(bq, s, nq, hk, dtype=dt)
                k = self.randn(bq, s, nq, hk, dtype=dt)
                v = self.randn(bq, s, nq, hv, dtype=dt)
                e = self.check("flash_attention", f"MLA B={bq} S={s} "
                               f"Hk={hk} Hv={hv}",
                               flash_attention(q, k, v, scale=scale),
                               flash_attention_plain(q, k, v, scale=scale), dt)
                self.errors["flash_attention"] = max(
                    self.errors["flash_attention"], e)
        self.time_mla(cfg)

    def time_mla(self, cfg):
        """Times at the MLA path's shapes in bf16 (the config's dtype): one
        4-row decode step at the main path's final lengths, one 256-token
        prefill row."""
        import torch.nn.functional as F

        from repro_torch.kernels.flash_attention import (
            flash_attention, flash_attention_plain)
        from repro_torch.kernels.paged_decode_attention import (
            paged_mla_decode_attention, paged_mla_decode_attention_plain)

        dt, el = torch.bfloat16, 2
        nq, r, pr = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
        hk, hv = cfg.qk_nope_head_dim + pr, cfg.v_head_dim
        scale = hk ** -0.5
        lengths = [p + STEPS + 1 for p in PROMPT_LENS]
        live = sum(lengths)
        w_cols = -(-max(lengths) // BLOCK)
        w_cols = 1 << (w_cols - 1).bit_length()  # the engine's pow2 width
        ql, qr, ckv, krope, tables, lens = self.mla_inputs(cfg, lengths, dt,
                                                           w_cols)
        # SDPA on the pre-gathered view (the gather is not timed): key
        # concat(c_kv, k_rope) and value c_kv, one kv head for all queries
        kg = torch.cat([ckv[tables.long()], krope[tables.long()]], dim=-1
                       ).reshape(4, 1, -1, r + pr)
        vg = ckv[tables.long()].reshape(4, 1, -1, r)
        qg = torch.cat([ql, qr], dim=-1)[:, :, None]
        mask = (torch.arange(w_cols * BLOCK, device=self.dev)[None, :]
                < lens[:, None])[:, None, None, :]
        rows = {}
        rows["paged_mla_decode_attention"] = timed(
            lambda: paged_mla_decode_attention(ql, qr, ckv, krope, tables,
                                               lens, scale=scale),
            lambda: paged_mla_decode_attention_plain(
                ql, qr, ckv, krope, tables, lens, scale=scale),
            lambda: F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mask, scale=scale, enable_gqa=True),
            # each live position's latent and rope row read once; q in, o
            # out; QK over R + PR and PV over R per head and position
            bound_ms(live * (r + pr) * el + 4 * nq * (2 * r + pr) * el
                     + tables.numel() * 4 + 16,
                     2 * nq * (2 * r + pr) * live, dt),
            f"q_lat (4,{nq},{r}), pools ({ckv.shape[0]},{BLOCK},{r})/"
            f"(.,.,{pr}), W={w_cols}, lengths {lengths}")
        s = 256
        q = self.randn(1, s, nq, hk, dtype=dt)
        k = self.randn(1, s, nq, hk, dtype=dt)
        v = self.randn(1, s, nq, hv, dtype=dt)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = s * (s + 1) // 2
        rows["flash_attention@mla"] = timed(
            lambda: flash_attention(q, k, v, scale=scale),
            lambda: flash_attention_plain(q, k, v, scale=scale),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale),
            bound_ms((2 * q.numel() + v.numel() + s * nq * hv) * el,
                     2 * nq * (hk + hv) * pairs, dt),
            f"q/k (1,{s},{nq},{hk}), v (1,{s},{nq},{hv}) causal")
        print_rows(rows, "SDPA")
        self.rows.update(rows)

        # information only: a 32-block table (4 rows, lengths up to 512)
        lengths = [130, 260, 390, MAX_SEQ]
        live = sum(lengths)
        w_cols = MAX_SEQ // BLOCK
        ql, qr, ckv, krope, tables, lens = self.mla_inputs(cfg, lengths, dt,
                                                           w_cols)
        kg = torch.cat([ckv[tables.long()], krope[tables.long()]], dim=-1
                       ).reshape(4, 1, -1, r + pr)
        vg = ckv[tables.long()].reshape(4, 1, -1, r)
        qg = torch.cat([ql, qr], dim=-1)[:, :, None]
        mask = (torch.arange(w_cols * BLOCK, device=self.dev)[None, :]
                < lens[:, None])[:, None, None, :]
        info = timed(
            lambda: paged_mla_decode_attention(ql, qr, ckv, krope, tables,
                                               lens, scale=scale),
            lambda: paged_mla_decode_attention_plain(
                ql, qr, ckv, krope, tables, lens, scale=scale),
            lambda: F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mask, scale=scale, enable_gqa=True),
            bound_ms(live * (r + pr) * el + 4 * nq * (2 * r + pr) * el
                     + tables.numel() * 4 + 16,
                     2 * nq * (2 * r + pr) * live, dt),
            f"W={w_cols}, lengths {lengths} (information only)")
        print_rows({"paged_mla_decode_attention": info}, "SDPA")

    def rank(self) -> None:
        """Phase 3's timings ranked by device time: against the library
        call where one exists (largest factor first), then the rest by
        device time over bound."""
        def has_lib(r):  # a library call whose device time was measured
            return r["library_device_ms"] is not None and math.isfinite(
                r["library_device_ms"]) and r["library_device_ms"] > 0

        with_lib = sorted(
            ((r["device_ms"] / r["library_device_ms"], n)
             for n, r in self.rows.items() if has_lib(r)), reverse=True)
        rest = sorted(((r["device_ms"] / r["bound"][0], n)
                       for n, r in self.rows.items() if not has_lib(r)),
                      reverse=True)
        print("rank by device time vs library: " + ", ".join(
            f"{n} {x:.2f}x" for x, n in with_lib))
        print("rank by device time vs bound (no library call): " + ", ".join(
            f"{n} {x:.0f}x" for x, n in rest))

    # -- the SSD kernels at mamba2-780m widths ------------------------------
    def ssd_views(self, cfg, rows, s, dtype):
        """The model's views for one prefill of ``rows`` x ``s`` tokens in
        chunks of min(256, s): x (M,H,Q,P) and B/C (M,Q,N) cut from an
        (rows, s, conv_dim) activation, dt/dA (M,H,Q) permuted from
        (rows, s, H) fp32.  dA lies on a grid of 2**-10 so that cumsum(dA)
        is exact in any order: the kernel sums it sequentially, the plain
        version with torch.cumsum, and exp(seg_i - seg_j) would turn their
        last-bit differences into errors above the fp32 tolerance."""
        from repro_torch.models.ssm import conv_dim

        h, p, n = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state_dim
        q = min(256, s)
        m = rows * (s // q)
        xbc = self.randn(rows, s, conv_dim(cfg), dtype=dtype)
        dt = torch.nn.functional.softplus(self.randn(rows, s, h))
        a = -torch.linspace(1.0, 16.0, h, device=self.dev)
        da = torch.round(dt * a * 1024) / 1024
        d_in = h * p
        x = xbc[..., :d_in].reshape(m, q, h, p).permute(0, 2, 1, 3)
        b = xbc[..., d_in:d_in + n].reshape(m, q, n)
        c = xbc[..., d_in + n:].reshape(m, q, n)
        return (x, dt.reshape(m, q, h).permute(0, 2, 1),
                da.reshape(m, q, h).permute(0, 2, 1), b, c)

    def slab_inputs(self, cfg, rows, dtype):
        """One decode step's views: x (B,H,P) and B/C (B,1,N) cut from a
        (rows, conv_dim) activation, dt (B,H) fp32, A (H,), and a slab pool
        of the engine's size."""
        from repro_torch.models.ssm import conv_dim

        h, p, n = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state_dim
        pool = self.randn(NUM_SLABS, h, p, n)
        xbc = self.randn(rows, conv_dim(cfg), dtype=dtype)
        dt = torch.nn.functional.softplus(self.randn(rows, 1, h))[:, 0]
        a = -torch.linspace(1.0, 16.0, h, device=self.dev)
        d_in = h * p
        return (pool, xbc[:, :d_in].view(rows, h, p),
                dt, a, xbc[:, d_in:d_in + n].view(rows, 1, n),
                xbc[:, d_in + n:].view(rows, 1, n))

    def run_ssm(self, cfg):
        from repro_torch.kernels.ssd_scan import ssd_intra, ssd_intra_plain

        for dt in (torch.float32, torch.bfloat16):
            self.check_ssd(cfg, dt)
            if dt == torch.bfloat16:  # N 64 at mamba2's 48 heads
                cfg64 = dataclasses.replace(cfg, ssm_state_dim=64)
                for rows, s in ((1, 256), (4, 100)):
                    args = self.ssd_views(cfg64, rows, s, dt)
                    y, st = ssd_intra(*args)
                    y_want, st_want = ssd_intra_plain(*args)
                    e = max(self.check("ssd_intra", f"N=64 M={rows} Q={s} y",
                                       y, y_want, dt),
                            self.check("ssd_intra", f"N=64 M={rows} Q={s} "
                                       "state", st, st_want, dt))
                    self.errors["ssd_intra"] = max(self.errors["ssd_intra"], e)
        self.time_ssm(cfg)

    def check_ssd(self, cfg, dt):
        """The SSD kernels at ``cfg``'s SSM widths: ``ssd_intra`` on prefill
        chunks of 5, 200 and 256 and a bucketed chunk bit-identical to the
        exact-length one; ``ssd_slab_decode`` on 1, 2 and 4 rows with slab
        ids permuted and repeated."""
        from repro_torch.kernels.ssd_scan import (
            ssd_intra, ssd_intra_plain, ssd_slab_decode,
            ssd_slab_decode_plain)

        h = cfg.ssm_nheads
        # prefill chunks: 4 rows of 5, 2 rows of 200, 2 rows of 512 (two
        # chunks of 256 each)
        for rows, s in ((4, 5), (2, 200), (2, 512)):
            args = self.ssd_views(cfg, rows, s, dt)
            y, st = ssd_intra(*args)
            y_want, st_want = ssd_intra_plain(*args)
            m, q = args[0].shape[0], args[0].shape[2]
            e = max(self.check("ssd_intra", f"H={h} M={m} Q={q} y", y, y_want,
                               dt),
                    self.check("ssd_intra", f"H={h} M={m} Q={q} state", st,
                               st_want, dt))
            self.errors["ssd_intra"] = max(self.errors.get("ssd_intra", 0), e)
        self.ssd_padding_bits(cfg, dt)
        # decode: 1, 2, 4 rows; permuted slab ids, one repeated with its
        # row's inputs (as the engine's padding rows repeat row 0)
        for slabs in ([6], [7, 2], [9, 3, 5, 3]):
            pool, x, dtv, a, b, c = self.slab_inputs(cfg, len(slabs), dt)
            if len(slabs) == 4:
                for t in (x, dtv, b, c):
                    t[3] = t[1]
            ids = torch.tensor(slabs, dtype=torch.int32, device=self.dev)
            y, st = ssd_slab_decode(pool, ids, x, dtv, a, b, c)
            y_want, st_want = ssd_slab_decode_plain(pool, ids, x, dtv, a, b, c)
            e = max(self.check("ssd_slab_decode", f"H={h} slabs {slabs} y", y,
                               y_want, dt),
                    self.check("ssd_slab_decode", f"H={h} slabs {slabs} state",
                               st, st_want, torch.float32))
            self.errors["ssd_slab_decode"] = max(
                self.errors.get("ssd_slab_decode", 0), e)
            new = pool.clone()
            new.index_copy_(0, ids.long(), st)
            rest = [i for i in range(NUM_SLABS) if i not in slabs]
            torch.cuda.synchronize()
            if not torch.equal(new[rest], pool[rest]):
                raise SmokeFailure("ssd_slab_decode: the scatter changed a "
                                   "slab no row addresses")
            if not torch.equal(new[ids.long()], st):
                raise SmokeFailure("ssd_slab_decode: a repeated slab id did "
                                   "not give identical states")
            print(f"check ssd_slab_decode [H={h} slabs {slabs}] "
                  f"{str(dt)[6:]}: untouched slabs bit-identical ok")

    def ssd_padding_bits(self, cfg, dt):
        """A bucketed chunk -- 256 positions, dt = dA = 0 past 200 -- gives
        the exact-length chunk's y rows and state bit for bit."""
        from repro_torch.kernels.ssd_scan import ssd_intra

        x, dtv, da, b, c = self.ssd_views(cfg, 1, 256, dt)
        dtv, da = dtv.clone(), da.clone()
        dtv[..., 200:] = 0.0
        da[..., 200:] = 0.0
        y_pad, s_pad = ssd_intra(x, dtv, da, b, c)
        y, st = ssd_intra(x[:, :, :200], dtv[..., :200], da[..., :200],
                          b[:, :200], c[:, :200])
        torch.cuda.synchronize()
        if not (torch.equal(y_pad[:, :, :200], y) and torch.equal(s_pad, st)):
            raise SmokeFailure(f"ssd_intra {dt}: the bucketed chunk differs "
                               "from the exact-length chunk")
        print(f"check ssd_intra [H={cfg.ssm_nheads} bucket 256 == exact 200] "
              f"{str(dt)[6:]}: bit-identical ok")

    def time_ssm(self, cfg):
        """Times at the SSM path's shapes in bf16 (the config's dtype):
        one 256-token prefill row, one 4-row decode step."""
        rows = {"ssd_intra": self.time_ssd_intra(cfg),
                "ssd_slab_decode": self.time_slab_decode(cfg)}
        print_rows({"ssd_slab_decode": rows["ssd_slab_decode"]}, "")
        self.rows.update(rows)

    def time_slab_decode(self, cfg, note=""):
        """ssd_slab_decode in bf16 on one 4-row decode step over the
        engine's slab pool at ``cfg``'s SSM widths."""
        from repro_torch.kernels.ssd_scan import (ssd_slab_decode,
                                                  ssd_slab_decode_plain)

        dt, el = torch.bfloat16, 2
        h, p, n = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state_dim
        pool, x, dtv, a, b, c = self.slab_inputs(cfg, 4, dt)
        ids = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device=self.dev)
        state = 4 * h * p * n
        # bytes: 4 rows' fp32 states read once and written once, plus x,
        # y, B, C, dt; operations ~5 per state element (decay, update,
        # the product with C and its sum)
        nbytes = 2 * state * 4 + 2 * 4 * h * p * el + 2 * 4 * n * el + 4 * h * 4
        return timed(
            lambda: ssd_slab_decode(pool, ids, x, dtv, a, b, c),
            lambda: ssd_slab_decode_plain(pool, ids, x, dtv, a, b, c), None,
            bound_ms(nbytes, 5 * state, torch.float32),
            f"pool ({NUM_SLABS},{h},{p},{n}) fp32, 4 rows{note}")

    def time_ssd_intra(self, cfg, tag: str = "time") -> dict:
        """ssd_intra in bf16 on one 256-token prefill row (its table row)
        and, for information, on the batched bucket's 4 rows."""
        from repro_torch.kernels.ssd_scan import ssd_intra, ssd_intra_plain

        dt, el = torch.bfloat16, 2
        h, p, n = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state_dim
        q = 256
        pairs = q * (q + 1) // 2
        rows = {}
        for m in (1, 4):
            args = self.ssd_views(cfg, m, q, dt)
            # bytes: x, B, C in bf16 and dt, dA fp32 read once; y and the
            # chunk state written once in fp32.  Operations: C B^T on the
            # causal half, the decayed scores times x, and the chunk state.
            nbytes = m * (q * h * p * el + 2 * q * h * 4 + 2 * q * n * el
                          + q * h * p * 4 + h * n * p * 4)
            flops = m * (2 * pairs * n + 2 * h * pairs * p + 2 * h * q * n * p)
            rows[m] = timed(
                lambda: ssd_intra(*args), lambda: ssd_intra_plain(*args),
                None, bound_ms(nbytes, flops, dt),
                f"x ({m},{h},{q},{p}), B/C ({m},{q},{n}), "
                + ("one 256-token row" if m == 1
                   else "the batched bucket (information only)"))
            print_rows({"ssd_intra": rows[m]}, "", tag)
        return rows[1]

    # -- the hybrid path's kernels at zamba2-7b widths -----------------------
    def run_hybrid(self, cfg):
        """Every kernel of the hybrid path at zamba2-7b's full widths, fp32
        and bf16: rmsnorm on rows of d_model (3584) and d_inner (7168, the
        gated norm), each with the route it takes; the attention kernels at
        32/32 heads of 112 (group size 1); the SSD kernels at 112 heads of
        P 64, N 64.  Then device times beside SDPA at the hybrid shapes,
        for information."""
        import torch.nn.functional as F

        from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_plain,
                                                 rmsnorm_route)

        eps = cfg.norm_eps
        for dt in (torch.float32, torch.bfloat16):
            for d in (cfg.d_model, cfg.d_inner):
                w = (self.randn(d) * 0.1 + 1.0).to(dt)
                for shape in ((4, 1, d), (1, 256, d)):
                    x = self.randn(*shape, dtype=dt) * 3.0
                    route = rmsnorm_route(x, w)
                    e = self.check("rmsnorm", f"x{shape}, {route} route",
                                   rmsnorm(x, w, eps),
                                   rmsnorm_plain(x, w, eps), dt)
                    self.errors["rmsnorm"] = max(self.errors["rmsnorm"], e)
            self.check_attention(cfg, dt)
            self.check_ssd(cfg, dt)
        # one decode step's norms: d_model in registers, d_inner on the
        # vector loop
        for d in (cfg.d_model, cfg.d_inner):
            x = self.randn(4, 1, d, dtype=torch.bfloat16)
            w = (self.randn(d) * 0.1 + 1.0).to(torch.bfloat16)
            print_rows({"rmsnorm": timed(
                lambda: rmsnorm(x, w, eps), lambda: rmsnorm_plain(x, w, eps),
                lambda: F.rms_norm(x, (d,), w, eps),
                bound_ms((2 * x.numel() + d) * 2, 4 * x.numel(),
                         torch.bfloat16),
                f"x (4,1,{d}), {rmsnorm_route(x, w)} route (hybrid, "
                "information only)")}, "F.rms_norm")
        lengths = [p + STEPS + 1 for p in PROMPT_LENS]
        w_cols = 1 << (-(-max(lengths) // BLOCK) - 1).bit_length()
        print_rows({"flash_attention": self.time_flash(
            cfg, 1, 256, " (hybrid, information only)"),
            "paged_decode_attention": self.time_paged(
                cfg, lengths, w_cols, " (hybrid, information only)"),
            "decode_attention": self.time_decode(
                cfg, lengths, " (hybrid, information only)")}, "SDPA")
        self.time_ssd_intra(cfg, "time[hybrid]")
        print_rows({"ssd_slab_decode": self.time_slab_decode(
            cfg, " (hybrid, information only)")}, "")

    # -- the enc-dec path's kernels at whisper-medium widths -----------------
    def run_encdec(self, cfg):
        """Every kernel of the enc-dec path at whisper-medium's widths (16/16
        heads of 64, d_model 1024, 1500 encoder frames), fp32 and bf16:
        rmsnorm at 1024 (in registers); the self-attention kernels at group
        size 1 (flash causal, the GQA decode pair); flash with no mask on
        the encoder (S = Sk = 1500) and on the cross-attention prefill (S
        in 1, 8, 40, 256 against Sk = 1500); dense decode over a full
        1500-frame cross cache; and decode through ``row_ids`` over a
        noisy pool of 6 segments, rows on permuted and repeated segments,
        bit-identical to dense decode of the gathered copy.  Then times."""
        from repro_torch.kernels.decode_attention import (
            decode_attention, decode_attention_plain)
        from repro_torch.kernels.flash_attention import (
            flash_attention, flash_attention_plain)
        from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_plain,
                                                 rmsnorm_route)

        n, h, t = cfg.num_heads, cfg.head_dim, cfg.encoder_seq
        d, eps = cfg.d_model, cfg.norm_eps
        for dt in (torch.float32, torch.bfloat16):
            w = (self.randn(d) * 0.1 + 1.0).to(dt)
            for shape in ((4, 1, d), (1, 256, d), (1, t, d)):
                x = self.randn(*shape, dtype=dt) * 3.0
                e = self.check("rmsnorm", f"x{shape}, {rmsnorm_route(x, w)} "
                               "route", rmsnorm(x, w, eps),
                               rmsnorm_plain(x, w, eps), dt)
                self.errors["rmsnorm"] = max(self.errors["rmsnorm"], e)
            self.check_attention(cfg, dt)
            for s in (t, 1, 8, 40, 256):
                q = self.randn(1, s, n, h, dtype=dt)
                k = self.randn(1, t, n, h, dtype=dt)
                v = self.randn(1, t, n, h, dtype=dt)
                what = "encoder" if s == t else "cross prefill"
                e = self.check("flash_attention", f"{what} S={s} Sk={t} "
                               f"Nq={n} H={h} no mask",
                               flash_attention(q, k, v, causal=False),
                               flash_attention_plain(q, k, v, causal=False),
                               dt)
                self.errors["flash_attention"] = max(
                    self.errors["flash_attention"], e)
            q = self.randn(4, n, h, dtype=dt)
            full = torch.full((4,), t, dtype=torch.int32, device=self.dev)
            kc = self.randn(4, t, n, h, dtype=dt)
            vc = self.randn(4, t, n, h, dtype=dt)
            e = self.check("decode_attention", f"dense cross cache (4,{t},{n},"
                           f"{h}), every frame live",
                           decode_attention(q, kc, vc, full),
                           decode_attention_plain(q, kc, vc, full), dt)
            self.errors["decode_attention"] = max(
                self.errors["decode_attention"], e)
            kp = self.randn(NUM_SEGMENTS, t, n, h, dtype=dt)
            vp = self.randn(NUM_SEGMENTS, t, n, h, dtype=dt)
            ids = torch.tensor([5, 2, 5, 0], dtype=torch.int32,
                               device=self.dev)
            for lengths in ([t] * 4, [t, 1, 33, t - 11]):
                lens = torch.tensor(lengths, dtype=torch.int32,
                                    device=self.dev)
                got = decode_attention(q, kp, vp, lens, row_ids=ids)
                case = (f"segments {ids.tolist()} of "
                        f"({NUM_SEGMENTS},{t},{n},{h})")
                e = self.check("decode_attention",
                               f"{case}, lengths {lengths}", got,
                               decode_attention_plain(q, kp, vp, lens,
                                                      row_ids=ids), dt)
                self.errors["decode_attention"] = max(
                    self.errors["decode_attention"], e)
                dense = decode_attention(q, kp[ids.long()], vp[ids.long()],
                                         lens)
                torch.cuda.synchronize()
                if not torch.equal(got, dense):
                    raise SmokeFailure(f"decode_attention: row_ids over "
                                       f"{case} differs from dense decode of "
                                       "the gathered copy")
                print(f"check decode_attention [row_ids == dense on the "
                      f"gathered copy, {case}, lengths {lengths}] "
                      f"{str(dt)[6:]}: bit-identical ok")
        self.time_encdec(cfg)

    def time_encdec(self, cfg):
        """Times at the enc-dec path's shapes in bf16 (the config's dtype):
        rmsnorm at 1024 (4-row decode step, 256-token prefill), the
        cross-attention prefill of the 200-token prompt's bucket 256
        against the 1500 frames, one 4-row decode step of the
        cross-attention over the server's segment pool with every row on
        the one segment the traffic's streams share; for information the
        encoder's flash at 1500 frames, the cross prefill of the smallest
        bucket, four rows on four segments, and the self-attention kernels
        at group size 1."""
        import torch.nn.functional as F

        from repro_torch.kernels.decode_attention import (
            decode_attention, decode_attention_plain)
        from repro_torch.kernels.flash_attention import (
            flash_attention, flash_attention_plain)

        dt, el = torch.bfloat16, 2
        n, h, t = cfg.num_heads, cfg.head_dim, cfg.encoder_seq
        rows = {"rmsnorm@1024": self.time_rmsnorm(cfg, "time[encdec]")}

        def flash(s, note=""):
            q = self.randn(1, s, n, h, dtype=dt)
            k = self.randn(1, t, n, h, dtype=dt)
            v = self.randn(1, t, n, h, dtype=dt)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            return timed(
                lambda: flash_attention(q, k, v, causal=False),
                lambda: flash_attention_plain(q, k, v, causal=False),
                lambda: F.scaled_dot_product_attention(qt, kt, vt),
                # q in, o out, K and V read once; QK and PV over every pair
                bound_ms((2 * q.numel() + k.numel() + v.numel()) * el,
                         4 * n * h * s * t, dt),
                f"q (1,{s},{n},{h}), k/v (1,{t},{n},{h}), no mask{note}")

        def segments(ids, note=""):
            q = self.randn(4, n, h, dtype=dt)
            kp = self.randn(NUM_SEGMENTS, t, n, h, dtype=dt)
            vp = self.randn(NUM_SEGMENTS, t, n, h, dtype=dt)
            ids = torch.tensor(ids, dtype=torch.int32, device=self.dev)
            lens = torch.full((4,), t, dtype=torch.int32, device=self.dev)
            kg, vg = (p[ids.long()].transpose(1, 2) for p in (kp, vp))
            live = len(set(ids.tolist()))  # segments the step must read
            return timed(
                lambda: decode_attention(q, kp, vp, lens, row_ids=ids),
                lambda: decode_attention_plain(q, kp, vp, lens, row_ids=ids),
                lambda: F.scaled_dot_product_attention(q[:, :, None], kg, vg),
                bound_ms(2 * live * t * n * h * el + 2 * q.numel() * el
                         + 8 * 4, 4 * 4 * n * h * t, dt),
                f"q (4,{n},{h}), pool ({NUM_SEGMENTS},{t},{n},{h}), segments "
                f"{ids.tolist()}, length {t}{note}")

        rows["flash_attention@cross"] = flash(256)
        rows["decode_attention@segment"] = segments([1, 1, 1, 1])
        print_rows({k: v for k, v in rows.items() if k != "rmsnorm@1024"},
                   "SDPA")
        self.rows.update(rows)
        print_rows({"flash_attention": flash(t, " (encoder, information "
                                             "only)"),
                    "flash_attention@cross": flash(8, " (information only)"),
                    "decode_attention@segment": segments(
                        [5, 2, 3, 0], " (information only)")}, "SDPA")
        lengths = [p + STEPS + 1 for p in PROMPT_LENS]
        w_cols = 1 << (-(-max(lengths) // BLOCK) - 1).bit_length()
        print_rows({"flash_attention": self.time_flash(
            cfg, 1, 256, " (encdec self, information only)"),
            "paged_decode_attention": self.time_paged(
                cfg, lengths, w_cols, " (encdec self, information only)"),
            "decode_attention": self.time_decode(
                cfg, lengths, " (encdec self, information only)")}, "SDPA")

    # -- the VLM path's kernels at qwen2-vl-2b widths ------------------------
    def run_vlm(self, cfg):
        """Every kernel of the VLM path at qwen2-vl-2b's widths (12 query
        heads over 2 kv heads of 128: group size 6, which fills 6 of the 16
        mma rows of a decode block; d_model 1536), fp32 and bf16: rmsnorm
        at 1536 (in registers), the attention kernels through
        ``check_attention`` (flash at buckets 8-256 and ragged 40 and 100,
        the decode pair at ragged lengths, length 0 and every KV split
        edge, paged equal to dense bit for bit).  Then timed rows of their
        own beside the library call and the bound: flash at (1,256,12,128)
        against Nkv 2, the decode pair at group size 6 and rmsnorm at
        (4,1,1536)."""
        from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_plain,
                                                 rmsnorm_route)

        d, eps = cfg.d_model, cfg.norm_eps
        for dt in (torch.float32, torch.bfloat16):
            w = (self.randn(d) * 0.1 + 1.0).to(dt)
            for shape in ((4, 1, d), (1, 256, d)):
                x = self.randn(*shape, dtype=dt) * 3.0
                e = self.check("rmsnorm", f"x{shape}, {rmsnorm_route(x, w)} "
                               "route", rmsnorm(x, w, eps),
                               rmsnorm_plain(x, w, eps), dt)
                self.errors["rmsnorm"] = max(self.errors["rmsnorm"], e)
            self.check_attention(cfg, dt)
        lengths = [p + STEPS + 1 for p in PROMPT_LENS]
        w_cols = 1 << (-(-max(lengths) // BLOCK) - 1).bit_length()
        rows = {"rmsnorm@vlm": self.time_rmsnorm(cfg, "time[vlm]"),
                "flash_attention@vlm": self.time_flash(cfg, 1, 256, " (vlm)"),
                "paged_decode_attention@vlm": self.time_paged(
                    cfg, lengths, w_cols, " (vlm, group size 6)"),
                "decode_attention@vlm": self.time_decode(
                    cfg, lengths, " (vlm, group size 6)")}
        print_rows({k: v for k, v in rows.items() if k != "rmsnorm@vlm"},
                   "SDPA", "time[vlm]")
        self.rows.update(rows)


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


def free_card() -> None:
    """Return a finished phase's memory to the card: collect the cycles
    that may still hold an engine (its weights, pools and graphs), then
    release the allocator's cache."""
    gc.collect()
    torch.cuda.empty_cache()


def captured_cells(eng, rep) -> dict:
    """Each warm cell's launches per call, the same on every server;
    every server captured every cell (a migration width is two graphs,
    its gather and its scatter)."""
    states = eng._paged if eng.paged else eng._slots
    cells = {}
    for st in states:
        for key, cell in st.graphs.items():
            if cells.setdefault(key, cell.launches) != cell.launches:
                raise SmokeFailure(f"cell {key} launches differ between "
                                   "servers")
    want = len(states) * (rep.compiled + len(rep.migrate_cells))
    if rep.captured != want:
        raise SmokeFailure(f"precompile warmed {rep.compiled} cells "
                           f"({len(rep.migrate_cells)} migration widths) but "
                           f"captured {rep.captured} graphs, want {want}")
    return cells


def run_streams(eng, prompts, *, during=None, timeout=900):
    """Every stream's job on its own thread; ``during(eng)`` runs on this
    thread while they do.  Returns (results, what ``during`` returned,
    wall seconds); a stream's error is raised here."""
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
    try:
        seen = during(eng) if during is not None else None
    finally:
        for t in threads:
            t.join(timeout=timeout)
    wall_s = time.monotonic() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise SmokeFailure("a stream did not finish")
    return results, seen, wall_s


def serve_batched(cfg, params, prompts, dev, *, graphs=True, cells=None,
                  paged=True, during=None, probe=None, after=None):
    """4 streams on 2 servers through the batched engine, paged or
    masked-dense.  With ``graphs``, ``precompile`` warms and captures every
    cell first and every device call of the traffic must replay a graph;
    without it no cell is warm and every call runs eagerly (the same
    buckets).  The run carries each cell's launches per call (``cells``:
    the captured counts, or those of an earlier graphed run of the same
    model).  ``during(eng)`` runs while the streams do (its result is
    ``run["during"]``); ``probe(eng)``, called before the traffic, returns a
    check that runs after it (its result is ``run["probe"]``);
    ``after(eng)`` runs once the traffic's launches are counted, before
    the engine closes (its result is ``run["after"]``)."""
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import PrecompileReport, ServeEngine

    eng = ServeEngine(cfg, params, max_seq=MAX_SEQ, num_servers=2,
                      batching=True, max_batch=4, paged=paged,
                      kv_block_size=BLOCK, device=dev)
    try:
        t0 = time.monotonic()
        rep = (eng.precompile(prompt_buckets=BUCKETS) if graphs
               else PrecompileReport())
        warm_s = time.monotonic() - t0
        if graphs:
            cells = captured_cells(eng, rep)
        # segments each server holds, read after every reservation (the
        # only place one is taken): the peak while the streams ran
        segments = [0] * len(eng._paged)
        reserve = eng._paged_reserve

        def reserve_and_count(*args):
            out = reserve(*args)
            for i, st in enumerate(eng._paged):
                with st.lock:
                    held = st.mgr.segments_in_use - (
                        st.mgr.seqs["__scratch__"].segment is not None)
                segments[i] = max(segments[i], held)
            return out

        eng._paged_reserve = reserve_and_count
        after_probe = probe(eng) if probe is not None else None
        _build.reset_launches()  # count the traffic's launches, not warm-up's
        for i, name in enumerate(prompts):
            if not eng.admit(_spec(name, len(prompts) - i)).admitted:
                raise SmokeFailure(f"stream {name} not admitted")
        servers = {eng.pool.server_of(n) for n in prompts}
        results, seen, wall_s = run_streams(eng, prompts, during=during)
        launches = dict(_build.launches)
        usage = eng.kv_usage()
        meta = [m for s in eng.pool.servers for m in s.stats.batch_meta]
        eager = [m for m in meta if m["graphed"] != graphs]
        if eager:
            raise SmokeFailure(f"{len(eager)} of {len(meta)} device calls "
                               f"{'ran eagerly' if graphs else 'replayed'}"
                               f", e.g. {eager[0]}")
        calls = [m for m in meta if m["kind"] == eng._decode_kind]
        prefills = [m for m in meta if m["kind"] == eng._prefill_kind]
        priced = after(eng) if after is not None else None
        return dict(results=results, servers=servers, usage=usage,
                    segments_peak=segments, wall_s=wall_s, warm_s=warm_s,
                    precompile=rep, graphs=graphs, cells=cells,
                    launches=launches, decode_calls=calls,
                    prefill_calls=prefills, during=seen,
                    migrations=[m for m in meta
                                if m["kind"] == eng._migrate_kind],
                    probe=after_probe() if after_probe is not None else None,
                    after=priced,
                    slots_free=[len(st.free) for st in eng._slots],
                    kinds={m["kind"] for m in meta})
    finally:
        eng.close()
        # the wrappers refer to the engine: drop them, or the cycle keeps
        # the engine (and the weights it holds) alive on the card
        for attr in ("_paged_reserve", "_execute_migration", "_acquire_slot"):
            vars(eng).pop(attr, None)


def serve_unbatched(cfg, params, prompts, dev):
    """The reference: each stream alone through unbatched ``generate``
    (dense cache; decode_attention or the SSD step over ids 0..B-1).
    Returns (results, launches)."""
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


def check_outputs(tag, run, prompts):
    for name, res in run["results"].items():
        if len(res.tokens) != STEPS or len(res.decode_latencies_s) != STEPS:
            raise SmokeFailure(f"{name}: {len(res.tokens)} tokens, want {STEPS}")
    if run["servers"] != {0, 1}:
        raise SmokeFailure(f"streams used servers {run['servers']}, not both")
    if any(run["usage"].values()):
        raise SmokeFailure(f"leaked KV resources: {run['usage']}")
    if any(n != 4 for n in run["slots_free"]):
        raise SmokeFailure(f"{tag}: free slots per server {run['slots_free']}"
                           ", want all 4")
    check_cell_launches(tag, run)


def check_cell_launches(tag, run):
    """Each kernel's launches over the traffic must equal the sum, over the
    traffic's device calls, of the call's cell's launches per call."""
    calls = run["decode_calls"] + run["prefill_calls"]
    want = Counter()
    for m in calls:
        phase = m["kind"].split("@")[0]
        want.update(run["cells"][(phase, m["padded"], m["width"]
                                  if phase == "decode" else m["bucket"])])
    got = +Counter(run["launches"])
    if got != want:
        raise SmokeFailure(f"{tag}: launches {dict(got)} != the sum over the "
                           f"{len(calls)} device calls of each cell's "
                           f"launches per call {dict(want)}")
    hit = sorted({(m["kind"].split("@")[0], m["padded"],
                   m.get("width", m.get("bucket"))) for m in calls})
    print(f"{tag}: launches {dict(got)} == the sum over {len(calls)} device "
          f"calls ({'graph replays' if run['graphs'] else 'eager'}) of each "
          f"cell's launches per call; per call: " + "; ".join(
              f"{k[0]} ({k[1]},{k[2]}) {dict(run['cells'][k])}" for k in hit))


def check_tokens(tag, run, ref, prompts):
    for name in prompts:
        got, want = run["results"][name].tokens, ref[name].tokens
        same = got == want
        print(f"{tag} {name} prompt {prompts[name].shape[1]}: batched "
              f"tokens {'==' if same else '!='} unbatched "
              f"(first {got[:8]})")
        if not same:
            raise SmokeFailure(f"{tag} {name}: batched {got} != unbatched "
                               f"{want}")
    print(f"{tag}: servers used {sorted(run['servers'])}, kv_usage "
          f"{run['usage']}, precompiled {run['precompile'].compiled} cells, "
          f"call kinds {sorted(run['kinds'])}")


def init_params(cfg, dev, tag):
    from repro_torch.models import model as M

    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.monotonic()
    params = M.init_params(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    print(f"{tag}: init {M.param_count(cfg) / 1e9:.3f} B params "
          f"({cfg.dtype}) in {time.monotonic() - t0:.1f} s")
    return params


def print_peak(tag, dev, card) -> None:
    print(f"{tag} [{card}]: peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated, since the phase began)")


def check_kinds(tag, run, family_tag) -> None:
    """Only the family's prefill and decode calls ran (and its migration
    calls, in a run that moved a stream), and some decoded."""
    want = {"prefill" + family_tag, "decode" + family_tag}
    if run["migrations"]:  # phase 7b's move
        want.add("migrate" + family_tag)
    if run["kinds"] != want or not run["decode_calls"]:
        raise SmokeFailure(f"{tag}: calls recorded as {sorted(run['kinds'])},"
                           f" want {sorted(want)}")


def fp32_phase(tag, cfg, prompts, dev, card, *, family_tag, check=None,
               extra=None):
    """Phases 4-4f with 7b and 7d: ``cfg`` in fp32, served graphed, one
    stream migrating mid-decode (phase 7b); the batched greedy tokens must
    equal unbatched ``generate``'s, every call replay a graph and the
    launches match the cells' counts; then the masked-dense layout on the
    same traffic (phase 7d).  ``check(tag, run)`` adds the family's own
    checks, ``extra(cfg, params, ref, priced)`` a model-level one (its
    launches, a Counter or None, are counted; ``priced`` is phase 9's
    migrate case on the graphed run's engine).  Returns the launch counts
    of every run."""
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, dev, tag)
    run = serve_batched(cfg, params, prompts, dev, during=migrate_mid_decode,
                        after=lambda eng: migrate_pricing(
                            f"{tag} phase 9", eng, card))
    ref, ref_launches = serve_unbatched(cfg, params, prompts, dev)
    check_outputs(tag, run, prompts)
    check_kinds(tag, run, family_tag)
    if check is not None:
        check(tag, run)
    check_tokens(tag, run, ref, prompts)
    report_migration(tag, run, card)
    print(f"{tag}: max |batched - unbatched| first-step logit "
          f"{first_logits_gap(cfg, params, prompts, dev):.3e} "
          f"(information only)")
    report_latency(tag, run, card)
    counts = Counter(run["launches"]) + Counter(ref_launches)
    priced = run["after"]
    del run
    free_card()
    counts += masked_dense_fp32(f"{tag} masked-dense", cfg, params, prompts,
                                dev, ref)
    if extra is not None:
        counts += extra(cfg, params, ref, priced) or Counter()
    print_peak(tag, dev, card)
    del params, ref, priced
    free_card()
    return counts


def bf16_phase(tag, cfg, prompts, dev, card, *, family_tag, profile,
               prefill_file=None, check=None, eager=False, extra=None,
               gqa=False):
    """Phases 5-5f: ``cfg`` in bf16 (the config's dtype), served graphed
    and timed -- with ``eager`` also served again with no cell warm, every
    call eager -- then one decode step profiled eagerly and as a replayed
    graph (``chiprun_out/<profile>``), where the decode call's time goes,
    and with ``prefill_file`` one prefill call profiled;
    ``extra(cfg, params, runs)`` adds runs of its own (their launches, a
    Counter, are counted).  Phase 9 prices the graphed run's warm cells
    and fits a cost model on its measured ones (``runs["graphed"]
    ["after"]``; with ``gqa``, the analytic decode flops and the paper's
    scenario too).  Returns the launch counts."""
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, dev, tag)
    runs = {"graphed": serve_batched(
        cfg, params, prompts, dev, after=lambda eng: static_pricing(
            f"{tag} phase 9", eng, card, gqa=gqa, scenario=gqa))}
    if eager:
        runs["eager"] = serve_batched(cfg, params, prompts, dev, graphs=False,
                                      cells=runs["graphed"]["cells"])
    counts = Counter()
    for mode, run in runs.items():
        counts += Counter(run["launches"])
        check_outputs(f"{tag} {mode}", run, prompts)
        check_kinds(f"{tag} {mode}", run, family_tag)
        if check is not None:
            check(f"{tag} {mode}", run)
        report_latency(f"{tag} {mode}", run, card)
    for name, res in runs["graphed"]["results"].items():
        print(f"{tag} {name} tokens (information only): {res.tokens}")
    prof = step_profile(cfg, params, dev, card, f"{tag} step profile",
                        profile)
    for mode, run in runs.items():
        decode_breakdown(f"{tag} {mode}", run, prof[mode], card)
    if prefill_file is not None:
        prefill_profile(cfg, params, dev, card, f"{tag} prefill profile",
                        prefill_file)
    if extra is not None:
        counts += extra(cfg, params, runs)
    print_peak(tag, dev, card)
    del params, runs
    free_card()
    return counts


def gqa_path(dev, card):
    """Phases 4-5: internlm2-1.8b, the main path; phase 5 serves the bf16
    traffic twice, graphed and eager.  Returns the launch counts."""
    from repro_torch.configs.registry import get_config

    base = get_config("internlm2_1_8b")
    prompts = _prompts(base.vocab_size)
    counts = fp32_phase(
        "main fp32", dataclasses.replace(base, dtype="float32"), prompts,
        dev, card, family_tag="",
        extra=lambda cfg, params, ref, priced: recovery_fp32(
            "recovery fp32", cfg, params, prompts, dev, card, ref, priced))
    counts += bf16_phase("main bf16", base, prompts, dev, card, family_tag="",
                         profile="decode_step_profile.txt", eager=True,
                         gqa=True,
                         extra=lambda cfg, params, runs: gqa_bf16_phase7(
                             cfg, params, prompts, dev, card, runs))
    return counts


def model_batch(cfg, tokens, dev, **extra):
    """The prefill batch the engine builds: ``tokens`` and, for the enc-dec
    stack, zero frames (B, encoder_seq, d_model) in the config's dtype (the
    audio frontend is a stub)."""
    batch = {"tokens": torch.as_tensor(tokens, device=dev), **extra}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros(
            (tokens.shape[0], cfg.encoder_seq, cfg.d_model),
            dtype=getattr(torch, cfg.dtype), device=dev)
    return batch


def first_logits_gap(cfg, params, prompts, dev):
    """Largest |batched - unbatched| first-step logit: each prompt prefilled
    as the batched path does (padded to its bucket, with its length) and
    alone at its exact length."""
    from repro_torch.models import model as M

    gap = 0.0
    with torch.inference_mode():
        for prompt in prompts.values():
            n = prompt.shape[1]
            bucket = min(b for b in BUCKETS if b >= n)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :n] = prompt[0]
            lb, _, _ = M.apply(cfg, params, model_batch(
                cfg, padded, dev,
                lengths=torch.tensor([n], dtype=torch.int32, device=dev)),
                mode="prefill")
            lu, _, _ = M.apply(cfg, params, model_batch(cfg, prompt, dev),
                               mode="prefill")
            gap = max(gap, (lb[0, n - 1] - lu[0, -1]).abs().max().item())
    return gap


def ssm_path(dev, card):
    """Phases 4b-5b: mamba2-780m through slab-paged decode; returns the
    launch counts."""
    from repro_torch.configs.registry import get_config

    base = get_config("mamba2_780m")
    prompts = _prompts(base.vocab_size)
    counts = fp32_phase("ssm fp32", dataclasses.replace(base, dtype="float32"),
                        prompts, dev, card, family_tag="@ssm")
    counts += bf16_phase("ssm bf16", base, prompts, dev, card,
                         family_tag="@ssm",
                         profile="ssm_decode_step_profile.txt",
                         prefill_file="ssm_prefill_profile.txt")
    return counts


def fp32_depth(base, dev) -> int:
    """The most layers of ``base`` whose fp32 weights fit beside
    MLA_FP32_HEADROOM in the card's free memory (all of them, on an 80 GB
    card)."""
    from repro_torch.models import model as M

    free, _ = torch.cuda.mem_get_info(dev)
    n = base.num_layers
    while n > base.first_dense_layers + 1 and 4 * M.param_count(
            dataclasses.replace(base, num_layers=n)) + MLA_FP32_HEADROOM > free:
        n -= 1
    return n


def mla_path(dev, card):
    """Phases 4c-5c: deepseek-v2-lite-16b through MLA latent block pools
    (fp32 at the depth that fits, bf16 at full depth); returns the launch
    counts."""
    from repro_torch.configs.registry import get_config

    base = get_config("deepseek_v2_lite_16b")
    prompts = _prompts(base.vocab_size)
    depth = fp32_depth(base, dev)
    if depth < base.num_layers:
        print(f"mla fp32: depth cut to {depth} of {base.num_layers} layers "
              f"(the fp32 weights of all layers do not fit)")
    counts = fp32_phase(
        f"mla fp32 ({depth} layers)",
        dataclasses.replace(base, dtype="float32", num_layers=depth),
        prompts, dev, card, family_tag="@mla")
    counts += bf16_phase("mla bf16", base, prompts, dev, card,
                         family_tag="@mla",
                         profile="mla_decode_step_profile.txt")
    return counts


def hybrid_path(dev, card):
    """Phases 4d-5d: zamba2-7b at all 81 layers through the shared block's
    KV block pools and the Mamba-2 state slabs in one decode call; returns
    the launch counts."""
    from repro_torch.configs.registry import get_config

    base = get_config("zamba2_7b")
    prompts = _prompts(base.vocab_size)
    counts = fp32_phase("hybrid fp32",
                        dataclasses.replace(base, dtype="float32"), prompts,
                        dev, card, family_tag="@hybrid")
    counts += bf16_phase("hybrid bf16", base, prompts, dev, card,
                         family_tag="@hybrid",
                         profile="hybrid_decode_step_profile.txt",
                         prefill_file="hybrid_prefill_profile.txt")
    return counts


def encdec_path(dev, card):
    """Phases 4e-5e: whisper-medium at all 24 + 24 layers through the
    decoder's KV block pools and the shared cross-attention segments in
    one decode call; each server must hold exactly one segment while its
    streams run.  Returns the launch counts."""
    from repro_torch.configs.registry import get_config

    base = get_config("whisper_medium")
    prompts = _prompts(base.vocab_size)

    def one_segment(tag, run):
        if run["segments_peak"] != [1, 1]:
            raise SmokeFailure(f"{tag}: servers held at most "
                               f"{run['segments_peak']} segments while their "
                               "streams ran, want exactly one each")
        print(f"{tag}: segments held per server while streams ran "
              f"{run['segments_peak']} (one shared segment each)")

    counts = fp32_phase("encdec fp32",
                        dataclasses.replace(base, dtype="float32"), prompts,
                        dev, card, family_tag="@encdec", check=one_segment)
    counts += bf16_phase("encdec bf16", base, prompts, dev, card,
                         family_tag="@encdec", check=one_segment,
                         profile="encdec_decode_step_profile.txt",
                         prefill_file="encdec_prefill_profile.txt")
    return counts


def mrope_teacher_forced(cfg, params, dev, s=32, steps=8):
    """The VLM stack's own inputs at full width: embeddings (1, s, d) and
    (3, 1, s) M-RoPE positions whose t, h and w streams differ (an image's
    patch grid, 4 wide).  Prefill s - steps positions, then decode the
    last ``steps`` one at a time with their embeddings and positions: the
    logits must be the full forward's within 1e-4 (the cache is exact).
    The prefill and the forward run flash, the decode steps the dense
    decode kernel."""
    from repro_torch.models import model as M

    gen = torch.Generator(device=dev).manual_seed(SEED)
    emb = torch.randn((1, s, cfg.d_model), generator=gen, device=dev)
    idx = torch.arange(s, device=dev)
    pos = torch.stack([idx // 4, 2 * (idx // 4) + 1, idx % 4 + 3 * (idx // 4)]
                      ).to(torch.int32)[:, None, :]
    n = s - steps
    with torch.inference_mode():
        full, _, _ = M.apply(cfg, params, {"embeds": emb,
                                           "mrope_positions": pos},
                             mode="train")
        _, cache, _ = M.apply(cfg, params, {
            "embeds": emb[:, :n], "mrope_positions": pos[:, :, :n],
            "max_seq": s}, mode="prefill")
        outs = []
        for t in range(n, s):
            lg, cache, _ = M.apply(cfg, params, {
                "embeds": emb[:, t:t + 1],
                "mrope_positions": pos[:, :, t:t + 1]},
                mode="decode", cache=cache)
            outs.append(lg[:, 0])
        got, want = torch.stack(outs, 1), full[:, n:]
        err = (got - want).abs().max().item()
        ok = bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
    print(f"check vlm M-RoPE teacher-forced decode [{steps} steps after a "
          f"{n}-position prefill, embeddings and distinct (t, h, w) "
          f"positions] float32: max_abs_err={err:.3e} against the full "
          f"forward (tol 1e-4) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"M-RoPE teacher-forced decode is {err} from the "
                           "full forward")


def vlm_path(dev, card):
    """Phases 4f-5f: qwen2-vl-2b at all 28 layers, served from tokens (the
    engine's input, plain rope) through GQA block pools; phase 4f also
    holds the stack's M-RoPE and embedding inputs at full width.  Returns
    the launch counts."""
    from repro_torch.configs.registry import get_config

    base = get_config("qwen2_vl_2b")
    prompts = _prompts(base.vocab_size)
    counts = fp32_phase("vlm fp32", dataclasses.replace(base, dtype="float32"),
                        prompts, dev, card, family_tag="",
                        extra=lambda cfg, params, ref, _: mrope_teacher_forced(
                            cfg, params, dev))
    counts += bf16_phase("vlm bf16", base, prompts, dev, card, family_tag="",
                         profile="vlm_decode_step_profile.txt")
    return counts


# ---------------------------------------------------------------------------
# phase 7: stream recovery, live migration, elasticity, masked-dense
# ---------------------------------------------------------------------------

MIGRANT = "s1"            # the stream phase 7b moves (prompt 40)
MIGRATE_AFTER = 8         # decode calls its server makes before the move
FT_TIMEOUT_S = 1.0        # heartbeat timeout of the stall runs
STALL_S = 5.0             # the injected stall (5 heartbeat timeouts)
FAULT_AT_CALL = 20        # the victim server's call that faults (mid-decode)


def wait_for(cond, what, timeout=300.0, poll=0.002):
    t_end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > t_end:
            raise SmokeFailure(f"timed out waiting for {what}")
        time.sleep(poll)


def migrate_mid_decode(eng):
    """Phase 7b, run while the traffic does: once the server of stream
    MIGRANT has made MIGRATE_AFTER decode calls, admission moves the stream
    to the other server and the pool records the intent; its own thread
    then moves its live cache at the next step boundary.  Returns what the
    move found on the destination: resident segments before and after it,
    and the refcount of the segment the stream got there."""
    src = eng.pool.server_of(MIGRANT)
    dst = 1 - src
    server = eng.pool.servers[src]
    wait_for(lambda: sum(m["kind"] == eng._decode_kind
                         for m in server.stats.batch_meta) >= MIGRATE_AFTER,
             f"{MIGRATE_AFTER} decode calls on server {src}")
    seen = dict(src=src, dst=dst)
    real = eng._execute_migration
    st = eng._paged[dst]

    def held():
        with st.lock:
            return st.mgr.segments_in_use - (
                st.mgr.seqs["__scratch__"].segment is not None)

    def traced(name, seq_id, src_si, dst_si, prio):
        if "segment" not in eng._cache_kinds:
            return real(name, seq_id, src_si, dst_si, prio)
        seen["segments_before"] = held()
        out = real(name, seq_id, src_si, dst_si, prio)
        seen["segments_after"] = held()
        with st.lock:
            seen["segment_refs"] = st.mgr.segment_refcount[out[2]]
        return out

    eng._execute_migration = traced
    _, d = eng.admission.migrate(MIGRANT, dst)
    if d != dst or not eng.pool.request_migration(MIGRANT, dst):
        raise SmokeFailure(f"migration of {MIGRANT} to server {dst} refused")
    wait_for(lambda: eng.migrations_completed >= 1, "the migration")
    return seen


def report_migration(tag, run, card):
    """Phase 7b's bars and numbers: exactly one migration, both sides
    replayed, the stream on its destination; export and import call ms,
    bytes moved against the bytes / HBM bound, the host hop's share; for
    a family with segments, the stream joined the destination's resident
    segment."""
    seen = run["during"]
    sides = {m["side"]: m for m in run["migrations"]}
    if len(run["migrations"]) != 2 or set(sides) != {"export", "import"}:
        raise SmokeFailure(f"{tag}: migration calls {run['migrations']}, "
                           "want one export and one import")
    exp, imp = sides["export"], sides["import"]
    if not (exp["graphed"] and imp["graphed"]):
        raise SmokeFailure(f"{tag}: a migration call ran eagerly")
    mb = exp["nbytes"] / 1e6
    bound = exp["nbytes"] / HBM_BYTES_S * 1e3
    hop = exp["hop_seconds"] + imp["hop_seconds"]
    total = exp["seconds"] + imp["seconds"]
    print(f"{tag} migration [{card}]: {MIGRANT} server {seen['src']} -> "
          f"{seen['dst']} after {MIGRATE_AFTER} decode calls, {exp['rows']} "
          f"blocks in a width-{exp['padded']} cell, {mb:.3f} MB moved; "
          f"export {exp['seconds'] * 1e3:.3f} ms (device-to-host copy "
          f"{exp['hop_seconds'] * 1e3:.3f} ms), import "
          f"{imp['seconds'] * 1e3:.3f} ms (host-to-device copy "
          f"{imp['hop_seconds'] * 1e3:.3f} ms); bound {bound:.4f} ms per side"
          f" (bytes / 3.35 TB/s); host hop {hop / total:.3f} of the two "
          f"calls; tokens == unmigrated unbatched (checked above)")
    if "segment_refs" in seen and seen["segments_before"]:
        joined = (seen["segments_after"] == seen["segments_before"]
                  and seen["segment_refs"] >= 2)
        print(f"{tag} migration: destination held {seen['segments_before']} "
              f"segment(s) before, {seen['segments_after']} after, the "
              f"stream's segment refcount {seen['segment_refs']}: "
              f"{'joined the resident key' if joined else 'NOT joined'}")
        if not joined:
            raise SmokeFailure(f"{tag}: the migrated stream did not join the "
                               "destination's resident segment")


def inactive_rows_probe(eng):
    """Phase 7d: before the traffic, copy rows 0 and 1 of every server's
    slot cache (each leaf and ``pos``; precompile's warm-up inserted into
    row 0) and record every slot a stream acquires; after it, every copied
    row no stream held must be bit for bit as it was, across every masked
    step.  Returns the check, which returns the rows it held."""
    from repro_torch.serving.engine import _cache_leaves

    rows = (0, 1)
    saved, used = {}, set()
    acquire = eng._acquire_slot

    def recorded(si):
        slot = acquire(si)
        used.add((si, slot))
        return slot

    eng._acquire_slot = recorded
    for si, st in enumerate(eng._slots):
        leaves = [*_cache_leaves(st.cache), st.cache["pos"]]
        axes = [a for a, _, _ in eng._batch_axes] + [0]
        saved[si] = [(leaf, ax, {r: leaf.select(ax, r).clone()
                                 for r in rows})
                     for leaf, ax in zip(leaves, axes)]

    def check():
        held = 0
        for si, leaves in saved.items():
            for r in rows:
                if (si, r) in used:
                    continue
                for leaf, ax, before in leaves:
                    if not torch.equal(leaf.select(ax, r), before[r]):
                        raise SmokeFailure(f"masked-dense: server {si}'s "
                                           f"inactive slot {r} changed")
                held += 1
        if not held:
            raise SmokeFailure("masked-dense: every probed slot was used")
        return held

    return check


def masked_dense_fp32(tag, cfg, params, prompts, dev, ref):
    """Phase 7d in fp32: the same traffic through ``batching=True,
    paged=False`` (every decode call all 4 slot rows, graphed): tokens must
    equal unbatched ``generate``'s, every call replay, nothing leak, and
    the inactive slots keep their bits.  Returns the launch counts."""
    run = serve_batched(cfg, params, prompts, dev, paged=False,
                        probe=inactive_rows_probe)
    check_outputs(tag, run, prompts)
    if any(m["padded"] != 4 for m in run["decode_calls"]):
        raise SmokeFailure(f"{tag}: a masked decode call ran fewer rows")
    check_tokens(tag, run, ref, prompts)
    print(f"{tag}: {run['probe']} inactive slot rows unchanged bit for bit "
          f"across {len(run['decode_calls'])} masked decode calls")
    counts = Counter(run["launches"])
    del run
    free_card()
    return counts


def serve_with_fault(cfg, params, prompts, dev, kind, cost_model=None):
    """Phase 7a: the traffic on 2 graphed servers with fault tolerance on,
    the server of stream s0 faulting at its FAULT_AT_CALL-th call --
    ``die`` (heartbeat FT_TIMEOUT_S * 30) or a ``stall`` of STALL_S that
    the heartbeat (FT_TIMEOUT_S) must detect.  Every server is woken by a
    first call before the fault is armed.  ``cost_model`` (phase 9's
    fitted model) prices the recovery and a migration in place of the
    declared costs.  Returns the run, with the death timed where it was
    handled."""
    from repro_torch.kernels import _build
    from repro_torch.runtime.faultinject import FaultInjector, ServerFault
    from repro_torch.serving.engine import ServeEngine

    eng = ServeEngine(cfg, params, max_seq=MAX_SEQ, num_servers=2,
                      batching=True, max_batch=4, paged=True,
                      kv_block_size=BLOCK, device=dev, cost_model=cost_model)
    try:
        rep = eng.precompile(prompt_buckets=BUCKETS)
        cells = captured_cells(eng, rep)
        deaths = []
        handle = eng._on_server_death

        def timed(si, displaced=None):
            n, at = len(eng.degraded_reports), time.monotonic()
            seen = [len(s.stats.batch_meta) for s in eng.pool.servers]
            handle(si, displaced)
            if len(eng.degraded_reports) > n:
                deaths.append(dict(si=si, at=at, meta=seen,
                                   done=time.monotonic()))

        eng._on_server_death = timed
        timeout = FT_TIMEOUT_S if kind == "stall" else 30 * FT_TIMEOUT_S
        eng.enable_fault_tolerance(heartbeat_timeout_s=timeout)
        for s in eng.pool.servers:  # an idle server beats once woken
            s.submit(lambda: None).wait(60)
        for i, name in enumerate(prompts):
            if not eng.admit(_spec(name, len(prompts) - i)).admitted:
                raise SmokeFailure(f"stream {name} not admitted")
        victim = eng.pool.server_of("s0")
        inj = FaultInjector([ServerFault(server=victim, at_call=FAULT_AT_CALL,
                                         kind=kind, delay_s=STALL_S)])
        eng.pool.attach_fault_injector(inj)
        _build.reset_launches()
        results, _, wall_s = run_streams(eng, prompts)
        launches = dict(_build.launches)
        survivor = 1 - victim
        meta = eng.pool.servers[survivor].stats.batch_meta
        dead = eng._paged[victim]
        kept = sum(t.numel() * t.element_size()
                   for v in dead.pools.values() for t in v)
        return dict(results=results, victim=victim, survivor=survivor,
                    deaths=deaths, events=list(inj.events),
                    reports=list(eng.degraded_reports),
                    alive=eng.pool.alive_servers(), usage=eng.kv_usage(),
                    meta=list(meta), cells=cells, launches=launches,
                    wall_s=wall_s, kept_bytes=kept,
                    kept_graphs=len(dead.graphs), graphs=True,
                    cost_model=cost_model is not None,
                    migration_ms=eng._migration_cost_ms("s0"),
                    recovery_cell=(eng._prefill_kind, 1,
                                   eng.prefill_buckets[-1]),
                    recovery_pred_ms=(
                        cost_model.predict(eng._prefill_kind, 1,
                                           eng.prefill_buckets[-1]) * 1e3
                        if cost_model is not None else None),
                    decode_calls=[m for s in eng.pool.servers
                                  for m in s.stats.batch_meta
                                  if m["kind"] == "decode"],
                    prefill_calls=[m for s in eng.pool.servers
                                   for m in s.stats.batch_meta
                                   if m["kind"] == "prefill"],
                    slots_free=len(eng._slots[survivor].free))
    finally:
        eng.close()
        vars(eng).pop("_on_server_death", None)


def report_recovery(tag, run, card, ref=None, migrate_ms=None):
    """Phase 7a's bars -- one death handled once, the victim's streams
    recovered, nothing leaked, every survivor call a replay, the launches
    adding up, and (with ``ref``, fp32) every stream's tokens equal to
    unbatched ``generate``'s -- then detection, resume and the re-prefill
    call against its priced recovery segment, and (phase 9.3, with a cost
    model attached) the priced migration beside 7b's measured one
    (``migrate_ms``)."""
    if len(run["deaths"]) != 1 or len(run["reports"]) != 1:
        raise SmokeFailure(f"{tag}: {len(run['reports'])} degraded reports, "
                           "want one")
    if run["alive"] != [run["survivor"]]:
        raise SmokeFailure(f"{tag}: alive servers {run['alive']}")
    if any(run["usage"].values()) or run["slots_free"] != 4:
        raise SmokeFailure(f"{tag}: leaked {run['usage']}, "
                           f"{run['slots_free']} slots free")
    if not all(m["graphed"] for m in run["meta"]):
        raise SmokeFailure(f"{tag}: a survivor call ran eagerly")
    check_cell_launches(tag, run)
    recovered = {n: r for n, r in run["results"].items() if r.recoveries}
    if not recovered:
        raise SmokeFailure(f"{tag}: no stream went through recovery")
    if ref is not None:
        for name, res in run["results"].items():
            if res.tokens != ref[name].tokens:
                raise SmokeFailure(f"{tag} {name}: recovered tokens "
                                   f"{res.tokens} != unbatched "
                                   f"{ref[name].tokens}")
        print(f"{tag}: every stream's tokens == unbatched ({len(recovered)} "
              f"recovered: {sorted(recovered)})")
    death, report = run["deaths"][0], run["reports"][0]
    fault = run["events"][0]
    after = run["meta"][death["meta"][run["survivor"]]:]
    reprefill = [m for m in after if m["kind"] == "prefill"]
    if not reprefill:
        raise SmokeFailure(f"{tag}: no re-prefill on the survivor")
    first = reprefill[0]
    resume = [(r.resumed_at_monotonic[0] - fault.at_monotonic) * 1e3
              for r in recovered.values()]
    priced = sorted(report.recovery_ms.values())
    print(f"{tag} [{card}]: {fault.kind} on server {run['victim']} at call "
          f"{fault.call}; detection {(death['at'] - fault.at_monotonic) * 1e3:.3f}"
          f" ms (fault to eviction), re-admission "
          f"{(death['done'] - death['at']) * 1e3:.3f} ms, resume "
          f"{[round(x, 3) for x in resume]} ms (fault to the first resumed "
          f"token) for {sorted(recovered)}")
    print(f"{tag} [{card}]: re-prefill calls on the survivor: "
          + ", ".join(f"{m['rows']} row(s) bucket {m['bucket']} "
                      f"{m['seconds'] * 1e3:.3f} ms"
                      for m in reprefill)
          + f"; priced recovery segment {priced} ms (_recovery_cost_ms: "
          + ("phase 9's fitted cost model, capped at" if run["cost_model"]
             else "no cost model:")
          + f" the declared prefill_ms 50.0) against the first call's "
          f"{first['seconds'] * 1e3:.3f} ms")
    if run["cost_model"]:
        print(f"{tag} phase 9 [{card}]: the model's {run['recovery_cell']} "
              f"(the largest bucket, what _recovery_cost_ms prices) "
              f"{run['recovery_pred_ms']:.3f} ms, x safety 1.2 = "
              f"{run['recovery_pred_ms'] * 1.2:.3f} ms")
        moved = (f"phase 7b's measured export + import {migrate_ms:.3f} ms"
                 if migrate_ms is not None else
                 "no migrate cell measured in this dtype (0 = unpriced)")
        print(f"{tag} phase 9 [{card}]: _migration_cost_ms "
              f"{run['migration_ms']:.3f} ms (full-width table, both sides, "
              f"x safety 1.2) beside {moved}; declared: none")
    print(f"{tag}: the dead server keeps {run['kept_bytes'] / 1e9:.3f} GB of "
          f"pools and {run['kept_graphs']} graphs, never used again")
    return Counter(run["launches"])


def recovery_fp32(tag, cfg, params, prompts, dev, card, ref, priced):
    """Phase 7a in fp32: a death, then (a second engine) a stall found by
    the heartbeat; recovered tokens equal unbatched with phase 9's fitted
    cost model attached (``priced``).  The stall must be detected before it
    ends."""
    counts = Counter()
    for kind in ("die", "stall"):
        run = serve_with_fault(cfg, params, prompts, dev, kind,
                               cost_model=priced["model"])
        counts += report_recovery(f"{tag} {kind}", run, card, ref,
                                  migrate_ms=priced["migrate_ms"])
        if kind == "stall":
            fault = run["events"][0]
            if run["deaths"][0]["at"] - fault.at_monotonic >= STALL_S:
                raise SmokeFailure(f"{tag}: the stall was not detected by "
                                   "the heartbeat before it ended")
        del run
        free_card()
    return counts


def elastic_run(cfg, params, prompts, dev, card):
    """Phase 7c (bf16, graphed): work stealing with every stream pinned on
    server 0; ``consolidate(1)`` and ``remove_server(1)`` mid-traffic;
    ``add_server()`` mid-traffic (its capture count and seconds, device
    memory around it), two streams admitted onto it, every one of its
    calls a replay; then ``ElasticPoolController.scale_to`` 3 and, with the
    traffic running, 1.  Nothing may leak."""
    from repro_torch.kernels import _build
    from repro_torch.runtime.elastic import ElasticPoolController
    from repro_torch.serving.engine import ServeEngine

    tag = "elastic bf16"
    mem = lambda: torch.cuda.memory_allocated(dev) / 1e9
    eng = ServeEngine(cfg, params, max_seq=MAX_SEQ, num_servers=2,
                      batching=True, max_batch=4, paged=True,
                      kv_block_size=BLOCK, device=dev)
    counts = Counter()
    try:
        captured_cells(eng, eng.precompile(prompt_buckets=BUCKETS))
        eng.enable_work_stealing()
        for i, name in enumerate(prompts):
            if not eng.admit(_spec(name, len(prompts) - i)).admitted:
                raise SmokeFailure(f"stream {name} not admitted")
            if eng.admission.device_of(name) != 0:
                eng.admission.migrate(name, 0)
            eng.pool.reassign(name, 0, priority=len(prompts) - i)

        def round_(label, during=None):
            _build.reset_launches()
            t0 = time.monotonic()
            _, seen, _ = run_streams(eng, prompts, during=during)
            counts.update(_build.launches)
            print(f"{tag} {label} [{card}]: {time.monotonic() - t0:.3f} s, "
                  f"{eng.migrations_completed} migrations so far, servers "
                  f"alive {eng.pool.alive_servers()}, kv_usage "
                  f"{eng.kv_usage()}")
            return seen

        round_("stealing (all streams pinned on server 0)")
        if eng.migrations_completed < 1:
            raise SmokeFailure(f"{tag}: work stealing moved no stream")

        def drain_1(eng):
            wait_for(lambda: len(eng._active_jobs) == len(prompts),
                     "every stream active")
            moved = eng.consolidate(1)
            before = mem()
            eng.remove_server(1, timeout_s=300.0)
            return moved, before, mem()

        moved, before, after = round_("consolidate(1) + remove_server(1)",
                                      drain_1)
        print(f"{tag}: consolidate(1) moved {moved}; memory_allocated "
              f"{before:.3f} GB before remove_server(1), {after:.3f} GB after")
        if eng.pool.alive_servers() != [0]:
            raise SmokeFailure(f"{tag}: server 1 not retired")

        added = {}

        def grow(eng):
            wait_for(lambda: len(eng._active_jobs) == len(prompts),
                     "every stream active")
            added["before"] = mem()
            t0 = time.monotonic()
            added["si"] = eng.add_server()
            added["s"] = time.monotonic() - t0
            added["after"] = mem()

        round_("add_server() mid-traffic", grow)
        si = added["si"]
        graphs = len(eng._paged[si].graphs)
        if graphs != len(eng._paged[0].graphs):
            raise SmokeFailure(f"{tag}: the added server captured {graphs} "
                               f"graphs, server 0 has "
                               f"{len(eng._paged[0].graphs)}")
        print(f"{tag} [{card}]: add_server() -> server {si} captured "
              f"{graphs} graphs in {added['s']:.3f} s while server 0 served; "
              f"memory_allocated {added['before']:.3f} GB before, "
              f"{added['after']:.3f} GB after")
        late = {f"n{i}": p for i, p in enumerate(prompts.values()) if i < 2}
        for name in late:
            if not eng.admit(_spec(name, 1)).admitted:
                raise SmokeFailure(f"stream {name} not admitted")
        print(f"{tag}: streams by server after the steals onto server {si} "
              f"and two more admitted: "
              f"{ {n: eng.pool.server_of(n) for n in {**prompts, **late}} }")
        _build.reset_launches()
        run_streams(eng, {**prompts, **late})
        counts.update(_build.launches)
        calls = eng.pool.servers[si].stats.batch_meta
        if not calls or not all(m["graphed"] for m in calls):
            raise SmokeFailure(f"{tag}: server {si} made {len(calls)} calls, "
                               "not all replays")
        print(f"{tag}: every one of the added server's {len(calls)} calls "
              f"replayed a graph")

        ctl = ElasticPoolController(eng, min_servers=1, max_servers=4)
        t0 = time.monotonic()
        live = ctl.scale_to(3)
        print(f"{tag} [{card}]: scale_to(3) -> servers {live} in "
              f"{time.monotonic() - t0:.3f} s, memory_allocated {mem():.3f} GB")

        def shrink(eng):
            wait_for(lambda: len(eng._active_jobs) == len(prompts),
                     "every stream active")
            t0 = time.monotonic()
            live = ctl.scale_to(1, timeout_s=300.0)
            return live, time.monotonic() - t0

        live, secs = round_("scale_to(1) mid-traffic", shrink)
        print(f"{tag} [{card}]: scale_to(1) -> servers {live} in {secs:.3f} "
              f"s (events {ctl.events}), memory_allocated {mem():.3f} GB after"
              f" the removals")
        if len(live) != 1 or any(eng.kv_usage().values()):
            raise SmokeFailure(f"{tag}: servers {live}, kv_usage "
                               f"{eng.kv_usage()}")
        if any(len(eng._slots[i].free) != 4 for i in live):
            raise SmokeFailure(f"{tag}: slots held after the traffic")
        print(f"{tag}: {eng.migrations_completed} live migrations in all, "
              f"nothing leaked")
    finally:
        eng.close()
    del eng
    free_card()
    return counts


def gqa_bf16_phase7(cfg, params, prompts, dev, card, runs):
    """Phase 7 at internlm2-1.8b in bf16: the recovery timings (7a: a
    death and a stall), elasticity (7c), and the masked-dense layout beside
    the paged engine's graphed run of phase 5 on the same traffic (7d).
    The recovery runs carry phase 9's model fitted on phase 5's graphed
    run.  Returns the launch counts."""
    counts = Counter()
    for kind in ("die", "stall"):
        run = serve_with_fault(cfg, params, prompts, dev, kind,
                               cost_model=runs["graphed"]["after"])
        counts += report_recovery(f"recovery bf16 {kind}", run, card)
        del run
        free_card()
    counts += elastic_run(cfg, params, prompts, dev, card)
    masked = serve_batched(cfg, params, prompts, dev, paged=False)
    check_outputs("masked-dense bf16", masked, prompts)
    counts += Counter(masked["launches"])
    paged = runs["graphed"]
    for label, run in (("paged", paged), ("masked-dense", masked)):
        report_latency(f"masked-vs-paged bf16 {label}", run, card)
    decode_cells = sorted((k, dict(v)) for k, v in paged["cells"].items()
                          if k[0] == "decode")
    print(f"masked-vs-paged bf16 [{card}]: decode launches per call, "
          f"masked-dense (4 rows of {MAX_SEQ} positions) "
          f"{dict(masked['cells'][('decode', 4, 0)])}; paged (rows, width) "
          + "; ".join(f"({r},{w}) {v}" for (_, r, w), v in decode_cells))
    del masked
    free_card()
    return counts


def report_latency(tag, run, card):
    prefill = [r.prefill_latency_s * 1e3 for r in run["results"].values()]
    steps = sorted(x * 1e3 for r in run["results"].values()
                   for x in r.decode_latencies_s)
    p50 = steps[len(steps) // 2]
    p99 = steps[min(len(steps) - 1, int(round(0.99 * (len(steps) - 1))))]
    tokens = sum(len(r.tokens) for r in run["results"].values())
    print(f"{tag} [{card}]: prefill latency ms per stream "
          f"{[round(x, 3) for x in prefill]}")
    print(f"{tag} [{card}]: decode step latency p50 {p50:.3f} ms, "
          f"p99 {p99:.3f} ms over {len(steps)} steps")
    print(f"{tag} [{card}]: {tokens} tokens in {run['wall_s']:.3f} s = "
          f"{tokens / run['wall_s']:.1f} tokens/s (4 streams, 2 servers, "
          f"precompile {run['warm_s']:.1f} s not counted)")
    for kind in ("decode", "prefill"):
        calls = run[f"{kind}_calls"]
        dev_ms = sorted(m["seconds"] * 1e3 for m in calls)
        print(f"{tag} [{card}]: {len(calls)} {kind} device calls, "
              f"{sum(m['rows'] for m in calls) / len(calls):.2f} rows per "
              f"call, device call p50 {dev_ms[len(dev_ms) // 2]:.3f} ms, max "
              f"{dev_ms[-1]:.3f} ms (server thread, launch to stream sync)")


def decode_step_cache(cfg, dev):
    """The pools and per-call cache entries of one 4-row paged decode step
    at phase 5's final lengths, for each pool kind of the family: block
    tables over the block pools (GQA, MLA -- the prefix layer's pools share
    them -- the hybrid stack's shared block and the enc-dec decoder's self
    attention), slab ids 1-4 over the slab pools (SSM, the hybrid stack's
    Mamba-2 layers) and segment id 1 for every row over the segment pools
    (the enc-dec cross-attention: the traffic's streams share one
    segment).  Returns (step cache, width; 0 without block pools)."""
    from repro_torch.models import model as M

    lengths = torch.tensor([p + STEPS for p in PROMPT_LENS],
                           dtype=torch.int32, device=dev)
    kinds = set(M.paged_pool_kinds(cfg).values())
    nb_row = MAX_SEQ // BLOCK
    pools = M.init_paged_cache(
        cfg, 4 * nb_row + 1 if "block" in kinds else 0, BLOCK,
        num_slabs=NUM_SLABS if "slab" in kinds else 0,
        num_segments=NUM_SEGMENTS if "segment" in kinds else 0, device=dev)
    cache, w = dict(pools, pos=lengths), 0
    if "slab" in kinds:
        cache["slab_ids"] = torch.arange(1, 5, dtype=torch.int32, device=dev)
    if "segment" in kinds:
        cache["segment_ids"] = torch.ones(4, dtype=torch.int32, device=dev)
    if "block" in kinds:
        need = -(-(int(lengths.max()) + 1) // BLOCK)
        w = 1 << (need - 1).bit_length()
        cache["block_tables"] = (
            1 + torch.arange(4, device=dev)[:, None] * nb_row
            + torch.arange(w, device=dev)[None, :]).to(torch.int32)
    return cache, w


def profile_calls(fn, n: int = 5) -> dict:
    """One function's timings: CUDA-event ms per call (10 back to back,
    median of 3), host ms to issue one call, and the device kernels of one
    torch.profiler window of ``n`` calls -- device busy per call and the
    idle share of the event time."""
    ms = time_ms(fn, iters=10, reps=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events, key, kernels = device_kernels(prof)
    kernels.sort(key=lambda e: getattr(e, key), reverse=True)
    busy = sum(getattr(e, key) for e in kernels) / 1e3 / n
    return dict(ms=ms, host_ms=host_ms, busy_ms=busy,
                idle=max(0.0, 1 - busy / ms), events=events, key=key,
                kernels=kernels, n=n)


def step_profile(cfg, params, dev, card, tag, outfile):
    """Where one decode step's time goes: the model's paged decode step
    alone (no engine, no threads) on 4 rows at phase 5's final lengths,
    run eagerly and as one CUDA graph captured from it
    (``repro_torch.serving.graphs.GraphCell``) and replayed on the same
    cache -- for each, CUDA-event time per step, host time to issue it,
    device busy from one torch.profiler window of 5 steps and the idle
    share (the kernel tables go to chiprun_out/<outfile>).  The replay's
    logits must equal the eager step's bit for bit (the pools are restored
    before each: SSM slabs advance in place).  Returns {"eager": ...,
    "graphed": ...}."""
    from repro_torch.models import model as M
    from repro_torch.serving.graphs import GraphCell

    cache, w = decode_step_cache(cfg, dev)
    tokens = torch.ones((4, 1), dtype=torch.int32, device=dev)

    def run(t):
        return M.apply(cfg, params, {"tokens": t}, mode="decode",
                       cache=dict(cache))[0]

    def step():
        with torch.inference_mode():
            run(tokens)

    pools = [t for t in cache.values() if isinstance(t, tuple)]
    pools = [t for leaves in pools for t in leaves]
    saved = [t.clone() for t in pools]

    def restore():
        for t, s in zip(pools, saved):
            t.copy_(s)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.inference_mode():
        with torch.cuda.stream(side):
            run(tokens)  # warm the capture stream
            cell = GraphCell(run, [tokens])
        torch.cuda.current_stream(dev).wait_stream(side)
        restore()
        want = run(tokens).clone()
        restore()
        cell.graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(cell.outputs, want):
            err = (cell.outputs - want).abs().max().item()
            raise SmokeFailure(f"{tag}: the replayed step's logits differ "
                               f"from the eager step's (max {err:.3e})")
    profs = {"eager": profile_calls(step),
             "graphed": profile_calls(cell.graph.replay)}
    lengths = [p + STEPS for p in PROMPT_LENS]
    print(f"{tag} [{card}] {cfg.name} {cfg.dtype}, 4 rows, W={w}, lengths "
          f"{lengths}: replayed logits == eager logits bit for bit")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    tables = []
    for mode, p in profs.items():
        busy = (f"device busy {p['busy_ms']:.3f} ms, idle share "
                f"{p['idle']:.3f}" if p["kernels"] else
                "device busy not measured (no device activity recorded)")
        print(f"{tag} [{card}] {mode}: {p['ms']:.3f} ms per step (CUDA "
              f"events), host {'enqueue' if mode == 'eager' else 'replay'} "
              f"{p['host_ms']:.3f} ms, {busy}, "
              f"{sum(e.count for e in p['kernels']) // p['n']} device "
              "activities per step")
        for e in p["kernels"][:8]:
            print(f"{tag} {mode}: {getattr(e, p['key']) / 1e3 / p['n']:8.4f}"
                  f" ms/step {e.count // p['n']:5d} calls/step  {e.key[:90]}")
        tables.append(f"{mode}\n" + p["events"].table(sort_by=p["key"],
                                                      row_limit=60))
    (out / outfile).write_text("\n".join(tables))
    del cell, saved
    return profs


def decode_breakdown(tag, run, prof, card) -> None:
    """Where the engine's decode time goes beside the model's step: the
    client's step latency (submit to result) is the device call (server
    thread: staging, copies, the step, the stream sync) plus the time
    outside it (queueing behind other streams' calls, thread hand-offs);
    the device call is the model-only step (``prof``: CUDA events) plus
    the engine's work around it."""
    client = sorted(x * 1e3 for r in run["results"].values()
                    for x in r.decode_latencies_s)
    call = sorted(m["seconds"] * 1e3 for m in run["decode_calls"])
    c50, d50 = client[len(client) // 2], call[len(call) // 2]
    print(f"{tag} [{card}]: decode p50 {c50:.3f} ms (client) = device call "
          f"p50 {d50:.3f} ms + {c50 - d50:.3f} ms outside the call; the "
          f"call = model-only step {prof['ms']:.3f} ms + {d50 - prof['ms']:.3f}"
          f" ms around it in the engine")


def prefill_profile(cfg, params, dev, card, tag, outfile):
    """Where one prefill call's time goes: the model's prefill alone (no
    engine, no threads) on one row of the 200-token prompt padded to its
    bucket 256, as the batched engine's prefill call runs it -- CUDA-event
    time per call, host time to enqueue it, and the device time of each
    kernel from one torch.profiler window of one call (tables by device
    time and by host time go to chiprun_out/<outfile>)."""
    from repro_torch.models import model as M

    n, bucket = PROMPT_LENS[-1], min(b for b in BUCKETS if b >= PROMPT_LENS[-1])
    tokens = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    tokens[0, :n] = torch.arange(n, device=dev) % cfg.vocab_size
    batch = model_batch(cfg, tokens, dev, max_seq=MAX_SEQ,
                        lengths=torch.tensor([n], dtype=torch.int32,
                                             device=dev))

    def call():
        with torch.inference_mode():
            M.apply(cfg, params, batch, mode="prefill")

    call_ms = time_ms(call, iters=2, reps=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    events, key, kernels = device_kernels(prof)
    dev_us = lambda e: getattr(e, key)
    kernels.sort(key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"{tag} [{card}] {cfg.name} {cfg.dtype}, 1 row, prompt {n} padded "
          f"to {bucket}: {call_ms:.3f} ms per call (CUDA events), host "
          f"enqueue {host_ms:.3f} ms, device busy {busy_ms:.3f} ms in "
          f"{launches} device activities, idle share "
          f"{max(0.0, 1 - busy_ms / call_ms):.3f}")
    for e in kernels[:8]:
        print(f"{tag}: {dev_us(e) / 1e3:8.4f} ms {e.count:5d} calls  "
              f"{e.key[:90]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / outfile).write_text(
        "by device time\n" + events.table(sort_by=key, row_limit=60)
        + "\nby host time\n"
        + events.table(sort_by="self_cpu_time_total", row_limit=60))


# ---------------------------------------------------------------------------
# phase 9: static cell pricing on the card's engines
# ---------------------------------------------------------------------------

PRICING_FILE = "static_pricing.txt"  # per-cell table, under chiprun_out/


def warm_cells(eng) -> list:
    """Every warm cell of a paged engine as a cost-model CellKey."""
    return ([(eng._decode_kind, r, w) for r, w in sorted(eng._warm_decode)]
            + [(eng._prefill_kind, r, b)
               for r, b in sorted(eng._warm_prefill)]
            + [(eng._migrate_kind, w, eng.kv_block_size)
               for w in sorted(eng._warm_migrate)])


def price_cells(tag, eng, cells, card) -> dict:
    """Phase 9.1: ``static_cell_costs`` over ``cells``.  Pricing runs on
    meta twins: it must launch no kernel, capture no graph and leave every
    captured cell's launch count and the warm sets as they were.  Prints
    each phase's cells (flops / bytes) and the seconds pricing took."""
    from repro_torch.kernels import _build

    def state():
        return (dict(_build.launches),
                [{k: dict(g.launches) for k, g in st.graphs.items()}
                 for st in eng._paged],
                (set(eng._warm_decode), set(eng._warm_prefill),
                 set(eng._warm_migrate)))

    before = state()
    t0 = time.monotonic()
    costs = eng.static_cell_costs(cells)
    secs = time.monotonic() - t0
    if state() != before:
        raise SmokeFailure(f"{tag}: static pricing changed the launch "
                           "counters, the graphs or the warm sets")
    bad = [c for c, (f, b) in costs.items()
           if not (math.isfinite(f) and math.isfinite(b) and b > 0)]
    if len(costs) != len(cells) or bad:
        raise SmokeFailure(f"{tag}: static pricing gave {len(costs)} of "
                           f"{len(cells)} cells, not finite or no bytes: "
                           f"{bad}")
    by_phase: dict = {}
    for c in cells:
        by_phase.setdefault(c[0], []).append(c)
    print(f"{tag} [{card}]: priced {len(costs)} warm cells ("
          + ", ".join(f"{len(v)} {k}" for k, v in by_phase.items())
          + f") in {secs:.2f} s on meta twins; launch counters, "
          f"{sum(len(st.graphs) for st in eng._paged)} graphs and the warm "
          "sets unchanged")
    for phase, keys in by_phase.items():
        print(f"{tag} {phase} (rows,width|bucket) flops/bytes: " + "; ".join(
            f"({k[1]},{k[2]}) {costs[k][0]:.4g}/{costs[k][1]:.4g}"
            for k in keys))
    return costs


def gqa_decode_flops(cfg, rows, width, block) -> int:
    """2 x rows x (matmul parameters) + 4 x rows x heads x head_dim x
    width x block_size: the projections, the SwiGLU MLP and the unembed,
    then QK and PV over the gathered blocks, per layer."""
    d, hd = cfg.d_model, cfg.head_dim
    params = cfg.num_layers * (2 * d * cfg.num_heads * hd
                               + 2 * d * cfg.num_kv_heads * hd
                               + 3 * d * cfg.d_ff) + d * cfg.vocab_size
    attn = 4 * rows * cfg.num_heads * hd * width * block * cfg.num_layers
    return 2 * rows * params + attn


def leave_one_out(measured: dict, work) -> dict:
    """Phase 9.2: each measured cell in turn predicted by a model fitted
    without it (the fitted surface, never the cell's own mean).  Returns
    {phase: [relative error]} over cells whose phase kept a measured cell."""
    from repro_torch.analysis.cost_model import StepCostModel

    errs: dict = {}
    for key, stats in measured.items():
        rest = {k: s for k, s in measured.items() if k != key}
        if not any(k[0] == key[0] for k in rest):
            continue
        model = StepCostModel(work=work)
        model.ingest(rest)
        pred = model.predict(*key, surface_only=True)
        errs.setdefault(key[0], []).append(
            abs(pred - stats.mean_s) / stats.mean_s)
    return errs


def print_errors(tag, label, errs) -> None:
    for phase, e in sorted(errs.items()):
        print(f"{tag} leave-one-out, {label}: {phase} over {len(e)} measured "
              f"cells, median relative error {statistics.median(e):.3f}, "
              f"worst {max(e):.3f}")


def static_pricing(tag, eng, card, *, gqa=False, scenario=False) -> dict:
    """Phase 9 on a bf16 engine after its graphed traffic: price every warm
    cell (9.1; with ``gqa``, the decode cell's flops beside the analytic
    count), fit ``StepCostModel`` on the measured cells with the static
    features and with the default (rows, rows*width) ones, each scored
    leave one out (9.2), and with ``scenario`` run the paper's
    ``measured_costs`` scenario on this card's model beside the
    reference's CPU file (9.4).  Returns the model fitted on every
    measured cell with the static features."""
    from repro_torch.analysis.cost_model import (StepCostModel,
                                                 hlo_cell_features)

    costs = price_cells(tag, eng, warm_cells(eng), card)
    if gqa:
        cell = max(c for c in costs if c[0] == eng._decode_kind)
        want = gqa_decode_flops(eng.cfg, cell[1], cell[2], eng.kv_block_size)
        got = costs[cell][0]
        print(f"{tag}: decode cell {cell} flops {got:.6g}, analytic "
              f"2*rows*(matmul params) + 4*rows*heads*head_dim*width*block "
              f"{want:.6g}")
        if abs(got - want) > 1e-6 * want:
            raise SmokeFailure(f"{tag}: decode flops {got} != analytic {want}")
    measured = {k: s for k, s in eng.pool.cell_stats().items() if s.timed}
    work = hlo_cell_features(costs)
    print_errors(tag, "static features", leave_one_out(measured, work))
    print_errors(tag, "default (rows, rows*width)",
                 leave_one_out(measured, StepCostModel().work))
    model = StepCostModel(work=work)
    model.ingest(measured)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    default = StepCostModel()
    default.ingest(measured)
    with open(out / PRICING_FILE, "a") as f:
        f.write(f"# {tag} [{card}]: cell, flops, bytes, measured mean ms, "
                "surface ms static, surface ms default\n")
        for c in sorted(costs):
            ms = (f"{measured[c].mean_s * 1e3:.4f}" if c in measured
                  else "-")
            f.write(f"{c} {costs[c][0]:.6g} {costs[c][1]:.6g} {ms} "
                    f"{model.predict(*c, surface_only=True) * 1e3:.4f} "
                    f"{default.predict(*c, surface_only=True) * 1e3:.4f}\n")
    if scenario:
        paper_scenario(tag, model, card)
    return model


def migrate_pricing(tag, eng, card) -> dict:
    """Phase 9.2's migrate case on an fp32 engine after phase 7b moved one
    stream: price every warm migrate width, fit on the measured cells (7b's
    one migrate cell among them) and predict every width that was never
    measured -- finite, positive, not falling with width.  Returns the
    model and 7b's measured export + import ms."""
    from repro_torch.analysis.cost_model import (StepCostModel,
                                                 hlo_cell_features)

    cells = [c for c in warm_cells(eng) if c[0] == eng._migrate_kind]
    costs = price_cells(tag, eng, cells, card)
    measured = {k: s for k, s in eng.pool.cell_stats().items() if s.timed}
    seen = [k for k in measured if k[0] == eng._migrate_kind]
    if len(seen) != 1:
        raise SmokeFailure(f"{tag}: measured migrate cells {seen}, want one")
    moves = [m for s in eng.pool.servers for m in s.stats.batch_meta
             if m["kind"] == eng._migrate_kind]
    moved_ms = sum(m["seconds"] for m in moves) * 1e3
    model = StepCostModel(work=hlo_cell_features(costs))
    model.ingest(measured)
    preds = [(c[1], model.predict(*c) * 1e3) for c in sorted(cells)
             if c not in measured]
    print(f"{tag} [{card}]: migrate cell {seen[0]} measured "
          f"{measured[seen[0]].mean_s * 1e3:.3f} ms per side (export + import "
          f"{moved_ms:.3f} ms); predicted ms per side from static bytes at "
          "the widths never measured: " + (", ".join(
              f"w{w} {p:.3f}" for w, p in preds) or "none (one width)"))
    vals = [p for _, p in preds]
    if not all(math.isfinite(v) and v > 0 for v in vals) or any(
            b < a for a, b in zip(vals, vals[1:])):
        raise SmokeFailure(f"{tag}: migrate predictions {preds} not finite, "
                           "positive and monotone in width")
    return dict(model=model, migrate_ms=moved_ms)


def paper_scenario(tag, model, card) -> None:
    """Phase 9.4: the paper's experiment, ``measured_costs`` (every GPU
    segment at min(declared, 1.2 x the cost model's decode (4, 64)
    cell)), on this card's fitted model beside ``default_cost_model()`` --
    the reference's CPU timings of reduced internlm2 in
    benchmarks/BENCH_cost_model.json, not this card's."""
    from repro_torch.scenarios import SCENARIOS, default_cost_model, run

    for label, cm in ((f"this card's model [{card}]", model),
                      ("the reference's CPU BENCH_cost_model.json [a CPU, "
                       "not this card]", default_cost_model())):
        for seed in (0, 3):
            res = run(SCENARIOS.create("measured_costs", seed=seed),
                      cost_model=cm)
            pairs = {n: (round(res.bounds[n], 3), round(res.wcrt[n], 3))
                     for n in sorted(res.bounds)}
            over = [n for n, (b, w) in pairs.items()
                    if math.isfinite(b) and w > b + 1e-6]
            if over:
                raise SmokeFailure(f"{tag} scenario: simulated WCRT over the "
                                   f"bound for {over}")
            pred = cm.predict("decode", 4, 64) * 1e3
            print(f"{tag} measured_costs seed {seed}, {label}: decode "
                  f"(4,64) predicted {pred:.3f} ms; schedulable "
                  f"{res.schedulable}, any miss {res.any_miss}; (bound, "
                  f"simulated WCRT) ms per task {pairs}")


def time_kernels_of(tree: pathlib.Path) -> int:
    """``--kernels-from TREE``: build the kernels of another checkout's
    ``src/repro_torch`` (for instance the parent commit, unpacked with git
    archive) and time its rmsnorm and ssd_intra on this script's inputs,
    tagged with the tree, so two versions are compared in one call."""
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build

    if pathlib.Path(_build.__file__).resolve().parents[2] != tree / "src":
        raise SmokeFailure(f"repro_torch did not come from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())
    print(f"build [{tree}]: {_build.build():.1f} s")
    checks = KernelChecks(torch.device("cuda"))
    tag = f"time[{tree.name}]"
    checks.time_rmsnorm(get_config("internlm2_1_8b"), tag)
    checks.time_ssd_intra(get_config("mamba2_780m"), tag)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--kernels-from":
        return time_kernels_of(pathlib.Path(sys.argv[2]).resolve())
    if len(sys.argv) != 1:
        print("usage: chip_smoke.py [--kernels-from TREE]", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    card = card_line()                                          # phase 1
    print(card)
    nvcc = _build._nvcc()                                       # phase 2
    sass = start_sass_report(_build.CSRC, nvcc)
    build_s = _build.build()
    _build.library()
    print(f"build: {build_s:.1f} s (one nvcc per source, in parallel, "
          f"{len(list(_build.CSRC.glob('*.cu')))} sources, then one link)")
    sass_report(sass, nvcc)

    checks = KernelChecks(dev)                                  # phase 3
    checks.run(get_config("internlm2_1_8b"))
    checks.run_ssm(get_config("mamba2_780m"))
    checks.run_mla(get_config("deepseek_v2_lite_16b"))
    checks.run_hybrid(get_config("zamba2_7b"))
    checks.run_encdec(get_config("whisper_medium"))
    checks.run_vlm(get_config("qwen2_vl_2b"))
    checks.rank()

    # phase 7 runs inside these: 7b and 7d in every fp32 phase, 7a, 7c
    # and 7d's bf16 comparison in the internlm2-1.8b phases
    counts = gqa_path(dev, card)                                # phases 4-5
    counts += ssm_path(dev, card)                               # phases 4b-5b
    counts += mla_path(dev, card)                               # phases 4c-5c
    counts += hybrid_path(dev, card)                            # phases 4d-5d
    counts += encdec_path(dev, card)                            # phases 4e-5e
    counts += vlm_path(dev, card)                               # phases 4f-5f

    print(f"launches over phases 4-7: {dict(counts)}")          # phase 8
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
