#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. card: name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, all in parallel) and, beside the build, the GQA decode pair's,
   ``ssd_intra``'s, ``rmsnorm``'s and ``flash_attention``'s sources and
   the backward kernels' (``flash_attention_bwd.cu``, ``ssd_intra_bwd.cu``)
   alone to cubins: registers and spills (``-Xptxas -v``) and the ``HMMA``
   count
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
   every KV split boundary, identity-table views of width 16 and 32) and
   the routed experts of the decode step on one MoE layer (1, 8 and 16
   rows; fp32 on the scalar route, bf16 on the tensor cores; timed at
   those rows against ``moe_dense``, and the whole layer routed against
   dense up to 512 rows), and every kernel of the hybrid path again at zamba2-7b widths (rmsnorm on
   rows of 3584 and of the gated norm's 7168, both in registers in bf16;
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
   size 6), and the training path's kernels at internlm2-1.8b widths in
   fp32 and bf16 (the flash forward's row lse; the flash backward's dq, dk
   and dv at B 4 x S 1024, B 1 x S 1000, S 64 and S 8; the rmsnorm
   backward's dx and dw at (4096, 2048) in registers, 1032 on the vector
   loop and 37 on the scalar loop; each within 1e-4 (fp32) / 2e-2 (bf16)
   of the plain gradient's max |.|, and a second run bit-identical) and
   at the other families' training shapes (``ssd_intra``'s backward at
   mamba2-780m and zamba2-7b widths, chunks of 1, 5, 200 and 256, the
   cotangent on y, on s and on both; the flash backward at MLA
   (4,1024,16,192/128) and zamba2 (4,1024,32,112) causal, whisper's
   encoder (4,1500,16,64) full and its cross-attention, S 1, 40 and 448
   against Sk 1500, with the forward's lse at each; the rmsnorm backward
   at every family width, 512-7168, on 1, 5, 4096 and 6000 rows) -- then
   its median time beside the
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
   decode pair and rmsnorm as timed rows of their own; the two backward
   kernels at the training shape beside the backward of SDPA and of
   ``F.rms_norm``, the rmsnorm backward at (4096, D) for every training
   width and at whisper's (6000, 1024), each with its device time by
   kernel name (row pass, dw pass), ``ssd_intra``'s backward at mamba2's
   and zamba2's training shapes, the flash backward at each of the
   families' shapes beside SDPA's); the phase's seconds;
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
   fit, and the cut is printed); each decode step's MoE layers run the
   routed experts' kernel (its scalar route), prefill runs ``moe_dense``;
5c. MLA + MoE path, bf16: the same traffic at full depth, timed, and a
   profile of one 4-row paged decode step;
4d. hybrid path, fp32: full-width zamba2-7b cut to 27 of its 81 layers
   (4 groups of 5 Mamba-2 layers + the shared attention block, then 3
   Mamba-2 layers: every layer kind) served the same way, each decode call staging the shared block's KV
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
8. launch counts of every kernel over phases 4-7 and 10-12 (each must be
   non-zero), then one JSON line describing every kernel;
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
10. training, after the serving phases:
   10a. one fp32 train step of full-width internlm2-1.8b at depth 2 on
       the card against the same step on the CPU (plain kernel versions),
       same weights and ``SyntheticLM`` batch of 2 x 128, grad_clip on:
       loss within 1e-5 relative, every gradient leaf non-zero on the
       card and within 1e-4 of its max |.| (the SSM families' leaves of
       ``PARITY_LEAF_TOL`` within their own fixed bound), the card's
       AdamW update within 1e-3 lr of the CPU's AdamW on the card's
       gradients;
   10b. full-width, full-depth internlm2-1.8b in bf16 through
       ``repro_torch.launch.train.main`` (4 x 1024 tokens, 8 steps, default
       AdamW, remat dots_no_batch, a checkpoint every 4 steps into a
       temporary directory): finite losses that fall from step 1 to step
       8; per step each layer's flash forward twice (with the remat
       recompute), its flash backward once, its two norms' forward twice
       and backward once, the final norm's once each; a second run
       resumed from step 4 gives steps 5-8's losses within 1e-6; step ms
       p50, tokens/s, peak memory, and a profile of one step by kernel
       category (``chiprun_out/train_step_profile.txt``);
   10c. for mamba2-780m (2 layers, 2 x 512 tokens), zamba2-7b (7: a group
       of 5 Mamba-2 layers + the shared block, then 1; 2 x 256),
       deepseek-v2-lite-16b (2: the dense layer + one MoE; 2 x 128) and
       whisper-medium (2 + 2 over all 1500 frames of seeded noise; 2 x
       128): 10a's fp32 parity step at full width, then
       a bf16 trainer at full width for 3 steps of 4 x 1024 tokens
       (whisper: 4 x 448 decoder tokens) -- mamba2 through
       ``launch.train.main`` at full depth, whisper at full depth and
       zamba2 (cut to 27 layers) and deepseek (cut to 4) through
       ``build_train_step`` -- finite losses, launches per step as the code
       implies (flash forward and backward, ``ssd_intra`` and its
       backward, rmsnorm and its backward), step ms p50, tokens/s, peak
       memory, a profile of one step by kernel category
       (``chiprun_out/train_step_profile_<arch>.txt``).  Every 10b run and
       10a's kernel step run with every kernel module's plain version
       refusing CUDA tensors;
11. the distributed layer and the serving launcher, after training, on a
   (1, 1) (data, model) DeviceMesh over an NCCL group of world 1 (from a
   FileStore in a temporary directory):
   11a. full-width internlm2-1.8b cut to 2 layers, fp32, 3 steps of the
       sharded train step (params and AdamW state DTensors, fsdp on)
       against the plain step from the same weights and batches: losses
       bit for bit, each param leaf within 1e-6 of its max |.|; the
       sharded state saved and restored onto the mesh
       (``restore(shardings=...)``) bit-identical; then full-width,
       full-depth bf16, 3 steps of 4 x 1024 tokens plain and sharded:
       step ms p50 and tokens/s of each (the gap is DTensor's host
       overhead), the sharded run's flash and rmsnorm launches per step
       as the code implies; every plain version refuses CUDA tensors;
   11b. ``moe._moe_local`` (the expert-parallel body, axis None) at
       deepseek-v2-lite-16b widths (64 experts, d 2048, ff 1408, top 6,
       512 tokens, capacity factor 8) against ``moe_dense``: fp32 within
       1e-5, bf16 within 2e-2; at capacity factor 1.25 the routing and
       kept-token mask equal the CPU's;
   11c. ``compressed_psum_mean`` over 11a's fp32 gradients: the first
       step equal to the scheme in numpy bit for bit; the error feedback
       after 10 steps;
   11d. ``python -m repro_torch.launch.serve`` as a subprocess on the card
       and with ``--device cpu``: rc 0, the reports, the same admission
       decisions; ``serve.main([])`` in-process launches flash_attention,
       decode_attention and rmsnorm with every plain version refusing CUDA
       tensors;
12. the sharded prefill and decode steps (``launch/steps.py``) on the
   same (1, 1) mesh, every plain version refusing CUDA tensors, and the
   dry run (``launch/dryrun.py``):
   12a. full-width internlm2-1.8b cut to 2 layers, fp32, ``build_prefill``
       of 2 x 128 and 8 ``build_decode`` steps against the unsharded
       ``model.apply`` from the same weights: every logit and the final
       cache bit for bit; then full-width, full-depth bf16, a prefill of
       4 x 2048 (max_seq 4096) and 16 decode steps, sharded and plain:
       prefill ms, decode ms p50, tokens/s, peak memory and greedy tokens
       of each (the gap is DTensor's host overhead), flash_attention,
       decode_attention and rmsnorm launched;
   12b. full-width mamba2-780m under ``perf.VARIANTS`` opt_ssm_q128 and
       opt_ssm_q64 (the split projections cut from the fused weights):
       fp32 at 2 layers, the logits at chunks of 128 and 64 within 1e-4
       of the baseline's (chunk 256) max |logit|; bf16 at 48 layers, a
       prefill of 4 x 2048 and 8 decode steps of each variant and the
       baseline, greedy tokens side by side, ssd_intra and
       ssd_slab_decode launched (phase 3 checks ``ssd_intra`` at chunks
       of 128 and 64 and times it over 4 x 2048 tokens at 256, 128, 64);
   12c. ``python -m repro_torch.launch.dryrun`` in three subprocesses at
       once with no card visible, started with 12a and run beside 12a and
       12b (their CPU work beside the card's): internlm2-1.8b train_4k and
       mamba2-780m prefill_32k (opt_ssm_q128) single pod, qwen3-moe-235b
       decode_32k multi-pod, each ok, this process's device memory
       unmoved while it waits for them;
13. last line: ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --kernels-from TREE

builds the kernels of another checkout (for instance the parent commit,
unpacked with ``git archive``) and times its ``rmsnorm`` (also at
zamba2-7b's 3584 and 7168) and ``ssd_intra`` on the same inputs as phase
3, and its three backward kernels at every training shape phase 3 times
them at (each with its device time by kernel name), so that two versions
are compared on one card in one call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
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
# the backward kernels' tolerances, against the reference gradient's max |.|
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the forward's lse (fp32 in both dtypes), absolute in natural-log units:
# exp(1e-3) scales the backward's recomputed P by 0.1% at most
LSE_TOL = 1e-3
# the flash backward's training shapes beyond the GQA decoder's:
# (name, B, S, Sk, Nq, Nkv, H, Hv, causal)
FLASH_BWD_SHAPES = (
    ("mla", 4, 1024, 1024, 16, 16, 192, 128, True),      # deepseek-v2-lite
    ("hybrid", 4, 1024, 1024, 32, 32, 112, 112, True),   # zamba2-7b
    ("encoder", 4, 1500, 1500, 16, 16, 64, 64, False),   # whisper-medium
    ("cross1", 4, 1, 1500, 16, 16, 64, 64, False),       # its cross-attention
    ("cross40", 4, 40, 1500, 16, 16, 64, 64, False),
    ("cross448", 4, 448, 1500, 16, 16, 64, 64, False))
# rmsnorm widths of the families' training: deepseek's latent (512),
# whisper (1024), mamba2 and qwen2-vl (1536), internlm2 and deepseek
# (2048), mamba2's gated norm (3072), zamba2 (3584) and its gated norm (7168)
RMSNORM_BWD_WIDTHS = (512, 1024, 1536, 2048, 3072, 3584, 7168)
# its rows: one row, a partial warp's worth, the step's 4 x 1024 tokens and
# whisper's encoder (4 x 1500)
RMSNORM_BWD_ROWS = (1, 5, 4096, 6000)
# its timed shapes: (4096, D) at every width, and whisper's encoder
RMSNORM_BWD_TIMED = tuple((4096, d) for d in RMSNORM_BWD_WIDTHS) + (
    (6000, 1024),)
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
    # the backward kernels: the reference has no kernel of its own there
    # (XLA differentiates the jnp path), so each names the TPU kernel whose
    # function it differentiates
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:76"),
    "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:34"),
    "ssd_intra_bwd": ("src/repro_torch/csrc/ssd_intra_bwd.cu",
                      "src/repro/kernels/ssd_scan.py:66"),
    # the decode step's routed experts: the reference has no kernel there
    # (its moe_dense is jnp, every token through every expert)
    "moe_routed_experts": ("src/repro_torch/csrc/moe_routed_experts.cu",
                           "none: src/repro/models/moe.py moe_dense is jnp"),
}
# the routed experts' rows a decode call: checked and timed (a 1-row call,
# about deepseek-sat-decode's mean of 8.7, a full 16-row tile), and wider,
# where an expert's slots outgrow a 16-row tile; each timing cycles through
# MOE_CALLS routings
MOE_ROWS = (1, 8, 16)
MOE_WIDE_ROWS = (32, 64, 128, 256, 512)
MOE_CALLS = 16
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
                "ssd_intra.cu", "rmsnorm.cu", "flash_attention.cu",
                "flash_attention_bwd.cu", "ssd_intra_bwd.cu",
                "moe_routed_experts.cu")
TENSOR_CORE_KERNELS = ("decode_tc_kernel", "ssd_tc_kernel", "flash_tc_kernel",
                       "dkdv_tc_kernel", "dq_tc_kernel",
                       "ssd_bwd_head_tc_kernel", "ssd_bwd_groups_tc_kernel",
                       "experts_tc_kernel")


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


def device_window(fn, iters: int, tries: int):
    """The device activity rows of one torch.profiler window of ``iters``
    back-to-back calls of ``fn``, and their time attribute.  Every call
    launches the same kernels, so a window whose activities are no
    positive multiple of ``iters`` lost some (a call of two kernels can
    lose a third of them and still count past ``iters``) and is taken
    again; (None, None) if every one of ``tries`` windows lost some."""
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
        count = sum(e.count for e in rows)
        if count >= iters and count % iters == 0:
            return rows, key
    return None, None


def device_ms(fn, *, iters: int = 50, tries: int = 3) -> float:
    """Device time per call of ``fn``: the summed device time of every
    kernel that ``iters`` back-to-back calls launched, from one whole
    torch.profiler window (:func:`device_window`; the host's issue rate
    does not enter); NaN (not measured) if no window came back whole."""
    rows, key = device_window(fn, iters, tries)
    if rows is None:
        return float("nan")
    return sum(getattr(e, key) for e in rows) / 1e3 / iters


def device_split(fn, *, iters: int = 20, tries: int = 3) -> dict[str, float]:
    """Device time per call of ``fn`` by kernel name, from one whole
    torch.profiler window of ``iters`` calls (a multi-kernel launch's
    share of each kernel); empty if no window came back whole."""
    rows, key = device_window(fn, iters, tries)
    out: dict[str, float] = {}
    for e in rows or ():
        name = e.key.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ").split("(")[0]
        out[name] = out.get(name, 0.0) + getattr(e, key) / 1e3 / iters
    return out


def print_split(name: str, split: dict[str, float],
                tag: str = "split") -> None:
    total = sum(split.values())
    parts = ", ".join(f"{k} {v:.4f}" for k, v in
                      sorted(split.items(), key=lambda kv: -kv[1]))
    print(f"{tag} {name}: {total:.4f} ms device = {parts}")


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

    def check(self, name: str, case: str, got, want, dtype,
              atol: float | None = None) -> float:
        """``got`` within TOL[dtype] (absolute and relative) of ``want``,
        or within ``atol`` alone when it is given."""
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        tol = TOL[dtype] if atol is None else atol
        rtol = tol if atol is None else 0.0
        ok = bool(torch.isfinite(got).all()) and bool(
            ((got - want).abs() <= tol + rtol * want.abs()).all())
        print(f"check {name} [{case}] {str(dtype)[6:]}: max_abs_err={err:.3e}"
              f" (tol {tol:g}{'' if rtol else ' absolute'}) "
              f"{'ok' if ok else 'FAIL'}")
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
        self.run_moe_routed(cfg)

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

    # -- the routed experts at deepseek-v2-lite-16b widths -------------------
    def moe_calls(self, cfg, rows, dtype, n=MOE_CALLS):
        """``n`` decode calls of ``rows`` rows for one MoE layer: x (rows, D)
        and the top-k of random logits (routing about uniform, as a trained
        router's over many calls) with its softmax weights."""
        calls = []
        for _ in range(n):
            top, idx = torch.topk(self.randn(rows, cfg.num_experts),
                                  cfg.num_experts_per_tok, dim=-1)
            calls.append((self.randn(rows, cfg.d_model, dtype=dtype), idx,
                          torch.softmax(top, dim=-1).to(dtype)))
        return calls

    def run_moe_routed(self, cfg):
        """``moe_routed_experts`` against its plain version on one layer at
        ``cfg``'s widths, MOE_ROWS rows: fp32 (the scalar route) and bf16
        (the tensor cores)."""
        from repro_torch.kernels.moe_experts import (
            moe_experts_route, moe_routed_experts, moe_routed_experts_plain)
        from repro_torch.models.moe import init_moe

        name = "moe_routed_experts"
        for dt in (torch.float32, torch.bfloat16):
            ex = init_moe(cfg, self.gen, dt, self.dev)["experts"]
            ws = (ex["w_gate"], ex["w_up"], ex["w_down"])
            for rows in MOE_ROWS:
                x, idx, w = self.moe_calls(cfg, rows, dt, n=1)[0]
                route = moe_experts_route(x, *ws)
                e = self.check(name, f"rows={rows} E={cfg.num_experts} "
                               f"K={cfg.num_experts_per_tok} route={route}",
                               moe_routed_experts(x, idx, w, *ws),
                               moe_routed_experts_plain(x, idx, w, *ws), dt)
                self.errors[name] = max(self.errors.get(name, 0.0), e)
            del ex, ws
        self.time_moe_routed(cfg)

    def time_moe_routed(self, cfg):
        """Times of ``moe_routed_experts`` on one bf16 layer at MOE_ROWS
        rows against ``moe_dense`` (the library yardstick: every decode
        step's path before the routed one), the bound being the chosen
        experts' weights, x and out over 3.35 TB/s; then, at MOE_ROWS and
        MOE_WIDE_ROWS, the whole layer routed (``moe_routed``) against
        dense, router included in both, device time.  Each call takes the
        next of MOE_CALLS routings, so it finds its experts' weights out of
        the L2 cache as a decode step's layers do."""
        from repro_torch.kernels.moe_experts import (
            moe_routed_experts, moe_routed_experts_plain)
        from repro_torch.models.moe import init_moe, moe_dense, moe_routed

        dt, el = torch.bfloat16, 2
        d, f = cfg.d_model, cfg.moe_d_ff
        p = init_moe(cfg, self.gen, dt, self.dev)
        ws = (p["experts"]["w_gate"], p["experts"]["w_up"],
              p["experts"]["w_down"])

        def cycled(calls, fn):
            each = itertools.cycle(calls)
            return lambda: fn(*next(each))

        rows_out = {}
        for rows in MOE_ROWS + MOE_WIDE_ROWS:
            calls = self.moe_calls(cfg, rows, dt)
            xs = [(c[0][:, None, :],) for c in calls]
            if rows in MOE_ROWS:
                hit = statistics.mean(len(torch.unique(c[1])) for c in calls)
                key = "moe_routed_experts" + ("" if rows == MOE_ROWS[1]
                                              else f"@{rows}")
                r = rows_out[key] = timed(
                    cycled(calls, lambda x, i, w: moe_routed_experts(
                        x, i, w, *ws)),
                    cycled(calls, lambda x, i, w: moe_routed_experts_plain(
                        x, i, w, *ws)),
                    cycled(xs, lambda x: moe_dense(cfg, p, x)),
                    # each chosen expert's three matrices once; x in, out
                    bound_ms(hit * 3 * d * f * el + 2 * rows * d * el,
                             2 * 3 * d * f * rows * cfg.num_experts_per_tok,
                             dt),
                    f"x ({rows},{d}), {hit:.2f} of {cfg.num_experts} "
                    f"experts of D {d} F {f} a call")
                print(f"time moe_routed_experts rows {rows}: "
                      f"{100 * r['bound'][0] / r['device_ms']:.1f}% of 3.35 "
                      f"TB/s on the chosen experts' bytes; moe_dense "
                      f"{r['library_device_ms'] / r['device_ms']:.2f}x its "
                      "device time")
            routed = device_ms(cycled(xs, lambda x: moe_routed(cfg, p, x)))
            dense = device_ms(cycled(xs, lambda x: moe_dense(cfg, p, x)))
            print(f"time moe layer bf16 rows {rows} (T*K/E "
                  f"{rows * cfg.num_experts_per_tok / cfg.num_experts:.2f}): "
                  f"routed {routed:.4f} ms device, dense {dense:.4f} ms "
                  f"device, dense / routed {dense / routed:.2f}x")
        print_rows(rows_out, "moe_dense")
        self.rows.update(rows_out)
        del p, ws

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
    def ssd_views(self, cfg, rows, s, dtype, chunk: int = 256):
        """The model's views for one prefill of ``rows`` x ``s`` tokens in
        chunks of min(chunk, s): x (M,H,Q,P) and B/C (M,Q,N) cut from an
        (rows, s, conv_dim) activation, dt/dA (M,H,Q) permuted from
        (rows, s, H) fp32.  dA lies on a grid of 2**-10 so that cumsum(dA)
        is exact in any order: the kernel sums it sequentially, the plain
        version with torch.cumsum, and exp(seg_i - seg_j) would turn their
        last-bit differences into errors above the fp32 tolerance."""
        from repro_torch.models.ssm import conv_dim

        h, p, n = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state_dim
        q = min(chunk, s)
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
            # the chunks of perf flag ssd_chunk (phase 12b): two rows of 512
            for q in (128, 64):
                args = self.ssd_views(cfg, 2, 512, dt, chunk=q)
                y, st = ssd_intra(*args)
                y_want, st_want = ssd_intra_plain(*args)
                m = args[0].shape[0]
                e = max(self.check("ssd_intra", f"M={m} Q={q} y", y, y_want,
                                   dt),
                        self.check("ssd_intra", f"M={m} Q={q} state", st,
                                   st_want, dt))
                self.errors["ssd_intra"] = max(self.errors["ssd_intra"], e)
        self.time_ssm(cfg)
        self.time_ssd_chunks(cfg)

    def time_ssd_chunks(self, cfg):
        """ssd_intra's device ms per call in bf16 over one layer of phase
        12b's prefill (STEPS_SHAPE's 4 x 2048 tokens) at chunks of 256, 128
        and 64: the same tokens in 32, 64 and 128 chunks."""
        from repro_torch.kernels.ssd_scan import ssd_intra

        b, s, _ = STEPS_SHAPE
        h, p, n = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state_dim
        for q in (256, 128, 64):
            args = self.ssd_views(cfg, b, s, torch.bfloat16, chunk=q)
            ms = device_ms(lambda: ssd_intra(*args))
            m = args[0].shape[0]
            print(f"time ssd_intra [x ({m},{h},{q},{p}), B/C ({m},{q},{n}): "
                  f"{b} x {s} tokens in chunks of {q}] bf16: device {ms:.4f} "
                  f"ms per call ({ms / (b * s) * 1e6:.3f} ns per token)")

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
        P 64, N 64.  Then device times beside SDPA and F.rms_norm at the
        hybrid shapes, for information."""
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
        self.time_rmsnorm_hybrid(cfg)
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

    def time_rmsnorm_hybrid(self, cfg, tag: str = "time") -> None:
        """rmsnorm in bf16 at zamba2's norms, d_model and the gated norm's
        d_inner, on one decode step (4 rows) and one 256-token prefill
        call, beside F.rms_norm (for information)."""
        import torch.nn.functional as F

        from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

        eps = cfg.norm_eps
        for d in (cfg.d_model, cfg.d_inner):
            w = (self.randn(d) * 0.1 + 1.0).to(torch.bfloat16)
            for shape in ((4, 1, d), (1, 256, d)):
                x = self.randn(*shape, dtype=torch.bfloat16)
                print_rows({"rmsnorm": timed(
                    lambda: rmsnorm(x, w, eps),
                    lambda: rmsnorm_plain(x, w, eps),
                    lambda: F.rms_norm(x, (d,), w, eps),
                    bound_ms((2 * x.numel() + d) * 2, 4 * x.numel(),
                             torch.bfloat16),
                    f"x ({','.join(map(str, shape))}) (hybrid, information "
                    "only)")}, "F.rms_norm", tag)

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

    # -- the backward kernels, at the training shapes -----------------------
    def check_grad(self, name: str, case: str, got, want, dtype) -> float:
        """``got`` against ``want`` with the tolerance stated against the
        reference gradient's scale: max |got - want| <= BWD_TOL * max
        |want|."""
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        scale = want.abs().max().item() if want.numel() else 0.0
        tol = BWD_TOL[dtype]
        ok = bool(torch.isfinite(got).all()) and err <= tol * scale
        print(f"check {name} [{case}] {str(dtype)[6:]}: max_abs_err={err:.3e}"
              f" (max |ref| {scale:.3e}, tol {tol:g} of it) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"{name} [{case}] disagrees with its plain "
                               f"version: max_abs_err={err}")
        self.errors[name] = max(self.errors.get(name, 0.0), err)
        return err

    def same_bits(self, name: str, case: str, first, second) -> None:
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise SmokeFailure(f"{name} [{case}]: a second run differs")
        print(f"check {name} [{case}]: a second run bit-identical ok")

    def run_backward(self, cfg):
        """The training path's kernels at ``cfg``'s widths (16/8 heads of
        128, rows of 2048), fp32 and bf16: the forward's lse (LSE_TOL
        absolute); the flash backward's dq, dk and dv at B 4 x S 1024 (the
        training shape), B 1 x S 1000 (ragged tiles), B 1 x S 128 (32
        blocks over two KV tiles: the bf16 forward's 8-warp configuration,
        whose warp pairs merge their softmax states and lse), S 64 and S 8;
        the rmsnorm backward's dx and dw at (4096, 2048) on the register
        route, at 1032 on the vector loop and 37 on the scalar loop -- each
        against its plain
        version, and a second run bit-identical to the first.  Then timed
        rows at the training shape in bf16 beside the library calls'
        backward and the bound."""
        nq, nkv, h, d = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                         cfg.d_model)
        for dt in (torch.float32, torch.bfloat16):
            for b, s in ((4, 1024), (1, 1000), (1, 128), (2, 64), (2, 8)):
                self.check_flash_bwd(("gqa", b, s, s, nq, nkv, h, h, True), dt)
            for rows, dw_ in ((4096, d), (256, 1032), (256, 37)):
                self.check_rmsnorm_bwd(dt, rows, dw_, cfg.norm_eps)
        rows = {"flash_attention_bwd": self.time_flash_bwd_shape(
                    ("gqa", 4, 1024, 1024, nq, nkv, h, h, True))}
        print_rows(rows, "SDPA backward")
        print_split("flash_attention_bwd",
                    rows["flash_attention_bwd"]["split"])
        rows["rmsnorm_bwd"] = self.time_rmsnorm_bwd_shapes()[(4096, d)]
        self.rows.update(rows)

    def time_backward(self, tag: str = "time") -> None:
        """The two backward kernels' timed rows at every training shape
        phase 3 times them at, each with its device time by kernel name:
        ``--kernels-from`` prints these for another checkout's kernels."""
        from repro_torch.configs.registry import get_config

        cfg = get_config("internlm2_1_8b")
        rows = {"flash_attention_bwd": self.time_flash_bwd_shape(
            ("gqa", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, cfg.num_heads,
             cfg.num_kv_heads, cfg.head_dim, cfg.head_dim, True))}
        rows.update({f"flash_attention_bwd@{shape[0]}":
                     self.time_flash_bwd_shape(shape)
                     for shape in FLASH_BWD_SHAPES})
        for fam, arch in (("", "mamba2_780m"), ("@hybrid", "zamba2_7b")):
            rows[f"ssd_intra_bwd{fam}"] = self.time_ssd_intra_bwd(
                get_config(arch))
        for name, r in rows.items():
            print_rows({name: r}, "SDPA backward" if "flash" in name else "",
                       tag)
            print_split(name, r["split"], tag.replace("time", "split"))
        self.time_rmsnorm_bwd_shapes(tag)

    def time_rmsnorm_bwd_shapes(self, tag: str = "time") -> dict:
        """The rmsnorm backward's timed rows at RMSNORM_BWD_TIMED, each
        printed with its device time by kernel name (the row pass and the
        dw pass); returned by (rows, D)."""
        out = {}
        for rows, d in RMSNORM_BWD_TIMED:
            r = out[(rows, d)] = self.time_rmsnorm_bwd(rows, d)
            print_rows({"rmsnorm_bwd": r}, "F.rms_norm backward", tag)
            print_split(f"rmsnorm_bwd ({rows},{d})", r["split"],
                        tag.replace("time", "split"))
        return out

    def time_rmsnorm_bwd(self, rows, d, eps=1e-5):
        """The rmsnorm backward in bf16 on ``rows`` rows of width ``d``
        (4096 = the training step's 4 x 1024 tokens), beside the backward
        of F.rms_norm on the same inputs."""
        import torch.nn.functional as F

        from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_bwd_plain

        dt, el = torch.bfloat16, 2
        x = self.randn(rows, d, dtype=dt)
        w = (self.randn(d) * 0.1 + 1.0).to(dt)
        dy = self.randn(rows, d, dtype=dt)
        xl, wl = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
        lib_y = F.rms_norm(xl, (d,), wl, eps)
        n = x.numel()
        row = timed(
            lambda: rmsnorm_bwd(x, w, dy, eps),
            lambda: rmsnorm_bwd_plain(x, w, dy, eps),
            lambda: torch.autograd.grad(lib_y, (xl, wl), dy,
                                        retain_graph=True),
            # x and dy read, dx written; w read, dw written; ~12 flops an
            # element (the statistics, dx and the dw term)
            bound_ms((3 * n + 2 * d) * el, 12 * n, dt),
            f"x ({rows},{d}), dx dw")
        row["split"] = device_split(lambda: rmsnorm_bwd(x, w, dy, eps))
        return row

    # -- the backward kernels at the other families' training shapes -------
    def run_backward_families(self, configs):
        """The training path's backward kernels at the shapes the SSM,
        hybrid, MLA + MoE and enc-dec families train at, fp32 and bf16,
        each against its plain version within BWD_TOL of the plain
        gradient's max |.| and a second run bit-identical: ``ssd_intra``'s
        backward at mamba2-780m (48 heads, P 64, N 128) and zamba2-7b (112
        heads, P 64, N 64) widths, chunks of 1, 5, 200 and 256, with the
        cotangent on y alone, on s alone and on both; the flash backward at
        MLA (4,1024,16,192/128) and zamba2 (4,1024,32,112) causal, whisper's
        encoder (4,1500,16,64) full and its cross-attention, S 1, 40 and
        448 against Sk 1500, with the forward's lse (LSE_TOL) at each; the
        rmsnorm backward at every family width on RMSNORM_BWD_ROWS rows.
        Then timed rows in bf16 at the training shapes beside the bound
        and, for flash, the SDPA backward."""
        for cfg in (configs["mamba2_780m"], configs["zamba2_7b"]):
            for dt in (torch.float32, torch.bfloat16):
                for q in (1, 5, 200, 256):
                    self.check_ssd_bwd(cfg, dt, q)
        for dt in (torch.float32, torch.bfloat16):
            for shape in FLASH_BWD_SHAPES:
                self.check_flash_bwd(shape, dt)
            for d in RMSNORM_BWD_WIDTHS:
                for rows in RMSNORM_BWD_ROWS:
                    self.check_rmsnorm_bwd(dt, rows, d, 1e-5)
        rows = {}
        for fam, cfg in (("", configs["mamba2_780m"]),
                         ("@hybrid", configs["zamba2_7b"])):
            rows[f"ssd_intra_bwd{fam}"] = self.time_ssd_intra_bwd(cfg)
        print_rows(rows, "")
        flash_rows = {f"flash_attention_bwd@{shape[0]}":
                      self.time_flash_bwd_shape(shape)
                      for shape in FLASH_BWD_SHAPES}
        print_rows(flash_rows, "SDPA backward")
        for name, r in {**rows, **flash_rows}.items():
            print_split(name, r["split"])
        self.rows.update(rows)
        self.rows.update(flash_rows)

    def ssd_bwd_inputs(self, cfg, dt, q, rows=2):
        """ssd_intra's inputs as the model passes them (``ssd_views``: rows
        of q tokens, one chunk each, or rows x q // 256 chunks), and the
        cotangents as autograd hands them over: dy (M,H,Q,P) fp32, a view
        of a (M,Q,H,P) buffer, ds (M,H,N,P) fp32."""
        args = self.ssd_views(cfg, rows, q, dt)
        m, h, qq, p = args[0].shape
        n = args[3].shape[-1]
        dy = self.randn(m, qq, h, p).permute(0, 2, 1, 3)
        ds = self.randn(m, h, n, p)
        return args, dy, ds

    def check_ssd_bwd(self, cfg, dt, q):
        from repro_torch.kernels.ssd_scan import (ssd_intra_bwd,
                                                  ssd_intra_bwd_plain)

        args, dy, ds = self.ssd_bwd_inputs(cfg, dt, q)
        m, h, _, p = args[0].shape
        n = args[3].shape[-1]
        for cot, dyc, dsc in (("y", dy, torch.zeros_like(ds)),
                              ("s", torch.zeros_like(dy), ds),
                              ("y and s", dy, ds)):
            case = f"M={m} H={h} Q={q} P={p} N={n}, cotangent on {cot}"
            got = ssd_intra_bwd(*args, dyc, dsc)
            want = ssd_intra_bwd_plain(*args, dyc, dsc)
            for what, g, w in zip(("dx", "ddt", "ddA", "dB", "dC"), got, want):
                self.check_grad("ssd_intra_bwd", f"{case} {what}", g, w, dt)
            del want
            self.same_bits("ssd_intra_bwd", case, got,
                           ssd_intra_bwd(*args, dyc, dsc))

    def flash_bwd_inputs(self, shape, dt):
        _, b, s, sk, nq, nkv, h, hv, causal = shape
        return (self.randn(b, s, nq, h, dtype=dt),
                self.randn(b, sk, nkv, h, dtype=dt),
                self.randn(b, sk, nkv, hv, dtype=dt),
                self.randn(b, s, nq, hv, dtype=dt))

    def check_flash_bwd(self, shape, dt):
        from repro_torch.kernels.flash_attention import (
            _flash_forward, flash_attention_bwd, flash_attention_bwd_plain,
            flash_attention_plain)

        name, b, s, sk, nq, nkv, h, hv, causal = shape
        q, k, v, do = self.flash_bwd_inputs(shape, dt)
        case = (f"{name}: B={b} S={s} Sk={sk} Nq={nq} Nkv={nkv} H={h} "
                f"Hv={hv} {'causal' if causal else 'full'}")
        out, lse = _flash_forward(q, k, v, causal, h ** -0.5, with_lse=True)
        o_ref, lse_ref = flash_attention_plain(q, k, v, causal=causal,
                                               with_lse=True)
        e = self.check("flash_attention", f"{case} out, lse written", out,
                       o_ref, dt)
        self.errors["flash_attention"] = max(self.errors["flash_attention"], e)
        self.check("flash_attention", f"{case} lse", lse, lse_ref, dt,
                   atol=LSE_TOL)
        del o_ref, lse_ref
        got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
        for what, g, w in zip(("dq", "dk", "dv"), got, want):
            self.check_grad("flash_attention_bwd", f"{case} {what}", g, w, dt)
        del want
        self.same_bits("flash_attention_bwd", case, got,
                       flash_attention_bwd(q, k, v, out, lse, do,
                                           causal=causal))

    def check_rmsnorm_bwd(self, dt, rows, d, eps):
        from repro_torch.kernels.rmsnorm import (rmsnorm_bwd,
                                                 rmsnorm_bwd_plain,
                                                 rmsnorm_bwd_route)

        x = self.randn(rows, d, dtype=dt) * 3.0
        w = (self.randn(d) * 0.1 + 1.0).to(dt)
        dy = self.randn(rows, d, dtype=dt)
        case = f"x({rows}, {d}), {rmsnorm_bwd_route(x, w, dy)} route"
        got = rmsnorm_bwd(x, w, dy, eps)
        for what, g, ref in zip(("dx", "dw"), got,
                                rmsnorm_bwd_plain(x, w, dy, eps)):
            self.check_grad("rmsnorm_bwd", f"{case} {what}", g, ref, dt)
        self.same_bits("rmsnorm_bwd", case, got, rmsnorm_bwd(x, w, dy, eps))

    def time_ssd_intra_bwd(self, cfg):
        """ssd_intra's backward in bf16 at the training shape: 4 rows of
        1024 tokens in chunks of 256 (16 chunks), cotangents on y and s."""
        from repro_torch.kernels.ssd_scan import (ssd_intra_bwd,
                                                  ssd_intra_bwd_plain)

        dt, el = torch.bfloat16, 2
        args, dy, ds = self.ssd_bwd_inputs(cfg, dt, TRAIN_SEQ,
                                           rows=TRAIN_BATCH)
        m, h, q, p = args[0].shape
        n = args[3].shape[-1]
        pairs = q * (q + 1) // 2
        # read once: x, B, C (bf16), dt, dA, dy, ds (fp32); written once: dx,
        # dB, dC (bf16), ddt, ddA (fp32).  Operations: C B^T, dC and dB on
        # the causal half per chunk; per head dW and du on the causal half,
        # ds^T B_j and ds x_j at every position.
        nbytes = m * (2 * q * h * p * el + 4 * q * h * 4 + 4 * q * n * el
                      + q * h * p * 4 + h * n * p * 4)
        flops = 2 * m * (3 * pairs * n + h * (2 * pairs * p + 2 * q * n * p))
        row = timed(
            lambda: ssd_intra_bwd(*args, dy, ds),
            lambda: ssd_intra_bwd_plain(*args, dy, ds), None,
            bound_ms(nbytes, flops, dt),
            f"x ({m},{h},{q},{p}), B/C ({m},{q},{n}), dy, ds: "
            f"dx ddt ddA dB dC")
        row["split"] = device_split(lambda: ssd_intra_bwd(*args, dy, ds))
        return row

    def time_flash_bwd_shape(self, shape):
        """The flash backward in bf16 at one of FLASH_BWD_SHAPES, beside
        the backward of SDPA (enable_gqa) on the same inputs."""
        import torch.nn.functional as F

        from repro_torch.kernels.flash_attention import (
            _flash_forward, flash_attention_bwd, flash_attention_bwd_plain)

        dt, el = torch.bfloat16, 2
        name, b, s, sk, nq, nkv, h, hv, causal = shape
        q, k, v, do = self.flash_bwd_inputs(shape, dt)
        out, lse = _flash_forward(q, k, v, causal, h ** -0.5, with_lse=True)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                 enable_gqa=True)
        lib_do = do.transpose(1, 2)
        pairs = s * (s + 1) // 2 if causal else s * sk
        # q, k, v, o, do and lse read once; dq, dk, dv written once.
        # Operations: QK^T and dQ, dK of width H; dO V^T and dV of width Hv
        nbytes = (2 * (q.numel() + k.numel() + v.numel() + out.numel())) * el \
            + 4 * lse.numel()
        row = timed(
            lambda: flash_attention_bwd(q, k, v, out, lse, do, causal=causal),
            lambda: flash_attention_bwd_plain(q, k, v, out, lse, do,
                                              causal=causal),
            lambda: torch.autograd.grad(lib_out, (qt, kt, vt), lib_do,
                                        retain_graph=True),
            bound_ms(nbytes, 2 * b * nq * pairs * (3 * h + 2 * hv), dt),
            f"{name}: q ({b},{s},{nq},{h}), k ({b},{sk},{nkv},{h}), v "
            f"({b},{sk},{nkv},{hv}) {'causal' if causal else 'full'}, "
            f"dq dk dv")
        row["split"] = device_split(
            lambda: flash_attention_bwd(q, k, v, out, lse, do, causal=causal))
        return row


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


# 4d-5d: zamba2-7b's serving depth, cut from 81 to keep the smoke under
# 1000 s of its 1200 s: 4 groups of 5 Mamba-2 layers and the shared block,
# then the 3 tail layers -- every layer kind of the full stack
HYBRID_SERVE_LAYERS = 27


def hybrid_path(dev, card):
    """Phases 4d-5d: zamba2-7b at HYBRID_SERVE_LAYERS layers through the
    shared block's KV block pools and the Mamba-2 state slabs in one
    decode call; returns the launch counts."""
    from repro_torch.configs.registry import get_config

    base = dataclasses.replace(get_config("zamba2_7b"),
                               num_layers=HYBRID_SERVE_LAYERS)
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


# ---------------------------------------------------------------------------
# phase 10: training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "internlm2_1_8b"
TRAIN_STEPS = 8            # 10b: steps of the straight run
TRAIN_RESUME_AT = 4        # 10b: the checkpoint the second run resumes from
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
PARITY_LAYERS = 2          # 10a: depth of the full-width fp32 parity step
PARITY_BATCH, PARITY_SEQ = 2, 128
PARITY_GRAD_TOL = 1e-4     # 10a: each gradient leaf's gap, of its max |.|
# 10a: the fixed bounds that differ from PARITY_GRAD_TOL, by config name
# and leaf path ("" for every leaf of the config).  ssd_intra's decay is
# exp of a difference of two fp32 cumsums of dA, which at these random
# weights reach 3900-4600 within a chunk: every decay weight carries up to
# an ulp of that (~5e-4) in its exponent, on the kernel and the plain
# version alike, and the step's sums over heads and tokens carry it into
# the SSM families' gradients.  Over seeds 0-3 (tools/grad_floor.py on an
# H100; PERF.md) the card's worst leaf was 9.7e-5 on mamba2 (A_log) and
# 1.9e-4 to 1.66e-3 on zamba2 (every leaf downstream of its mixers), and
# the card's plain versions, or ssd_intra alone on the card under a CPU
# step, as far off (to 1.75e-3).
PARITY_LEAF_TOL = {
    "mamba2-780m": {"/layers/mamba/A_log": 2e-4},
    "zamba2-7b": {"": 2e-3},
}
TRAIN_PROFILE_FILE = "train_step_profile.txt"  # under chiprun_out/
# 10a / 10b for the other families: (arch, 10a's depth -- the smallest that
# has every layer kind --, 10a's tokens per row, 10b's depth cut or None for
# full depth).  mamba2's 10a rows are two chunks of 256, zamba2's one.
# zamba2 and deepseek cannot train at full depth on one card: at 12 bytes a
# parameter (bf16 params and grads, fp32 AdamW moments) their params,
# grads and state need 68.8 and 188.5 GB.
TRAIN_FAMILIES = (
    ("mamba2_780m", dict(num_layers=2), 512, None),
    # one group of 5 Mamba-2 layers + the shared block, then 1; 10b: 4
    # groups + a 3-layer tail (2.23 B parameters)
    ("zamba2_7b", dict(num_layers=7), 256, dict(num_layers=27)),
    # the dense layer + one MoE; 10b: 1 dense + 3 MoE (2.26 B parameters)
    ("deepseek_v2_lite_16b", dict(num_layers=2), 128, dict(num_layers=4)),
    # 2 encoder + 2 decoder layers over all 1500 frames
    ("whisper_medium", dict(num_layers=2, encoder_layers=2), 128, None),
)
FAMILY_STEPS = 3           # 10b: steps of each other family's trainer
WHISPER_TRAIN_SEQ = 448    # 10b: whisper's decoder tokens per row


def train_parity(dev, card, arch=TRAIN_ARCH,
                 depth=(("num_layers", PARITY_LAYERS),),
                 seq=PARITY_SEQ) -> None:
    """Phase 10a: one fp32 train step of full-width ``arch`` (internlm2-1.8b
    unless given) cut to ``depth`` on the card against the same step on the
    CPU through the port's plain path -- same weights (initialised on the
    CPU from the seed), the same SyntheticLM batch of PARITY_BATCH x
    ``seq`` (plus, for the enc-dec stack, all its frames drawn from the
    seed), the default settings (grad_clip on,
    remat dots_no_batch) but ``warmup_steps=1``, so the step runs at the
    full lr.  The loss within 1e-5 relative, every gradient leaf non-zero
    on the card and within PARITY_GRAD_TOL of its max |.| (the leaves of
    PARITY_LEAF_TOL within their own fixed bound).  The card's AdamW step is
    held against the CPU's AdamW step on the card's own gradients: every
    weight's update within 1e-3 lr of it (a first Adam step moves a weight
    by about lr, so a missing, halved or sign-flipped update fails).  The
    CPU's own step stops at its gradients: the CPU runs AdamW once, on the
    card's gradients, the reference of that bound (its unfused passes
    over every weight are the longest part of the CPU's work)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import (TrainSettings, make_loss,
                                                 value_and_grad)
    from repro_torch.training.tree import (leaves, leaves_with_paths,
                                          tree_map, unflatten)

    cfg = dataclasses.replace(get_config(arch), **dict(depth),
                              dtype="float32")
    settings = TrainSettings(adamw=opt.AdamWConfig(warmup_steps=1))
    loss_fn = make_loss(cfg, settings)
    cpu = torch.device("cpu")
    init = M.init_params(cfg, generator=torch.Generator().manual_seed(SEED),
                         device=cpu)
    data = train_batch(cfg, PARITY_BATCH, seq, 0)

    def step(where, grads=None, update=True):
        """One step from ``init`` on ``where``: its own gradients, or
        ``grads`` (a tree on ``where``) when given, then AdamW unless not
        ``update``; returns the loss (None with ``grads``), the gradients
        and the params after AdamW (None without it) as CPU lists, the
        step's lr (None without AdamW) and seconds."""
        # AdamW writes the params in place, so it takes a copy of init
        params = tree_map(lambda t: t.to(where, copy=update), init)
        state = opt.init(params, settings.adamw) if update else None
        batch = {k: torch.from_numpy(v).to(where) for k, v in data.items()}
        t0 = time.monotonic()
        loss = m = None
        if grads is None:
            (loss, _), grads = value_and_grad(loss_fn, params, batch)
        if update:
            _, _, m = opt.update(grads, state, params, settings.adamw)
        if where.type == "cuda":
            torch.cuda.synchronize()
        return (None if loss is None else loss.item(),
                [g.to(cpu) for g in leaves(grads)],
                [t.to(cpu) for t in leaves(params)] if update else None,
                None if m is None else float(m["lr"]),
                time.monotonic() - t0)

    with no_plain_on_card():
        l_gpu, g_gpu, p_gpu, lr, s_gpu = step(dev)
    free_card()
    l_cpu, g_cpu, _, _, s_cpu = step(cpu, update=False)
    _, _, p_want, _, _ = step(cpu, grads=unflatten(init, g_gpu))
    p_init = leaves(init)
    tag = f"train 10a {cfg.name} [{card}]"
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    # each leaf's gap against the CPU (of its max |.|), its bound, its path
    tols = PARITY_LEAF_TOL.get(cfg.name, {})
    gaps = [((a - b).abs().max().item() / b.abs().max().item(),
             tols.get(path, tols.get("", PARITY_GRAD_TOL)), path)
            for a, b, (path, _) in zip(g_gpu, g_cpu, leaves_with_paths(init))]
    g_err, g_tol, g_leaf = max(gaps, key=lambda g: g[0] / g[1])
    own = "; ".join(f"{path} {err:.2e} (tol {tol:.0e})"
                    for err, tol, path in gaps if path in tols)
    own = own or ("every leaf" if "" in tols else "")
    zero = sum(1 for g in g_gpu if not g.abs().max() > 0)
    u_err = max((a - b).abs().max().item() for a, b in zip(p_gpu, p_want))
    u_max = max((b - p0).abs().max().item() for b, p0 in zip(p_want, p_init))
    print(f"{tag}: full width, {dict(depth)}, fp32, batch {PARITY_BATCH} x "
          f"{seq}{frames_note(cfg)}: loss card {l_gpu:.7f} cpu "
          f"{l_cpu:.7f} (rel {rel:.2e}, tol 1e-5); worst gradient leaf "
          f"against its bound {g_err:.2e} of its max |.| ({g_leaf}; tol "
          f"{g_tol:.0e}) over {len(g_gpu)} leaves"
          f"{f' (PARITY_LEAF_TOL: {own})' if own else ''}, "
          f"{zero} all-zero on the card; AdamW at lr {lr:.3e}: the card's "
          f"update against the CPU's on the card's gradients max abs diff "
          f"{u_err:.2e} = {u_err / lr:.2e} lr (tol 1e-3 lr; largest update "
          f"{u_max / lr:.3f} lr); step {s_gpu:.2f} s card, gradients "
          f"{s_cpu:.2f} s cpu")
    if not (rel <= 1e-5 and all(err <= tol for err, tol, _ in gaps)
            and zero == 0
            and u_err <= 1e-3 * lr and u_max >= 0.5 * lr):
        raise SmokeFailure(f"{tag}: the card's train step differs from the "
                           f"CPU's (or a leaf got no gradient)")


def train_batch(cfg, batch: int, seq: int, step: int) -> dict:
    """The SyntheticLM batch of ``step`` (numpy), and for the enc-dec stack
    ``frames`` (batch, encoder_seq, d_model) fp32 drawn from the seed and
    the step: the reference's launcher feeds tokens only, so the frames
    enter through ``build_train_step``'s batch."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch)).batch(step)
    if cfg.family == "encdec":
        rng = np.random.default_rng([SEED, step])
        data["frames"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return data


def frames_note(cfg) -> str:
    return (f" over {cfg.encoder_seq} frames" if cfg.family == "encdec"
            else "")


def device_batch(cfg, batch: int, seq: int, step: int, dev) -> dict:
    """:func:`train_batch` on ``dev``, the frames in the model's dtype."""
    out = {k: torch.from_numpy(v).to(dev)
           for k, v in train_batch(cfg, batch, seq, step).items()}
    if "frames" in out:
        out["frames"] = out["frames"].to(getattr(torch, cfg.dtype))
    return out


def train_launches_per_step(cfg) -> Counter:
    """The kernels one train step launches under remat dots_no_batch: a
    checkpointed unit's flash forwards, norms and ssd_intra run again in
    the backward's recompute (the GEMM outputs are saved); the final norm,
    the hybrid stack's tail and the enc-dec encoder are outside the
    checkpointed units.  Per family: the GQA and MLA stacks checkpoint each
    layer (one flash, two norms); mamba2 each layer (two norms -- the
    block's and the gated one -- and one ssd_intra); zamba2 each group (PG
    Mamba-2 layers and the shared block's flash and two norms), its R tail
    layers not; whisper each decoder layer (self and cross flash, three
    norms), its encoder layers (one full flash, two norms) and their final
    norm not."""
    n = cfg.num_layers
    fam = cfg.family
    if fam == "ssm":
        return Counter({"ssd_intra": 2 * n, "ssd_intra_bwd": n,
                        "rmsnorm": 4 * n + 1, "rmsnorm_bwd": 2 * n + 1})
    if fam == "hybrid":
        g = n // cfg.attn_every
        pg, r = cfg.attn_every - 1, n - g * cfg.attn_every
        per_group = 2 * pg + 2  # norms of a group: its Mamba-2 layers' and the block's
        return Counter({"flash_attention": 2 * g, "flash_attention_bwd": g,
                        "ssd_intra": 2 * g * pg + r,
                        "ssd_intra_bwd": g * pg + r,
                        "rmsnorm": 2 * g * per_group + 2 * r + 1,
                        "rmsnorm_bwd": g * per_group + 2 * r + 1})
    if fam == "encdec":
        e = cfg.encoder_layers
        return Counter({"flash_attention": e + 4 * n,
                        "flash_attention_bwd": e + 2 * n,
                        "rmsnorm": 2 * e + 1 + 6 * n + 1,
                        "rmsnorm_bwd": 2 * e + 1 + 3 * n + 1})
    return Counter({"flash_attention": 2 * n, "flash_attention_bwd": n,
                    "rmsnorm": 2 * n + 1 + 2 * n, "rmsnorm_bwd": 2 * n + 1})


@contextlib.contextmanager
def no_plain_on_card():
    """Inside the block every kernel module's plain version raises if it is
    handed a CUDA tensor: the wrappers take it only for CPU tensors, and
    this shows that a training run on the card took none of them."""
    import importlib

    saved = []

    def guarded(name, fn):
        def call(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda
                   for a in (*args, *kw.values())):
                raise SmokeFailure(f"{name}, a plain version, was called on "
                                   f"the card")
            return fn(*args, **kw)
        return call

    for short in ("flash_attention", "rmsnorm", "ssd_scan",
                  "decode_attention", "paged_decode_attention"):
        mod = importlib.import_module(f"repro_torch.kernels.{short}")
        for name in dir(mod):
            if name.endswith("_plain") and callable(getattr(mod, name)):
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, guarded(f"{short}.{name}",
                                           getattr(mod, name)))
    try:
        yield len(saved)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def train_run(argv, steps, dev):
    """One ``repro_torch.launch.train.main`` run with the launches counted
    from zero; returns (result, launches)."""
    from repro_torch.kernels import _build
    from repro_torch.launch import train as TL

    _build.reset_launches()
    result = TL.main(argv)
    torch.cuda.synchronize()
    launches = Counter(_build.launches)
    if len(result["losses"]) != steps:
        raise SmokeFailure(f"train: {len(result['losses'])} steps, want "
                           f"{steps}")
    return result, launches


def train_trainer(dev, card) -> Counter:
    """Phase 10b: full-width, full-depth internlm2-1.8b in bf16 through
    ``repro_torch.launch.train.main`` -- TRAIN_STEPS steps of TRAIN_BATCH x
    TRAIN_SEQ, default AdamW, remat dots_no_batch, a checkpoint every
    TRAIN_RESUME_AT steps into a temporary directory; then a second run
    resumed from step TRAIN_RESUME_AT.  Returns the straight run's
    launches."""
    import shutil
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M

    cfg = get_config(TRAIN_ARCH)
    tag = f"train 10b [{card}]"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckdir:
        def argv(interval):
            return ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                    "--global-batch", str(TRAIN_BATCH), "--seq-len",
                    str(TRAIN_SEQ), "--checkpoint-dir", ckdir,
                    "--checkpoint-interval", str(interval), "--log-every", "1",
                    "--device", dev.type]

        print(f"{tag}: checkpoints under a temporary directory with "
              f"{shutil.disk_usage(ckdir).free / 1e9:.1f} GB free")
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.monotonic()
        run, launches = train_run(argv(TRAIN_RESUME_AT), TRAIN_STEPS, dev)
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        losses = run["losses"]
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise SmokeFailure(f"{tag}: losses not finite and falling: {losses}")
        want = Counter({k: v * TRAIN_STEPS
                        for k, v in train_launches_per_step(cfg).items()})
        got = Counter({k: launches[k] for k in want})
        print(f"{tag}: launches over {TRAIN_STEPS} steps {dict(launches)}; "
              f"the code implies {dict(want)}")
        if got != want:
            raise SmokeFailure(f"{tag}: launches {dict(got)} differ from "
                               f"{dict(want)}")
        ms = sorted(1e3 * x for x in run["step_seconds"])
        p50 = statistics.median(ms)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        n = M.param_count(cfg)
        print(f"{tag}: losses {', '.join(f'{x:.4f}' for x in losses)}; step "
              f"ms p50 {p50:.1f} (min {ms[0]:.1f}, max {ms[-1]:.1f}, the first "
              f"step included); {tokens / p50 * 1e3:.0f} tokens/s; peak "
              f"device memory {peak / 1e9:.2f} GB; 6*N*tokens/step/989 TF/s = "
              f"{6 * n * tokens / (p50 / 1e3) / 989e12:.3f} (N {n / 1e9:.3f} B, "
              f"for information); run {wall:.1f} s with 2 checkpoints")

        # the second run resumes from the step-TRAIN_RESUME_AT checkpoint
        root = pathlib.Path(ckdir)
        keep = f"step_{TRAIN_RESUME_AT:08d}"
        for d in root.iterdir():
            if d.is_dir() and d.name.startswith("step_") and d.name != keep:
                shutil.rmtree(d)
        (root / "LATEST").write_text(keep)
        del run
        free_card()
        t0 = time.monotonic()
        # it writes no checkpoint of its own: the interval passes its end
        resumed, resumed_launches = train_run(
            argv(TRAIN_STEPS + 1) + ["--resume"],
            TRAIN_STEPS - TRAIN_RESUME_AT, dev)
        tail = losses[TRAIN_RESUME_AT:]
        err = max(abs(a - b) / abs(b) for a, b in zip(resumed["losses"], tail))
        print(f"{tag}: resumed from step {TRAIN_RESUME_AT} in "
              f"{time.monotonic() - t0:.1f} s: losses "
              f"{', '.join(f'{x:.6f}' for x in resumed['losses'])} against "
              f"the straight run's {', '.join(f'{x:.6f}' for x in tail)} "
              f"(worst rel {err:.2e}, tol 1e-6)")
        if err > 1e-6:
            raise SmokeFailure(f"{tag}: the resumed run's losses differ")
        want_r = Counter({k: v * (TRAIN_STEPS - TRAIN_RESUME_AT)
                          for k, v in train_launches_per_step(cfg).items()})
        if Counter({k: resumed_launches[k] for k in want_r}) != want_r:
            raise SmokeFailure(f"{tag}: resumed launches "
                               f"{dict(resumed_launches)}, want {dict(want_r)}")
        train_profile(cfg, resumed["params"], dev, card)
    del resumed
    free_card()
    return launches


# kernel name patterns of a train step's device time, by category
TRAIN_CATEGORIES = (
    ("ssd_intra backward", ("ssd_bwd_",)),
    ("ssd_intra forward", ("ssd_tc_kernel", "cb_kernel", "y_kernel",
                           "s_kernel")),
    ("flash forward", ("flash_tc_kernel", "flash_kernel")),
    ("flash backward", ("delta_kernel", "dkdv_kernel", "dq_kernel",
                        "dkdv_tc_kernel", "dq_tc_kernel")),
    ("rmsnorm forward", ("row_kernel", "vec_kernel", "scalar_kernel")),
    ("rmsnorm backward", ("bwd_rows_kernel", "bwd_loop_kernel",
                          "dw_reduce_kernel")),
    ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
)


def train_category(name: str) -> str:
    import re

    for cat, pats in TRAIN_CATEGORIES:
        for pat in pats:
            if (re.search(rf"::{pat}[<(]", name) if pat.endswith("kernel")
                    else pat in name):
                return cat
    return "elementwise and other"


def train_profile(cfg, params, dev, card, seq=TRAIN_SEQ,
                  outfile=TRAIN_PROFILE_FILE, steps=TRAIN_STEPS) -> None:
    """Where one train step's device time goes: forward + backward in one
    torch.profiler window and the AdamW update in another, on the params
    of 10b's last step and its next batch (TRAIN_BATCH x ``seq``).  Shares
    of the step's device time by category; the table under
    chiprun_out/``outfile``."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import (TrainSettings, make_loss,
                                                 value_and_grad)

    settings = TrainSettings(adamw=opt.AdamWConfig(
        warmup_steps=1, total_steps=steps))
    state = opt.init(params, settings.adamw)
    batch = device_batch(cfg, TRAIN_BATCH, seq, steps, dev)
    loss_fn = make_loss(cfg, settings)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.profiler.profile(activities=acts) as fb:
        _, grads = value_and_grad(loss_fn, params, batch)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as up:
        opt.update(grads, state, params, settings.adamw)
        torch.cuda.synchronize()
    by = Counter()
    lines = []
    for window, prof in (("forward+backward", fb), ("optimizer", up)):
        _, key, rows = device_kernels(prof)
        for e in rows:
            cat = "optimizer" if window == "optimizer" else train_category(e.key)
            by[cat] += getattr(e, key) / 1e3
            lines.append(f"{window}\t{cat}\t{getattr(e, key) / 1e3:.3f} ms\t"
                         f"{e.count}\t{e.key[:160]}")
    total = sum(by.values())
    shares = ", ".join(f"{k} {v:.1f} ms ({100 * v / total:.1f}%)"
                       for k, v in by.most_common())
    print(f"train 10b profile {cfg.name} [{card}]: one step's device time "
          f"{total:.1f} ms: {shares}; profiled and read in "
          f"{time.monotonic() - t0:.1f} s")
    out = ROOT / "chiprun_out" / outfile
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(f"{card}\none bf16 train step of {cfg.name} "
                   f"({cfg.num_layers} layers), batch {TRAIN_BATCH} x {seq}"
                   f"{frames_note(cfg)}, remat dots_no_batch\n"
                   f"{shares}\n\nwindow\tcategory\tdevice\tcalls\tkernel\n"
                   + "\n".join(lines) + "\n")


def family_trainer(arch, cut, dev, card) -> Counter:
    """Phase 10b for another family: a bf16 trainer of ``arch`` at full
    width (its depth cut to ``cut`` when given, and the cut printed) for
    FAMILY_STEPS steps of TRAIN_BATCH rows of TRAIN_SEQ tokens (whisper:
    WHISPER_TRAIN_SEQ decoder tokens over its 1500 frames), default AdamW
    and remat dots_no_batch.  mamba2-780m runs through
    ``repro_torch.launch.train.main``; the cut configs and whisper (whose
    frames the launcher does not feed) through ``build_train_step`` with
    the launcher's settings and data.  Finite losses and the launches per
    step that the code implies; step ms p50, tokens/s and peak memory.
    Returns the run's launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import (TrainSettings,
                                                 build_train_step)

    full = get_config(arch)
    cfg = dataclasses.replace(full, **cut) if cut else full
    seq = WHISPER_TRAIN_SEQ if cfg.family == "encdec" else TRAIN_SEQ
    steps = FAMILY_STEPS
    n = M.param_count(cfg)
    tag = f"train 10b {cfg.name} [{card}]"
    if cut:
        print(f"{tag}: depth cut from {full.num_layers} to {cfg.num_layers} "
              f"layers: {n / 1e9:.2f} B parameters, {12 * n / 1e9:.1f} GB of "
              f"params, grads and AdamW state at 12 bytes a parameter "
              f"(full depth: {12 * M.param_count(full) / 1e9:.1f} GB)")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    if cut is None and cfg.family != "encdec":
        run, launches = train_run(
            ["--arch", arch, "--steps", str(steps), "--global-batch",
             str(TRAIN_BATCH), "--seq-len", str(seq), "--log-every", "1",
             "--device", dev.type], steps, dev)
        losses, seconds, params = (run["losses"], run["step_seconds"],
                                   run["params"])
        del run
    else:
        settings = TrainSettings(adamw=opt.AdamWConfig(
            warmup_steps=max(steps // 20, 1), total_steps=steps))
        params = M.init_params(
            cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
            device=dev)
        state = opt.init(params, settings.adamw)
        step_fn = build_train_step(cfg, settings, None)
        _build.reset_launches()
        losses, seconds = [], []
        for i in range(steps):
            batch = device_batch(cfg, TRAIN_BATCH, seq, i, dev)
            t1 = time.perf_counter()
            params, state, metrics = step_fn(params, state, batch)
            losses.append(float(metrics["loss"]))
            seconds.append(time.perf_counter() - t1)
            print(f"step {i + 1:5d} loss {losses[-1]:.4f} lr "
                  f"{float(metrics['lr']):.2e} gnorm "
                  f"{float(metrics['grad_norm']):.3f}")
        torch.cuda.synchronize()
        launches = Counter(_build.launches)
        del state, metrics, batch
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(x) for x in losses):
        raise SmokeFailure(f"{tag}: losses not finite: {losses}")
    want = Counter({k: v * steps
                    for k, v in train_launches_per_step(cfg).items()})
    got = Counter({k: launches[k] for k in want})
    print(f"{tag}: launches over {steps} steps {dict(launches)}; the code "
          f"implies {dict(want)}")
    if got != want:
        raise SmokeFailure(f"{tag}: launches {dict(got)} differ from "
                           f"{dict(want)}")
    ms = sorted(1e3 * x for x in seconds)
    p50 = statistics.median(ms)
    tokens = TRAIN_BATCH * seq
    print(f"{tag}: bf16, batch {TRAIN_BATCH} x {seq}{frames_note(cfg)}, "
          f"{cfg.num_layers} layers: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; step ms p50 {p50:.1f} "
          f"(min {ms[0]:.1f}, max {ms[-1]:.1f}, the first step included); "
          f"{tokens / p50 * 1e3:.0f} tokens/s; peak device memory "
          f"{peak / 1e9:.2f} GB; N {n / 1e9:.3f} B; run {wall:.1f} s")
    train_profile(cfg, params, dev, card, seq, f"train_step_profile_{arch}.txt",
                  steps)
    del params
    free_card()
    return launches


def train_path(dev, card) -> Counter:
    """Phase 10: 10a's fp32 parity step and 10b's trainer for internlm2,
    then for each of TRAIN_FAMILIES; every kernel module's plain version
    refuses CUDA tensors during 10b's runs and 10a's kernel step.  Returns
    the 10b runs' launches (internlm2's straight run and each family's)."""
    t0 = time.monotonic()
    train_parity(dev, card)
    free_card()
    t1 = time.monotonic()
    with no_plain_on_card() as guarded:
        print(f"train 10b [{card}]: {guarded} plain versions refuse CUDA "
              f"tensors during the trainers")
        launches = train_trainer(dev, card)
    print(f"train {TRAIN_ARCH}: 10a {t1 - t0:.1f} s, 10b "
          f"{time.monotonic() - t1:.1f} s")
    for arch, depth, seq, cut in TRAIN_FAMILIES:
        free_card()
        t0 = time.monotonic()
        train_parity(dev, card, arch, tuple(depth.items()), seq)
        free_card()
        t1 = time.monotonic()
        with no_plain_on_card():
            launches += family_trainer(arch, cut, dev, card)
        print(f"train {arch}: 10a {t1 - t0:.1f} s, 10b "
              f"{time.monotonic() - t1:.1f} s")
    return launches


# -- phase 11: the distributed layer on a (1, 1) mesh, and the launcher -----

DIST_ARCH = "internlm2_1_8b"
DIST_PARITY_LAYERS = 2     # 11a fp32: depth of the sharded-vs-plain steps
DIST_STEPS = 3             # 11a: steps of each run
MOE_ARCH = "deepseek_v2_lite_16b"  # 11b: 64 experts, d 2048, ff 1408, top 6
MOE_TOKENS = 512           # 11b: tokens through one expert-parallel body
COMPRESS_STEPS = 10        # 11c: steps of error feedback
SERVE_TIMEOUT_S = 300      # 11d: the launcher's subprocess


@contextlib.contextmanager
def one_rank_mesh(dev):
    """A process group of world 1 (NCCL on the card, gloo on the CPU)
    initialised from a FileStore in a temporary directory, and a (1, 1)
    (data, model) DeviceMesh over it; the group is destroyed after."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                            world_size=1)
    try:
        yield make_debug_mesh(1, shape=(1, 1))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def run_steps(step_fn, params, state, batches, dev):
    """``step_fn`` over ``batches``; returns (params, state, losses, step
    seconds, launches)."""
    from repro_torch.kernels import _build

    _build.reset_launches()
    losses, seconds = [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        losses.append(m["loss"].item())
        seconds.append(time.perf_counter() - t0)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return params, state, losses, seconds, Counter(_build.launches)


def sharded_parity(mesh, dev, card) -> Counter:
    """11a in fp32: DIST_STEPS steps of full-width internlm2-1.8b cut to
    DIST_PARITY_LAYERS layers, sharded over the (1, 1) mesh (params and
    AdamW state DTensors, fsdp on) against the plain step from the same
    weights and batches: the losses bit for bit, each param leaf within
    1e-6 of its max |.|.  Then the sharded state is saved and restored
    onto the mesh (``restore(shardings=...)``), bit-identical.  Returns
    the sharded run's launches."""
    import shutil
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_rules
    from repro_torch.models import model as M
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import (TrainSettings, _opt_specs,
                                                 build_train_step)
    from repro_torch.training.tree import leaves, tree_map

    cfg = dataclasses.replace(get_config(DIST_ARCH),
                              num_layers=DIST_PARITY_LAYERS, dtype="float32")
    settings = TrainSettings(adamw=opt.AdamWConfig(warmup_steps=1))
    rules = make_rules(mesh)
    init = M.init_params(cfg, generator=torch.Generator(device=dev)
                         .manual_seed(SEED), device=dev)
    batches = [device_batch(cfg, PARITY_BATCH, PARITY_SEQ, i, dev)
               for i in range(DIST_STEPS)]
    runs = {}
    for name, r in (("plain", None), ("sharded", rules)):
        params = tree_map(lambda t: t.clone(), init)
        runs[name] = run_steps(build_train_step(cfg, settings, r), params,
                               opt.init(params, settings.adamw), batches, dev)
    (p_plain, _, l_plain, _, _), (p_shd, s_shd, l_shd, _, launches) = \
        runs["plain"], runs["sharded"]
    worst = max((shd.to_full(a) - b).abs().max().item()
                / max(b.abs().max().item(), 1e-30)
                for a, b in zip(leaves(p_shd), leaves(p_plain)))
    tag = f"distributed 11a {cfg.name} [{card}]"
    print(f"{tag}: fp32, {cfg.num_layers} layers, batch {PARITY_BATCH} x "
          f"{PARITY_SEQ}, {DIST_STEPS} steps on the (1, 1) mesh: losses "
          f"sharded {l_shd} plain {l_plain} (bit for bit: "
          f"{l_shd == l_plain}); worst param leaf gap {worst:.2e} of its "
          f"max |.| (tol 1e-6); embed {list(p_shd['embed'].placements)}")
    if l_shd != l_plain or worst > 1e-6:
        raise SmokeFailure(f"{tag}: the sharded step differs from the plain")
    del runs, p_plain
    tree = {"params": p_shd, "opt": s_shd}
    pspecs = shd.param_specs(p_shd, rules)
    shardings = shd.named({"params": pspecs,
                           "opt": _opt_specs(s_shd, pspecs)}, rules)
    tmp = tempfile.mkdtemp()
    try:
        t0 = time.monotonic()
        ckpt.save(tmp, DIST_STEPS, tree)
        t1 = time.monotonic()
        got, step = ckpt.restore(tmp, tree, shardings=shardings)
        t2 = time.monotonic()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = step == DIST_STEPS and all(
        a.placements == b.placements and a.dtype == b.dtype
        and torch.equal(a.to_local(), b.to_local())
        for a, b in zip(leaves(got), leaves(tree)))
    n_bytes = sum(t.to_local().numel() * t.element_size() for t in leaves(tree))
    print(f"{tag}: checkpoint of the sharded params and AdamW state "
          f"({len(leaves(tree))} leaves, {n_bytes / 1e9:.2f} GB): save "
          f"{t1 - t0:.1f} s, restore onto the mesh {t2 - t1:.1f} s, "
          f"bit-identical: {same}")
    if not same:
        raise SmokeFailure(f"{tag}: the restored state differs")
    return launches


def sharded_trainer(mesh, dev, card) -> Counter:
    """11a in bf16: full-width, full-depth internlm2-1.8b, DIST_STEPS steps
    of TRAIN_BATCH x TRAIN_SEQ plain and then sharded over the (1, 1) mesh
    from the same seed (the trainer's settings): finite losses, step ms p50
    and tokens/s of each (their gap is DTensor's host overhead), the
    sharded run's launches per step as the code implies.  Returns the
    sharded run's launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_rules
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import (TrainSettings,
                                                 build_train_step)

    cfg = get_config(DIST_ARCH)
    settings = TrainSettings(adamw=opt.AdamWConfig(
        warmup_steps=1, total_steps=DIST_STEPS))
    batches = [device_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, i, dev)
               for i in range(DIST_STEPS)]
    tag = f"distributed 11a {cfg.name} [{card}]"
    out = {}
    for name, r in (("plain", None), ("sharded", make_rules(mesh))):
        params = M.init_params(cfg, generator=torch.Generator(device=dev)
                               .manual_seed(SEED), device=dev)
        state = opt.init(params, settings.adamw)
        _, _, losses, seconds, launches = run_steps(
            build_train_step(cfg, settings, r), params, state, batches, dev)
        del params, state
        free_card()
        p50 = statistics.median(1e3 * x for x in seconds)
        out[name] = (losses, p50, launches)
        print(f"{tag}: bf16 {name}, {cfg.num_layers} layers, batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}: losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}; step ms p50 "
              f"{p50:.1f} over {DIST_STEPS} steps (the first included); "
              f"{TRAIN_BATCH * TRAIN_SEQ / p50 * 1e3:.0f} tokens/s")
    losses, p50, launches = out["sharded"]
    print(f"{tag}: DTensor's overhead on the step: "
          f"{p50 - out['plain'][1]:+.1f} ms p50 ({p50 / out['plain'][1]:.3f}x)")
    want = Counter({k: v * DIST_STEPS
                    for k, v in train_launches_per_step(cfg).items()})
    got = Counter({k: launches[k] for k in want})
    print(f"{tag}: sharded launches over {DIST_STEPS} steps "
          f"{dict(launches)}; the code implies {dict(want)}")
    if not all(math.isfinite(x) for x in losses) or got != want:
        raise SmokeFailure(f"{tag}: losses {losses} or launches {dict(got)}")
    return launches


def expert_parallel_body(dev, card) -> None:
    """11b: ``moe._moe_local`` (axis None: the expert-parallel body alone)
    at deepseek-v2-lite-16b widths on MOE_TOKENS tokens, capacity factor 8
    (no drops), against ``moe_dense`` on the same weights: fp32 within
    1e-5, bf16 within 2e-2.  At capacity factor 1.25 the routing and the
    kept-token mask equal the CPU's on the same inputs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as MOE

    base = get_config(MOE_ARCH)
    e, k, d = base.num_experts, base.num_experts_per_tok, base.d_model
    tag = f"distributed 11b {base.name} [{card}]"
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(base, capacity_factor=8.0)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        p = MOE.init_moe(cfg, gen, dtype, dev)
        p.pop("shared", None)  # the routed experts only: what the body runs
        x = torch.randn((MOE_TOKENS, d), generator=gen, device=dev).to(dtype)
        cap = max(int(math.ceil(MOE_TOKENS * k / e * cfg.capacity_factor)), 4)
        t0 = time.perf_counter()
        got, aux = MOE._moe_local(cfg, p["router"], p["experts"], x,
                                  capacity=cap, e_local=e, axis=None)
        want, aux_d = MOE.moe_dense(cfg, p, x[None])
        torch.cuda.synchronize()
        err = (got.float() - want[0].float()).abs().max().item()
        tol = TOL[dtype]
        ok = bool(((got.float() - want[0].float()).abs()
                   <= tol + tol * want[0].float().abs()).all())
        print(f"{tag}: {str(dtype)[6:]} _moe_local (E {e}, d {d}, ff "
              f"{cfg.moe_d_ff}, top {k}, {MOE_TOKENS} tokens, capacity "
              f"{cap}) against moe_dense: max_abs_err {err:.3e} (tol "
              f"{tol:g}); aux {float(aux):.6f} / {float(aux_d):.6f}; "
              f"{1e3 * (time.perf_counter() - t0):.1f} ms both")
        if not ok or float(aux) != float(aux_d):
            raise SmokeFailure(f"{tag}: _moe_local differs from moe_dense")
    cfg = base  # capacity factor 1.25: tokens drop
    cap = max(int(math.ceil(MOE_TOKENS * k / e * cfg.capacity_factor)), 4)
    masks = []
    for where in (dev, torch.device("cpu")):
        gen = torch.Generator().manual_seed(SEED)
        router = torch.randn((d, e), generator=gen) * 0.02
        x = torch.randn((MOE_TOKENS, d), generator=gen)
        idx, w, _ = MOE.router_topk(cfg, {"router": router.to(where)},
                                    x.to(where))
        _, _, keep = MOE._dispatch(x.to(where), idx, w, e, cap)
        masks.append((idx.cpu(), keep.cpu()))
    same = all(torch.equal(a, b) for a, b in zip(*masks))
    print(f"{tag}: capacity factor {cfg.capacity_factor} (capacity {cap}): "
          f"{int(masks[0][1].sum())} of {masks[0][1].numel()} routed slots "
          f"kept; routing and kept-token mask equal the CPU's: {same}")
    if not same:
        raise SmokeFailure(f"{tag}: the card's kept-token mask differs")


def compressed_reduce(mesh, dev, card) -> None:
    """11c: ``compressed_psum_mean`` on the world-1 mesh's data axis over
    the gradients of full-width internlm2-1.8b cut to DIST_PARITY_LAYERS
    layers (fp32, one PARITY_BATCH x PARITY_SEQ batch): the first step's
    mean and error feedback equal the scheme in numpy bit for bit; the
    error feedback's norm after COMPRESS_STEPS steps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.training import grad_compress as gc
    from repro_torch.training.train_step import (TrainSettings, make_loss,
                                                 value_and_grad)
    from repro_torch.training.tree import leaves

    cfg = dataclasses.replace(get_config(DIST_ARCH),
                              num_layers=DIST_PARITY_LAYERS, dtype="float32")
    params = M.init_params(cfg, generator=torch.Generator(device=dev)
                           .manual_seed(SEED), device=dev)
    _, grads = value_and_grad(make_loss(cfg, TrainSettings()), params,
                              device_batch(cfg, PARITY_BATCH, PARITY_SEQ, 0,
                                           dev))
    del params
    err = gc.init_error_state(grads)
    t0 = time.perf_counter()
    mean, new_err = gc.compressed_psum_mean(grads, err, mesh, ("data",))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    bad = 0
    for g, m, e in zip(leaves(grads), leaves(mean), leaves(new_err)):
        gn = g.cpu().numpy()
        corrected = gn + np.float32(0.0)
        scale = np.float32(max(np.abs(corrected).max(), np.float32(1e-12))) \
            / np.float32(127.0)
        q = np.clip(np.round(corrected / scale), -127, 127)
        want_mean = q.astype(np.int32).astype(np.float32) * scale / np.float32(1)
        want_err = corrected - q * scale
        bad += int(not (np.array_equal(m.cpu().numpy(), want_mean)
                        and np.array_equal(e.cpu().numpy(), want_err)))
    n = sum(g.numel() for g in leaves(grads))
    for _ in range(COMPRESS_STEPS - 1):
        mean, new_err = gc.compressed_psum_mean(grads, new_err, mesh,
                                                ("data",))
    norm = math.sqrt(sum(float((e.double() ** 2).sum())
                         for e in leaves(new_err)))
    gnorm = math.sqrt(sum(float((g.double() ** 2).sum())
                          for g in leaves(grads)))
    tag = f"distributed 11c {cfg.name} [{card}]"
    print(f"{tag}: int8 + error feedback over {n / 1e6:.1f} M gradient "
          f"entries ({len(leaves(grads))} leaves), int32 on the wire "
          f"(the reference: int16): first step {ms:.1f} ms, {bad} leaves "
          f"differ from numpy; error feedback after {COMPRESS_STEPS} steps "
          f"|e| {norm:.4e} (|g| {gnorm:.4e})")
    if bad:
        raise SmokeFailure(f"{tag}: {bad} leaves differ from the scheme")


def launcher_kernels(dev, card) -> None:
    """11d's kernels at the launcher's shapes (the reduced config: head
    width 16, 4 query and 2 kv heads, bf16, prompts of 8, caches of 64)
    against their plain versions: flash_attention and decode_attention
    (the bf16 tensor-core kernels at H 16, which only this path runs)
    within 2e-2."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    q, k, v = randn(1, 8, 4, 16), randn(1, 8, 2, 16), randn(1, 8, 2, 16)
    errs = {"flash_attention": (FA.flash_attention(q, k, v),
                                FA.flash_attention_plain(q, k, v))}
    qd, kc, vc = randn(3, 4, 16), randn(3, 64, 2, 16), randn(3, 64, 2, 16)
    lens = torch.tensor([9, 33, 64], dtype=torch.int32, device=dev)
    errs["decode_attention"] = (DA.decode_attention(qd, kc, vc, lens),
                                DA.decode_attention_plain(qd, kc, vc, lens))
    torch.cuda.synchronize()
    for name, (got, want) in errs.items():
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item()
        ok = bool(((got - want).abs() <= TOL[bf16] * (1 + want.abs())).all())
        print(f"distributed 11d {name} [{card}]: bf16 at head width 16 "
              f"against its plain version: max_abs_err {err:.3e} (tol "
              f"{TOL[bf16]:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"{name} at head width 16 disagrees")


def serve_launcher(dev, card) -> Counter:
    """11d: the launcher's kernels first (:func:`launcher_kernels`); then
    ``python -m repro_torch.launch.serve`` in a subprocess with no
    ``--device`` (the card) and with ``--device cpu``: rc 0, every
    admitted stream's report line, the same admission decisions; then
    ``serve.main([])`` in this process with every kernel module's plain
    version refusing CUDA tensors, which must launch flash_attention,
    decode_attention and rmsnorm.  Returns that run's launches."""
    import os
    import re

    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    launcher_kernels(dev, card)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.monotonic()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for name, extra in (("card", []),
                                      ("cpu", ["--device", "cpu"]))}
    runs = {}
    try:
        for name, proc in procs.items():  # both at once: the CPU's is host work
            out, err = proc.communicate(timeout=SERVE_TIMEOUT_S)
            runs[name] = subprocess.CompletedProcess(proc.args,
                                                     proc.returncode, out, err)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, res in runs.items():
        print(f"distributed 11d launcher [{name}] rc {res.returncode}, both "
              f"in {time.monotonic() - t0:.1f} s:\n{res.stdout.rstrip()}")
        if res.returncode:
            raise SmokeFailure(f"launcher [{name}] failed:\n{res.stderr}")

    def decisions(out):
        return (sorted(re.findall(r"^(stream\d+): REJECTED", out, re.M)),
                sorted(re.findall(r"^(stream\d+): prefill p50", out, re.M)))

    same = (decisions(runs["card"].stdout) == decisions(runs["cpu"].stdout)
            and decisions(runs["card"].stdout)[1] != [])
    with no_plain_on_card():
        _build.reset_launches()
        report = serve.main([])
        torch.cuda.synchronize()
        launches = Counter(_build.launches)
    print(f"distributed 11d launcher [{card}]: admission as on the CPU: "
          f"{same}; in-process report {report}; launches {dict(launches)}")
    need = ("flash_attention", "decode_attention", "rmsnorm")
    if not same or not report or not all(launches[k] for k in need):
        raise SmokeFailure("the launcher's admission differs from the CPU's "
                           "or a kernel of its path never launched")
    return launches


def distributed_path(dev, card) -> Counter:
    """Phase 11: 11a's sharded train step (fp32 parity and the checkpoint,
    then the bf16 trainer) and 11c's compressed reduce on a (1, 1) mesh of
    one NCCL rank, 11b's expert-parallel body, 11d's launcher; every kernel
    module's plain version refuses CUDA tensors in 11a and 11d.  Returns
    the launches of 11a's sharded runs and 11d's in-process run."""
    t0 = time.monotonic()
    launches = Counter()
    with one_rank_mesh(dev) as mesh:
        with no_plain_on_card():
            launches += sharded_parity(mesh, dev, card)
            free_card()
            launches += sharded_trainer(mesh, dev, card)
        free_card()
        t1 = time.monotonic()
        compressed_reduce(mesh, dev, card)
        free_card()
    t2 = time.monotonic()
    expert_parallel_body(dev, card)
    free_card()
    t3 = time.monotonic()
    launches += serve_launcher(dev, card)
    print(f"distributed: 11a {t1 - t0:.1f} s, 11c {t2 - t1:.1f} s, 11b "
          f"{t3 - t2:.1f} s, 11d {time.monotonic() - t3:.1f} s")
    return launches


STEPS_ARCH = "internlm2_1_8b"
STEPS_PARITY_LAYERS = 2    # 12a fp32: depth of the step-vs-apply parity
STEPS_PARITY_SHAPE = (2, 128, 256)   # 12a fp32: batch, prompt, max_seq
STEPS_PARITY_DECODE = 8    # 12a fp32: decode steps
STEPS_SHAPE = (4, 2048, 4096)        # 12a bf16 / 12b: batch, prompt, max_seq
STEPS_DECODE = 16          # 12a bf16: decode steps
SSM_STEPS_ARCH = "mamba2_780m"
SSM_STEPS_VARIANTS = ("opt_ssm_q128", "opt_ssm_q64")
SSM_STEPS_DECODE = 8       # 12b: decode steps
SSM_PARITY_TOL = 1e-4      # 12b fp32: logits at Q 128 / 64 vs 256, of max |.|
DRYRUN_CELLS = (("internlm2_1_8b", "train_4k"),
                ("mamba2_780m", "prefill_32k", "--variant", "opt_ssm_q128"),
                ("qwen3_moe_235b_a22b", "decode_32k", "--multi-pod"))
DRYRUN_TIMEOUT_S = 300     # 12c: each dry-run subprocess


def step_tokens(cfg, batch, seq, seed, dev):
    g = np.random.default_rng([SEED, seed])
    return torch.from_numpy(g.integers(0, cfg.vocab_size, (batch, seq),
                                       dtype=np.int32)).to(dev)


def sharded_steps(cfg, rules, params, prompt, max_seq, decode_tokens):
    """``build_prefill`` then ``build_decode`` over ``rules``' mesh, params
    placed once: returns (logits of each call as plain tensors, the final
    cache's leaves, the prefill's seconds, each decode step's seconds)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.training.tree import leaves

    b = prompt.shape[0]
    pf = steps.build_prefill(cfg, rules, max_seq=max_seq, batch=b,
                             batch_shapes={"tokens": prompt})
    placed = shd.distribute(params, pf.specs["params"], rules)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = pf(placed, {"tokens": prompt})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    out = [shd.to_full(logits)]
    dec = steps.build_decode(cfg, rules, max_seq=max_seq, batch=b,
                             batch_shapes={"tokens": decode_tokens[0]},
                             cache_shapes=cache)
    t_dec = []
    for tok in decode_tokens:
        t0 = time.perf_counter()
        logits, cache = dec(placed, {"tokens": tok}, cache)
        torch.cuda.synchronize()
        t_dec.append(time.perf_counter() - t0)
        out.append(shd.to_full(logits))
    return out, [shd.to_full(t) for t in leaves(cache)], t_prefill, t_dec


def plain_steps(cfg, params, prompt, max_seq, decode_tokens):
    """:func:`sharded_steps` through the unsharded ``model.apply``."""
    from repro_torch.models import model as M
    from repro_torch.training.tree import leaves

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, _ = M.apply(cfg, params, {"tokens": prompt,
                                             "max_seq": max_seq},
                               mode="prefill")
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    out, t_dec = [logits], []
    for tok in decode_tokens:
        t0 = time.perf_counter()
        logits, cache, _ = M.apply(cfg, params, {"tokens": tok},
                                   mode="decode", cache=cache)
        torch.cuda.synchronize()
        t_dec.append(time.perf_counter() - t0)
        out.append(logits)
    return out, list(leaves(cache)), t_prefill, t_dec


def steps_parity(mesh, dev, card) -> Counter:
    """12a in fp32: full-width internlm2-1.8b cut to STEPS_PARITY_LAYERS
    layers, ``build_prefill`` and STEPS_PARITY_DECODE ``build_decode``
    steps on the (1, 1) mesh against the unsharded ``model.apply`` from the
    same weights: every logit and the final cache bit for bit.  Returns
    the sharded run's launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_rules

    cfg = dataclasses.replace(get_config(STEPS_ARCH),
                              num_layers=STEPS_PARITY_LAYERS, dtype="float32")
    b, s, max_seq = STEPS_PARITY_SHAPE
    params = init_params(cfg, dev, f"steps 12a {cfg.name}")
    prompt = step_tokens(cfg, b, s, 0, dev)
    toks = [step_tokens(cfg, b, 1, 1 + i, dev)
            for i in range(STEPS_PARITY_DECODE)]
    with torch.inference_mode():
        _build.reset_launches()
        got, cache, _, _ = sharded_steps(cfg, make_rules(mesh), params,
                                         prompt, max_seq, toks)
        launches = Counter(_build.launches)
        want, ref_cache, _, _ = plain_steps(cfg, params, prompt, max_seq, toks)
    same = (all(torch.equal(a, b) for a, b in zip(got, want))
            and len(cache) == len(ref_cache)
            and all(torch.equal(a, b) for a, b in zip(cache, ref_cache)))
    gap = max((a - b).abs().max().item() for a, b in zip(got, want))
    tag = f"steps 12a {cfg.name} [{card}]"
    print(f"{tag}: fp32, {cfg.num_layers} layers, prefill {b} x {s} "
          f"(max_seq {max_seq}) + {len(toks)} decode steps through "
          f"build_prefill / build_decode on the (1, 1) mesh vs model.apply: "
          f"logits and cache bit for bit: {same} (max |gap| {gap:.2e}); "
          f"launches {dict(launches)}")
    if not same:
        raise SmokeFailure(f"{tag}: the sharded steps differ from apply")
    return launches


def steps_bf16(mesh, dev, card) -> Counter:
    """12a in bf16: full-width, full-depth internlm2-1.8b, a prefill of
    STEPS_SHAPE and STEPS_DECODE decode steps through the sharded steps
    and through ``model.apply``: finite logits, the greedy tokens of
    both, prefill ms and decode ms p50 of each (their gap is DTensor's
    overhead), tokens/s, peak memory and the sharded run's launches,
    which must hold flash_attention, decode_attention and rmsnorm."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_rules

    cfg = get_config(STEPS_ARCH)
    b, s, max_seq = STEPS_SHAPE
    params = init_params(cfg, dev, f"steps 12a {cfg.name}")
    prompt = step_tokens(cfg, b, s, 0, dev)
    toks = [step_tokens(cfg, b, 1, 1 + i, dev) for i in range(STEPS_DECODE)]
    tag = f"steps 12a {cfg.name} [{card}]"
    res = {}
    with torch.inference_mode():
        for name in ("plain", "sharded"):
            torch.cuda.reset_peak_memory_stats(dev)
            _build.reset_launches()
            if name == "plain":
                out = plain_steps(cfg, params, prompt, max_seq, toks)
            else:
                out = sharded_steps(cfg, make_rules(mesh), params, prompt,
                                    max_seq, toks)
            launches = Counter(_build.launches)
            logits, _, t_pf, t_dec = out
            del out
            p50 = statistics.median(t_dec) * 1e3
            greedy = [int(x[0, -1].argmax()) for x in logits]
            res[name] = (t_pf * 1e3, p50, greedy, launches)
            print(f"{tag}: bf16 {name}, {cfg.num_layers} layers, prefill "
                  f"{b} x {s} (max_seq {max_seq}) {t_pf * 1e3:.1f} ms "
                  f"({b * s / t_pf:.0f} tokens/s), {len(toks)} decode steps "
                  f"ms p50 {p50:.2f} ({b / p50 * 1e3:.0f} tokens/s; the "
                  f"first step included); peak "
                  f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; "
                  f"greedy row 0 {greedy[:8]}; launches {dict(launches)}")
            if not all(torch.isfinite(x).all() for x in logits):
                raise SmokeFailure(f"{tag}: {name} logits not finite")
            del logits
            free_card()
    pf_plain, dec_plain, g_plain, _ = res["plain"]
    pf_shd, dec_shd, g_shd, launches = res["sharded"]
    print(f"{tag}: DTensor's overhead: prefill {pf_shd - pf_plain:+.1f} ms "
          f"({pf_shd / pf_plain:.3f}x), decode p50 {dec_shd - dec_plain:+.2f} "
          f"ms ({dec_shd / dec_plain:.3f}x); greedy tokens equal: "
          f"{g_plain == g_shd}")
    need = ("flash_attention", "decode_attention", "rmsnorm")
    if any(not launches.get(k) for k in need):
        raise SmokeFailure(f"{tag}: the sharded steps launched "
                           f"{dict(launches)}, want each of {need}")
    return launches


def split_projections(params):
    """``params`` of a Mamba-2 stack with each fused ``in_proj`` cut into
    the split projections that ``perf`` flag ``split_ssm_proj`` makes
    (``z_proj``, ``xbc_proj``, ``dt_proj``: its column blocks), so that a
    split-flag run computes what the fused one does."""
    def go(node):
        if isinstance(node, dict):
            if "in_proj" in node:
                node = dict(node)
                w = node.pop("in_proj")
                h = node["A_log"].shape[-1]
                d_in = node["gate_norm"].shape[-1]
                node["z_proj"] = w[..., :d_in].contiguous()
                node["xbc_proj"] = w[..., d_in:w.shape[-1] - h].contiguous()
                node["dt_proj"] = w[..., w.shape[-1] - h:].contiguous()
                return node
            return {k: go(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(go(v) for v in node)
        return node

    return go(params)


def ssm_steps(mesh, dev, card) -> Counter:
    """12b: full-width mamba2-780m through ``build_prefill`` /
    ``build_decode`` on the (1, 1) mesh under ``perf.VARIANTS``
    opt_ssm_q128 and opt_ssm_q64 (split projections cut from the fused
    weights, so each variant computes the baseline's function): in fp32 at
    2 layers the prefill and decode logits against the baseline's (chunk
    256) within SSM_PARITY_TOL of their max |.|; in bf16 at all 48 layers
    a prefill of STEPS_SHAPE and SSM_STEPS_DECODE decode steps, with the
    greedy tokens beside the baseline's, ssd_intra launched at each
    variant's chunk.  Returns the bf16 variants' launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_rules
    from repro_torch.models import perf
    from repro_torch.models.ssm import _chunk

    full = get_config(SSM_STEPS_ARCH)
    rules = make_rules(mesh)
    tag = f"steps 12b {full.name} [{card}]"
    launches = Counter()
    for cfg, (b, s, max_seq), n_dec in (
            (dataclasses.replace(full, num_layers=2, dtype="float32"),
             (2, 512, 640), 2),
            (full, STEPS_SHAPE, SSM_STEPS_DECODE)):
        params = init_params(cfg, dev, f"steps 12b {cfg.name} {cfg.dtype}")
        split = split_projections(params)
        prompt = step_tokens(cfg, b, s, 0, dev)
        toks = [step_tokens(cfg, b, 1, 1 + i, dev) for i in range(n_dec)]
        runs = {}
        with torch.inference_mode():
            for variant in ("baseline", *SSM_STEPS_VARIANTS):
                flags = perf.VARIANTS[variant]
                with perf.use_flags(flags):
                    _build.reset_launches()
                    t0 = time.monotonic()
                    logits, _, t_pf, t_dec = sharded_steps(
                        cfg, rules, params if variant == "baseline" else split,
                        prompt, max_seq, toks)
                    got = Counter(_build.launches)
                    q = _chunk(s)
                runs[variant] = [x.float() for x in logits]
                greedy = [int(x[0, -1].argmax()) for x in logits]
                print(f"{tag}: {cfg.dtype} {cfg.num_layers} layers, "
                      f"{variant} (chunk {q}): prefill {b} x {s} "
                      f"{t_pf * 1e3:.1f} ms, {n_dec} decode steps ms p50 "
                      f"{statistics.median(t_dec) * 1e3:.2f}; greedy row 0 "
                      f"{greedy}; launches {dict(got)} "
                      f"({time.monotonic() - t0:.1f} s)")
                if not got.get("ssd_intra") or not got.get("ssd_slab_decode"):
                    raise SmokeFailure(f"{tag}: {variant} launched {dict(got)}")
                if variant != "baseline":
                    if q != flags.ssd_chunk:
                        raise SmokeFailure(f"{tag}: {variant} chunk {q}")
                    if cfg.dtype == "bfloat16":
                        launches += got
                del logits
        if cfg.dtype == "float32":
            for variant in SSM_STEPS_VARIANTS:
                gap = max(((a - r).abs().max() / r.abs().max()).item()
                          for a, r in zip(runs[variant], runs["baseline"]))
                print(f"{tag}: fp32 {variant} logits vs the baseline's "
                      f"(chunk 256): max |gap| {gap:.2e} of max |logit| "
                      f"(tol {SSM_PARITY_TOL})")
                if not gap <= SSM_PARITY_TOL:
                    raise SmokeFailure(f"{tag}: {variant} differs from "
                                       "the baseline")
        del params, split, runs
        free_card()
    return launches


def start_dryrun_cells():
    """12c's subprocesses: ``python -m repro_torch.launch.dryrun`` on
    DRYRUN_CELLS, one each, all at once (a fake process group cannot
    share this process with the NCCL group), none of them with a card to
    see (CUDA_VISIBLE_DEVICES empty) and each on one thread.  Started
    with phase 12 and not waited for: their CPU work runs beside 12a's
    and 12b's card work.  Returns (start time, [(cell, process)])."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return time.monotonic(), [(cell, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", cell[0],
         "--shape", cell[1], *cell[2:]], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for cell in DRYRUN_CELLS]


def dryrun_cells(dev, card, started) -> None:
    """12c: waits for :func:`start_dryrun_cells`'s subprocesses; each must
    end ok, and this process's device memory must not move while it
    waits."""
    t0, procs = started
    before = torch.cuda.memory_allocated(dev)
    failed = []
    for cell, proc in procs:
        try:
            out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            failed.append(cell)
        mesh = "multi_pod" if "--multi-pod" in cell else "single_pod"
        tail = f"__{cell[3]}" if "--variant" in cell else ""
        path = ROOT / "artifacts" / "dryrun_torch" / \
            f"{cell[0]}__{cell[1]}__{mesh}{tail}.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        if proc.returncode != 0 or rec.get("status") != "ok":
            failed.append(cell)
            print(f"dryrun 12c {cell}: rc {proc.returncode}\n{out[-2000:]}\n"
                  f"{err[-3000:]}\n{rec.get('traceback', '')}")
            continue
        coll = {k: (v["count"], v["bytes"])
                for k, v in rec["collectives"].items() if v["count"]}
        print(f"dryrun 12c {' '.join(cell)} [{card}'s host, no card]: "
              f"status ok, meta run {rec['lower_s']:.1f} s, per rank "
              f"{rec['cost_flops']:.4g} flops, {rec['cost_bytes']:.4g} bytes, "
              f"collectives (count, bytes) {coll}, temp "
              f"{rec['temp_size_in_bytes'] / 1e9:.2f} GB"
              + (f", bottleneck {rec['roofline']['bottleneck']}"
                 if rec.get("roofline") else ""))
    after = torch.cuda.memory_allocated(dev)
    print(f"dryrun 12c: {len(procs)} cells in {time.monotonic() - t0:.1f} s "
          f"from the start of phase 12; this process's device memory while "
          f"it waited {before} -> {after} bytes")
    if failed or after != before:
        raise SmokeFailure(f"dryrun 12c: failed {failed}, memory {before} -> "
                           f"{after}")


def steps_path(dev, card) -> Counter:
    """Phase 12: 12a's sharded prefill and decode of internlm2-1.8b (fp32
    parity, then bf16 at full depth) and 12b's mamba2-780m under the
    split-projection variants on a (1, 1) mesh of one NCCL rank, every
    kernel module's plain version refusing CUDA tensors, with 12c's dry
    runs started beside them and waited for after them.  Returns the
    launches of 12a's and 12b's sharded runs."""
    t0 = time.monotonic()
    launches = Counter()
    started = start_dryrun_cells()
    try:
        with one_rank_mesh(dev) as mesh, no_plain_on_card():
            launches += steps_parity(mesh, dev, card)
            free_card()
            launches += steps_bf16(mesh, dev, card)
            free_card()
            t1 = time.monotonic()
            launches += ssm_steps(mesh, dev, card)
            free_card()
    except BaseException:
        for _, proc in started[1]:
            proc.kill()
            proc.communicate()
        raise
    t2 = time.monotonic()
    dryrun_cells(dev, card, started)
    print(f"steps: 12a {t1 - t0:.1f} s, 12b {t2 - t1:.1f} s, 12c "
          f"{time.monotonic() - t2:.1f} s more")
    return launches


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
    checks.time_rmsnorm_hybrid(get_config("zamba2_7b"), tag)
    checks.time_ssd_intra(get_config("mamba2_780m"), tag)
    checks.time_backward(tag)
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

    t_start = time.monotonic()
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
    t3 = time.monotonic()
    checks.run(get_config("internlm2_1_8b"))
    checks.run_ssm(get_config("mamba2_780m"))
    checks.run_mla(get_config("deepseek_v2_lite_16b"))
    checks.run_hybrid(get_config("zamba2_7b"))
    checks.run_encdec(get_config("whisper_medium"))
    checks.run_vlm(get_config("qwen2_vl_2b"))
    checks.run_backward(get_config("internlm2_1_8b"))
    checks.run_backward_families({a: get_config(a) for a in (
        "mamba2_780m", "zamba2_7b")})
    checks.rank()
    print(f"phase 3: {time.monotonic() - t3:.1f} s")

    # phase 7 runs inside these: 7b and 7d in every fp32 phase, 7a, 7c
    # and 7d's bf16 comparison in the internlm2-1.8b phases
    counts = Counter()
    for path in (gqa_path,                                      # phases 4-5
                 ssm_path,                                      # phases 4b-5b
                 mla_path,                                      # phases 4c-5c
                 hybrid_path,                                   # phases 4d-5d
                 encdec_path,                                   # phases 4e-5e
                 vlm_path,                                      # phases 4f-5f
                 train_path,                                    # phase 10
                 distributed_path,                              # phase 11
                 steps_path):                                   # phase 12
        print(f"{path.__name__} starts at {time.monotonic() - t_start:.1f} s")
        counts += path(dev, card)
    print(f"phase 12 ends at {time.monotonic() - t_start:.1f} s")

    print(f"launches over phases 4-7 and 10-12: {dict(counts)}")  # phase 8
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
