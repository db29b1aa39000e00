"""Where the fp32 gradient gaps between the card and the CPU come from on
the SSM families: mamba2-780m and zamba2-7b at ``chip_smoke.py``'s phase
10a depths and batches (full width, fp32, remat dots_no_batch), over
several seeds (each seed is the init seed and the ``SyntheticLM`` step).

One train step's gradients, six ways:

  cpu          the CPU through the plain versions (10a's reference)
  card         the card through the kernels (10a's step)
  card-plain   the card through the plain versions: the CPU's arithmetic
               in the card's own op order
  cpu-intra64  the CPU with ``ssd_intra`` (forward and backward) in
               float64, its outputs cast back to fp32
  cpu-intra-card        the CPU with ``ssd_intra`` (forward and
               backward) on the card's kernels
  cpu-intra-card-plain  the CPU with ``ssd_intra`` on the card through
               its plain version

For each way and leaf, the gap against ``cpu`` of the leaf's max |.|.  For
the two SSM parameter leaves, the terms of the sum that makes their
gradient are captured on cpu and card (hooks on the Mamba-2 mixer's dt and
on ``ssd_intra``'s dA):

  dt_bias  sum over tokens of dL/ddt * sigmoid(dt_raw + dt_bias)
  A_log    A * sum over tokens of dL/ddA * dt (the intra-chunk part: for
           two chunks the inter-chunk decay adds to dL/ddA)

and printed: the cancellation of the sum (the largest sum of |term| over
the largest |sum|, across heads and layers) and how far the card's and
cpu-intra64's terms, summed exactly, are off the CPU's, in units of the
largest sum of |term|.  A gap that is a few fp32 ulps of
sum |term| and large of the leaf's max comes from summation order.

Run on the card from the root of the repo:

    python tools/grad_floor.py [--seeds 0 1 2 3] [--archs zamba2_7b]

Prints one line per (config, seed, leaf) and writes every leaf's gaps to
``chiprun_out/grad_floor.txt``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402

FAMILIES = tuple((arch, depth, seq) for arch, depth, seq, _ in
                 smoke.TRAIN_FAMILIES if arch in ("mamba2_780m", "zamba2_7b"))
SUMS = {"dt_bias": "dt", "A_log": "dA"}  # leaf name -> captured tensor
WAYS = ("card", "card-plain", "cpu-intra64", "cpu-intra-card",
        "cpu-intra-card-plain")


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def step_grads(cfg, init, data, where, *, plain=False, intra64=False,
               intra_on=None):
    """One fp32 step's gradients from ``init`` on ``where``, as CPU
    tensors in ``leaves`` order, the terms of the SSM leaves' sums
    ({"dt": [(B,S,H) per mixer], "dA": [(M,H,Q) per mixer]} on the CPU)
    and the largest |cumsum of dA| over a chunk.  ``plain``: every kernel
    wrapper takes its plain version; ``intra64``: ``ssd_intra`` in
    float64; ``intra_on``: ``ssd_intra`` on that device."""
    from repro_torch.kernels import _build
    from repro_torch.models import ssm as S
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import (TrainSettings, make_loss,
                                                 value_and_grad)
    from repro_torch.training.tree import leaves, tree_map

    loss_fn = make_loss(cfg, TrainSettings(
        adamw=opt.AdamWConfig(warmup_steps=1)))
    calls, terms, forward_calls, seg = [0], {}, [None], [0.0]

    def hook_terms(kind, t, weight):
        """Record ``weight`` times t's gradient under this forward call's
        index (remat's recompute registers hooks that never fire)."""
        i = calls[0]
        calls[0] += 1
        if t.requires_grad:
            w = weight.detach()
            t.register_hook(lambda g: terms.__setitem__(
                (kind, i), (g.detach() * w).cpu()))

    real_chunked, real_intra = S.ssd_chunked, S.ssd_intra

    def chunked(x, dt, A, B, C, *, chunk):
        hook_terms("dt", dt, -torch.expm1(-dt))  # sigmoid(softplus^-1(dt))
        return real_chunked(x, dt, A, B, C, chunk=chunk)

    def intra(x, dt, dA, B, C):
        hook_terms("dA", dA, dt)
        seg[0] = max(seg[0], dA.detach().sum(-1).abs().max().item())
        if intra_on is not None:
            outs = real_intra(*(t.to(intra_on) for t in (x, dt, dA, B, C)))
            return tuple(o.to(x.device) for o in outs)
        if intra64:
            y, s = real_intra(*(t.double() for t in (x, dt, dA, B, C)))
            return y.float(), s.float()
        return real_intra(x, dt, dA, B, C)

    def counted_loss(params, batch):
        out = loss_fn(params, batch)
        forward_calls[0] = calls[0]
        return out

    params = tree_map(lambda t: t.to(where, copy=True), init)
    batch = {k: torch.from_numpy(v).to(where) for k, v in data.items()}
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(S, "ssd_chunked", chunked))
        stack.enter_context(patched(S, "ssd_intra", intra))
        if plain:
            stack.enter_context(patched(_build, "on_cpu", lambda *t: True))
        (loss, _), grads = value_and_grad(counted_loss, params, batch)
    out = [g.to("cpu", copy=True) for g in leaves(grads)]
    del params, grads, batch
    if where.type == "cuda":
        torch.cuda.synchronize()
        smoke.free_card()
    by_kind = {k: [terms[(k, i)] for i in range(forward_calls[0])
                   if (k, i) in terms] for k in ("dt", "dA")}
    return loss.item(), out, by_kind, seg[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--archs", nargs="+", default=[a for a, _, _ in FAMILIES])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grad_floor: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.training.tree import leaves_with_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(card)
    print(f"build: {_build.build():.1f} s")
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    table = [f"{card}\nconfig\tseed\tleaf\t" + "\t".join(WAYS)]
    for arch, depth, seq in FAMILIES:
        if arch not in args.archs:
            continue
        cfg = dataclasses.replace(get_config(arch), **depth, dtype="float32")
        for seed in args.seeds:
            t0 = time.monotonic()
            init = M.init_params(
                cfg, generator=torch.Generator().manual_seed(seed),
                device=cpu)
            data = smoke.train_batch(cfg, smoke.PARITY_BATCH, seq, seed)
            paths = [p for p, _ in leaves_with_paths(init)]
            l_cpu, g_cpu, t_cpu, seg = step_grads(cfg, init, data, cpu)
            ways = {}
            l_card, ways["card"], t_card, _ = step_grads(cfg, init, data, dev)
            _, ways["card-plain"], _, _ = step_grads(cfg, init, data, dev,
                                                     plain=True)
            _, ways["cpu-intra64"], t_64, _ = step_grads(
                cfg, init, data, cpu, intra64=True)
            _, ways["cpu-intra-card"], _, _ = step_grads(
                cfg, init, data, cpu, intra_on=dev)
            _, ways["cpu-intra-card-plain"], _, _ = step_grads(
                cfg, init, data, cpu, intra_on=dev, plain=True)
            gaps = {w: [(a - b).abs().max().item() / b.abs().max().item()
                        for a, b in zip(g, g_cpu)] for w, g in ways.items()}
            for i, path in enumerate(paths):
                table.append(f"{cfg.name}\t{seed}\t{path}\t" + "\t".join(
                    f"{gaps[w][i]:.3e}" for w in ways))
            worst = max(range(len(paths)), key=lambda i: gaps["card"][i])
            print(f"grad_floor {cfg.name} seed {seed} [{card}]: loss card "
                  f"{l_card:.7f} cpu {l_cpu:.7f}; worst leaf on the card "
                  f"{paths[worst]} {gaps['card'][worst]:.3e} of its max; "
                  f"largest |cumsum dA| over a chunk {seg:.1f}; worst leaf "
                  f"of each way: " + ", ".join(
                      f"{w} {max(g):.3e}" for w, g in gaps.items())
                  + f"; {time.monotonic() - t0:.1f} s")
            taken = dict.fromkeys(SUMS.values(), 0)
            for i, path in enumerate(paths):
                name = path.rsplit("/", 1)[-1]
                if name not in SUMS:
                    continue
                # this leaf's mixers: the next (its numel / heads) in
                # forward order, which is the leaves' order (groups, tail)
                kind = SUMS[name]
                mixers = slice(taken[kind],
                               taken[kind] + g_cpu[i].numel() // cfg.ssm_nheads)
                taken[kind] = mixers.stop
                cancel, card_gap = term_sums(t_cpu[kind][mixers],
                                             t_card[kind][mixers], kind)
                _, gap_64 = term_sums(t_cpu[kind][mixers],
                                      t_64[kind][mixers], kind)
                print(f"grad_floor {cfg.name} seed {seed} {path}: gap of its "
                      f"max |.|: " + ", ".join(f"{w} {g[i]:.3e}"
                                               for w, g in gaps.items())
                      + f"; its sum over tokens ({mixers.stop - mixers.start}"
                      f" mixers) cancels {cancel:.0f}x (max sum |term| / max "
                      f"|sum|); the terms' exact sums off the CPU's, of max "
                      f"sum |term|: card {card_gap:.3e}, cpu-intra64 "
                      f"{gap_64:.3e}")
            del init, g_cpu, ways, t_cpu, t_card, t_64
    out = ROOT / "chiprun_out" / "grad_floor.txt"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(table) + "\n")
    return 0


def term_sums(cpu_terms, card_terms, kind):
    """(cancellation, card gap): the largest per-head sum of |term| over
    the largest per-head |sum| (across mixers), and the largest per-head
    gap of the card's sum against the CPU's in units of the largest sum
    of |term|.  dt terms are (B,S,H), dA terms (M,H,Q)."""
    dims = (0, 1) if kind == "dt" else (0, 2)

    def sums(ts, absolute=False):
        return torch.stack([(t.abs() if absolute else t).double().sum(dims)
                            for t in ts])

    total, mags = sums(cpu_terms), sums(cpu_terms, absolute=True)
    gap = (sums(card_terms) - total).abs().max()
    return (mags.max() / total.abs().max()).item(), (gap / mags.max()).item()


if __name__ == "__main__":
    sys.exit(main())
