"""How ``correct`` is decided for a served model.

Once the window has closed and the program's state is freed, a sample of
the jobs that finished in the window is drawn from the seed, with the
job of the longest sequence in it.  The plain reference (fp32, a layer at
a time, from the same bf16 weights) runs once over each prompt with its
served tokens, teacher-forced, and each served token is read against the
reference's best logit at its position: ``max_gap`` is the widest gap by
which a served token's logit lies below the reference's best,
``mean_gap`` the mean gap over every served token read.  The limits file
of a cell names the numbers it compares.  The served
tokens are greedy, so a sound program's gap is rounding alone.

The control is the reference in the precision below the configuration's
bf16 -- every weight rounded to fp8 e4m3 with a per-tensor scale -- read
the same way: at each position, the gap in the fp32 reference of the
token the fp8 copy puts first.
"""

from __future__ import annotations

import torch

from harness import spec as S
from harness import traffic as T


def sample(jobs, seed: int, count: int) -> list:
    """``count`` finished jobs drawn from the seed, the longest among
    them."""
    done = [j for j in jobs if j.ok]
    if not done:
        return []
    longest = max(done, key=lambda j: (j.prompt_len + j.out_len, j.stream))
    rest = [j for j in done if j is not longest]
    rng = T.rng_for(seed, 5)
    pick = rng.choice(len(rest), size=min(count - 1, len(rest)),
                      replace=False) if rest else []
    return [longest, *(rest[i] for i in sorted(pick))]


def sequences(jobs, seed: int, vocab: int, device):
    """Each job's prompt and its served tokens but the last (the inputs
    that produced them), and the position of its first served token."""
    seqs, starts, targets = [], [], []
    for j in jobs:
        prompt = T.prompt_tokens(seed, j.stream, j.index, j.prompt_len, vocab)
        toks = torch.as_tensor(j.tokens, dtype=torch.long, device=device)
        seqs.append(torch.cat([torch.as_tensor(prompt[0], dtype=torch.long,
                                               device=device), toks[:-1]]))
        starts.append(j.prompt_len - 1)
        targets.append(toks)
    return seqs, starts, targets


def gaps(ref_logits, chosen) -> torch.Tensor:
    """Per position: the reference's best logit minus its logit of the
    chosen token."""
    return torch.cat([lg.max(-1).values - lg.gather(-1, c[:, None])[:, 0]
                      for lg, c in zip(ref_logits, chosen)])


def fp8_cast(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to fp8 e4m3 with a per-tensor absmax scale."""
    amax = t.abs().max().clamp(min=1e-12)
    s = 448.0 / amax
    return (t * s).to(torch.float8_e4m3fn).float() / s


def readings(ref_logits, chosen) -> dict:
    """The compared numbers of tokens ``chosen`` against reference logits:
    ``max_gap``, ``mean_gap`` over every token read, and ``mismatch_pct``,
    the share of tokens that are not the reference's first."""
    g = gaps(ref_logits, chosen)
    return {"max_gap": float(g.max()), "mean_gap": float(g.mean()),
            "mismatch_pct": 100.0 * float((g > 0).float().mean()),
            "tokens": int(g.numel())}


def reference_gaps(conf: dict, params, jobs, seed: int, device,
                   control: bool = False) -> dict:
    """The readings of the served tokens of ``jobs`` against the plain
    reference; with ``control``, also the fp8 control's, prefixed
    ``control_``."""
    ref = S.load_module("reference", conf["reference"])
    seqs, starts, targets = sequences(jobs, seed, conf["vocab_size"], device)
    full = ref.logits(conf, params, seqs, starts)
    out = readings(full, targets)
    if control:
        low = ref.logits(conf, params, seqs, starts, cast=fp8_cast)
        picks = [lg.argmax(-1) for lg in low]
        out.update({f"control_{k}": v for k, v in
                    readings(full, picks).items() if k != "tokens"})
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when each is within
    it."""
    checks = {k: {"value": values.get(k), "limit": lim}
              for k, lim in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
