"""Performance flags for the §Perf hillclimb.

Defaults are the NAIVE baselines the roofline table was recorded with;
named variants in launch/dryrun.py flip individual flags so each
hypothesis -> change -> re-lower -> re-analyse iteration is a one-liner.
After the hillclimb, launchers enable the winners explicitly.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, replace

_CTX = threading.local()


@dataclass(frozen=True)
class PerfFlags:
    # decode KV/latent cache update: "where" rewrites the whole cache per
    # step (baseline); "scatter" touches only the new token's row.
    cache_update: str = "where"
    # Mamba2 input projection: fused single matmul whose output width
    # (d_in + conv_dim + heads) rarely divides the TP axis -> falls back to
    # fully replicated compute (baseline).  True splits z/xBC/dt into three
    # cleanly-shardable projections.
    split_ssm_proj: bool = False
    # SSD intra-chunk length Q: the L matrix is O(B*S*Q*H) bytes — linear
    # in Q.
    ssd_chunk: int = 256
    # MoE decode: "replicated" psum-combine with FSDP weight gathers
    # (baseline); "tp_data" shards expert FFN width over the data axis and
    # gathers TOKENS instead of weights (requires rules.expert_ff_fsdp so
    # the storage sharding matches).
    moe_decode: str = "replicated"
    # decode: 2D tensor parallelism — weights stay (data x model)-sharded,
    # activations replicate over the batch axes (psum), the cache sequence
    # shards over both axes.  Kills the per-layer FSDP weight all-gathers.
    serve_2d: bool = False
    # train: sequence parallelism — residual-stream activations sharded over
    # the model axis on the sequence dim (Megatron-SP), so norms/residual
    # ops touch S/TP tokens and the TP all-reduces become RS+AG pairs.
    shard_seq: bool = False


def current() -> PerfFlags:
    return getattr(_CTX, "flags", None) or PerfFlags()


def set_flags(flags: PerfFlags | None) -> None:
    _CTX.flags = flags


class use_flags:
    def __init__(self, flags: PerfFlags | None):
        self.flags = flags

    def __enter__(self):
        self.prev = getattr(_CTX, "flags", None)
        set_flags(self.flags)
        return self.flags

    def __exit__(self, *exc):
        set_flags(self.prev)


VARIANTS: dict[str, PerfFlags] = {
    "baseline": PerfFlags(),
    "opt_cache": PerfFlags(cache_update="scatter"),
    "opt_moe": PerfFlags(moe_decode="tp_data"),
    "opt_ssm": PerfFlags(split_ssm_proj=True),
    "opt_ssm_q128": PerfFlags(split_ssm_proj=True, ssd_chunk=128),
    "opt_ssm_q64": PerfFlags(split_ssm_proj=True, ssd_chunk=64),
    "opt_serve2d": PerfFlags(serve_2d=True),
    "opt_serve2d_moe": PerfFlags(serve_2d=True, moe_decode="tp_data"),
    "opt_sp": PerfFlags(shard_seq=True),
    "opt_ssm_sp": PerfFlags(split_ssm_proj=True, ssd_chunk=128, shard_seq=True),
    "opt_all": PerfFlags(split_ssm_proj=True, ssd_chunk=128,
                         moe_decode="tp_data", serve_2d=True, shard_seq=True),
}
