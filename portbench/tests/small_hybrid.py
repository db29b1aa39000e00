"""A small cut of the granite-4.0-h-small configuration for the CPU
tests, beside ``small.py`` (the accepted cells' cuts): one period with
both kinds (mamba, mamba, attention, mamba), 8 experts top 3, a shared
width of its own and the published multipliers; the published keys and
the port's fields cut alike."""

from __future__ import annotations

import copy
import dataclasses

import small

CELL = "granite-h-sat-decode"
SMALL = {"hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 2, "num_hidden_layers": 4,
         "layer_types": ["mamba", "mamba", "attention", "mamba"],
         "vocab_size": 128, "mamba_n_heads": 8, "mamba_d_head": 16,
         "mamba_d_state": 16, "num_local_experts": 8,
         "num_experts_per_tok": 3, "intermediate_size": 32,
         "shared_intermediate_size": 48}


def small_conf(conf: dict) -> dict:
    """``conf`` cut to a CPU size, as the reference reads it."""
    out = copy.deepcopy(conf)
    out.update(copy.deepcopy(SMALL))
    return out


def port_cfg(conf: dict, dtype: str = "float32"):
    """The port's config for a cut ``conf``: the base that
    ``driver.port_config`` starts from, with the cut fields."""
    from harness import driver as D

    c = conf
    d, n = c["hidden_size"], c["num_attention_heads"]
    f = dict(num_layers=c["num_hidden_layers"],
             layer_types=tuple(c["layer_types"]), d_model=d, num_heads=n,
             num_kv_heads=c["num_key_value_heads"], head_dim=d // n,
             d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
             num_experts=c["num_local_experts"],
             num_experts_per_tok=c["num_experts_per_tok"],
             moe_d_ff=c["intermediate_size"],
             shared_d_ff=c["shared_intermediate_size"],
             ssm_state_dim=c["mamba_d_state"], ssm_head_dim=c["mamba_d_head"],
             ssm_expand=c["mamba_n_heads"] * c["mamba_d_head"] // d,
             ssm_ngroups=c["mamba_n_groups"], conv_width=c["mamba_d_conv"],
             embedding_multiplier=float(c["embedding_multiplier"]),
             residual_multiplier=float(c["residual_multiplier"]),
             logits_scaling=float(c["logits_scaling"]),
             attention_multiplier=float(c["attention_multiplier"]),
             rope_theta=0.0, norm_eps=c["rms_norm_eps"],
             tie_embeddings=c["tie_word_embeddings"], dtype=dtype)
    return dataclasses.replace(D.port_base(conf["port"]), **f)


def small_cell(name: str = CELL):
    """The cell ``name`` of BENCHMARK.json at a CPU size, and its port
    config."""
    from harness import spec as S

    cell = S.load_cell(name)
    cell.config = small_conf(cell.config)
    cell.traffic = small.small_traffic(cell.traffic)
    return cell, port_cfg(cell.config)
