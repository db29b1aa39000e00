"""Small versions of the benchmark's cells for the CPU tests: the same
configuration files and traffic mixes with every width and count cut to a
size a test run holds, the published keys and the port's fields cut
alike."""

from __future__ import annotations

import copy
import dataclasses
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

SMALL_GQA = {"hidden_size": 64, "num_attention_heads": 4,
             "num_key_value_heads": 2, "intermediate_size": 128,
             "num_hidden_layers": 2, "vocab_size": 128}
SMALL_MLA = {"hidden_size": 64, "num_attention_heads": 4,
             "num_key_value_heads": 4, "intermediate_size": 128,
             "num_hidden_layers": 3, "vocab_size": 128, "kv_lora_rank": 32,
             "qk_rope_head_dim": 8, "qk_nope_head_dim": 16, "v_head_dim": 16,
             "n_routed_experts": 8, "num_experts_per_tok": 2,
             "n_shared_experts": 1, "moe_intermediate_size": 32}


def small_conf(conf: dict) -> dict:
    """``conf`` cut to a CPU size, as the reference reads it."""
    out = copy.deepcopy(conf)
    out.update(SMALL_MLA if conf["reference"] == "mla_moe" else SMALL_GQA)
    return out


def port_cfg(conf: dict, dtype: str = "float32"):
    """The port's config for a cut ``conf``: the base that
    ``driver.port_config`` starts from, with the cut fields."""
    from harness import driver as D

    c = conf
    f = dict(num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
             num_heads=c["num_attention_heads"],
             num_kv_heads=c["num_key_value_heads"],
             d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
             rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
             dtype=dtype)
    if c["reference"] == "mla_moe":
        f.update(kv_lora_rank=c["kv_lora_rank"],
                 qk_rope_head_dim=c["qk_rope_head_dim"],
                 qk_nope_head_dim=c["qk_nope_head_dim"],
                 v_head_dim=c["v_head_dim"],
                 head_dim=c["qk_rope_head_dim"] + c["qk_nope_head_dim"],
                 num_experts=c["n_routed_experts"],
                 num_experts_per_tok=c["num_experts_per_tok"],
                 num_shared_experts=c["n_shared_experts"],
                 moe_d_ff=c["moe_intermediate_size"],
                 first_dense_layers=c["first_k_dense_replace"])
    else:
        f["head_dim"] = c["hidden_size"] // c["num_attention_heads"]
    return dataclasses.replace(D.port_base(conf["port"]), **f)


def small_traffic(traffic: dict) -> dict:
    out = copy.deepcopy(traffic)
    out.update(streams=8, max_batch=4, max_seq=64, warm_s=1.0,
               drain_cap_s=60, sample_jobs=4,
               prompt_len={"dist": "lognormal", "median": 12, "sigma": 0.5,
                           "min": 4, "max": 32},
               output_len={"dist": "lognormal", "median": 6, "sigma": 0.3,
                           "min": 3, "max": 12},
               declared={"prefill_ms": 1.0, "decode_ms": 0.1,
                         "decode_steps": 8, "cpu_ms": 0.1})
    if out["loop"] == "open":
        out["period_ms"] = 400.0
    return out


def small_cell(name: str):
    """The cell ``name`` of BENCHMARK.json at a CPU size, and its port
    config."""
    from harness import spec as S

    cell = S.load_cell(name)
    cell.config = small_conf(cell.config)
    cell.traffic = small_traffic(cell.traffic)
    return cell, port_cfg(cell.config)
