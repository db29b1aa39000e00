"""How a configuration file names the port's config, and how the weights
are drawn: ``port.arch`` names the module ``repro_torch.configs.<arch>``,
whose ``CONFIG`` is the base (it may be an instance of a port-only
subclass of ``ModelConfig``); the accepted cells' draws unchanged to the
bit; Mamba-2's own leaves drawn as ``mamba_ssm`` initialises them, so that
the state carries from one 256-token chunk of the SSD scan into the
next."""

import dataclasses
import hashlib
import importlib
import sys
import types

import pytest
import torch

import small
from harness import driver as D
from harness import spec as S
from harness import weights as W
from repro_torch.configs.registry import ARCH_IDS

CONFIGS = ("internlm2-1.8b", "deepseek-v2-lite-16b")
MAMBA2 = ("A_log", "dt_bias", "ssm_D", "gate_norm")

# sha256 over every leaf's path and bytes of the small trees (small.py's
# cuts), recorded from the weights module before Mamba-2's leaves had a
# rule of their own: the accepted cells' draws must not move by a bit.
DIGESTS = {
    ("internlm2-1.8b", "float32", 0):
        "01398025fce44ea2146f2926ea82c896195616034ae427b0fbd25b3229f37624",
    ("internlm2-1.8b", "float32", 2**31 + 7):
        "7d32f4b7927c02d9c1c38dc168be4d2efd5b22f6af76e621198a3d4379c63d5c",
    ("internlm2-1.8b", "bfloat16", 0):
        "a6f770fb7f0a725d5a9ee4598086f8e5b39e5537ab95f0f1f4d9c00e35062725",
    ("internlm2-1.8b", "bfloat16", 2**31 + 7):
        "a2d38879c106c3d9518a98fe49671a58a509cc0a55bd3e161d994bfdb16784c8",
    ("deepseek-v2-lite-16b", "float32", 0):
        "ec57cea088e8277d80603872d1aa30fdbc8c3351943438b8c5113121897f4710",
    ("deepseek-v2-lite-16b", "float32", 2**31 + 7):
        "179aa13e0a3f3f69091c5c6e25e05fc7f28f27d803d0c8af558b54b6ded807df",
    ("deepseek-v2-lite-16b", "bfloat16", 0):
        "f010c2e36466078b6f39acdb7aac27c809f2f1b5d34f1a948c104f15507df7dc",
    ("deepseek-v2-lite-16b", "bfloat16", 2**31 + 7):
        "97df466ef04c4a72a88d0b2b35d5136354e5d4f0dd4ea6b5ac8d62d9d74d218c",
}


def _conf(name):
    return S.read_json(S.BENCH / "configs" / f"{name}.json")


def _digest(params) -> str:
    h = hashlib.sha256()
    for path, t in W._leaves(params):
        h.update(repr(path).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.fixture
def config_module(monkeypatch):
    """Registers a module ``repro_torch.configs.<arch>`` holding
    ``CONFIG``, and gives its ``arch``."""
    import repro_torch.configs  # noqa: F401

    def register(arch, config):
        name = f"repro_torch.configs.{arch}"
        mod = types.ModuleType(name)
        mod.CONFIG = config
        monkeypatch.setitem(sys.modules, name, mod)
        return arch
    return register


@pytest.mark.parametrize("name", CONFIGS)
def test_accepted_files_build_the_registry_config(name):
    from repro_torch.configs.registry import get_config

    port = _conf(name)["port"]
    want = dataclasses.replace(get_config(port["arch"]), **port["fields"])
    assert D.port_config(_conf(name)) == want


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_arch_reads_the_module_config(arch):
    """The registry's own archs build what ``get_config`` gives, with or
    without their fields, and ``-`` reads as ``_``."""
    from repro_torch.configs.registry import get_config

    assert D.port_base({"arch": arch}) is get_config(arch)
    assert D.port_config({"port": {"arch": arch.replace("_", "-")}}) \
        == get_config(arch)


def test_arch_may_name_a_port_only_subclass(config_module):
    """A config the port defines itself, with a key the registry's configs
    lack, is built and cut like any other: by the file's fields and by the
    CPU tests' cut."""
    from repro_torch.configs.registry import ModelConfig, get_config

    @dataclasses.dataclass(frozen=True)
    class Hybrid(ModelConfig):
        layer_types: tuple = ()

    ref = get_config("internlm2_1_8b")
    base = Hybrid(**{f.name: getattr(ref, f.name)
                     for f in dataclasses.fields(ModelConfig)},
                  layer_types=("mamba", "attention"))
    arch = config_module("probe_hybrid", base)
    cfg = D.port_config({"port": {"arch": arch, "fields": {
        "num_layers": 2, "layer_types": ("attention", "mamba")}}})
    assert type(cfg) is Hybrid
    assert cfg.layer_types == ("attention", "mamba") and cfg.num_layers == 2
    assert cfg.d_model == base.d_model
    conf = small.small_conf(_conf("internlm2-1.8b"))
    cut = small.port_cfg(dict(conf, port={"arch": arch}))
    assert type(cut) is Hybrid and cut.layer_types == ("mamba", "attention")
    plain = small.port_cfg(conf)
    assert all(getattr(cut, f.name) == getattr(plain, f.name)
               for f in dataclasses.fields(ModelConfig))


@pytest.mark.parametrize("port", [
    {"fields": {"num_layers": 2}},
    {"arch": 7},
    {"arch": "internlm2_1_8b.CONFIG"},
    {"arch": "../internlm2_1_8b"},
    {"arch": "internlm2 1 8b"},
], ids=["no-arch", "not-a-string", "dotted", "a-path", "not-a-name"])
def test_arch_that_is_no_name_is_refused_before_import(port, monkeypatch):
    imported = []

    def record(name, *a, **k):
        imported.append(name)
        raise AssertionError(f"imported {name}")
    monkeypatch.setattr(importlib, "import_module", record)
    with pytest.raises(ValueError) as e:
        D.port_config({"port": port})
    assert repr(port) in str(e.value)
    assert imported == []


@pytest.mark.parametrize("port", [
    {"arch": "no_such_arch"},
    {"arch": "registry"},
], ids=["unknown", "no-CONFIG"])
def test_arch_without_a_config_is_refused(port):
    with pytest.raises(ValueError) as e:
        D.port_config({"port": port})
    assert repr(port) in str(e.value)


def test_config_that_is_no_model_config_is_refused(config_module):
    port = {"arch": config_module("probe_dict", {"num_layers": 2})}
    with pytest.raises(ValueError, match="no CONFIG") as e:
        D.port_config({"port": port})
    assert repr(port) in str(e.value)


@pytest.mark.parametrize("name", CONFIGS)
def test_small_cut_goes_through_the_shared_lookup(name, monkeypatch):
    conf = small.small_conf(_conf(name))
    seen = []
    base = D.port_base
    monkeypatch.setattr(D, "port_base", lambda port: seen.append(port)
                        or base(port))
    small.port_cfg(conf)
    assert seen == [conf["port"]]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_accepted_draws_are_unchanged(name, dtype, seed):
    cfg = small.port_cfg(small.small_conf(_conf(name)), dtype)
    params = W.make(cfg, seed, torch.device("cpu"))
    assert _digest(params) == DIGESTS[(name, dtype, seed)]


@pytest.mark.parametrize("name", CONFIGS)
def test_accepted_layouts_hold_no_mamba2_leaf(name):
    tree = W.layout(D.port_config(_conf(name)))
    assert not {p[-1] for p, _ in W._leaves(tree)} & set(MAMBA2)


def _mamba2(seed):
    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config("mamba2_780m").reduced(),
                              dtype="float32")
    return cfg, W.make(cfg, seed, torch.device("cpu"))


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_mamba2_leaves_follow_the_published_init(seed):
    cfg, params = _mamba2(seed)
    m = params["layers"]["mamba"]
    assert m["A_log"].min() >= 0.0
    assert m["A_log"].max() <= torch.log(torch.tensor(16.0))
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert dt.min() >= 1e-4 and dt.max() <= 0.1
    # both spread over their ranges: A on each side of 8.5, dt of 0.01
    assert m["A_log"].min() < torch.log(torch.tensor(8.5)) < m["A_log"].max()
    assert dt.min() < 0.01 < dt.max()
    assert torch.equal(m["ssm_D"], torch.ones_like(m["ssm_D"]))
    assert torch.equal(m["gate_norm"], torch.ones_like(m["gate_norm"]))


def _moved(cfg, params):
    """How far changing the first 8 of 768 tokens (three 256-token chunks
    of the SSD scan) moves the logits at positions 300 and 767, as a
    share of their largest magnitude."""
    from repro_torch.models import model as M

    gen = torch.Generator().manual_seed(3)
    a = torch.randint(0, cfg.vocab_size, (1, 768), generator=gen)
    b = a.clone()
    b[0, :8] = (a[0, :8] + 1) % cfg.vocab_size
    with torch.no_grad():
        la, _, _ = M.apply(cfg, params, {"tokens": a}, mode="train")
        lb, _, _ = M.apply(cfg, params, {"tokens": b}, mode="train")
    return [((la[0, i] - lb[0, i]).abs().max()
             / la[0, i].abs().max()).item() for i in (300, 767)]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_mamba2_state_carries_across_chunks(seed, monkeypatch):
    """Mamba-2's rule reads 1.6e-4 to 1.7e-3 at position 300 on seeds 0-11
    and 1.6e-5 on 2**31 + 11, where even the slowest of the reduced
    model's 16 heads keeps only about e^-3 of its state over 300 tokens;
    the general rule reads about 4e-7 on each."""
    cfg, params = _mamba2(seed)
    at_300, at_767 = _moved(cfg, params)
    assert at_300 > 1e-5 and at_767 > 0.0
    # the general rule alone on those leaves erases the state: the probe
    # sees it
    monkeypatch.setattr(W, "UNIFORM", {})
    monkeypatch.setattr(W, "ONES", ("scale",))
    W.fill(params, seed)
    at_300, at_767 = _moved(cfg, params)
    assert at_300 < 1e-6 and at_767 == 0.0
