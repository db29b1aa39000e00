"""Boundaries of the port (src/repro_torch and chip_smoke.py):

* it imports neither jax nor anything of the reference package ``repro``;
* each host-side module it keeps a copy of equals its source after the
  one substitution ``repro.`` -> ``repro_torch.``;
* every module imports on a machine without CUDA, triton or nvcc, and the
  entry points refuse to run on the CPU unless asked to.
"""

import ast
import importlib
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

# host-side modules the port keeps as rename-only copies
COPIES = (
    [f"configs/{p.name}" for p in sorted((SRC / "repro" / "configs").glob("*.py"))]
    + [f"core/{m}.py" for m in ("task_model", "faults", "migration",
                                "server_analysis", "allocation", "taskset_gen",
                                "admission", "server_runtime")]
    + [f"core/dispatch/{m}.py" for m in ("__init__", "policy", "batching",
                                         "pool")]
    + ["runtime/straggler.py", "runtime/faultinject.py", "serving/kvcache.py",
       "analysis/cost_model.py", "analysis/roofline.py",
       "analysis/hlo_cost.py", "core/mpcp_analysis.py",
       "core/fmlp_analysis.py", "core/simulator.py"]
    + [f"scenarios/{m}.py" for m in ("registry", "arrivals", "etm",
                                     "overheads", "schedulers", "protocols",
                                     "lp_alloc", "scenario", "matrix",
                                     "__init__")])

# data files the port keeps byte for byte
DATA_COPIES = [f"scenarios/traces/{name}" for name in
               ("README.md", "bursty_pool.jsonl", "diurnal_ramp.jsonl")]

# classes and functions the port copies word for word out of a module it
# does not copy whole: (module, names)
CLASS_COPIES = [("runtime/fault_tolerance.py", ("WorkerState",
                                                "HeartbeatMonitor")),
                ("runtime/elastic.py", ("plan_after_failure",
                                        "degraded_throughput_fraction",
                                        "LoadTrajectory",
                                        "ElasticPoolController"))]


def _imported_modules(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], (ast.Constant, ast.JoinedStr))):
            arg = node.args[0]
            head = arg if isinstance(arg, ast.Constant) else arg.values[0]
            names.add(str(getattr(head, "value", "")))
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    for name in _imported_modules(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro", "triton"), (
            f"{path.relative_to(ROOT)} imports {name}")


@pytest.mark.parametrize("rel", COPIES)
def test_copies_differ_only_by_package_name(rel):
    source = (SRC / "repro" / rel).read_text()
    assert (PORT / rel).read_text() == source.replace("repro.", "repro_torch.")


@pytest.mark.parametrize("rel", DATA_COPIES)
def test_data_files_are_byte_copies(rel):
    assert (PORT / rel).read_bytes() == (SRC / "repro" / rel).read_bytes()


def _class_text(path: pathlib.Path, name: str) -> str:
    """The source lines of class or function ``name``, its decorators
    included."""
    text = path.read_text()
    node = next(n for n in ast.parse(text).body
                if isinstance(n, (ast.ClassDef, ast.FunctionDef))
                and n.name == name)
    first = min([node.lineno] + [d.lineno for d in node.decorator_list])
    return "\n".join(text.splitlines()[first - 1:node.end_lineno])


@pytest.mark.parametrize("rel,names", CLASS_COPIES)
def test_copied_classes_equal_their_source(rel, names):
    for name in names:
        assert (_class_text(PORT / rel, name)
                == _class_text(SRC / "repro" / rel, name))


def test_every_module_imports_without_cuda():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        importlib.import_module(".".join(parts))


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.params import params_from_numpy
    from repro_torch.serving.engine import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("internlm2_1_8b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({})
    eng = ServeEngine(cfg, {}, device="cpu")
    assert eng.device == torch.device("cpu")
    eng.close()
