"""What the benchmark may import, and the names it gives.

Every module under ``portbench/`` is parsed: no import's top-level name
may be ``jax``, ``jaxlib``, ``flax`` or ``repro`` (compared whole:
``repro_torch`` is the port, not the JAX package), and nothing under
``portbench/reference/`` may import the port either.  Names and units in
``BENCHMARK.json`` keep to the benchmark's character sets."""

import ast
import json
import pathlib
import re

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert "repro_torch" not in names
    assert names <= {"__future__", "contextlib", "math", "torch", "reference"}


def test_whole_name_comparison():
    assert "repro_torch" not in FORBIDDEN
    src = "import repro_torch.models\nfrom repro.models import x\n"
    p = BENCH / "out" / "_probe.py"
    p.parent.mkdir(exist_ok=True)
    p.write_text(src)
    try:
        assert top_level_imports(p) & FORBIDDEN == {"repro"}
    finally:
        p.unlink()


def _bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_names_and_units():
    b = _bench()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]] + [c["name"] for c in b["configs"]]
    names += [w["traffic"] for w in b["workloads"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
    assert len(set(m["name"] for m in b["end_to_end"] + b["per_layer"])) == \
        len(b["end_to_end"]) + len(b["per_layer"])


def test_every_name_has_its_files():
    """Cells, mixes, configurations, limits and metric readers are found by
    name, each in a file of its own."""
    b = _bench()
    for c in b["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert (BENCH / "reference" / f"{conf['reference']}.py").is_file()
        assert (BENCH / "work" / f"{conf['work']}.py").is_file()
    for w in b["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        cells = {w["name"] for w in b["workloads"]}
        assert set(m.get("workloads", cells)) <= cells
    layers = {m["moves"] for m in b["per_layer"]}
    assert layers <= {m["name"] for m in b["end_to_end"]}
