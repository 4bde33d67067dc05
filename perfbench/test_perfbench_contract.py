"""The benchmark's own rules, checked on the CPU: no module of the
harness imports JAX or the JAX package, the reference and the generators
import nothing of the program, and ``BENCHMARK.json`` keeps the form that
the harness reads and its contract states (every cell's files present,
names, units, bounds and lengths within their limits)."""
import ast
import json
import re
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# modules that must stay independent of the program under test
PLAIN = ("reference.py", "corpus.py", "traffic.py", "counts.py")


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES_PY = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES_PY, ids=lambda p: p.name)
def test_no_jax_or_jax_package(path):
    top = _imports(path)
    assert not top & {"jax", "jaxlib", "flax", "repro"}, (path, top)


@pytest.mark.parametrize("name", PLAIN)
def test_reference_and_generators_import_nothing_of_the_program(name):
    assert "repro_torch" not in _imports(HERE / name)


def test_import_rule_compares_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom repro_torch import x\n"
                 "import jaxtyping\n")
    top = _imports(f)
    assert top == {"repro_torch", "jaxtyping"}
    assert not top & {"jax", "jaxlib", "flax", "repro"}
    f.write_text("from repro.core import a\nimport jax.numpy as jnp\n")
    assert _imports(f) == {"repro", "jax"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(1 <= len(w) <= 200 for w in cmd)
    assert all(not w.startswith("/") and ".." not in w for w in cmd)
    assert (ROOT / cmd[1]).is_file() and cmd[1].startswith("perfbench/")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_fits_with_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_configs():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank")), key


def test_workloads_name_their_files():
    seen = set()
    cfgs = {c["name"] for c in BENCH["configs"]}
    assert 1 <= len(BENCH["workloads"]) <= 24
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "limits" / f"{w['name']}.json").is_file()
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    names = list(e2e) + [m["name"] for m in BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            moved = e2e[m["moves"]]
            assert c in moved.get("workloads", cells), (m["name"], c)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        own = HERE / "metrics" / f"{m['name']}.py"
        base = HERE / "metrics" / f"{m['name'].rsplit('.', 1)[0]}.py"
        assert own.is_file() or base.is_file(), m["name"]
    for c in cells:
        e = [m for m in BENCH["end_to_end"] if c in m.get("workloads", cells)]
        p = [m for m in BENCH["per_layer"] if c in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in e] and len(e) >= 2 and p


def test_file_is_small():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
