"""Every file the benchmark names loads by its name, every name keeps
to the characters the benchmark's format allows, and nothing under
``lookup_bench/`` loads JAX or the JAX package."""
import ast
import json
import re
from pathlib import Path

import pytest

from lookup_bench import harness, keys, traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: what the harness may not read: the JAX package's benchmark folder and
#: the port's smoke script
UNREAD = ("benchmarks" + "/", "chip" + "_smoke")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["lookup_bench"]
    assert BENCH["command"][1].startswith("lookup_bench/")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units_use_allowed_characters():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.fullmatch(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.fullmatch(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
    for cell in BENCH["workloads"]:
        assert NAME.fullmatch(cell["config"])
        assert NAME.fullmatch(cell["traffic"])
        assert cell["chips"] in (1, 4)
        assert 1 <= len(cell["why"]) <= 200
    for group in ("configs", "workloads"):
        seen = [e["name"] for e in BENCH[group]]
        assert len(seen) == len(set(seen))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_bounds_and_setup_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_config_loads_and_names_its_generator():
    for entry in BENCH["configs"]:
        assert entry["file"] == f"lookup_bench/configs/{entry['name']}.json"
        config = harness.load_config(entry["name"])
        assert config["name"] == entry["name"]
        assert config["source"] == entry["source"]
        assert callable(keys.load(config["dataset"]).generate)
        assert entry["reduced"] == []


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_config_and_traffic(cell):
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    assert entry["config"] in {c["name"] for c in BENCH["configs"]}
    mix = traffic.load(entry["traffic"])
    assert mix["in_flight"] >= 1 and mix["batch"] >= 1


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader_that_agrees(name):
    entry = {m["name"]: m for m in BENCH["per_layer"]}[name]
    reader = harness.load_metric(name)
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES,
            reader.BETTER) == (entry["layer"], entry["unit"],
                               entry["source"], entry["moves"],
                               entry["better"])
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert reader.read({"kind": "cpu", "trace": {}}) is None


def imported_top_levels(path: Path) -> set:
    """Top-level names of every module a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_import_check_compares_whole_top_level_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.core\nfrom repro.core import x\n"
                   "import jaxtyping\n")
    assert imported_top_levels(src) & FORBIDDEN == {"repro"}


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(HERE)) for p in HERE.rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    source = HERE / path
    assert not imported_top_levels(source) & FORBIDDEN
    text = source.read_text()
    assert not [u for u in UNREAD if u in text]
