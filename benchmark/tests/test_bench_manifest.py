"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import ast
import json
import re
from pathlib import Path

import pytest

from benchmark.spec import Bench

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(SPEC["command"]) <= 32
    for word in SPEC["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51


def test_full_check_fits_with_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    limits = {"configs": 24, "workloads": 24, "end_to_end": 16,
              "per_layer": 128}
    assert 1 <= len(names) <= limits[kind]


def test_no_name_repeats_across_metrics():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    per_layer = metric in SPEC["per_layer"]
    if per_layer:
        assert {"name", "unit", "better", "source", "layer", "moves"} \
            <= set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert _line(metric["layer"])
        assert metric["moves"] in [m["name"] for m in SPEC["end_to_end"]]
        assert (REPO / "benchmark" / "metrics"
                / f"{metric['name']}.py").is_file()
    else:
        assert {"name", "unit", "better", "bound", "source"} \
            <= set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_setup_s_is_there_with_its_bound():
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and setup[0]["bound"] == 0.25


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_by_name(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert _line(config["source"]) and _line(config["why"])
    assert config["source"].startswith("https://")
    for key in config["reduced"]:
        assert NAME.match(key), key
    assert config["file"] == f"benchmark/configs/{config['name']}.json"
    data = json.loads((REPO / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert len(config["reduced"]) <= 16
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])
    files = [c["file"] for c in SPEC["configs"]]
    assert files.count(config["file"]) == 1


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    assert _line(cell["why"])
    assert NAME.match(cell["traffic"]) and NAME.match(cell["config"])
    bench = Bench(REPO)
    traffic = bench.traffic(cell["traffic"])
    assert traffic["name"] == cell["traffic"]
    assert hasattr(bench.generator(traffic["generator"]), "make_pool")
    assert callable(bench.driver(traffic["driver"]))
    bench.config(cell["config"])
    for m in bench.per_layer(cell["name"]):
        assert callable(bench.reader(m["name"]))
    names = {m["name"] for m in bench.end_to_end(cell["name"])}
    assert "setup_s" in names and len(names) >= 2
    assert bench.per_layer(cell["name"])


def test_config_and_traffic_pairs_are_unique_and_four_chips_are_rare():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_every_file_under_paths_is_named_from_name_characters():
    for p in SPEC["paths"]:
        for f in (REPO / p).rglob("*"):
            if "__pycache__" in f.parts or not f.is_file():
                continue
            assert PATH.match(str(f.relative_to(REPO))), f


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_benchmark_imports_neither_jax_nor_the_jax_package():
    for f in (REPO / "benchmark").rglob("*.py"):
        assert not _imports(f) & {"jax", "jaxlib", "flax", "biokanga_tpu"}, f


def test_reference_imports_nothing_of_the_port():
    for f in (REPO / "benchmark" / "reference").rglob("*.py"):
        assert "biokanga_tpu_torch" not in _imports(f), f
