"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with one
tiny cell added as files and entries, as a later change would add one."""
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY_CELL = "tiny.tiny_pe"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped without one")


def add_tiny_cell(root: Path) -> None:
    """A 50 kb genome in two entries and a pool of 512 pairs of 2 x 100 bp,
    added as a configuration file, a traffic file and BENCHMARK.json
    entries only."""
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "ecoli_k12.json").read_text())
    cfg.update(name="tiny", entries=[["a", 30000], ["b", 20000]],
               lut_bases=8)
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "pe100.json").read_text())
    tr.update(name="tiny_pe", pool_pairs=512, batch_pairs=128,
              sample_pairs=96, trace_batches=4)
    (bench / "traffic" / "tiny_pe.json").write_text(json.dumps(tr))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "a test genome",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "CPU dry run"})
    spec["workloads"].append({"name": TINY_CELL, "config": "tiny",
                              "traffic": "tiny_pe", "chips": 1,
                              "why": "CPU dry run"})
    for m in spec["per_layer"]:
        m.setdefault("workloads", []).append(TINY_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("bench_root")
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny_cell(root)
    return root
