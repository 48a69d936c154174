"""BENCHMARK.json and the files it names, found by name.

- a configuration: benchmark/configs/<config>.json
- a traffic mix: benchmark/traffic/<traffic>.json, which names its
  generator (benchmark/gen/<generator>.py, `make_pool`) and its driver
  (benchmark/drivers/<driver>.py, which names its class in `DRIVER`)
- a per-layer metric: benchmark/metrics/<metric>.py, `read(ctx)`

A later cell, mix or metric is added as files and entries; nothing here
changes.  Modules are loaded from their files under the root, so a root
that holds added files finds them.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, package: str):
    """The module in `path`, loaded as a member of benchmark.<package> so
    that its relative imports of the harness resolve."""
    tag = hashlib.sha1(str(path.resolve()).encode()).hexdigest()[:10]
    full = f"benchmark.{package}._{path.stem.replace('.', '_')}_{tag}"
    if full in sys.modules:
        return sys.modules[full]
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod


class Bench:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")
        self.dir = self.root / "benchmark"

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return load_json(self.dir / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.dir / "traffic" / f"{name}.json")

    def generator(self, name: str):
        return load_module(self.dir / "gen" / f"{name}.py", "gen")

    def driver(self, name: str):
        mod = load_module(self.dir / "drivers" / f"{name}.py", "drivers")
        return getattr(mod, mod.DRIVER)

    def reader(self, metric: str):
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           "metrics").read

    def _applies(self, m: dict, cell: str, reported=()) -> bool:
        if "workloads" in m:
            return cell in m["workloads"]
        return not reported or m.get("moves") in reported

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.spec["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> list[dict]:
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if self._applies(m, cell, reported)]
