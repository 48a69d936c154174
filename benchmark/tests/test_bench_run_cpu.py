"""The whole run on the CPU at a tiny size: a cell added as files only,
found and run in both modes; the check failing on broken outputs and on
the control; the import guard."""
import sys
import time
import types

import numpy as np
import pytest
import torch

from benchmark.control import control
from benchmark.drivers.align_pe import draw_sample
from benchmark.run import forbidden_modules, run_cell
from benchmark.spec import Bench


CPU = torch.device("cpu")
TINY_CELL = "tiny.tiny_pe"          # added by conftest.add_tiny_cell


def _run(root, trace=False, seed=2**31 + 7):
    bench = Bench(root)
    return run_cell(bench, bench.workload(TINY_CELL), seed, 0.5, trace,
                    CPU, time.monotonic())


def test_added_cell_runs_and_is_correct(tiny_root):
    r = _run(tiny_root)
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"reads_per_s", "setup_s"}
    assert r["metrics"]["reads_per_s"]["value"] > 0
    assert r["attempted"] > 0
    assert list(r)[-1] == "checks"
    # every sampled pair of the batches the window finished is judged
    batches = min(r["attempted"] // (2 * 128), 512 // 128)
    due = int((draw_sample(2**31 + 7, 512, 96) < batches * 128).sum())
    assert due > 0 and r["checks"]["checked_pairs"]["value"] == due


def test_added_cell_traced(tiny_root):
    r = _run(tiny_root, trace=True)
    assert r["correct"] is True
    names = set(r["metrics"])
    # host ranges read on the CPU; device metrics need a card's trace
    assert {"engine.launch_ms_per_mread", "engine.finish_ms_per_mread",
            "pe.pairing_ms_per_mread"} <= names
    assert "extend_roofline" not in names and "device.idle_share" not in names
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(r)[-1] == "checks"


def _stale(fn):
    last = {}

    def finish(self, pending):
        res = fn(self, pending)
        prev = last.get("res", res)
        last["res"] = res
        return prev
    return finish


def _half(fn):
    def finish(self, pending):
        res = fn(self, pending)
        n = len(res["proper"])
        for m in ("res1", "res2"):
            for k in ("unique", "any_hit", "is_rc"):
                res[m][k][n // 2:] = False
            res[m]["locus"][n // 2:] = -1
        res["proper"][n // 2:] = False
        return res
    return finish


def _altered(fn):
    def finish(self, pending):
        res = fn(self, pending)
        res["res1"]["locus"][::8] += 1
        return res
    return finish


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["stale_result", "half_batch", "answer_altered"])
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    from biokanga_tpu_torch.align import pe

    monkeypatch.setattr(pe.PEAligner, "finish_pairs",
                        fault(pe.PEAligner.finish_pairs))
    r = _run(tiny_root)
    assert r["correct"] is False
    assert r["checks"]["wrong_pairs"]["value"] > 0


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_is_not_correct(tiny_root, seed):
    out = control(Bench(tiny_root), TINY_CELL, seed, CPU)
    assert out["correct"] is False
    assert out["wrong_mates"] > 0 and out["wrong_pairs"] > 0


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    base = forbidden_modules()
    monkeypatch.setitem(sys.modules, "biokanga_tpu_torch_x",
                        types.ModuleType("biokanga_tpu_torch_x"))
    monkeypatch.setitem(sys.modules, "jaxtyping",
                        types.ModuleType("jaxtyping"))
    assert forbidden_modules() == base
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert "jax" in forbidden_modules()


@pytest.mark.cuda
def test_added_cell_on_the_card(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    bench = Bench(tiny_root)
    r = run_cell(bench, bench.workload(TINY_CELL), 5, 0.5, True,
                 torch.device("cuda", 0), time.monotonic())
    assert r["correct"] is True
    assert r["device"]["busy_s"] > 0
    assert "device.idle_share" in r["metrics"]
    assert np.isfinite(r["metrics"]["extend_roofline"]["value"])
