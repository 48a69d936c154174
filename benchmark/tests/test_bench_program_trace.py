"""The readers of the program's spans and counters, on the CPU: a tiny
traced run of a divergent cell (8% substitutions, added as files and
entries) reports each of them; each gives nothing where its span, its
denominator or the program's counter module is absent."""
import json
import shutil
import sys
import time

import pytest
import torch

from benchmark.run import run_cell
from benchmark.spec import Bench
from benchmark.trace import TraceSummary

CPU = torch.device("cpu")
DIV_CELL = "tiny.tiny_div"
SPANS = {"engine.upload_ms_per_mread": "engine.upload",
         "engine.enqueue_ms_per_mread": "engine.enqueue",
         "engine.fetch_ms_per_mread": "engine.fetch",
         "engine.rerun_ms_per_mread": "engine.rerun"}
COUNTERS = {"engine.rerun_row_share": ("engine.rerun_rows", "engine.rows"),
            "extend.valid_slot_share": ("extend.valid_slots",
                                        "extend.slots"),
            "pe.rescue_yield": ("pe.rescued_mates", "pe.rescue_mates")}
NEW = {**SPANS, **COUNTERS}


@pytest.fixture(scope="module")
def div_root(tiny_root, tmp_path_factory):
    """The tiny root with a second cell on `pe100_divergent`'s substitution
    rate, listed by every new metric."""
    root = tmp_path_factory.mktemp("div_root")
    shutil.copy(tiny_root / "BENCHMARK.json", root)
    shutil.copytree(tiny_root / "benchmark", root / "benchmark")
    bench = root / "benchmark"
    tr = json.loads((bench / "traffic" / "tiny_pe.json").read_text())
    div = json.loads((bench / "traffic" / "pe100_divergent.json")
                     .read_text())
    tr.update(name="tiny_div", sub_rate=div["sub_rate"])
    (bench / "traffic" / "tiny_div.json").write_text(json.dumps(tr))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": DIV_CELL, "config": "tiny",
                              "traffic": "tiny_div", "chips": 1,
                              "why": "CPU dry run"})
    for m in spec["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append(DIV_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_metrics_listed_as_the_cells_need(div_root):
    spec = json.loads((div_root / "BENCHMARK.json").read_text())
    cells = {m["name"]: m["workloads"] for m in spec["per_layer"]}
    assert set(NEW) <= set(cells)
    rerun = {"athaliana_tair10.pe150", "ecoli_k12.pe100_divergent"}
    assert set(cells["engine.rerun_ms_per_mread"]) >= rerun
    assert "ecoli_k12.pe100" not in cells["engine.rerun_row_share"]
    assert "ecoli_k12.pe100_divergent" in cells["pe.rescue_yield"]


def test_divergent_cell_traced_reports_every_new_metric(div_root):
    from biokanga_tpu_torch.utils import trace

    trace.reset_counts()
    bench = Bench(div_root)
    r = run_cell(bench, bench.workload(DIV_CELL), 2**31 + 11, 0.5, True,
                 CPU, time.monotonic())
    assert r["correct"] is True
    got = r["metrics"]
    for name in NEW:
        assert name in got, name
        assert got[name]["value"] >= 0, name
    assert 0 < got["engine.rerun_row_share"]["value"] < 100
    assert 0 < got["extend.valid_slot_share"]["value"] < 100
    assert got["pe.rescue_yield"]["value"] <= 100
    c = trace.counts()
    # the traced batches alone: the warm-up and the replay count nothing
    batches = bench.traffic("tiny_div")
    assert c["engine.rows"] == (2 * batches["batch_pairs"]
                                * batches["trace_batches"])


def _ctx(host_s=None):
    return {"trace": TraceSummary(window_s=1.0, busy_s=0.0,
                                  host_s=host_s or {}),
            "mates": 2_000_000, "counts": {}, "peak_bytes": 0}


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_reader(metric):
    read = Bench().reader(metric)
    assert read(_ctx()) is None
    assert read(_ctx({SPANS[metric]: 0.5})) == pytest.approx(250.0)


@pytest.mark.parametrize("metric", sorted(COUNTERS))
def test_counter_reader(metric, monkeypatch):
    from biokanga_tpu_torch.utils import trace

    read = Bench().reader(metric)
    num, den = COUNTERS[metric]
    monkeypatch.setattr(trace, "_counts", {})
    assert read(_ctx()) is None
    trace._counts.update({num: 3})
    assert read(_ctx()) is None                 # no denominator
    trace._counts.update({den: 0})
    assert read(_ctx()) is None                 # nothing counted under it
    trace._counts.update({den: torch.tensor(12)})
    assert read(_ctx()) == pytest.approx(25.0)
    # a program without the counter module (an older tree) gives nothing
    monkeypatch.setitem(sys.modules, "biokanga_tpu_torch.utils.trace", None)
    assert read(_ctx()) is None
