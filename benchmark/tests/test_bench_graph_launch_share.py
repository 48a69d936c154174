"""The reader of `engine.graph_launch_share`: the engine's launches that
replay captured CUDA graphs over all its launches, from the program's
counters; nothing where they are absent or nothing was launched."""
import sys

import pytest
import torch

from benchmark.spec import Bench
from benchmark.trace import TraceSummary

METRIC = "engine.graph_launch_share"


def _ctx():
    return {"trace": TraceSummary(window_s=1.0, busy_s=0.0, host_s={}),
            "mates": 2_000_000, "counts": {}, "peak_bytes": 0}


@pytest.fixture
def counters(monkeypatch):
    from biokanga_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "_counts", {})
    return trace._counts


def test_counters_present(counters):
    read = Bench().reader(METRIC)
    counters.update({"engine.launches": 40, "engine.graph_launches": 38})
    assert read(_ctx()) == pytest.approx(95.0)
    # the counters as the program keeps them under a profiler: host ints
    # and tensors alike
    counters["engine.graph_launches"] = torch.tensor(40)
    assert read(_ctx()) == pytest.approx(100.0)


def test_counters_absent(counters, monkeypatch):
    read = Bench().reader(METRIC)
    assert read(_ctx()) is None
    counters["engine.launches"] = 12         # an engine that never replays
    assert read(_ctx()) is None
    # a program without the counter module (an older tree) gives nothing
    monkeypatch.setitem(sys.modules, "biokanga_tpu_torch.utils.trace", None)
    assert read(_ctx()) is None


def test_zero_denominator(counters):
    read = Bench().reader(METRIC)
    counters.update({"engine.launches": 0, "engine.graph_launches": 0})
    assert read(_ctx()) is None
