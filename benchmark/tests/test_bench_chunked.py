"""The chunked cell's pieces on the CPU: the blocked reference against
aligner.find_hits, hit for hit, and the chunked driver end to end on a
small multi-chunk configuration, added as files and entries only."""
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import blocked
from benchmark.reference.aligner import build_seed_index, find_hits, rc_codes
from benchmark.reference.guarantee import guarantee
from benchmark.run import run_cell
from benchmark.spec import Bench

REPO = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
CELL = "tiny_chunked.tiny_pe_chunked"


def _plant(g, locus, L, subs, rc, rng):
    r = g[locus:locus + L].copy()
    pos = rng.choice(L, size=subs, replace=False)
    r[pos] = (r[pos] + rng.integers(1, 4, size=subs)) % 4
    return rc_codes(torch.from_numpy(r[None]))[0].numpy() if rc else r


def test_lemma_parts():
    assert blocked.parts(100, 10) == (6, 16)
    assert blocked.parts(150, 15) == (8, 18)
    assert blocked.parts(100, 0) == (1, 27)


@pytest.mark.parametrize("L,M", [(100, 10), (60, 4), (150, 15)])
def test_blocked_reference_equals_find_hits(L, M):
    """Reads at exactly M mismatches and fewer, on both strands, across
    block cuts, across an entry boundary (no placement there), in a
    repeat, with Ns in the genome and in reads, and random reads."""
    rng = np.random.default_rng(L + M)
    n = 60_000
    g = rng.integers(0, 4, n).astype(np.int8)
    g[41_000:41_300] = g[7_000:7_300]                 # a two-copy repeat
    g[rng.choice(n, 30, replace=False)] = 4           # genome Ns
    starts = np.array([0, 20_000, 37_500, n], np.int64)
    block = 9_000
    plan = []
    for cut in range(block, n, block):
        for back in (1, L // 2, L - 1):
            plan.append((cut - back, M, bool(back % 2)))
    plan += [(20_000 - L // 2, 1, False), (37_500 - 3, 0, True),
             (7_050, M, False), (41_100, M - 1, True), (100, M, True),
             (59_000, M // 2, False), (30_000, M + 1, False)]
    reads = [_plant(g, l, L, s, rc, rng) for l, s, rc in plan]
    reads.append(rng.integers(0, 4, L).astype(np.int8))
    withn = _plant(g, 12_345, L, M - 1, False, rng)
    withn[L // 3] = 4
    reads.append(withn)
    reads = torch.from_numpy(np.stack(reads))
    gt = torch.from_numpy(g)
    want = find_hits(gt, starts, reads, M,
                     build_seed_index(gt, L // (M + 1)))
    got = blocked.find_hits(gt, starts, reads, M, block_len=block)
    for f in ("read", "mm", "is_rc", "locus"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    # each planted read is placed where it lies inside an entry within M
    # mismatches (a genome N counts as one)
    placed = set(zip(want.read.tolist(), want.locus.tolist()))
    for i, (locus, _, rc) in enumerate(plan):
        fwd = reads[i].numpy()
        fwd = rc_codes(torch.from_numpy(fwd[None]))[0].numpy() if rc else fwd
        win = g[locus:locus + L]
        mm = int(((win != fwd) | (win >= 4) | (fwd >= 4)).sum())
        inside = (np.searchsorted(starts, locus, "right")
                  == np.searchsorted(starts, locus + L - 1, "right"))
        assert ((i, locus) in placed) == (inside and mm <= M), i
    assert (want.mm == M).any() and want.is_rc.any() and (~want.is_rc).any()
    assert len(placed) > len(plan) // 2


def _add_chunked_cell(root: Path) -> None:
    """A 90 kb genome in three entries cut into three chunks of 30 kb, and
    a pool of 512 pairs of 2 x 100 bp, as a configuration file, a traffic
    file and BENCHMARK.json entries only."""
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "grch38.json").read_text())
    cfg.update(name="tiny_chunked", lut_bases=8, max_chunk=30_000,
               overlap=1024,
               entries=[["a", 40_000], ["b", 30_000], ["c", 20_000]])
    (bench / "configs" / "tiny_chunked.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "pe100_chunked.json").read_text())
    tr.update(name="tiny_pe_chunked", pool_pairs=512, batch_pairs=128,
              sample_pairs=96, trace_batches=2)
    (bench / "traffic" / "tiny_pe_chunked.json").write_text(json.dumps(tr))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_chunked", "source": "a test",
                            "file": "benchmark/configs/tiny_chunked.json",
                            "reduced": [], "why": "CPU dry run"})
    spec["workloads"].append({"name": CELL, "config": "tiny_chunked",
                              "traffic": "tiny_pe_chunked", "chips": 1,
                              "why": "CPU dry run"})
    for m in spec["per_layer"]:
        if (m["name"].startswith("chunked.")
                or m["name"] == "pe.pairing_ms_per_mread"):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture(scope="module")
def chunked_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("bench_chunked_root")
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    _add_chunked_cell(root)
    return root


def _run(root, trace, seed=2**31 + 11):
    bench = Bench(root)
    return run_cell(bench, bench.workload(CELL), seed, 1.0, trace, CPU,
                    time.monotonic())


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_chunked_cell_runs_and_is_correct(chunked_root, trace):
    r = _run(chunked_root, trace)
    c = r["checks"]
    assert r["failed"] == 0 and r["correct"] is True
    assert c["wrong_mates"]["value"] == 0 and c["wrong_pairs"]["value"] == 0
    assert c["checked_pairs"]["value"] > 0
    assert r["timing"]["chunks"] == 3
    # a 90 kb genome: no mate lies past 2^31
    assert r["timing"]["sample_mates_past_2_31"] == 0
    assert 0 <= r["timing"]["sample_orphan_mates_placed"] <= r["timing"][
        "sample_orphan_pairs"]
    if trace:
        names = set(r["metrics"])
        assert {"chunked.sweep_ms_per_mread", "chunked.merge_ms_per_mread",
                "chunked.rescue_ms_per_mread", "chunked.index_gib",
                "pe.pairing_ms_per_mread"} <= names
        gib = r["metrics"]["chunked.index_gib"]["value"]
        assert 0 < gib < 0.1
    else:
        assert set(r["metrics"]) == {"reads_per_s", "setup_s"}


def test_guarantee_of_the_grch38_configuration():
    g = guarantee(100, 3_088_269_832, 13, 10, 1, "default")
    assert (g.max_mm, g.best_mm, g.multi_mm) == (10, 6, 5)


@pytest.mark.parametrize("seed", [21, 22])
def test_chunked_control_is_not_correct(chunked_root, seed):
    from benchmark.control_chunked import control

    out = control(Bench(chunked_root), CELL, seed, CPU)
    assert out["correct"] is False
    assert out["wrong_mates"] > 0 and out["wrong_pairs"] > 0
