"""The port's tracing (`biokanga_tpu_torch/utils/trace.py`) on the
paired-end path, on the CPU.

Two seeded sets of 64 pairs of 2 x 100 bp: `clean` (1% substitutions)
and `divergent` (6%, with mates carrying a substitution in every seed
core, which only the orphan rescue places).  Under a CPU
`torch.profiler` the engine's four spans nest in `pe.launch` and
`pe.finish`, and each counter equals its quantity computed apart from
the counters; without a profiler nothing is counted and no range opens;
the results are the same bits either way.
"""
import inspect

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from biokanga_tpu_torch.align import pipeline
from biokanga_tpu_torch.align.params import AlignParams
from biokanga_tpu_torch.align.pe import PEAligner, PEParams, classify_pairs
from biokanga_tpu_torch.align.pipeline import AlignEngine, _to_host
from biokanga_tpu_torch.index.build import build_index
from biokanga_tpu_torch.index.device import to_device
from biokanga_tpu_torch.ops.seed_rows import seed_rows_plain
from biokanga_tpu_torch.sim.simreads import random_genome, simulate_reads
from biokanga_tpu_torch.utils import trace

torch.set_num_threads(2)

CPU = torch.device("cpu")
L = 100
N_PAIRS = 64
PE = dict(pair_min_len=100, pair_max_len=600)
COUNTERS = ("engine.rows", "engine.rerun_rows", "extend.slots",
            "extend.valid_slots", "pe.rescue_mates", "pe.rescued_mates",
            "seed.calls", "seed.slots", "seed.filled_slots")


def _kill_seeds(r):
    """One substitution in every seed core: no seed, within the budget."""
    r = r.copy()
    r[4:93:11] = (r[4:93:11] + 1) % 4
    return r


@pytest.fixture(scope="module")
def seqs():
    return random_genome([("chrA", 50_000), ("chrB", 30_000)], seed=55)


@pytest.fixture(scope="module")
def didx(seqs):
    return to_device(build_index(seqs, lut_bases=8), CPU)


@pytest.fixture(scope="module", params=["clean", "divergent"])
def pairs(request, seqs):
    divergent = request.param == "divergent"
    _, reads, _ = simulate_reads(seqs, N_PAIRS, read_len=L,
                                 sub_rate=0.06 if divergent else 0.01,
                                 seed=12, pe=True, insert_min=200,
                                 insert_max=500)
    r1, r2 = reads[0::2].copy(), reads[1::2].copy()
    if divergent:
        # 16 exact pairs, one mate of each with its seeds killed
        _, exact, _ = simulate_reads(seqs, 16, read_len=L, seed=13, pe=True,
                                     insert_min=200, insert_max=500)
        r1[:16], r2[:16] = exact[0::2], exact[1::2]
        for i in range(0, 16, 2):
            r1[i] = _kill_seeds(r1[i])
            r2[i + 1] = _kill_seeds(r2[i + 1])
    ln = np.full(N_PAIRS, L, np.int32)
    return request.param, (r1, ln, r2, ln)


def _aligner(didx):
    return PEAligner(AlignEngine(didx, AlignParams()), PEParams(**PE))


def _profiled(fn):
    trace.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _expected(didx, args, slots, seeds):
    """Each counter's quantity, computed without the counters; `slots`
    and `seeds` hold each candidate mask's and each seed row's (all,
    valid or filled) slot counts."""
    r1, l1, r2, l2 = args
    reads, lengths = np.concatenate([r1, r2]), np.concatenate([l1, l2])
    eng = AlignEngine(didx, AlignParams())
    _, _, out, dp, fp = eng.launch_primary(reads, lengths)
    res = _to_host(out, dp)
    bound = fp.resolved_bound(lengths, eng.params.min_edit_dist)
    resolved = ((res["best_mm"].astype(np.int32) + res["n_over"] <= bound)
                & ~res["cap_trunc"])
    both = eng.align_with_rescue(reads, lengths)
    n = len(r1)
    half = [{k: v[s] for k, v in both.items() if k != "derived"}
            for s in (slice(None, n), slice(n, None))]
    cls = classify_pairs(*half, l1, l2, didx.entry_starts.numpy(),
                         PEParams(**PE))
    return {"engine.rows": len(reads),
            "engine.rerun_rows": int((~resolved).sum()),
            "extend.slots": sum(s for s, _ in slots),
            "extend.valid_slots": sum(v for _, v in slots),
            "seed.calls": len(seeds),
            "seed.slots": sum(s for s, _ in seeds),
            "seed.filled_slots": sum(f for _, f in seeds),
            "pe.rescue_mates": int(cls["orphan1"].sum()
                                   + cls["orphan2"].sum())}


@pytest.fixture(scope="module")
def traced(didx, pairs):
    """One batch through launch_pairs / finish_pairs under the profiler,
    with every candidate mask of the engine, and every seed row made
    again by the plain version, recorded apart."""
    name, args = pairs
    assert didx.packed is not None
    slots, seeds = [], []
    real = pipeline._strand_candidates

    def recording(*a, **k):
        out = real(*a, **k)
        slots.append((out[1].numel(), int(out[1].sum())))
        g = inspect.signature(real).bind(*a, **k).arguments
        flat, _ = seed_rows_plain(
            g["didx"], g["reads"], g["lengths"], g["rc"],
            torch.tensor(g["dp"].offsets, dtype=torch.int32),
            g["dp"].core_len, g["H"], g.get("owned"), g.get("occ_skip", False))
        seeds.append((flat.numel(), int((flat != 2**31 - 1).sum())))
        return out

    pea = _aligner(didx)
    pipeline._strand_candidates = recording
    try:
        res, prof = _profiled(lambda: pea.finish_pairs(pea.launch_pairs(
            *args)))
    finally:
        pipeline._strand_candidates = real
    got = trace.counts()
    want = _expected(didx, args, slots, seeds)
    want["pe.rescued_mates"] = pea.rescued
    return {"name": name, "got": got, "want": want, "prof": prof,
            "res": res}


@pytest.mark.parametrize("counter", COUNTERS)
def test_counter_equals_its_quantity(traced, counter):
    got, want = traced["got"], traced["want"]
    assert got.get(counter, 0) == want[counter]
    if traced["name"] == "divergent":
        # the set drives the rerun and the rescue, and the rescue places
        assert want["engine.rerun_rows"] > 0
        assert want["pe.rescue_mates"] > 0 and want["pe.rescued_mates"] > 0
    assert want["extend.slots"] > want["extend.valid_slots"] > 0
    assert want["seed.slots"] > want["seed.filled_slots"] > 0


def _ranges(prof, name):
    return [(e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name == name]


def test_engine_spans_nest_in_the_pe_spans(traced):
    prof = traced["prof"]
    (l0, l1), = _ranges(prof, "pe.launch")
    (f0, f1), = _ranges(prof, "pe.finish")
    reruns = _ranges(prof, "engine.rerun")
    assert len(reruns) == (traced["want"]["engine.rerun_rows"] > 0)
    for name in ("engine.fetch", "engine.rerun"):
        spans = _ranges(prof, name)
        assert len(spans) == (1 if name == "engine.fetch" else len(reruns))
        assert all(f0 <= a <= b <= f1 for a, b in spans), name
    for name in ("engine.upload", "engine.enqueue"):
        # the primary pass's in pe.launch; the classic rerun's and the
        # ladder's in engine.rerun
        spans = _ranges(prof, name)
        primary = [s for s in spans if l0 <= s[0] <= s[1] <= l1]
        rerun = [(a, b) for a, b in spans
                 if any(r0 <= a <= b <= r1 for r0, r1 in reruns)]
        assert len(primary) == 1 and len(primary) + len(rerun) == len(spans)
        assert len(rerun) >= len(reruns), name


def test_nothing_counted_and_no_range_without_a_profiler(didx, pairs,
                                                         monkeypatch):
    def no_range(name):
        raise AssertionError(f"range {name} opened without a profiler")

    monkeypatch.setattr(trace, "record_function", no_range)
    trace.reset_counts()
    _aligner(didx).align_pairs(*pairs[1])
    assert trace.counts() == {}
    assert trace.span("engine.upload") is trace.span("pe.launch")


def test_results_are_bit_identical_under_a_profiler(didx, pairs):
    args = pairs[1]
    plain = _aligner(didx).align_pairs(*args)
    under, _ = _profiled(lambda: _aligner(didx).align_pairs(*args))
    assert plain.keys() == under.keys()
    for k in ("proper", "orphan1", "orphan2", "insert"):
        assert plain[k].dtype == under[k].dtype
        np.testing.assert_array_equal(plain[k], under[k], err_msg=k)
    for side in ("res1", "res2"):
        assert plain[side].keys() == under[side].keys()
        for k, v in plain[side].items():
            if k == "derived":
                assert v == under[side][k]
                continue
            assert v.dtype == under[side][k].dtype, (side, k)
            np.testing.assert_array_equal(v, under[side][k],
                                          err_msg=f"{side}.{k}")


def test_count_sums_tensors_and_spanned_opens_a_range_a_call():
    made = []

    @trace.spanned("test.call")
    def f(x):
        trace.count("test.n", 3)
        trace.count("test.mask", x > 1)
        trace.count("test.made", lambda: made.append(1) or x > 2)
        return x.sum()

    x = torch.arange(5)
    trace.reset_counts()
    assert int(f(x)) == 10 and trace.counts() == {} and not made
    _, prof = _profiled(lambda: (f(x), f(x)))
    assert trace.counts() == {"test.n": 6, "test.mask": 6, "test.made": 4}
    assert len(made) == 2
    assert len(_ranges(prof, "test.call")) == 2
    trace.reset_counts()
    assert trace.counts() == {}


def test_every_launch_counted_and_none_replayed_on_the_cpu(didx, pairs,
                                                           monkeypatch):
    calls = []
    real = pipeline.align_core

    def counting(*a, **k):
        calls.append(a[1].shape)
        return real(*a, **k)

    monkeypatch.setattr(pipeline, "align_core", counting)
    pea = _aligner(didx)
    _profiled(lambda: pea.finish_pairs(pea.launch_pairs(*pairs[1])))
    got = trace.counts()
    # the primary pass, and in the divergent set the classic rerun: one
    # align_core call a launch on the CPU
    assert len(calls) >= (2 if pairs[0] == "divergent" else 1)
    assert got["engine.launches"] == len(calls)
    assert got.get("engine.graph_launches", 0) == 0
    assert pea.engine._cores == {}
