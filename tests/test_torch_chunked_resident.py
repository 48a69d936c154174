"""The resident chunked path, on the CPU: every chunk held at once, one
AlignEngine a chunk sharing one set of graphs, against the cycling path
and the JAX package's chunked PE path, tolerance 0.

Three chunks of a 90 kb genome with a three-copy repeat; pairs whose
rescue windows cross each chunk cut, their second mates seed-dead so that
only the orphan rescue places them, and clean pairs.  The resident set is
made both ways: a host ChunkedIndex uploaded once, and every chunk built
on the device (`build_resident_chunks`).  Under a CPU profiler the
`chunked.*` and `pe.*` spans open and their counters equal their
quantities.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from biokanga_tpu.align.pe import PEParams as JaxPEParams
from biokanga_tpu.index import chunked as jax_chunked
from biokanga_tpu.parallel import chunked as jax_par
from biokanga_tpu.sim.simreads import random_genome, simulate_reads
from biokanga_tpu_torch.align.pe import PEAligner, PEParams, classify_pairs
from biokanga_tpu_torch.align.pipeline import pad_rows
from biokanga_tpu_torch.index import chunked as tch
from biokanga_tpu_torch.index.device import index_nbytes
from biokanga_tpu_torch.index.device_build import build_resident_chunks
from biokanga_tpu_torch.parallel import chunked as tpar
from biokanga_tpu_torch.utils import trace
from torch_align_data import KEYS

torch.set_num_threads(2)

PE = dict(pair_min_len=100, pair_max_len=600)
PAIR_KEYS = ("proper", "orphan1", "orphan2", "insert")


def _kill_seeds(r):
    """A substitution in every seed core: no seed hit, within the budget."""
    r = r.copy()
    r[4:93:11] = (r[4:93:11] + 1) % 4
    return r


@pytest.fixture(scope="module")
def case():
    seqs = random_genome([("chrA", 50_000), ("chrB", 40_000)], seed=56)
    g = seqs[0][1]
    g[25_000:25_300] = g[5_000:5_300]
    seqs[1][1][12_000:12_300] = g[5_000:5_300]
    cat = np.concatenate([s for _, s in seqs])
    _, reads, _ = simulate_reads(seqs, 160, read_len=100, sub_rate=0.01,
                                 seed=14, pe=True, insert_min=200,
                                 insert_max=500)
    r1, r2 = reads[0::2].copy(), reads[1::2].copy()
    rc = lambda x: np.where(x >= 4, x, 3 - x)[::-1]
    ci = tch.build_chunked_index(seqs, num_chunks=3, overlap=1024,
                                 lut_bases=8)
    for i, cut in enumerate(ci.bases[1:]):
        for j, back in enumerate((150, 300, 420)):
            s, ins = int(cut) - back, 440
            a, b = cat[s:s + 100], rc(cat[s + ins - 100:s + ins])
            r1[6 * i + 2 * j], r2[6 * i + 2 * j] = a, _kill_seeds(b)
            r1[6 * i + 2 * j + 1] = _kill_seeds(b)
            r2[6 * i + 2 * j + 1] = a
    ln = np.full(len(r1), 100, np.int32)
    r1, l1 = pad_rows(r1, ln)
    r2, l2 = pad_rows(r2, ln)
    ci_j = jax_chunked.build_chunked_index(seqs, num_chunks=3, overlap=1024,
                                           lut_bases=8)
    built = build_resident_chunks(cat, ci.entry_starts,
                                  [n for n, _ in seqs], lut_bases=8,
                                  max_chunk=-(-len(cat) // 3), overlap=1024,
                                  device="cpu")
    return ci, ci_j, built, (r1, l1, r2, l2)


def _pe(index):
    return tpar.ChunkedPEAligner(tpar.ChunkedAligner(index, device="cpu"),
                                 PEParams(**PE))


def _cycling(ci, monkeypatch):
    monkeypatch.setattr(tpar, "fits_on_device", lambda *a: False)
    ca = tpar.ChunkedAligner(ci, device="cpu")
    monkeypatch.undo()
    assert ca.resident is None and ca.engines is None
    return tpar.ChunkedPEAligner(ca, PEParams(**PE))


def _assert_same(got, want, where):
    for side in ("res1", "res2"):
        for k in KEYS:
            g, w = np.asarray(got[side][k]), np.asarray(want[side][k])
            assert g.dtype == w.dtype, (where, side, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {side}.{k}")
    for k in PAIR_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{where} {k}")


def test_host_index_is_held_resident_when_it_fits(case):
    ci, _, _, _ = case
    ca = tpar.ChunkedAligner(ci, device="cpu")
    assert ca.resident is not None and len(ca.engines) == 3
    assert [e.didx for e in ca.engines] == ca.resident.chunks
    assert ca.engine_for(2) is ca.engines[2]
    # one graph set for the three engines
    assert len({id(e._cores) for e in ca.engines}) == 1
    assert ca.resident.nbytes() == tch.padded_nbytes(ci) == sum(
        index_nbytes(d) for d in ca.resident.chunks)
    ca.close()
    assert ca.engines is None and ca.resident is None


@pytest.mark.parametrize("source", ["uploaded", "device_built"])
def test_resident_pe_equals_cycling_and_jax(case, source, monkeypatch):
    ci, ci_j, built, args = case
    want = jax_par.ChunkedPEAligner(jax_par.ChunkedAligner(ci_j),
                                    JaxPEParams(**PE)).align_pairs(*args)
    cycling = _cycling(ci, monkeypatch).align_pairs(*args)
    pe = _pe(ci if source == "uploaded" else built)
    assert pe.ca.resident is not None
    got = pe.align_pairs(*args)
    _assert_same(cycling, want, "cycling vs jax")
    _assert_same(got, want, f"{source} vs jax")
    # every window across a cut pairs, the seed-dead mates by the rescue
    assert got["proper"][:12].all()
    assert not got["orphan1"][:12].any() and not got["orphan2"][:12].any()
    assert got["proper"][:80].mean() > 0.9           # 80 pairs, then pad
    # mates whose loci lie in every chunk, past the first cut
    assert len(np.unique(tpar.chunk_of(pe.ca.bases,
                                       got["res1"]["locus"]))) == 3


def _ranges(prof, name):
    return [(e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name == name]


def _profiled(fn):
    trace.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof, trace.counts()


@pytest.mark.parametrize("resident", [True, False])
def test_chunked_spans_and_counters(case, resident, monkeypatch):
    ci, _, _, args = case
    pe = _pe(ci) if resident else _cycling(ci, monkeypatch)
    plain = pe.align_pairs(*args)
    engines = []
    real = PEAligner.rescue

    def spy(self, engine, *a, **k):
        engines.append(engine)
        return real(self, engine, *a, **k)

    monkeypatch.setattr(PEAligner, "rescue", spy)
    out, prof, got = _profiled(lambda: pe.align_pairs(*args))
    _assert_same(out, plain, "under the profiler")
    sweeps = sorted(_ranges(prof, "chunked.sweep"))
    (m0, m1), = _ranges(prof, "chunked.merge")
    if resident:
        # one sweep, the launch's: every chunk's passes and its select
        # (`engine.rerun`); behind it the merge's enqueue, then the one
        # fetch of the merged result
        (l0, l1), = sweeps
        (f0, f1), = _ranges(prof, "engine.fetch")
        assert l1 <= m0 <= m1 <= f0 <= f1
        nested = {"engine.upload": (l0, l1), "engine.enqueue": (l0, l1),
                  "engine.rerun": (l0, l1)}
        done = f1
    else:
        # the launch's and the finish's sweep ranges, then the merge; the
        # engines' spans all in the finish's
        (l0, l1), (f0, f1) = sweeps
        assert l1 <= f0 <= f1 <= m0
        nested = {"engine.upload": (f0, f1), "engine.enqueue": (f0, f1),
                  "engine.fetch": (f0, f1)}
        done = m1
    for name, (a, b) in nested.items():
        spans = _ranges(prof, name)
        inside = [s for s in spans if a <= s[0] <= s[1] <= b]
        assert len(inside) >= 3 and len(inside) == len(spans), name
    # after the merged result, the pairing, one orphan rescue range a
    # block, and the pairing again
    (r0, r1_), = _ranges(prof, "pe.rescue")
    (c0, c1), (c2, _) = sorted(_ranges(prof, "pe.classify"))
    assert done <= c0 <= c1 <= r0 <= r1_ <= c2
    # one block merged; resident, on the device with no ladder fallback
    assert got["chunked.merges"] == 1
    if resident:
        assert got["chunked.device_merges"] == 1
    else:
        assert "chunked.device_merges" not in got
    # one PEAligner.rescue call a mate side and anchor chunk holding
    # orphans, each on that chunk's engine
    r1, l1, r2, l2 = args
    both = pe.engine.align(np.concatenate([r1, r2]), np.concatenate([l1, l2]))
    n = len(r1)
    m1_, m2_ = ({k: v[s] for k, v in both.items() if k != "derived"}
                for s in (slice(None, n), slice(n, None)))
    cls = classify_pairs(m1_, m2_, l1, l2, pe.engine.entry_starts, pe.pe)
    groups = sum(len(np.unique(tpar.chunk_of(
        pe.engine.bases, m["locus"][cls[f"orphan{w}"]])))
        for w, m in ((1, m1_), (2, m2_)))
    assert len(engines) == groups >= 3
    assert got["pe.rescue_mates"] == cls["orphan1"].sum() + cls[
        "orphan2"].sum()
    assert got["pe.rescued_mates"] == (
        out["res2"]["unique"][cls["orphan1"]].sum()
        + out["res1"]["unique"][cls["orphan2"]].sum()) > 0
    if resident:
        assert all(any(e is r for r in pe.engine.engines) for e in engines)
        assert "chunked.uploads" not in got
        assert got["chunked.index_bytes"] == pe.engine.resident.nbytes()
    else:
        assert got["chunked.uploads"] == 3 + groups
        # the one chunk on the device as the sweep ends
        assert 3 * got["chunked.index_bytes"] == tch.padded_nbytes(ci)
    trace.reset_counts()
    pe.align_pairs(*args)
    assert trace.counts() == {}
    if resident:
        # the unresolved rows, counted on the device, as the cycling
        # engines count them
        _, _, cyc = _profiled(
            lambda: _cycling(ci, monkeypatch).align_pairs(*args))
        assert got["engine.rerun_rows"] == cyc["engine.rerun_rows"] > 0
