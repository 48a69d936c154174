"""The resident chunked path's per-chunk select and exact merge on the
results' device (ops/chunk_merge.py, csrc/chunk_merge.cu) against the
host path they replace: each chunk's fast and classic results fetched,
selected and laddered on the host (`host_path` below) and merged by
`merge_chunk_results`, field for field and dtype for dtype.

CPU: the select on seeded passes (resolved and unresolved rows, cap
truncation, skipped cores, no fast pass); the merge of seeded staging
sets (ties across chunks on (mm, strand) broken by locus, equal keys
where the first chunk wins, rows with no valid candidate in any chunk,
unions of two or more best instances, equal multi-hit keys across
chunks, loci past 2^31, one chunk, a zero mismatch budget); the resident
aligner on a repeat genome of three chunks with the fast pass on and
off, two blocks in flight, and a candidate cap so low that rows take
the rescue ladder's fallback.  CUDA (marked): both kernels against their
plain versions at GRCh38's shapes (13 chunks of 131,072 rows), and the
resident aligner on the card against the CPU.  Imports no jax, so it
runs on the card as it is:

    python -m pytest tests/test_torch_chunk_merge.py --noconftest -q
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from biokanga_tpu_torch.align.params import AlignParams
from biokanga_tpu_torch.align.pipeline import (_LADDER_KEYS, RESULT_KEYS,
                                               inexact_rows, pad_rows)
from biokanga_tpu_torch.index.chunked import build_chunked_index
from biokanga_tpu_torch.ops import chunk_merge as cm
from biokanga_tpu_torch.parallel import chunked as tpar
from biokanga_tpu_torch.sim.simreads import random_genome, simulate_reads
from biokanga_tpu_torch.utils import trace
from chunk_merge_cases import (CHUNK_LEN, GRCH38_B, grch38_passes,
                               partials, pass_result, stage_of, tensors)

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_fields_are_the_engine_result_keys():
    assert cm.FIELDS == RESULT_KEYS + _LADDER_KEYS


def _host_select(fast, classic, lengths, fp, dp, med):
    """A chunk's part of the host path before its ladder: the classic
    pass's fields, the fast pass's RESULT_KEYS and zero ladder keys on its
    resolved rows; and its rows for the ladder and its unresolved rows."""
    sub = {k: np.array(classic[k]) for k in cm.FIELDS}
    if fp is None:
        rows = np.arange(len(lengths))
    else:
        bound = fp.resolved_bound(lengths, med)
        resolved = ((fast["best_mm"].astype(np.int32) + fast["n_over"]
                     <= bound) & ~fast["cap_trunc"])
        rows = np.nonzero(~resolved)[0]
        kept = np.ones(len(lengths), bool)
        kept[rows] = False
        for k in _LADDER_KEYS:
            sub[k][kept] = 0
        for k in RESULT_KEYS:
            sub[k][kept] = fast[k][kept]
    sub["derived"] = dp
    return sub, int(inexact_rows(sub, lengths, med).sum()), len(rows)


def _assert_fields(got, want, where, keys=cm.FIELDS):
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, (where, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {k}")


def _params_100bp():
    params = AlignParams()
    return (params, params.derive_fast(100, CHUNK_LEN, 13),
            params.derive(100, CHUNK_LEN))


@pytest.mark.parametrize("med", [1, 2])
@pytest.mark.parametrize("fast_pass", [True, False])
def test_select_matches_host_select(fast_pass, med):
    rng = np.random.default_rng(31 + med)
    K, B = 3, 700
    _, fp, dp = _params_100bp()
    fp = fp if fast_pass else None
    lengths = rng.integers(0, 101, B).astype(np.int32)
    lengths[:8] = 0                                   # pad rows
    stage = cm.staging(K, B, 5, CPU)
    for k in range(K):
        fast, classic = pass_result(rng, B), pass_result(rng, B)
        if fp is None:
            fast = classic
        want, flagged, unresolved = _host_select(fast, classic, lengths,
                                                 fp, dp, med)
        cm.select_chunk(stage, k, torch.from_numpy(lengths),
                        tensors(classic), dp, med,
                        None if fp is None else tensors(fast), fp)
        _assert_fields({f: stage[f][k] for f in cm.FIELDS}, want, k)
        assert int(stage["counts"][0, k]) == flagged > 0
        assert int(stage["counts"][1, k]) == (0 if fp is None
                                              else unresolved)
        if fp is not None:
            assert 0 < unresolved < B
    assert int(stage["counts"][2, 0]) == 0


@pytest.mark.parametrize("subs", [5, 0])
@pytest.mark.parametrize("where", ["overlap", "past_2_31"])
@pytest.mark.parametrize("K,med", [(1, 1), (3, 1), (13, 2)])
def test_merge_matches_host_merge(K, med, where, subs):
    rng = np.random.default_rng(K * 7 + med)
    B = 600
    parts, bases = partials(rng, K, B, where)
    lengths = rng.integers(40, 151, B).astype(np.int32)
    params = AlignParams(min_edit_dist=med, max_subs_per100=subs)
    want = tpar.merge_chunk_results(parts, bases, lengths, params)
    got = cm.merge_chunks(stage_of(parts), torch.from_numpy(bases),
                          torch.from_numpy(lengths), subs, med)
    _assert_fields({k: v.numpy() for k, v in got.items()}, want, K)
    if K > 1:
        best = np.stack([p["best_mm"] for p in parts])
        assert (want["inst"][20:40] >= 2).all() and (best[:, :20] == 255
                                                     ).all()
        if where == "past_2_31":
            assert want["locus"].max() > 2**31
            assert want["ml_loci"].max() > 2**31
        else:
            # equal keys: the first chunk wins, at global 3,000
            assert (want["locus"][40:60] == 3_000).all()


def test_merge_raises_on_loci_past_2_42():
    rng = np.random.default_rng(3)
    parts, _ = partials(rng, 2, 64, "overlap")
    bases = np.array([0, (1 << 42) - 10], np.int64)
    with pytest.raises(ValueError, match="2\\^42"):
        cm.merge_chunks(stage_of(parts), torch.from_numpy(bases),
                        torch.full((64,), 100, dtype=torch.int32), 5, 1)


@pytest.fixture(scope="module")
def genome():
    """Two entries in three chunks: a 400 bp block in copies across the
    chunks, a 120 bp block in 40 copies (within the classic pass's 48
    positions a core, past a cap of 8), an N run."""
    seqs = random_genome([("chrA", 60_000), ("chrB", 30_000)], seed=5)
    g = seqs[0][1]
    block = g[1_000:1_400].copy()
    for dst in (31_000, 52_000):
        g[dst:dst + 400] = block
    seqs[1][1][25_000:25_400] = block
    rep = g[10_000:10_120].copy()
    for c in range(40):
        g[12_000 + c * 130:12_000 + c * 130 + 120] = rep
    seqs[1][1][5_000:5_060] = 4
    return seqs, build_chunked_index(seqs, num_chunks=3, overlap=1_024,
                                     lut_bases=8)


def _reads(seqs, seed, n=300, hard=True):
    """Simulated reads, padded to a power of two with empty rows; `hard`:
    3% substitutions, reads of the repeats, all-N and ragged reads, which
    take the rescue ladder in some chunk; else 1% substitutions and no
    read from the tandem copies, whose candidates pass the cap."""
    names, reads, _ = simulate_reads(seqs, 2 * n, read_len=100,
                                     sub_rate=0.03 if hard else 0.01,
                                     seed=seed)
    if not hard:
        fields = [nm.split("|") for nm in names]
        clear = [i for i, f in enumerate(fields)
                 if f[3] != "chrA" or not 11_800 <= int(f[4]) < 17_400]
        reads = reads[clear]
    reads = reads[:n]
    lengths = np.full(n, 100, np.int32)
    if hard:
        g = seqs[0][1]
        reads[:12] = [g[1_000 + 20 * i:1_100 + 20 * i] for i in range(12)]
        reads[12:24] = [g[10_000 + i:10_100 + i] for i in range(12)]
        reads[24:28] = 4
        lengths[28:40] = 60 + np.arange(12)
        for i in range(28, 40):
            reads[i, lengths[i]:] = 4
    return pad_rows(reads, lengths)


def host_path(ca, reads, lengths):
    """The resident aligner's result as it was made on the host: each
    chunk's fast and classic results fetched, the fast pass's resolved
    rows kept, the rescue ladder on the rest, and `merge_chunk_results`."""
    partials = []
    for e in ca.engines:
        fast = e.launch_fast(reads, lengths)
        res = e.finish_fast(fast)
        if fast[2] is None:
            e.rescue_pass(reads, lengths, res)
        else:
            classic = e.finish_fast(e.launch(reads, lengths) + (None,))
            sub, _, _ = _host_select(res, classic, lengths, fast[2],
                                     classic["derived"],
                                     ca.params.min_edit_dist)
            e.rescue_pass(reads, lengths, sub)
            sub["derived"] = res["derived"]
            res = sub
        partials.append(res)
    out = tpar.merge_chunk_results(partials, ca.bases, lengths, ca.params,
                                   ca.device)
    out["derived"] = partials[0]["derived"]
    return out


def _counted(fn):
    """fn's result, the counters, and the `chunked.merge` spans opened:
    one a block, with a ladder fallback too (chunked.index_gib counts
    blocks by them)."""
    trace.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    got = trace.counts()
    trace.reset_counts()
    return out, got, sum(e.name == "chunked.merge" for e in prof.events())


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("fast_pass", [True, False])
def test_resident_block_equals_host_path(genome, fast_pass, hard):
    """Clean reads: the merge on the device stands.  Hard reads: some
    chunk's rows take the ladder, and the block is merged again."""
    seqs, ci = genome
    ca = tpar.ChunkedAligner(ci, AlignParams(fast_pass=fast_pass), "cpu")
    assert ca.resident is not None
    reads, lengths = _reads(seqs, 41, hard=hard)
    got, counted, merges = _counted(lambda: ca.align(reads, lengths))
    want = host_path(ca, reads, lengths)
    _assert_fields(got, want, "resident")
    assert got["derived"] == want["derived"]
    assert counted["chunked.merges"] == merges == 1
    assert counted["chunked.device_merges"] == int(not hard)
    assert len(np.unique(tpar.chunk_of(ca.bases, got["locus"]))) == 3
    if hard:
        # best instances in several chunks, rows with no valid candidate
        assert (got["inst"][:12] >= 3).all()
        assert (got["best_mm"][24:28] == 255).all()


def test_ladder_fallback_with_blocks_in_flight(genome):
    """A candidate cap of 8 truncates the repeats' classic candidates:
    those chunks' slots take the ladder on the host and the block is
    merged again, while the next block is in flight."""
    seqs, ci = genome
    ca = tpar.ChunkedAligner(ci, AlignParams(max_cand_per_strand=8), "cpu")
    blocks = [_reads(seqs, s) for s in (43, 47)]
    blocks[1][0][:12] = blocks[0][0][12:24]

    def run():
        first = ca.launch_primary(*blocks[0])
        second = ca.launch_primary(*blocks[1])
        return ca.finish_primary(first), ca.finish_primary(second)

    got, counted, merges = _counted(run)
    for b, (reads, lengths) in enumerate(blocks):
        want = host_path(ca, reads, lengths)
        _assert_fields(got[b], want, f"block {b}")
    assert counted["chunked.merges"] == merges == 2
    assert counted["chunked.device_merges"] < counted["chunked.merges"]
    # both staging sets are free again, and serve the next blocks
    assert len(ca._free) == 2
    again = ca.align(*blocks[1])
    _assert_fields(again, got[1], "reused staging")
    assert len(ca._free) == 2


# ---- on the card ----

@pytest.mark.cuda
@pytest.mark.parametrize("fast_pass", [True, False])
def test_select_chunk_kernel_matches_plain(cuda_device, fast_pass):
    rng = np.random.default_rng(5)
    _, fp, dp = _params_100bp()
    lengths = rng.integers(0, 101, GRCH38_B).astype(np.int32)
    ln = torch.from_numpy(lengths)
    stages = [cm.staging(13, GRCH38_B, 5, d) for d in (cuda_device, CPU)]
    for k, (fast, classic) in enumerate(grch38_passes(rng, cuda_device)):
        for stage in stages:
            dev = stage["counts"].device
            to = (lambda p: {f: v.to(dev) for f, v in p.items()})
            cm.select_chunk(stage, k, ln.to(dev), to(classic), dp, 1,
                            to(fast) if fast_pass else None,
                            fp if fast_pass else None)
    torch.cuda.synchronize()
    for f in cm.FIELDS + ("counts",):
        np.testing.assert_array_equal(stages[0][f].cpu().numpy(),
                                      stages[1][f].numpy(), err_msg=f)
    assert int(stages[1]["counts"][0].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 13])
def test_merge_chunks_kernel_matches_plain(cuda_device, K):
    rng = np.random.default_rng(K)
    for where in ("overlap", "past_2_31"):
        parts, bases = partials(rng, K, GRCH38_B, where)
        lengths = torch.from_numpy(
            rng.integers(40, 151, GRCH38_B).astype(np.int32))
        base = torch.from_numpy(bases)
        for subs, med in ((5, 1), (0, 2)):
            want = cm.merge_chunks(stage_of(parts), base, lengths, subs,
                                   med)
            stage = stage_of(parts, cuda_device)
            got = cm.merge_chunks(stage, base.to(cuda_device),
                                  lengths.to(cuda_device), subs, med)
            _assert_fields({k: v.cpu() for k, v in got.items()},
                           {k: v for k, v in want.items()}, (K, where))
            assert int(stage["counts"][2, 0]) == 0
    # a locus past 2^42 sets the flag where the plain version raises
    if K > 1:
        stage = stage_of(parts, cuda_device)
        far = torch.tensor([0] + [(1 << 42) - 10] * (K - 1),
                           dtype=torch.int64, device=cuda_device)
        cm.merge_chunks(stage, far, lengths.to(cuda_device), 5, 1)
        assert int(stage["counts"][2, 0]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [192, 8])
def test_resident_aligner_on_card_equals_cpu(cuda_device, genome, cap):
    """Blocks through the card's resident path, one in flight, until the
    graphs replay (the first launch of a key runs eagerly, the second
    captures), against the CPU's."""
    seqs, ci = genome
    params = AlignParams(max_cand_per_strand=cap)
    cpu = tpar.ChunkedAligner(ci, params, "cpu")
    card = tpar.ChunkedAligner(ci, params, cuda_device)
    assert card.resident is not None
    blocks = [_reads(seqs, s) for s in (51, 53, 57, 59)]
    got, pending = [], None
    for reads, lengths in blocks:
        state = card.launch_primary(reads, lengths)
        if pending is not None:
            got.append(card.finish_primary(pending))
        pending = state
    got.append(card.finish_primary(pending))
    for b, (reads, lengths) in enumerate(blocks):
        _assert_fields(got[b], cpu.align(reads, lengths), f"block {b}")
    card.close()
