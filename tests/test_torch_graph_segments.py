"""The align engine's CUDA-graph path, on the CPU: its segments and the
kernels' `out=`.

`_CoreGraphs` calls `align_core`'s hand-written kernels into static
buffers and captures the op chains after them as segments.  Here each
segment's capture is emulated (the capture runs the segment once; a
replay runs it again, if the engine still holds it, and copies its
outputs into the tensors the capture returned, as a CUDA graph writes
into the same memory), so the cut, the static buffers and the kernels'
`out=` wiring are checked without a card: a run equals `align_core`
field for field, batch after batch, and calls each kernel as often.  The keyword `out=` of `seed_rows`, `sort_rows`,
`dedup_pack`, `sort2_rows` and `hamming_extend_packed` gives what the
call without it gives, and the positional signatures that the benchmark
unpacks are unchanged.
"""
import inspect
import weakref

import numpy as np
import pytest
import torch

from biokanga_tpu_torch.align import pipeline
from biokanga_tpu_torch.align.params import AlignParams
from biokanga_tpu_torch.index.build import build_index
from biokanga_tpu_torch.index.device import to_device
from biokanga_tpu_torch.ops import extend_packed as ep
from biokanga_tpu_torch.ops import seed_rows, sort
from biokanga_tpu_torch.sim.simreads import random_genome, simulate_reads

torch.set_num_threads(2)

CPU = torch.device("cpu")
KERNELS = ("seed_rows", "sort_rows", "dedup_pack", "sort2_rows",
           "hamming_extend_packed")


def _emulated_capture(fn):
    """Run the segment once; a replay runs it again into its outputs.  A
    CUDA graph reads what the segment's closure holds by address, so the
    segment must outlive the capture: hold it weakly and check."""
    out = fn()
    ref = weakref.ref(fn)

    def tensors(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for v in (x.values() if isinstance(x, dict) else x)
                for t in tensors(v)]

    def replay():
        seg = ref()
        assert seg is not None, "a captured segment was freed"
        for static, fresh in zip(tensors(out), tensors(seg())):
            static.copy_(fresh)

    return replay, out


@pytest.fixture(scope="module")
def seqs():
    seqs = random_genome([("chrA", 60_000), ("chrB", 30_000)], seed=71)
    # a 150 bp block in 60 copies: its cores pass H and skip or truncate
    block = seqs[0][1][1_000:1_150].copy()
    for i in range(60):
        seqs[1][1][2_000 + 300 * i: 2_150 + 300 * i] = block
    return seqs


@pytest.fixture(scope="module")
def didx(seqs):
    return to_device(build_index(seqs, lut_bases=8), CPU)


def _batches(seqs, n, B=48, L=100):
    out = []
    for k in range(n):
        _, reads, _ = simulate_reads(seqs, B, read_len=L, sub_rate=0.03,
                                     seed=100 + k)
        reads = reads.copy()
        lengths = np.full(B, L, np.int32)
        lengths[::7] = L - 9 - k          # ragged reads, padded with N
        reads[np.arange(L)[None, :] >= lengths[:, None]] = 4
        reads[5::11, 40:43] = 4           # Ns inside reads
        reads[3] = seqs[1][1][2_010 + k: 2_010 + k + L]   # in the repeat
        out.append((reads, lengths))
    return out


class _Calls:
    """Counts the kernel calls made through the pipeline module's names,
    wrapped as the benchmark wraps them (`*args, **kwargs` passed on)."""

    def __init__(self, monkeypatch):
        self.n = dict.fromkeys(KERNELS, 0)
        for name in KERNELS:
            fn = getattr(pipeline, name)

            def wrapped(*a, _fn=fn, _name=name, **k):
                self.n[_name] += 1
                return _fn(*a, **k)

            monkeypatch.setattr(pipeline, name, wrapped)

    def take(self):
        n, self.n = self.n, dict.fromkeys(KERNELS, 0)
        return n


CASES = {
    "fast": dict(strand="both", fast=True, occ_skip=True),
    "classic": dict(strand="both", fast=False, occ_skip=True),
    "truncating": dict(strand="both", fast=False, occ_skip=False),
    "sense": dict(strand="sense", fast=False, occ_skip=True),
    "antisense": dict(strand="antisense", fast=True, occ_skip=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_segments_equal_align_core(didx, seqs, case, monkeypatch):
    c = CASES[case]
    ap = AlignParams(strand=c["strand"])
    L = 100
    if c["fast"]:
        fp = ap.derive_fast(L, didx.total_len, didx.lut_bases)
        dp, H, cap = fp.dp, fp.H, fp.cand_cap
    else:
        dp = ap.derive(L, didx.total_len)
        H, cap = ap.cand_per_core, ap.max_cand_per_strand
    calls = _Calls(monkeypatch)
    batches = _batches(seqs, 3)
    B = len(batches[0][0])
    core = pipeline._CoreGraphs(didx, ap, dp, H, cap, c["occ_skip"], B, L,
                                capture=_emulated_capture)
    assert calls.take() == dict.fromkeys(KERNELS, 0)   # capture runs none
    flags = {"overflow": 0, "cap_trunc": 0, "unique": 0}
    for reads, lengths in batches:
        r = torch.from_numpy(reads)
        ln = torch.from_numpy(lengths)
        want = pipeline.align_core(didx, r, ln, ap=ap, dp=dp, H=H,
                                   cand_cap=cap, strand=ap.strand,
                                   occ_skip=c["occ_skip"])
        eager_calls = calls.take()
        core.reads.copy_(r)
        core.lengths.copy_(ln)
        got, packed = core.run()
        assert calls.take() == eager_calls
        assert torch.equal(packed, pipeline._pack_result(want))
        # the host's views of the packed bytes are the result
        host = pipeline._unpack(packed.clone(), pipeline._layout(want))
        assert list(host) == list(want)
        for k, v in want.items():
            assert host[k].dtype == v.dtype and torch.equal(host[k], v), k
            assert host[k].is_contiguous(), k
            np.testing.assert_array_equal(host[k].numpy(), v.numpy())
        assert eager_calls["sort2_rows"] == 1
        n_strands = 2 if ap.strand == "both" else 1
        for name in ("seed_rows", "sort_rows", "dedup_pack",
                     "hamming_extend_packed"):
            assert eager_calls[name] == n_strands, name
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            assert torch.equal(got[k], v), k
        for k in flags:
            flags[k] += int(want[k].sum())
    # the batches reach the paths the segments cut through
    assert flags["unique"] > 0
    assert flags["overflow"] > 0 or flags["cap_trunc"] > 0


def test_kernels_keep_their_positional_signatures():
    def positional(fn):
        return [p.name for p in inspect.signature(fn).parameters.values()
                if p.kind is p.POSITIONAL_OR_KEYWORD]

    assert positional(sort.sort_rows) == ["x"]
    assert positional(sort.sort2_rows) == ["key", "val"]
    assert positional(ep.hamming_extend_packed) == [
        "pg", "entry_starts", "loci", "valid", "rcodes", "rnlane", "lengths"]
    for fn in (sort.sort_rows, sort.sort2_rows, ep.hamming_extend_packed):
        out = inspect.signature(fn).parameters["out"]
        assert out.kind is out.KEYWORD_ONLY and out.default is None


@pytest.mark.parametrize("B,C", [(1, 1), (7, 33), (64, 480)])
def test_sort_rows_out_equals_the_call_without_it(B, C):
    rng = np.random.default_rng(B * 1000 + C)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, (B, C)).astype(np.int32))
    out = torch.empty_like(x)
    assert sort.sort_rows(x, out=out) is out
    assert torch.equal(out, sort.sort_rows(x))
    with pytest.raises(ValueError):
        sort.sort_rows(x, out=torch.empty((B, C + 1), dtype=torch.int32))


@pytest.mark.parametrize("B,C", [(1, 1), (5, 17), (32, 192)])
def test_sort2_rows_out_equals_the_call_without_it(B, C):
    rng = np.random.default_rng(B * 1000 + C)
    key = torch.from_numpy(rng.integers(0, 9, (B, C)).astype(np.int32))
    val = torch.from_numpy(rng.integers(-2**31, 2**31, (B, C))
                           .astype(np.int32))
    out = (torch.empty_like(key), torch.empty_like(val))
    got = sort.sort2_rows(key, val, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    for a, b in zip(got, sort.sort2_rows(key, val)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        sort.sort2_rows(key, val, out=(out[0], out[1].to(torch.int64)))


@pytest.mark.parametrize("L", [100, 150])
def test_hamming_extend_packed_out_equals_the_call_without_it(didx, seqs,
                                                               L):
    (reads, lengths), = _batches(seqs, 1, B=40, L=L)
    r = torch.from_numpy(reads)
    ln = torch.from_numpy(lengths)
    rng = np.random.default_rng(L)
    loci = torch.from_numpy(rng.integers(-5, didx.total_len, (40, 24))
                            .astype(np.int32))
    valid = torch.from_numpy(rng.random((40, 24)) < 0.8)
    rcodes, rnlane = ep.pack_reads(r, ln)
    args = (didx.packed, didx.entry_starts, loci, valid, rcodes, rnlane, ln)
    out = torch.empty(loci.shape, dtype=torch.uint8)
    assert ep.hamming_extend_packed(*args, out=out) is out
    assert torch.equal(out, ep.hamming_extend_packed(*args))
    with pytest.raises(ValueError):
        ep.hamming_extend_packed(*args, out=torch.empty(loci.shape,
                                                        dtype=torch.int32))


@pytest.mark.parametrize("rc", [False, True])
def test_seed_kernels_out_equals_the_call_without_it(didx, seqs, rc):
    (reads, lengths), = _batches(seqs, 1, B=40)
    r, ln = torch.from_numpy(reads), torch.from_numpy(lengths)
    ap = AlignParams()
    fp = ap.derive_fast(100, didx.total_len, didx.lut_bases)
    offs = torch.tensor(fp.dp.offsets, dtype=torch.int32)
    args = (didx, r, ln, rc, offs, fp.dp.core_len, fp.H, None, True)
    want = seed_rows.seed_rows(*args)
    out = tuple(torch.empty_like(t) for t in want)
    got = seed_rows.seed_rows(*args, out=out)
    assert all(g is o and torch.equal(g, w)
               for g, o, w in zip(got, out, want))
    srt, overflow = sort.sort_rows(want[0]), want[1]
    want = seed_rows.dedup_pack(srt, overflow, r, ln, rc, fp.cand_cap, True)
    out = tuple(torch.empty_like(t.contiguous()) for t in want)
    got = seed_rows.dedup_pack(srt, overflow, r, ln, rc, fp.cand_cap, True,
                               out=out)
    assert all(g is o and torch.equal(g, w)
               for g, o, w in zip(got, out, want))
    with pytest.raises(ValueError):
        seed_rows.dedup_pack(srt, overflow, r, ln, rc, fp.cand_cap, True,
                             out=out[:-1])


def test_one_core_serves_indexes_of_one_shape(didx, seqs, monkeypatch):
    """The chunks of a chunked index share a key's `_CoreGraphs`: a second
    index of the same shape is given to the kernels and captures nothing.
    Runs that alternate between the indexes each equal `align_core` on
    their own index, field for field, and call each kernel as often."""
    other = to_device(build_index(
        [(n, np.roll(s, 7_919)) for n, s in seqs], lut_bases=8), CPU)
    assert other.total_len == didx.total_len
    ap = AlignParams()
    L = 100
    fp = ap.derive_fast(L, didx.total_len, didx.lut_bases)
    calls = _Calls(monkeypatch)
    batches = _batches(seqs, 2)
    B = len(batches[0][0])
    captured = []

    def capture(fn):
        captured.append(fn)
        return _emulated_capture(fn)

    core = pipeline._CoreGraphs(didx, ap, fp.dp, fp.H, fp.cand_cap, True, B,
                                L, capture=capture)
    first = len(captured)
    for reads, lengths in batches:
        for idx in (didx, other, didx, other):
            r, ln = torch.from_numpy(reads), torch.from_numpy(lengths)
            want = pipeline.align_core(idx, r, ln, ap=ap, dp=fp.dp, H=fp.H,
                                       cand_cap=fp.cand_cap,
                                       strand=ap.strand, occ_skip=True)
            eager_calls = calls.take()
            core.reads.copy_(r)
            core.lengths.copy_(ln)
            got, packed = core.run(idx)
            assert calls.take() == eager_calls
            assert torch.equal(packed, pipeline._pack_result(want))
            for k, v in want.items():
                assert torch.equal(got[k], v), k
    # the key and the accept segments, captured once for both indexes
    assert len(captured) == first == 2
    assert not torch.equal(pipeline._pack_result(pipeline.align_core(
        didx, r, ln, ap=ap, dp=fp.dp, H=fp.H, cand_cap=fp.cand_cap,
        strand=ap.strand, occ_skip=True)), packed)
