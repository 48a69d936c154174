"""The frozen byte and operation counts against hand counts, and the trace
reader on a hand-made trace."""
import torch

from benchmark import roofline
from benchmark.trace import summarize


def test_peaks_and_bound():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert abs(roofline.INT32_OPS_PER_S - 16.727e12) < 1e9
    assert roofline.bound_s(3.35e12, 0) == 1.0
    assert roofline.bound_s(0, roofline.INT32_OPS_PER_S * 2) == 2.0


def test_sort_counts_by_hand():
    # (2, 4): 2 x 4 int32 in and out; 4 * log2(4) = 8 compares a row
    assert roofline.sort_rows_counts(2, 4) == (64, 16)
    assert roofline.sort2_rows_counts(2, 4) == (128, 16)
    # C = 5 rounds log2 up to 3
    assert roofline.sort_rows_counts(1, 5) == (40, 15)


def test_extend_counts_by_hand():
    """Genome of 100 bases in two entries [0, 50) and [50, 100); one read
    of 10 bases (1 word) with three flagged candidates: locus 0 passes
    all tests, 45 is in range but crosses the entry boundary, -1 is out
    of range.

    ops: 3 flags + 2 x 3 range tests + (2 x 2 + 1) x 2 entry searches
    (bit_length(3) = 2 steps) + 6 x 1 word + 2 = 27.
    bytes: 3 + 3 (flags, counts) + 4 x 3 (loci) + 8 (both read planes)
    + 4 (length) + 12 (three entry starts) + 4 (one genome word) = 46."""
    starts = torch.tensor([0, 50, 100], dtype=torch.int32)
    loci = torch.tensor([[0, 45, -1]], dtype=torch.int32)
    valid = torch.ones((1, 3), dtype=torch.bool)
    lengths = torch.tensor([10], dtype=torch.int32)
    assert roofline.extend_counts(100, False, starts, loci, valid, lengths,
                                  1) == (46, 27)
    # the N plane: 8 ops a word and every genome word twice
    assert roofline.extend_counts(100, True, starts, loci, valid, lengths,
                                  1) == (50, 29)
    # an unflagged candidate costs its flag test, its flag and its count
    valid[0, 1:] = False
    assert roofline.extend_counts(100, False, starts, loci, valid, lengths,
                                  1) == (38, 3 + 2 + 5 + 6 + 2)


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_trace_summary_by_hand():
    events = [
        _x("bench.window", "user_annotation", 0, 100),
        _x("pe.launch", "user_annotation", 0, 30),
        _x("pe.classify", "user_annotation", 60, 30),
        _x("bench.kernel.extend", "user_annotation", 4, 3),
        _x("cudaLaunchKernel", "cuda_runtime", 5, 1, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 6, 1, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 20, 1, correlation=3),
        _x("hamming_extend_kernel", "kernel", 10, 20, tid=7, correlation=1),
        _x("void at::native::copy", "kernel", 25, 15, tid=7, correlation=2),
        _x("other_kernel", "kernel", 42, 3, tid=7, correlation=3),
        _x("Memcpy DtoH", "gpu_memcpy", 50, 5, tid=7),
        _x("bench.kernel.extend", "gpu_user_annotation", 10, 30, tid=7),
    ]
    t = summarize(events)
    assert t.window_s == 100e-6
    # union of [10, 40], [42, 45], [50, 55] (30 + 3 + 5): overlaps once
    assert abs(t.busy_s - 38e-6) < 1e-12
    assert t.host_calls == {"pe.launch": 1, "pe.classify": 1,
                            "bench.kernel.extend": 1}
    # the copy kernel launched in the range is PyTorch's own: left out
    assert t.group_kernels == {"extend": 1}
    assert abs(t.group_s["extend"] - 20e-6) < 1e-12
    gaps = [(label, round(s * 1e6, 6)) for label, s in t.idle_gaps]
    assert gaps[0] == ("pe.classify", 45.0)
    assert ("pe.launch", 10.0) in gaps and ("outside_pe", 5.0) in gaps
    assert t.device_ops[0] == ["hamming_extend_kernel", 20e-6]
