"""The aligner pipeline: seed -> candidates -> Hamming extend -> accept.

Counterpart of biokanga_tpu/align/pipeline.py for the single-end path.
`align_core` runs the device stages on one batch of reads, a strand at a
time, then both strands together:

  1. pack each read's seed cores, look up their suffix-array ranges and
     write up to H diagonals a core into one candidate row
     (ops/seed_rows.seed_rows)
  2. sort each row with the row sort kernel (ops/sort.sort_rows), drop
     repeated diagonals, keep the first cand_cap and pack the read
     (ops/seed_rows.dedup_pack)
  3. count packed Hamming mismatches with the extension kernel
     (ops/extend_packed.hamming_extend_packed), or, for an index without
     packed rows or reads past MAX_PACKED_READ_LEN bases, on the dense
     path (ops/extend.hamming_extend)
  4. accept hits through one two-key row sort (ops/sort.sort2_rows)

`AlignEngine` drives it from the host exactly as the JAX engine does:
a two-level fast pass, a classic rerun of unresolved reads, and the
two-step rescue ladder; chunk sweeps (parallel/chunked.py) take the fast
pass alone (`launch_fast`).  The TPU workarounds of the JAX version (row
gathers with static selects, the (C, B) layout, 2-bit upload packing,
the `uniform` flag and the streaming-extension switch) are left out;
each is replaced by the general form that gives the same bits.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import gc
import math

import numpy as np
import torch

from ..device import I32_MAX
from ..index.device import DeviceIndex
from ..ops.extend import hamming_extend
from ..ops.extend_packed import (
    BASES_PER_WORD,
    MAX_PACKED_READ_LEN,
    MM_INVALID,
    hamming_extend_packed,
)
from ..ops.seed_rows import dedup_pack, seed_rows
from ..ops.seed_rows import rc_reads as _rc_reads
from ..ops.sort import sort2_rows, sort_rows
from ..utils.trace import count, span
from .params import AlignParams, DerivedParams

# candidate diagonals a strand gives the indel and splice scans: the
# lowest of its sorted seed diagonals (biokanga_tpu/align/pipeline.py:790,
# the splice_cand_cap default, which no caller changes)
SPLICE_CAND_CAP = 24


def _offsets(dp: DerivedParams, device) -> torch.Tensor:
    return torch.as_tensor(dp.offsets, dtype=torch.int32, device=device)


def _strand_candidates(didx: DeviceIndex, reads: torch.Tensor,
                       lengths: torch.Tensor, rc: bool, dp: DerivedParams,
                       H: int, cand_cap: int, owned=None,
                       occ_skip: bool = False, offs=None, out=None):
    """Candidate loci for one strand of (B, L) int8 reads and their (B,)
    int32 lengths (the reverse complements with `rc`): (B, C) int32 loci
    + validity, with C = min(cand_cap, S*H), the per-read count of skipped
    cores, the cap-truncation flag, and the strand's packed read words
    and N-plane words.

    Pack cores -> LUT / binary-search range -> read up to H sorted
    positions per core (seed_rows) -> diagonal dedup (row sort + neighbour
    mask) -> keep the first cand_cap columns (INT32_MAX sentinels sort
    last) and pack the read (dedup_pack).

    `occ_skip`: a core whose range exceeds H gives no candidates and is
    counted in n_over (biokanga_tpu/align/pipeline.py:116-126 states the
    rule); without it the range is cut to its first H positions and the
    read is flagged truncated.  `owned`: alignments must start below it.
    `offs`: dp.offsets as an int32 tensor on the reads' device (made here
    when None).  `out`: static buffers to write into, a dict with the
    pair "seed", the tensor "srt" and the tuple "cand" of the kernels'
    `out=` (`_CoreGraphs`).
    """
    bufs = out or {}
    if offs is None:
        offs = _offsets(dp, reads.device)
    flat, overflow = seed_rows(didx, reads, lengths, rc, offs, dp.core_len,
                               H, owned, occ_skip, out=bufs.get("seed"))
    count("seed.calls", 1)
    count("seed.slots", flat.numel())
    count("seed.filled_slots", lambda: flat != I32_MAX)
    # diagonal dedup: one locus found through several cores is one hit
    srt = sort_rows(flat) if out is None else sort_rows(flat, out=out["srt"])
    return dedup_pack(srt, overflow, reads, lengths, rc, cand_cap, occ_skip,
                      out=bufs.get("cand"))


def _strand_mismatches(didx: DeviceIndex, reads, lengths, rc: bool,
                       dp: DerivedParams, H: int, cand_cap: int,
                       occ_skip: bool, offs, out=None):
    """One strand of align_core up to the extension: (loci, mm, n_over,
    trunc).  `out`: `_strand_candidates`' buffers and "mm", the packed
    extension's."""
    loci, vmask, n_over, trunc, rcodes, rnlane = _strand_candidates(
        didx, reads, lengths, rc, dp, H, cand_cap, didx.owned, occ_skip,
        offs, out)
    if didx.packed is not None and reads.shape[1] <= MAX_PACKED_READ_LEN:
        count("extend.slots", vmask.numel())
        count("extend.valid_slots", vmask)
        args = (didx.packed, didx.entry_starts, loci, vmask, rcodes, rnlane,
                lengths)
        mm = (hamming_extend_packed(*args) if out is None
              else hamming_extend_packed(*args, out=out["mm"]))
    else:
        seq = _rc_reads(reads, lengths) if rc else reads
        mm = hamming_extend(didx.genome, didx.entry_starts, loci, vmask, seq,
                            lengths)
    return loci, mm, n_over, trunc


def _budget_rate(ap: AlignParams, device) -> torch.Tensor:
    return torch.tensor(ap.max_subs_per100 / 100.0, dtype=torch.float32,
                        device=device)


def mismatch_budget(lengths: torch.Tensor, ap: AlignParams,
                    rate: torch.Tensor | None = None) -> torch.Tensor:
    """Per-read mismatch budget from the actual read length, in float32 as
    the JAX package computes it (float64 rounds differently at x.5).
    `rate`: `_budget_rate` made beforehand (made here when None)."""
    if ap.max_subs_per100 == 0:
        return torch.zeros_like(lengths)
    if rate is None:
        rate = _budget_rate(ap, lengths.device)
    return torch.clamp(torch.floor(lengths.to(torch.float32) * rate + 0.5).to(
        torch.int32), 1, 63)


def _accept_key(loci_parts, mm_parts, strand: str):
    """The two-key sort's inputs, (mm*2 | rc, locus), and the (B, Ctot)
    int32 counts of both strands."""
    loci_all = torch.cat(loci_parts, dim=1)
    mm_all = torch.cat(mm_parts, dim=1).to(torch.int32)
    C1 = loci_parts[0].shape[1]
    Ctot = mm_all.shape[1]
    dev = mm_all.device
    if strand == "both":
        rc_col = (torch.arange(Ctot, device=dev) >= C1).to(torch.int32)
    else:
        rc_col = torch.full((Ctot,), int(strand == "antisense"),
                            dtype=torch.int32, device=dev)
    return mm_all * 2 + rc_col[None, :], loci_all, mm_all


def _accept(s_key, s_loci, mm_all, max_tot_mm, n_over, trunc,
            ap: AlignParams) -> dict:
    """align_core's result from the sorted (key, locus) rows."""
    K = max(1, ap.max_multi)
    best = s_key[:, 0] >> 1
    is_rc_hit = (s_key[:, 0] & 1).to(torch.bool)
    locus = s_loci[:, 0]
    next_mm = s_key[:, 1] >> 1
    inst = (mm_all == best[:, None]).sum(dim=1, dtype=torch.int32)
    any_hit = best <= max_tot_mm
    unique = any_hit & ((next_mm - best) >= ap.min_edit_dist)
    # next_mm is canonical only up to the accept margin: saturate it
    next_sat = torch.minimum(next_mm, best + ap.min_edit_dist)
    # ml_* columns are valid hits only; the rest is (-1, 255, False)
    ml_mm_rows = s_key[:, :K] >> 1
    ml_ok = ml_mm_rows <= max_tot_mm[:, None]
    return {
        "unique": unique,
        "any_hit": any_hit,
        "best_mm": torch.clamp(best, max=MM_INVALID).to(torch.uint8),
        "next_mm": torch.clamp(next_sat, max=MM_INVALID).to(torch.uint8),
        "inst": inst,
        "locus": locus,
        "is_rc": is_rc_hit,
        "overflow": (n_over > 0) | trunc,
        "n_over": n_over,
        "cap_trunc": trunc,
        "ml_loci": torch.where(ml_ok, s_loci[:, :K], -1),
        "ml_mm": torch.where(ml_ok, torch.clamp(ml_mm_rows, max=255),
                             255).to(torch.uint8),
        "ml_rc": ml_ok & ((s_key[:, :K] & 1) != 0),
    }


def _strands(strand: str) -> tuple:
    """The `rc` flag of each strand align_core runs, sense first."""
    return {"sense": (False,), "antisense": (True,)}.get(strand,
                                                          (False, True))


def align_core(didx: DeviceIndex, reads: torch.Tensor, lengths: torch.Tensor,
               *, ap: AlignParams, dp: DerivedParams, H: int, cand_cap: int,
               strand: str, occ_skip: bool = True) -> dict:
    """One batch through the device stages; returns device tensors keyed
    as the JAX align_core's result (RESULT_KEYS + ladder keys)."""
    max_tot_mm = mismatch_budget(lengths, ap)
    offs = _offsets(dp, reads.device)
    loci_parts, mm_parts = [], []
    n_over = trunc = None
    for rc in _strands(strand):       # sense columns first (rc_col below)
        loci, mm, s_over, s_trunc = _strand_mismatches(
            didx, reads, lengths, rc, dp, H, cand_cap, occ_skip, offs)
        loci_parts.append(loci)
        mm_parts.append(mm)
        # a hidden hit lives on one strand: the worst single strand counts
        n_over = s_over if n_over is None else torch.maximum(n_over, s_over)
        trunc = s_trunc if trunc is None else (trunc | s_trunc)

    # one two-key sort by (mm*2 | rc, locus): column 0 is the best hit,
    # column 1 the next best, columns 0..K-1 the multi-hit loci; rc in the
    # key's low bit puts sense before antisense at equal mm
    key, loci_all, mm_all = _accept_key(loci_parts, mm_parts, strand)
    s_key, s_loci = sort2_rows(key, loci_all)
    return _accept(s_key, s_loci, mm_all, max_tot_mm, n_over, trunc, ap)


def _cuda_capture(device):
    """A capture function for _CoreGraphs: each segment one CUDA graph,
    captured on a stream of its own into a memory pool that the key's
    segments share; returns (the graph's replay, the segment's outputs)."""
    pool = torch.cuda.graph_pool_handle()
    stream = torch.cuda.Stream(device)

    def capture(fn):
        g = torch.cuda.CUDAGraph()
        # a graph freed while another is captured invalidates the capture,
        # and the cyclic collector frees dropped keys' graphs at any time:
        # it does not run during a capture
        collect = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                g.capture_begin(pool=pool)
                try:
                    out = fn()
                finally:
                    g.capture_end()
        finally:
            if collect:
                gc.enable()
        return g.replay, out

    return capture


class _CoreGraphs:
    """`align_core` of one launch key: its kernels called into static
    buffers, and the PyTorch op chains between them replayed from CUDA
    graphs.

    A strand runs four hand-written kernels eagerly, through this
    module's names, each into the static input of the next (their
    `out=`): `seed_rows` writes the candidate rows, #1 `sort_rows` sorts
    them, `dedup_pack` writes the extension's inputs and #3
    `hamming_extend_packed` counts the mismatches.  Two segments are
    captured: the accept key up to the two-key sort (#2, `sort2_rows`),
    and the result.  So a kernel is called once a call site as in
    `align_core`.  The segments replay in the order they were captured,
    on one stream: `reads` and `lengths` are filled on it before `run`,
    and the dict `run` returns is overwritten by the next `run`.

    `capture(fn) -> (replay, outputs)` captures one segment
    (`_cuda_capture`); outputs are read after each replay.

    No segment reads the index: the kernels are given it.  So one
    `_CoreGraphs` serves every index its launches take (`AlignEngine`'s
    `graphs`: the chunks of a chunked index), `run(didx)`; the indexes'
    runs must then follow one another on one stream, as a key's do.
    """

    def __init__(self, didx: DeviceIndex, ap: AlignParams, dp: DerivedParams,
                 H: int, cand_cap: int, occ_skip: bool, B: int, L: int,
                 capture=None):
        dev = didx.device
        cuda_capture = capture or _cuda_capture(dev)
        # the segments stay referenced: a graph reads the constants and
        # the static tensors they hold by address, and nothing else keeps
        # those alive
        self._segments = []

        def capture(fn):
            self._segments.append(fn)
            return cuda_capture(fn)

        self.didx = didx
        self.dp, self.H = dp, H
        self.cand_cap, self.occ_skip = cand_cap, occ_skip
        # all N and of length 0 until the first batch is copied in
        self.reads = torch.full((B, L), 4, dtype=torch.int8, device=dev)
        self.lengths = torch.zeros(B, dtype=torch.int32, device=dev)
        # made by host-to-device copies, so outside the captures
        self.offs = _offsets(dp, dev)
        rate = _budget_rate(ap, dev)
        S = len(dp.offsets)
        C = min(cand_cap, S * H)
        W = -(-L // BASES_PER_WORD)

        def empty(dtype, *shape):
            return torch.empty(shape, dtype=dtype, device=dev)

        i32 = torch.int32
        self.strands = [{
            "rc": rc,
            "seed": (empty(i32, B, S * H), empty(torch.bool, B, S)),
            "srt": empty(i32, B, S * H),
            # loci, valid, n_over, trunc, rcodes, rnlane
            "cand": (empty(i32, B, C), empty(torch.bool, B, C),
                     empty(i32, B), empty(torch.bool, B), empty(i32, B, W),
                     empty(i32, B, W)),
            "mm": empty(torch.uint8, B, C),
        } for rc in _strands(ap.strand)]

        def key():
            k, loci_all, mm_all = _accept_key(
                [st["cand"][0] for st in self.strands],
                [st["mm"] for st in self.strands], ap.strand)
            n_over, trunc = self.strands[0]["cand"][2:4]
            for st in self.strands[1:]:
                n_over = torch.maximum(n_over, st["cand"][2])
                trunc = trunc | st["cand"][3]
            return k, loci_all, mm_all, n_over, trunc

        self.key, (self.sort_key, self.sort_loci, mm_all, n_over,
                   trunc) = capture(key)
        self.s_key = torch.empty_like(self.sort_key)
        self.s_loci = torch.empty_like(self.sort_loci)

        def accept():
            out = _accept(self.s_key, self.s_loci, mm_all,
                          mismatch_budget(self.lengths, ap, rate), n_over,
                          trunc, ap)
            return out, _pack_result(out)

        self.accept, (self.out, self.packed) = capture(accept)

    def run(self, didx: DeviceIndex | None = None):
        """(result dict, its `_pack_result`), both static, for `didx` (the
        index it was made with when None)."""
        didx = self.didx if didx is None else didx
        for st in self.strands:
            _strand_mismatches(didx, self.reads, self.lengths, st["rc"],
                               self.dp, self.H, self.cand_cap, self.occ_skip,
                               self.offs, st)
        self.key()
        sort2_rows(self.sort_key, self.sort_loci,
                   out=(self.s_key, self.s_loci))
        self.accept()
        return self.out, self.packed


def _layout(out: dict) -> dict:
    return {k: (t.dtype, tuple(t.shape)) for k, t in out.items()}


def _packing(layout: dict) -> dict:
    """Where each tensor of a result lies in `_pack_result`'s bytes: key
    -> (first byte, bytes); 4-byte tensors first, so that every one
    starts on a multiple of its size."""
    at, where = 0, {}
    for k in sorted(layout, key=lambda k: -layout[k][0].itemsize):
        dtype, shape = layout[k]
        where[k] = (at, math.prod(shape) * dtype.itemsize)
        at += where[k][1]
    return where


def _pack_result(out: dict) -> torch.Tensor:
    """A result's tensors one after another as the bytes of one uint8
    tensor, for one copy to the host."""
    return torch.cat([out[k].contiguous().view(torch.uint8).reshape(-1)
                      for k in _packing(_layout(out))])


def _unpack(buf: torch.Tensor, layout: dict) -> dict:
    """The tensors of a `_pack_result`, each a contiguous view of it."""
    where = _packing(layout)
    res = {}
    for k, (dtype, shape) in layout.items():
        at, n = where[k]
        res[k] = buf[at:at + n].view(dtype).reshape(shape)
    return res


class _Fetch:
    """A launch's result on its way to the host: its `_pack_result` copied
    into a pinned host buffer on the launch's stream, and the event
    recorded after the copy.  The buffer comes from PyTorch's caching
    host allocator, which reuses it only once its copy is done."""

    def __init__(self, out: dict, packed: torch.Tensor | None, stream):
        if packed is None:
            packed = _pack_result(out)
        self.layout = _layout(out)
        self.buf = torch.empty(packed.shape, dtype=torch.uint8,
                               pin_memory=True)
        self.buf.copy_(packed, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(stream)
        # a primary pass's classic rerun, once enqueued ahead of the next
        # pass: (rows, None or (sub_reads, sub_lengths, (fetch, dp)))
        self.rerun = None

    def tensors(self) -> dict:
        """The result's host tensors, views of the buffer, once the event
        has passed: it waits for that alone."""
        self.event.synchronize()
        return _unpack(self.buf, self.layout)


def result_tensors(out) -> dict:
    """The tensors of a launch's result: the host tensors of a `_Fetch`,
    else the device tensors themselves."""
    return out.tensors() if isinstance(out, _Fetch) else out


def _to_host(out, dp: DerivedParams) -> dict:
    """A launch's result as a host result dict."""
    res = {k: v.cpu().numpy() for k, v in result_tensors(out).items()}
    res["derived"] = dp
    return res


def _pinned(a: np.ndarray, dtype) -> torch.Tensor:
    """`a` as a pinned host tensor: itself where it lies in pinned memory
    (`AlignEngine.stack`), else a pinned copy."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype))
    return t if t.is_pinned() else t.pin_memory()


# launch keys an engine captures at most; past them a key runs eagerly
MAX_GRAPH_KEYS = 8


@functools.cache
def _high_priority_stream(device_index: int):
    """The high-priority stream of align_batch on one card, shared by the
    engines: PyTorch's caching allocator reuses a freed block only on the
    stream it was made on, so a stream of its own would start each engine,
    and the many short-lived ones (assembly makes one a pass), on fresh
    device allocations."""
    return torch.cuda.Stream(torch.device("cuda", device_index),
                             priority=-1)


class AlignEngine:
    """Runs batch alignment of host reads against one DeviceIndex.

    On a CUDA index with packed rows a launch stages its reads through
    pinned host memory, copies its result back into pinned memory on the
    launch's stream and records an event there, and its fetch waits for
    that event alone.  A launch key (the batch's shape, H, the candidate
    cap, occ_skip, the derived parameters, the parameters and the stream)
    runs `align_core` eagerly on its first launch, is captured as CUDA
    graphs (`_CoreGraphs`) on its second, and replays them from then on;
    one-off shapes stay eager.  The graphs belong to the index: setting
    `didx` drops them.  `align_batch`, which waits for its result at once
    (the classic rerun and the rescue ladder), runs on a high-priority
    stream (`_high_priority_stream`), so that it need not wait behind the
    primary pass enqueued before it; and the classic rerun of a primary pass in flight
    is enqueued, where it can be, ahead of the next one
    (`_start_reruns`).

    `graphs`: a dict of launch keys to `_CoreGraphs` that engines over
    several indexes share (the chunks of a chunked index), so that a
    key's static buffers and graph pool are held once and not once an
    engine.  Their launches must then run one after another, as a sweep
    over the chunks runs them; shared graphs outlive a `didx` setting.
    """

    def __init__(self, didx: DeviceIndex, params: AlignParams | None = None,
                 graphs: dict | None = None):
        self.params = params or AlignParams()
        self._own_graphs = graphs is None
        # launch key -> _CoreGraphs
        self._cores: dict = {} if graphs is None else graphs
        self._seen: dict = {}       # launch key -> launches so far
        # staged primary passes launched and not yet finished, whose
        # reruns _start_reruns may enqueue early
        self._inflight = collections.deque(maxlen=4)
        self._rerun_last = False    # the last finish_primary reran rows
        self.didx = didx

    @property
    def didx(self) -> DeviceIndex:
        return self._didx

    @didx.setter
    def didx(self, didx: DeviceIndex) -> None:
        if self._own_graphs and self._cores:
            torch.cuda.synchronize()    # replays may still read the old one
            self._cores.clear()
            gc.collect()                # free their graphs and pools now
        self._seen.clear()
        self._inflight.clear()
        self._side_ready = False        # the new index may still be built
        self._starts = None
        self._didx = didx

    def entry_starts_host(self) -> np.ndarray:
        """The index's entry starts in host memory, copied once."""
        if self._starts is None:
            self._starts = self.didx.entry_starts.cpu().numpy()
        return self._starts

    def engines_of(self, loci: np.ndarray):
        """(positions, engine, base) of the engines whose index holds each
        locus: this engine for all of them, at base 0."""
        return [(np.arange(len(loci)), self, 0)]

    def stack(self, parts) -> np.ndarray:
        """`np.concatenate(parts)`, a batch to `launch`: where launches are
        staged, built in pinned memory by PyTorch's threads, so that the
        upload copies it as it lies."""
        parts = [np.asarray(p) for p in parts]
        if not self._staged(0):
            return np.concatenate(parts)
        dtype = np.result_type(*parts)
        out = torch.from_numpy(np.empty(0, dtype)).new_empty(
            (sum(len(p) for p in parts),) + parts[0].shape[1:],
            pin_memory=True)
        at = 0
        for p in parts:
            out[at:at + len(p)].copy_(torch.from_numpy(
                np.ascontiguousarray(p, dtype)))
            at += len(p)
        return out.numpy()

    def _staged(self, L: int) -> bool:
        didx = self.didx
        return (didx.device.type == "cuda" and didx.packed is not None
                and L <= MAX_PACKED_READ_LEN)

    def launch(self, reads: np.ndarray, lengths: np.ndarray, H=None,
               cand_cap=None, dp=None, occ_skip: bool = True,
               fetch: bool = True):
        """Upload one batch and enqueue its alignment; returns (result,
        dp): a dict of device tensors, or a `_Fetch` where the launch is
        staged and `fetch` is set.  Read it with `_to_host` or
        `result_tensors`.  Nothing waits for the device here.  A staged
        launch's device tensors may be a graph's static outputs, which the
        next launch of its key overwrites."""
        B, L = reads.shape
        if dp is None:
            dp = self.params.derive(int(L), self.didx.total_len)
        if (self.didx.key_hi.shape[0] == 1
                and dp.core_len > self.didx.lut_bases):
            raise ValueError(
                f"LUT-only index cannot serve core_len {dp.core_len} > "
                f"lut_bases {self.didx.lut_bases}")
        H = int(H or self.params.cand_per_core)
        if cand_cap is None:
            cand_cap = self.params.max_cand_per_strand
        count("engine.launches", 1)
        if self._staged(L):
            return self._launch_staged(reads, lengths, dp, H, int(cand_cap),
                                       occ_skip, fetch), dp
        dev = self.didx.device
        with span("engine.upload"):
            r = torch.from_numpy(np.ascontiguousarray(reads, np.int8)).to(dev)
            ln = torch.from_numpy(np.ascontiguousarray(lengths,
                                                       np.int32)).to(dev)
        with span("engine.enqueue"):
            out = align_core(self.didx, r, ln, ap=self.params, dp=dp, H=H,
                             cand_cap=int(cand_cap),
                             strand=self.params.strand, occ_skip=occ_skip)
        return out, dp

    def _launch_staged(self, reads, lengths, dp, H, cand_cap, occ_skip,
                       fetch=True):
        didx, ap = self.didx, self.params
        dev = didx.device
        stream = torch.cuda.current_stream(dev)
        B, L = reads.shape
        key = (stream.cuda_stream, B, L, H, cand_cap, occ_skip, dp, ap)
        seen = self._seen[key] = self._seen.get(key, 0) + 1
        core = self._cores.get(key)
        if (core is None and seen >= 2 and B
                and len(self._cores) < MAX_GRAPH_KEYS):
            core = self._cores[key] = _CoreGraphs(didx, ap, dp, H, cand_cap,
                                                  occ_skip, B, L)
        with span("engine.upload"):
            r, ln = _pinned(reads, np.int8), _pinned(lengths, np.int32)
            if core is None:
                r = r.to(dev, non_blocking=True)
                ln = ln.to(dev, non_blocking=True)
            else:
                core.reads.copy_(r, non_blocking=True)
                core.lengths.copy_(ln, non_blocking=True)
        with span("engine.enqueue"):
            count("engine.graph_launches", int(core is not None))
            if core is None:
                out = align_core(didx, r, ln, ap=ap, dp=dp, H=H,
                                 cand_cap=cand_cap, strand=ap.strand,
                                 occ_skip=occ_skip)
                packed = None
            else:
                out, packed = core.run(didx)
            return _Fetch(out, packed, stream) if fetch else out

    def _side_stream(self):
        """align_batch's high-priority stream; it waits once an index for
        the work enqueued so far, which may still be building the index."""
        dev = self.didx.device
        side = _high_priority_stream(
            torch.cuda.current_device() if dev.index is None else dev.index)
        if not self._side_ready:
            side.wait_stream(torch.cuda.current_stream(dev))
            self._side_ready = True
        return side

    def align_batch(self, reads: np.ndarray, lengths: np.ndarray, H=None,
                    cand_cap=None, dp=None, occ_skip: bool = True) -> dict:
        """reads: (B, L) int8 host array.  Returns host-side result dict."""
        on = (torch.cuda.stream(self._side_stream())
              if self._staged(reads.shape[1]) else contextlib.nullcontext())
        with on:
            out, dp = self.launch(reads, lengths, H=H, cand_cap=cand_cap,
                                  dp=dp, occ_skip=occ_skip)
        return _to_host(out, dp)

    def _fast_params(self, reads):
        """FastPassParams for this batch shape, or None (also for an index
        without packed rows, as in the JAX engine)."""
        if self.didx.packed is None:
            return None
        return self.params.derive_fast(
            int(reads.shape[1]), self.didx.total_len, self.didx.lut_bases)

    def _launch_pass(self, reads: np.ndarray, lengths: np.ndarray,
                     fetch: bool = True):
        count("engine.rows", len(reads))
        fp = self._fast_params(reads)
        if fp is None:
            out, dp = self.launch(reads, lengths, fetch=fetch)
        else:
            out, dp = self.launch(reads, lengths, H=fp.H,
                                  cand_cap=fp.cand_cap, dp=fp.dp,
                                  fetch=fetch)
        return (reads, lengths, out, dp, fp)

    def launch_primary(self, reads: np.ndarray, lengths: np.ndarray):
        """Enqueue the primary pass (two-level fast pass when available,
        classic otherwise).  Pair with finish_primary."""
        self._start_reruns()
        state = self._launch_pass(reads, lengths)
        if isinstance(state[2], _Fetch) and state[4] is not None:
            self._inflight.append(state)
        return state

    def unresolved(self, res: dict, lengths, fp) -> np.ndarray:
        """The rows the fast pass left unresolved, for the classic rerun."""
        return np.nonzero(~resolved_rows(res, lengths, fp,
                                         self.params.min_edit_dist))[0]

    def _start_reruns(self) -> None:
        """Enqueue the classic rerun of each staged primary pass in flight
        on align_batch's stream, ahead of the pass about to be launched,
        which the current stream makes wait for it: on a card busy with
        that pass the rerun's few rows take as long as the pass, since its
        ops wait for the pass's blocks, and ahead of it a few hundred
        microseconds.  A pass in flight is read once its result has
        landed, or waited for where the last pass finished had rows to
        rerun (finish_primary would wait for it next all the same)."""
        for state in self._inflight:
            reads, lengths, out, dp, fp = state
            if out.rerun is not None or not (self._rerun_last
                                             or out.event.query()):
                continue
            with span("engine.rerun"):
                rows = self.unresolved(
                    {k: v.numpy() for k, v in out.tensors().items()},
                    lengths, fp)
                out.rerun = (rows, None)
                if len(rows):
                    count("engine.early_reruns", 1)
                    sub_r, sub_l = pad_rows(reads[rows], lengths[rows])
                    with torch.cuda.stream(self._side_stream()):
                        sub = self.launch(sub_r, sub_l)
                    torch.cuda.current_stream(self.didx.device).wait_event(
                        sub[0].event)
                    out.rerun = (rows, (sub_r, sub_l, sub))

    def finish_primary(self, state) -> dict:
        """Fetch a launch_primary result and complete it to the full
        align_with_rescue semantics: rerun fast-pass-unresolved reads
        through the classic pass, then the rescue ladder."""
        reads, lengths, out, dp, fp = state
        self._inflight = collections.deque(
            (s for s in self._inflight if s is not state),
            maxlen=self._inflight.maxlen)
        with span("engine.fetch"):
            res = _to_host(out, dp)
        if fp is None:
            self.rescue_pass(reads, lengths, res)
            return res
        rows = self.unresolved(res, lengths, fp)
        res["overflow"] = np.zeros_like(res["overflow"])
        res["n_over"] = np.zeros_like(res["n_over"])
        res["cap_trunc"] = np.zeros_like(res["cap_trunc"])
        count("engine.rerun_rows", len(rows))
        self._rerun_last = bool(len(rows))
        if len(rows):
            with span("engine.rerun"):
                early = getattr(out, "rerun", None)
                if early is not None and early[1] is not None:
                    sub_r, sub_l, (sub, sub_dp) = early[1]
                    sub = _to_host(sub, sub_dp)
                else:
                    sub_r, sub_l = pad_rows(reads[rows], lengths[rows])
                    sub = self.align_batch(sub_r, sub_l)
                self.rescue_pass(sub_r, sub_l, sub)
                for k in RESULT_KEYS + _LADDER_KEYS:
                    res[k][rows] = sub[k][: len(rows)]
        return res

    def launch_fast(self, reads: np.ndarray, lengths: np.ndarray,
                    fetch: bool = True):
        """Enqueue only the fast pass (the classic pass where there is no
        fast pass): no unresolved rerun, no rescue.  For chunk sweeps that
        resolve reads on the merged result (two_level_chunk_sweep), or
        that select and merge on the device (`fetch` off; see `launch`)."""
        _, _, out, dp, fp = self._launch_pass(reads, lengths, fetch)
        return (out, dp, fp)

    def finish_fast(self, state) -> dict:
        out, dp, _ = state
        with span("engine.fetch"):
            return _to_host(out, dp)

    def align_stream(self, blocks):
        """align_with_rescue over an iterator of (reads, lengths), with the
        next block's primary pass enqueued before this block's result is
        fetched and completed; yields host result dicts."""
        pending = None
        for reads, lengths in blocks:
            state = self.launch_primary(reads, lengths)
            if pending is not None:
                yield self.finish_primary(pending)
            pending = state
        if pending is not None:
            yield self.finish_primary(pending)

    def align_with_rescue(self, reads: np.ndarray, lengths: np.ndarray):
        """Primary pass + classic rerun + rescue ladder (the JAX engine's
        align_with_rescue, field for field)."""
        return self.finish_primary(self.launch_primary(reads, lengths))

    def rescue_pass(self, reads: np.ndarray, lengths: np.ndarray,
                    res: dict) -> None:
        """Apply the progressive rescue ladder in place (rescue_ladder)."""
        def run(r, l, H, cap, skip):
            return self.align_batch(r, l, H=H, cand_cap=cap, occ_skip=skip)

        return rescue_ladder(run, reads, lengths, res, self.params)


class ExtendedAligner:
    """Adds micro-indel and splice-junction fall-through passes to an
    AlignEngine (the -a/-A aligner modes; CSfxArrayV3::AlignReads
    progressive fall-through, SfxArrayV2.cpp:7663-7760), following
    biokanga_tpu/align/pipeline.py:780-910.

    Reads with no hit from the Hamming pass are re-seeded on both
    strands; their candidate diagonals feed the indel and splice scans
    (align/splice_indel.py) on the index's device.  The per-row best
    stays on the device until it is chosen, then goes to the host.
    """

    def __init__(self, engine: AlignEngine, micro_indel_len: int = 0,
                 splice_junct_len: int = 0):
        self.engine = engine
        self.micro_indel_len = min(micro_indel_len, 20)
        self.splice_junct_len = min(splice_junct_len, 100_000)

    def align(self, reads: np.ndarray, lengths: np.ndarray):
        eng = self.engine
        res = eng.align_with_rescue(reads, lengths)
        res["cigar_op"] = np.zeros(len(reads), dtype=np.int32)  # 0 = pure M
        res["op_len"] = np.zeros(len(reads), dtype=np.int32)
        res["split"] = np.zeros(len(reads), dtype=np.int32)
        if not (self.micro_indel_len or self.splice_junct_len):
            return res

        left = np.nonzero(~res["unique"] & ~res["any_hit"])[0]
        if len(left) == 0:
            return res
        sub_r, sub_l = pad_rows(reads[left], lengths[left])
        best = self.scan_rows(sub_r, sub_l)
        if best is None:
            return res
        acc = np.nonzero(best["ok"] & (best["score"] > -(1 << 20)))[0]
        acc = acc[acc < len(left)]  # drop pad rows
        gi = left[acc]
        res["unique"][gi] = True
        res["any_hit"][gi] = True
        res["locus"][gi] = best["locus"][acc]
        res["is_rc"][gi] = best["is_rc"][acc]
        res["best_mm"][gi] = np.minimum(best["mm"][acc], 255).astype(np.uint8)
        res["split"][gi] = best["split"][acc]
        res["cigar_op"][gi] = best["op"][acc]
        res["op_len"][gi] = best["gaplen"][acc]
        return res

    def scan_rows(self, sub_r: np.ndarray, sub_l: np.ndarray):
        """Indel/splice fall-through scans for one padded row block;
        returns the per-row best-candidate dict of host arrays (schema of
        scan_fallthrough), or None."""
        eng = self.engine
        didx = eng.didx
        dev = didx.device
        best = scan_fallthrough(
            didx, eng.params,
            eng.params.derive(int(sub_r.shape[1]), didx.total_len),
            torch.from_numpy(np.ascontiguousarray(sub_r, np.int8)).to(dev),
            torch.from_numpy(np.ascontiguousarray(sub_l, np.int32)).to(dev),
            self.micro_indel_len, self.splice_junct_len)
        if best is None:
            return None
        return {k: v.cpu().numpy() for k, v in best.items()}


def scan_fallthrough(didx: DeviceIndex, params: AlignParams,
                     dp: DerivedParams, reads: torch.Tensor,
                     lengths: torch.Tensor, micro_indel_len: int,
                     splice_junct_len: int):
    """The indel and splice scans of a row block on didx's device; the
    per-row best candidate as a dict of device tensors, or None if no
    scan runs.

    Result schema: ok, score (-(1 << 20) where not ok), mm, split, locus,
    is_rc, op (signed indel, or 1<<30 for a splice), gaplen (the splice's
    N length).  Sense before antisense and indels before splices; a later
    scan replaces the best only on a strictly higher score.  No ownership
    limit: a junction's 3' segment may lie in a chunk's overlap tail."""
    from .splice_indel import indel_scan, splice_scan

    B, L = reads.shape
    dev = reads.device
    scan_args = (didx.packed, didx.entry_starts)
    best = None
    offs = _offsets(dp, dev)
    for is_rc in (False, True):
        loci, vmask, _, _, rcodes, rnlane = _strand_candidates(
            didx, reads, lengths, is_rc, dp, params.cand_per_core,
            SPLICE_CAND_CAP, occ_skip=True, offs=offs)
        cand = (loci, vmask, rcodes, rnlane, lengths, L)
        outs = []
        if micro_indel_len:
            o = indel_scan(*scan_args, *cand, micro_indel_len)
            outs.append({
                "ok": o["ok"], "score": o["score"], "mm": o["mm"],
                "split": o["split"],
                "locus": torch.gather(loci, 1, o["cand"].to(
                    torch.int64)[:, None])[:, 0],
                "op": o["indel"].to(torch.int64),
                "gaplen": torch.zeros(B, dtype=torch.int64, device=dev),
            })
        if splice_junct_len:
            o = splice_scan(*scan_args, *cand, splice_junct_len)
            outs.append({
                "ok": o["ok"], "score": o["score"], "mm": o["mm"],
                "split": o["split"], "locus": o["locus5"],
                "op": torch.full((B,), 1 << 30, dtype=torch.int64,
                                 device=dev),
                "gaplen": (o["locus3"] - o["locus5"]).to(torch.int64),
            })
        for o in outs:
            o["is_rc"] = torch.full((B,), is_rc, dtype=torch.bool,
                                    device=dev)
            o["score"] = torch.where(o["ok"], o["score"], -(1 << 20))
            if best is None:
                best = o
            else:
                better = o["score"] > best["score"]
                best = {k: torch.where(better, o[k], best[k])
                        for k in best}
    return best


def cigar_for(length: int, cigar_op: int, op_len: int, split: int) -> str:
    """CIGAR string from the extended-aligner encodings (copy of
    biokanga_tpu/align/pipeline.py:913)."""
    if cigar_op == 0:
        return f"{length}M"
    if cigar_op == 1 << 30:  # splice: N gap of op_len at split
        return f"{split}M{op_len}N{length - split}M"
    g = int(cigar_op)
    if g > 0:  # genome deletion
        return f"{split}M{g}D{length - split}M"
    j = -g     # read insertion
    return f"{split}M{j}I{length - split - j}M"


# RESULT_KEYS, inexact_rows, rescue_ladder and pad_rows are copied from
# biokanga_tpu/align/pipeline.py:687-777 and :926 (numpy host code; that
# module imports jax).
RESULT_KEYS = ("unique", "any_hit", "best_mm", "next_mm", "inst",
               "locus", "is_rc", "ml_loci", "ml_mm", "ml_rc")
_LADDER_KEYS = ("overflow", "n_over", "cap_trunc")


def resolved_rows(res: dict, lengths, fp, min_edit_dist: int):
    """Rows the fast pass (FastPassParams `fp`) resolves exactly:
    skip-aware, each skipped core weakens the bound by one, and no
    candidate-cap truncation."""
    bound = fp.resolved_bound(lengths, min_edit_dist)
    return ((res["best_mm"].astype(np.int32) + res["n_over"] <= bound)
            & (~res["cap_trunc"]))


def inexact_rows(res: dict, lengths, min_edit_dist: int):
    """Rows whose result is NOT provably exact under the skip-aware
    pigeonhole bound:

        exact  iff  no candidate-cap truncation AND
                    (no core skipped  OR
                     best_mm + n_over + MMDelta <= length // core_len)
    """
    n = np.asarray(lengths, np.int32) // np.int32(res["derived"].core_len)
    best = res["best_mm"].astype(np.int32)
    exact = (~res["cap_trunc"]) & (
        (res["n_over"] == 0)
        | (best + res["n_over"] + np.int32(min_edit_dist) <= n)
    )
    return ~exact


def rescue_ladder(run, reads, lengths, res: dict, params: AlignParams,
                  extra_keys=()):
    """Progressive-sensitivity rescue for inexact reads:

      step 1  medium-width complete enumeration (occ_skip at
              rescue_mid_H), in fixed 2,048-row dispatches;
      step 2  full-width truncating pass (first rescue_cand_per_core
              positions per core) for the still-inexact residue, except
              reads already excessive-multi at mm == 0, in fixed 512-row
              dispatches.

    `run(reads, lengths, H, cand_cap, occ_skip) -> host result dict`.
    Mutates `res` in place and returns it.
    """
    keys = RESULT_KEYS + _LADDER_KEYS + tuple(extra_keys)
    p = params
    need = inexact_rows(res, lengths, p.min_edit_dist)
    if not need.any():
        return res
    if p.rescue_mid_H > p.cand_per_core:
        rows = np.nonzero(need)[0]
        CH1 = 2048
        for s in range(0, len(rows), CH1):
            sub_rows = rows[s: s + CH1]
            k_n = len(sub_rows)
            sub_r = np.full((CH1, reads.shape[1]), 4, reads.dtype)
            sub_l = np.zeros(CH1, lengths.dtype)
            sub_r[:k_n] = reads[sub_rows]
            sub_l[:k_n] = lengths[sub_rows]
            sub = run(sub_r, sub_l, p.rescue_mid_H, p.rescue_mid_cap, True)
            for k in keys:
                res[k][sub_rows] = sub[k][:k_n]
    multi0 = (res["any_hit"] & (res["best_mm"] == 0)
              & (res["inst"] > p.max_multi))
    need2 = inexact_rows(res, lengths, p.min_edit_dist) & ~multi0
    if need2.any():
        rows = np.nonzero(need2)[0]
        CH = 512
        cap = 8 * p.max_cand_per_strand
        for s in range(0, len(rows), CH):
            sub_rows = rows[s: s + CH]
            k_n = len(sub_rows)
            r = np.full((CH, reads.shape[1]), 4, reads.dtype)
            l = np.zeros(CH, lengths.dtype)
            r[:k_n] = reads[sub_rows]
            l[:k_n] = lengths[sub_rows]
            sub = run(r, l, p.rescue_cand_per_core, cap, False)
            for k in keys:
                res[k][sub_rows] = sub[k][:k_n]
    return res


def pad_rows(reads: np.ndarray, lengths: np.ndarray,
             target: int | None = None):
    """Pad a read block to a power-of-two row count (min 64) with N-filled
    rows of length 0."""
    B = reads.shape[0]
    if target is None:
        target = 64
        while target < B:
            target *= 2
    if B == target:
        return reads, lengths
    pr = np.full((target, reads.shape[1]), 4, dtype=reads.dtype)
    pr[:B] = reads
    pl = np.zeros(target, dtype=lengths.dtype)
    pl[:B] = lengths
    return pr, pl
