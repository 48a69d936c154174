"""Port of biokanga_tpu/tools/mergeoverlaps.py: PE short-insert overlap
merging (`biokanga mergeoverlaps`, CMergeReadPairs,
biokanga/MergeReadPairs.cpp: MergeOverlaps :1002, ProcOverlapPairs :1157),
and the amplicon modes with their 96-well MID-barcode demux.

The overlap scan counts, for every pair of a block and every overlap
length, the mismatches between the 5' read's 3' tail and the reverse-
complemented 3' read's 5' head: torch ops on the device, one (B, ov)
compare a length.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..seq.encode import revcomp
from ..seq.fasta import read_blocks, write_fasta, write_fastq


@dataclass(frozen=True)
class MergeParams:
    min_overlap: int = 16        # reference allows down to 1 (-l)
    max_subs_pcnt: float = 5.0   # max subs as % of overlap length


def _overlap_mm(r1: torch.Tensor, rc2: torch.Tensor) -> torch.Tensor:
    """Mismatch counts for every overlap length ov in [1, L]: overlap ov
    aligns r1[:, L-ov:] with rc2[:, :ov]; a code >= 4 mismatches.
    Returns (B, L) int32, column ov-1 for length ov."""
    B, L = r1.shape
    n1, n2 = r1 >= 4, rc2 >= 4
    mm = torch.empty((B, L), dtype=torch.int32, device=r1.device)
    for ov in range(1, L + 1):
        bad = (r1[:, L - ov:] != rc2[:, :ov]) | n1[:, L - ov:] | n2[:, :ov]
        mm[:, ov - 1] = bad.sum(dim=1, dtype=torch.int32)
    return mm


def merge_pairs_arrays(r1: np.ndarray, r2: np.ndarray, p: MergeParams,
                       device: str | torch.device = "cuda"):
    """r1, r2: (B, L) int8 (uniform length). Returns (merged list of int8
    arrays or None per pair, best overlap lengths, mm counts)."""
    B, L = r1.shape
    dev = resolve_device(device)
    rc2 = revcomp(r2)
    mm = _overlap_mm(torch.from_numpy(np.ascontiguousarray(r1)).to(dev),
                     torch.from_numpy(np.ascontiguousarray(rc2)).to(dev))
    mm = mm.cpu().numpy()
    ovs = np.arange(1, L + 1)
    allowed = np.floor(ovs * p.max_subs_pcnt / 100.0).astype(np.int32)
    ok = (mm <= allowed[None, :]) & (ovs[None, :] >= p.min_overlap)
    # prefer the LONGEST acceptable overlap (reference takes best-scoring;
    # longest-with-subs-in-budget is its dominant outcome)
    best_ov = np.where(ok.any(axis=1), L - np.argmax(ok[:, ::-1], axis=1), 0)
    merged = []
    for i in range(B):
        ov = int(best_ov[i])
        if ov == 0:
            merged.append(None)
        else:
            # merged length = 2L - ov; take r1 then the unoverlapped rc2 tail
            merged.append(np.concatenate([r1[i], rc2[i, ov:]]))
    return merged, best_ov, mm


# ------------------------- amplicon MID-barcode demux ---------------------
# default plate barcodes (MergeReadPairs.cpp:33-57): 12 column (5') + 8 row
# (3') 6-mers identifying 96 wells; well = col + (row-1)*12 when the column
# barcode is at the 5' end, else row + (col-1)*12 (MapSEBarcodesToWell,
# MergeReadPairs.cpp:420-490)
_COL_BARCODES = ["AACCAA", "ACCCCC", "AGCCGG", "ATCCTT", "AAGGAA",
                 "ACGGCC", "AGGGGG", "ATGGTT", "AATTAA", "ACTTCC",
                 "AGTTGG", "ATTTTT"]
_ROW_BARCODES = ["TAATAA", "TCATCC", "TGATGG", "TTATTT", "TATAAA",
                 "TCTACC", "TGTAGG", "TTTATT"]
_B2C = {"A": 0, "C": 1, "G": 2, "T": 3}


def _codes(s: str) -> np.ndarray:
    return np.array([_B2C[c] for c in s], np.int8)


@dataclass
class PlateBarcodes:
    """The reference's hardcoded 96-well column/row barcode table."""

    cols: list = None
    rows: list = None

    def __post_init__(self):
        if self.cols is None:
            self.cols = [_codes(s) for s in _COL_BARCODES]
        if self.rows is None:
            self.rows = [_codes(s) for s in _ROW_BARCODES]
        self.blen = len(self.cols[0])

    def map_pe(self, s1: np.ndarray, s2: np.ndarray) -> int:
        """Well from the 5' barcodes of PE1 and PE2 (MapPEBarcodesToWell,
        MergeReadPairs.cpp:492-556: both barcodes read sense at the reads'
        5' ends)."""
        k = self.blen
        if len(s1) < k or len(s2) < k:
            return 0
        if (s1[:k] >= 4).any() or (s2[:k] >= 4).any():
            return 0
        p5, p3 = s1[:k], s2[:k]
        col5 = next((i + 1 for i, b in enumerate(self.cols)
                     if np.array_equal(p5, b)), 0)
        row3 = next((i + 1 for i, b in enumerate(self.rows)
                     if np.array_equal(p3, b)), 0)
        if col5 and row3:
            return col5 + (row3 - 1) * 12
        row5 = next((i + 1 for i, b in enumerate(self.rows)
                     if np.array_equal(p5, b)), 0)
        col3 = next((i + 1 for i, b in enumerate(self.cols)
                     if np.array_equal(p3, b)), 0)
        if row5 and col3:
            return col3 + (row5 - 1) * 12
        return 0


def _first_index(table: list, k: int) -> dict:
    """Packed k-mer -> 1-based index of its first row in `table`."""
    out: dict[int, int] = {}
    for i, b in enumerate(table):
        out.setdefault(_pack(np.asarray(b)[None])[0], i + 1)
    return out


def _pack(rows: np.ndarray) -> np.ndarray:
    """(B, k) codes 0-3 -> (B,) int64 base-4 numbers."""
    return (rows.astype(np.int64) << (2 * np.arange(rows.shape[1])[::-1])
            ).sum(axis=1)


def _lookup(table: dict, keys: np.ndarray, ok: np.ndarray) -> np.ndarray:
    """table[key] where ok and the key is in the table, else 0."""
    known = np.array(sorted(table), np.int64)
    vals = np.array([table[x] for x in known], np.int64)
    at = np.clip(np.searchsorted(known, keys), 0, len(known) - 1)
    return np.where(ok & (known[at] == keys), vals[at], 0)


def _wells_se(bc: PlateBarcodes, r1: np.ndarray, rc2: np.ndarray,
              best_ov: np.ndarray) -> np.ndarray:
    """The well of every merged amplicon concat(r1[i], rc2[i, ov:]) of a
    block, 0 where unmerged or unidentifiable (MapSEBarcodesToWell,
    MergeReadPairs.cpp:420-490; the JAX package's `map_se` a read at a
    time): the 5' column (or row) barcode and the 3' row (or column)
    barcode, reverse-complemented, each without an N, in an amplicon of
    at least two barcodes' length; found by index arithmetic on the
    block."""
    B, L = r1.shape
    k = bc.blen
    ov = best_ov.astype(np.int64)
    n = 2 * L - ov                                   # merged lengths
    t = n[:, None] - k + np.arange(k)[None, :]       # the 3' k positions
    tail = np.where(t < L, r1[np.arange(B)[:, None], np.minimum(t, L - 1)],
                    rc2[np.arange(B)[:, None],
                        np.clip(ov[:, None] + t - L, 0, L - 1)])
    head = r1[:, :k]
    ok = (ov > 0) & (n >= 2 * k) & (head < 4).all(1) & (tail < 4).all(1)
    p5 = _pack(np.where(head < 4, head, 0))
    p3 = _pack(np.where(tail < 4, tail, 0))
    col5 = _lookup(_first_index(bc.cols, k), p5, ok)
    row3 = _lookup(_first_index([revcomp(b) for b in bc.rows], k), p3, ok)
    row5 = _lookup(_first_index(bc.rows, k), p5, ok)
    col3 = _lookup(_first_index([revcomp(b) for b in bc.cols], k), p3, ok)
    return np.where((col5 > 0) & (row3 > 0), col5 + (row3 - 1) * 12,
                    np.where((row5 > 0) & (col3 > 0),
                             col3 + (row5 - 1) * 12, 0))


def _pad_to(c: np.ndarray, L: int) -> np.ndarray:
    if c.shape[1] == L:
        return c
    out = np.full((c.shape[0], L), 4, dtype=np.int8)
    out[:, : c.shape[1]] = c
    return out


def _pair_blocks(in1: str, in2: str):
    """(blk1, blk2, r1, r2): blocks of 8,192 pairs, both padded with N to
    the wider block's width."""
    for blk1, blk2 in zip(read_blocks(in1, block_size=8192),
                          read_blocks(in2, block_size=8192)):
        L = max(blk1.codes.shape[1], blk2.codes.shape[1])
        yield blk1, blk2, _pad_to(blk1.codes, L), _pad_to(blk2.codes, L)


def merge_amplicons(
    in1: str, in2: str, out_prefix: str,
    params: MergeParams | None = None,
    no_merge: bool = False,
    barcodes: PlateBarcodes | None = None,
    fmt: str = "fastq",
    device: str | torch.device = "cuda",
):
    """Amplicon modes (ePMAmplicon / ePMAmpliconNoMerge,
    MergeReadPairs.h:14-17): identify the originating plate well from the
    5'/3' MID barcodes, trim the barcodes, and write per-well files
    `prefix.WellN.SE.fastq` (merged) or `prefix.WellN.PE1/PE2.fastq`
    (no-merge).  Returns (n_pairs, n_welled, per-well counts)."""
    p = params or MergeParams()
    bc = barcodes or PlateBarcodes()
    k = bc.blen
    wells: dict[int, list] = {}
    n_pairs = n_welled = 0
    for blk1, blk2, r1, r2 in _pair_blocks(in1, in2):
        n_pairs += len(blk1.names)
        if no_merge:
            for i in range(len(blk1.names)):
                s1 = blk1.codes[i, : blk1.lengths[i]]
                s2 = blk2.codes[i, : blk2.lengths[i]]
                well = bc.map_pe(s1, s2)
                if well == 0:
                    continue
                n_welled += 1
                wells.setdefault(well, []).append(
                    (blk1.names[i], s1[k:], s2[k:])
                )
            continue
        merged, best_ov, _ = merge_pairs_arrays(r1, r2, p, device)
        rc2 = revcomp(r2)
        well_of = _wells_se(bc, r1, rc2, best_ov)
        for i in np.nonzero(well_of)[0]:
            n_welled += 1
            wells.setdefault(int(well_of[i]), []).append(
                (blk1.names[i], merged[i][k:-k], None))
    counts = {}
    for well, recs in sorted(wells.items()):
        counts[well] = len(recs)
        if no_merge:
            write_fastq(f"{out_prefix}.Well{well}.PE1.{fmt}",
                        ((n, a, None) for n, a, _ in recs))
            write_fastq(f"{out_prefix}.Well{well}.PE2.{fmt}",
                        ((n, b, None) for n, _, b in recs))
        else:
            path = f"{out_prefix}.Well{well}.SE.{fmt}"
            if fmt == "fasta":
                write_fasta(path, ((n, a) for n, a, _ in recs))
            else:
                write_fastq(path, ((n, a, None) for n, a, _ in recs))
    return n_pairs, n_welled, counts


def merge_overlaps(
    in1: str, in2: str, out_merged: str,
    params: MergeParams | None = None,
    out_unmerged1: str | None = None,
    out_unmerged2: str | None = None,
    device: str | torch.device = "cuda",
):
    p = params or MergeParams()
    n_pairs = n_merged = 0
    merged_recs = []
    un1, un2 = [], []
    for blk1, blk2, r1, r2 in _pair_blocks(in1, in2):
        merged, _, _ = merge_pairs_arrays(r1, r2, p, device)
        for i, m in enumerate(merged):
            n_pairs += 1
            if m is not None:
                n_merged += 1
                merged_recs.append((blk1.names[i], m))
            else:
                un1.append((blk1.names[i], blk1.codes[i, : blk1.lengths[i]], None))
                un2.append((blk2.names[i], blk2.codes[i, : blk2.lengths[i]], None))
    if out_merged.endswith((".fastq", ".fq")):
        write_fastq(out_merged, ((n, c, None) for n, c in merged_recs))
    else:
        write_fasta(out_merged, merged_recs)
    if out_unmerged1:
        write_fastq(out_unmerged1, un1)
    if out_unmerged2:
        write_fastq(out_unmerged2, un2)
    return n_pairs, n_merged
