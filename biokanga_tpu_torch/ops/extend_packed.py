"""Packed Hamming extension: 2-bit genome rows, XOR and bit counts.

Counterpart of biokanga_tpu/ops/extend_packed.py, same contract.  The
genome is packed 2 bits a base, 16 bases a uint32 word (first base most
significant), into overlapping rows of 16 words with a stride of 8 words
(128 bases), and a genome that holds Ns carries a second "N plane" of
0b11 lanes at N positions.  `hamming_extend_packed` counts, for each
candidate locus of each read, the positions where read and genome differ
or either side is N, over the read's true length.

Tensors read by the kernel keep uint32 words in int32 storage (same
bits); the plain version widens them to int64 (device.u32) because torch
has no unsigned 32-bit shifts or popcount on the CPU.

`hamming_extend_packed_win` counts over a window of its own for each
candidate (the assembler's overlap verification, assembly/scale_overlap):
the first win[b, c] bases of read b against the genome at loci[b, c].

On a CUDA tensor each wrapper launches its entry of
csrc/hamming_extend.cu or raises; on a CPU tensor it runs its plain
version (`hamming_extend_packed_plain`, `hamming_extend_packed_win_plain`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..device import U32_MASK, i32_bits, popcount32, u32, u32_from_numpy

MM_INVALID = 255
MM_WIN_INVALID = 1 << 30        # the windowed count where masked

BASES_PER_WORD = 16
ROW_STRIDE_BASES = 128          # row i starts at base 128*i
ROW_WORDS = 16                  # 256 bases per (overlapping) row
MAX_PACKED_READ_LEN = 4096      # multi-row gather cap (see PAD_ROWS)
# genome rows padded past the end so r0 + 2*(K-1) stays in-bounds for the
# largest multi-row window: W = 4096/16 = 256 words -> K = 17 -> 32 rows
PAD_ROWS = 40


@dataclass
class PackedGenome:
    rows: torch.Tensor           # (R, 16) int32 bits of uint32 words, N as 0
    n_rows: torch.Tensor | None  # (R, 16) int32 bits: 0b11 lanes at Ns
    length: int                  # genome length in bases

    @property
    def has_n(self) -> bool:
        return self.n_rows is not None


# _pack_words, _overlap_rows and pack_genome_numpy are copied from
# biokanga_tpu/ops/extend_packed.py:56-98 (numpy; that module imports jax).
def _pack_words(v: np.ndarray) -> np.ndarray:
    """(16k,) uint32 base codes -> (k,) uint32 packed words, MSB-first."""
    v = v.reshape(-1, BASES_PER_WORD)
    words = np.zeros(v.shape[0], dtype=np.uint32)
    for j in range(BASES_PER_WORD):
        words |= v[:, j] << np.uint32(2 * (15 - j))
    return words


def _overlap_rows(words: np.ndarray) -> np.ndarray:
    """(W,) words -> (W//8, 16) overlapping rows: row i = words[8i : 8i+16]."""
    W = len(words)
    R = W // 8
    out = np.zeros((R, ROW_WORDS), dtype=np.uint32)
    for j in range(ROW_WORDS):
        src = words[j : j + 8 * R : 8]
        out[: len(src), j] = src
    return out


def pack_genome_numpy(codes: np.ndarray):
    """int8 codes -> (rows, n_rows or None), both (R, 16) uint32 numpy."""
    n = len(codes)
    # enough full rows that row (n >> 7) + the widest multi-row window exist
    n_words = 8 * ((n // ROW_STRIDE_BASES) + PAD_ROWS)
    total = n_words * BASES_PER_WORD
    b = np.zeros(total, dtype=np.uint32)
    b[:n] = codes.astype(np.uint32)
    is_n = b >= 4
    b[is_n] = 0

    rows = _overlap_rows(_pack_words(b))
    if is_n[:n].any():
        n_rows = _overlap_rows(
            _pack_words(np.where(is_n, np.uint32(3), np.uint32(0)))
        )
    else:
        n_rows = None
    return rows, n_rows


def pack_genome(codes: np.ndarray, device: torch.device) -> PackedGenome:
    """Pack int8 genome codes on the host and move the rows to `device`."""
    rows, n_rows = pack_genome_numpy(codes)
    return PackedGenome(
        rows=u32_from_numpy(rows, device),
        n_rows=None if n_rows is None else u32_from_numpy(n_rows, device),
        length=len(codes),
    )


def pack_reads(reads: torch.Tensor, lengths: torch.Tensor):
    """Pack (B, L) int8 reads (N=4, padded) into (B, W) code words and
    (B, W) N-plane words, W = ceil(L/16), as int32 bits of uint32."""
    B, L = reads.shape
    W = -(-L // BASES_PER_WORD)
    pad = W * BASES_PER_WORD - L
    r = reads.to(torch.int64)
    if pad:
        r = torch.nn.functional.pad(r, (0, pad), value=4)
    is_n = r >= 4
    codes = torch.where(is_n, 0, r).reshape(B, W, BASES_PER_WORD)
    nlane = torch.where(is_n, 3, 0).reshape(B, W, BASES_PER_WORD)
    shifts = 2 * (15 - torch.arange(16, device=reads.device))
    return (i32_bits((codes << shifts).sum(2)),
            i32_bits((nlane << shifts).sum(2)))


def rows_for_words(W: int) -> int:
    """Number of stride-2 overlapping rows needed to cover a W-word window
    at any in-row offset (word offset 0..7): rows r0, r0+2, ... r0+2(K-1)
    are contiguous words[8*r0 : 8*r0 + 16*K]; need 8 + W <= 16*K."""
    return -(-(W + 8) // 16)


def gather_window_words(rows: torch.Tensor, loci: torch.Tensor, W: int):
    """(..., W) base-aligned window words (int64, unsigned) starting at base
    `loci`, read from the K = rows_for_words(W) stride-2 rows starting at
    row loci >> 7, each row index clamped to the table as in the JAX
    package.  Only the W + 1 words the alignment needs are gathered."""
    R = rows.shape[0]
    loci = loci.to(torch.int64)
    r0 = torch.clamp(loci >> 7, 0, R - 1)
    s = loci & 127
    s16 = (s >> 4)[..., None]
    sh = (2 * (s & 15))[..., None]
    i = s16 + torch.arange(W + 1, device=loci.device)       # word index
    r = torch.clamp(r0[..., None] + 2 * (i >> 4), 0, R - 1)
    w = u32(rows.reshape(-1)[r * ROW_WORDS + (i & 15)])
    hi = (w[..., :W] << sh) & U32_MASK
    lo = torch.where(sh > 0, w[..., 1:] >> (32 - sh), 0)
    return hi | lo


def _check_extend_args(pg, entry_starts, loci, valid, rcodes, rnlane,
                       lengths, win=None) -> None:
    B, C = loci.shape
    W = rcodes.shape[1]
    fn = "hamming_extend_packed" + ("" if win is None else "_win")
    if W > MAX_PACKED_READ_LEN // BASES_PER_WORD:
        raise ValueError(
            f"packed extension takes reads of at most {MAX_PACKED_READ_LEN} "
            f"bases, got {W} words")
    want = {"loci": (loci, torch.int32, (B, C)),
            "valid": (valid, torch.bool, (B, C)),
            "rcodes": (rcodes, torch.int32, (B, W)),
            "rnlane": (rnlane, torch.int32, (B, W)),
            "entry_starts": (entry_starts, torch.int32, None),
            "rows": (pg.rows, torch.int32, None)}
    if win is None:
        want["lengths"] = (lengths, torch.int32, (B,))
    else:
        want["win"] = (win, torch.int32, (B, C))
    if pg.n_rows is not None:
        want["n_rows"] = (pg.n_rows, torch.int32, tuple(pg.rows.shape))
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"{fn}: {name} is "
                             f"{tuple(t.shape)} {t.dtype}, want {shape} {dtype}")
        if t.device != loci.device:
            raise ValueError(f"{fn}: {name} on {t.device}, "
                             f"loci on {loci.device}")
    if loci.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {loci.device}")


def _window_mismatches(pg, entry_starts, loci, valid, rcodes, rnlane,
                       span):
    """Mismatches of the first span[b, c] bases of read b at loci[b, c]
    for the candidates that pass the flag, range and one-entry tests:
    (row, col, count) of those, the rest left out."""
    W = rcodes.shape[1]
    starts = entry_starts.to(torch.int64)
    loci64 = loci.to(torch.int64)
    last = loci64 + span - 1
    ent_a = torch.searchsorted(starts, loci64, right=True)
    ent_b = torch.searchsorted(starts, last, right=True)
    valid = valid & (loci64 >= 0) & (last < pg.length) & (ent_a == ent_b)

    # the words of valid candidates only: (N, W) for N of them
    row, col = valid.nonzero(as_tuple=True)
    at = loci[row, col]
    x = gather_window_words(pg.rows, at, W) ^ u32(rcodes)[row]
    x = x | u32(rnlane)[row]
    if pg.n_rows is not None:
        x = x | gather_window_words(pg.n_rows, at, W)
    lanes = (x | (x >> 1)) & 0x55555555

    # keep the first clamp(span - 16j, 0, 16) lanes of word j (MSB-first)
    wb = torch.arange(W, device=loci.device) * 16
    v = torch.clamp(span[row, col, None] - wb[None, :], 0, 16)
    lane_mask = torch.where(v == 0, 0, (0x55555555 << (2 * (16 - v))) & U32_MASK)
    return row, col, popcount32(lanes & lane_mask).sum(-1)


def hamming_extend_packed_plain(pg, entry_starts, loci, valid, rcodes,
                                rnlane, lengths):
    span = lengths.to(torch.int64)[:, None].expand(loci.shape)
    row, col, mm = _window_mismatches(pg, entry_starts, loci, valid, rcodes,
                                      rnlane, span)
    out = torch.full(loci.shape, MM_INVALID, dtype=torch.uint8,
                     device=loci.device)
    out[row, col] = torch.clamp(mm, max=MM_INVALID - 1).to(torch.uint8)
    return out


def hamming_extend_packed_win_plain(pg, entry_starts, loci, valid, rcodes,
                                    rnlane, win):
    span = torch.clamp(win.to(torch.int64), 0, rcodes.shape[1] * BASES_PER_WORD)
    row, col, mm = _window_mismatches(pg, entry_starts, loci, valid & (span > 0),
                                      rcodes, rnlane, span)
    out = torch.full(loci.shape, MM_WIN_INVALID, dtype=torch.int32,
                     device=loci.device)
    out[row, col] = mm.to(torch.int32)
    return out


def _launch(name: str, pg: PackedGenome, entry_starts, loci, valid, rcodes,
            rnlane, per, out):
    """Launch the C entry `name` of csrc/hamming_extend.cu; `per` is the
    lengths (B,) or the windows (B, C)."""
    B, C = loci.shape
    if not (B and C):
        return
    rows = pg.rows.contiguous()
    n_rows = None if pg.n_rows is None else pg.n_rows.contiguous()
    args = [t.contiguous() for t in (entry_starts, loci, valid, rcodes,
                                     rnlane, per)]
    lib = kernels.library()
    with torch.cuda.device(loci.device):
        err = getattr(lib, name)(
            rows.data_ptr(), None if n_rows is None else n_rows.data_ptr(),
            rows.shape[0], pg.length, args[0].data_ptr(), args[0].shape[0],
            *[t.data_ptr() for t in args[1:]], out.data_ptr(), B, C,
            rcodes.shape[1], kernels.stream_ptr(loci.device))
    kernels.check(err, name)


def hamming_extend_packed(pg: PackedGenome, entry_starts, loci, valid,
                          rcodes, rnlane, lengths, *, out=None):
    """(B, C) uint8 mismatch counts; MM_INVALID where masked.

    pg: packed genome; entry_starts (E+1,) int32; loci (B, C) int32;
    valid (B, C) bool; rcodes / rnlane (B, W) int32 bits (pack_reads);
    lengths (B,) int32.  `out`: a contiguous (B, C) uint8 tensor on
    loci's device to write the counts into and return."""
    _check_extend_args(pg, entry_starts, loci, valid, rcodes, rnlane,
                       lengths)
    if out is not None and (out.shape != loci.shape
                            or out.dtype != torch.uint8
                            or out.device != loci.device
                            or not out.is_contiguous()):
        raise ValueError(f"hamming_extend_packed: out is {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}, want a contiguous "
                         f"{tuple(loci.shape)} torch.uint8 on {loci.device}")
    if loci.device.type == "cpu":
        mm = hamming_extend_packed_plain(pg, entry_starts, loci, valid,
                                         rcodes, rnlane, lengths)
        return mm if out is None else out.copy_(mm)
    if out is None:
        out = torch.empty(loci.shape, dtype=torch.uint8, device=loci.device)
    if loci.numel():
        _launch("hamming_extend_packed", pg, entry_starts, loci, valid,
                rcodes, rnlane, lengths, out)
        hamming_extend_packed.launches += 1
    return out


hamming_extend_packed.launches = 0


def hamming_extend_packed_win(pg: PackedGenome, entry_starts, loci, valid,
                              rcodes, rnlane, win):
    """(B, C) int32 mismatch counts over the first win[b, c] bases of read
    b at loci[b, c]; MM_WIN_INVALID where masked.

    As hamming_extend_packed, with a window a candidate: win (B, C) int32
    is clipped to [0, 16 W]; a candidate needs win > 0, locus >= 0,
    locus + win - 1 < n and its window inside one entry.  The count is
    not clamped (long windows pass 255)."""
    _check_extend_args(pg, entry_starts, loci, valid, rcodes, rnlane, None,
                       win=win)
    if loci.device.type == "cpu":
        return hamming_extend_packed_win_plain(pg, entry_starts, loci, valid,
                                               rcodes, rnlane, win)
    out = torch.empty(loci.shape, dtype=torch.int32, device=loci.device)
    if loci.numel():
        _launch("hamming_extend_packed_win", pg, entry_starts, loci, valid,
                rcodes, rnlane, win, out)
        hamming_extend_packed_win.launches += 1
    return out


hamming_extend_packed_win.launches = 0
