"""The seed stage of `align_core` around the dedup sort (#1, ops/sort.py).

    seed_rows(didx, reads, lengths, rc, offs, core_len, H, owned, occ_skip)
        -> (flat, overflow)
    dedup_pack(srt, overflow, reads, lengths, rc, cand_cap, occ_skip)
        -> (loci, valid, n_over, trunc, rcodes, rnlane)

`seed_rows` takes one strand of a batch: the (B, L) int8 reads, or,
with `rc`, their reverse complements (`rc_reads`), taken from the reads
and their (B,) int32 lengths.  It packs the `core_len` bases at each of
the S core offsets `offs` (an int32 tensor on the reads' device) into
query bounds (ops/lookup.pack_read_kmers), finds each core's range of
the index's sorted suffixes (ops/lookup.seed_range_lookup: the LUT
bucket, searched where core_len > lut_bases), and fills each core's H
slots of the (B, S*H) int32 row: slot j holds the diagonal pos - offset
of the range's j-th position where j < min(size, H), the core has no N,
the diagonal is >= 0 and, with `owned`, below it; INT32_MAX otherwise.
`overflow` (B, S) bool marks the cores whose range passes H (never one
with an N); with `occ_skip` such a core fills no slot.

`dedup_pack` takes those rows once sort_rows has sorted them: a slot
equal to its left neighbour is a duplicate, the first C = min(cand_cap,
S*H) columns are the (B, C) int32 loci and their bool valid flags,
`trunc` (B,) marks a row with a valid slot past C, and without occ_skip
also a row with any core over H; `n_over` (B,) int32 counts the cores
over H (0 without occ_skip).  With them the strand's read packed as
ops/extend_packed.pack_reads packs it: the extension's (#3) inputs.

Each takes a keyword-only `out=` (the tuple of its outputs) that it
writes into and returns: the align engine's CUDA graphs read the
outputs from static buffers (align/pipeline.py).  On a CUDA tensor each
wrapper launches its entry of csrc/seed_rows.cu (see the source note
there) or raises; on a CPU tensor it runs its plain version
(`seed_rows_plain`, `dedup_pack_plain`: PyTorch op chains).  The
kernel reads the rows as sorted: a row's first sentinel ends it.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..device import I32_MAX
from ..utils.trace import count
from .extend_packed import BASES_PER_WORD, pack_reads
from .lookup import pack_read_kmers, seed_range_lookup

# three int32 a core of a row in the kernel's 48 KB of shared memory
MAX_SEED_CORES = 4096
# owned when the caller gives none: above every int32 diagonal
_ALL_OWNED = 1 << 40


def rc_reads(reads: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-read reverse complement keeping padding at the tail."""
    L = reads.shape[1]
    flipped = reads.flip(1)
    rc = torch.where(flipped >= 4, flipped, 3 - flipped).to(reads.dtype)
    # rc has (L - len) pad codes at the front; roll left per read
    col = (torch.arange(L, device=reads.device)[None, :]
           + (L - lengths.to(torch.int64))[:, None]) % L
    return torch.gather(rc, 1, col)


def seed_rows_plain(didx, reads, lengths, rc: bool, offs, core_len: int,
                    H: int, owned, occ_skip: bool):
    seq = rc_reads(reads, lengths) if rc else reads
    S = offs.shape[0]
    B = seq.shape[0]
    dev = seq.device
    qlh, qll, qhh, qhl, has_n = pack_read_kmers(seq, offs, core_len)
    start, end = seed_range_lookup(
        didx.key_hi, didx.key_lo, didx.lut, didx.lut_bases, qlh, qll, qhh,
        qhl, core_len=core_len, max_steps=didx.max_bsearch_steps,
    )
    size = end - start
    # N-containing cores give junk ranges; they never count as over-occurring
    overflow = (size > H) & ~has_n
    if occ_skip:
        size = torch.where(overflow, 0, size)
    j = torch.arange(H, device=dev)
    slot = torch.clamp(start[..., None] + j, max=didx.pos_sorted.shape[0] - 1)
    pos = didx.pos_sorted[slot]                                # (B, S, H)
    in_range = j < torch.clamp(size, max=H)[..., None]
    diag = pos - offs[None, :, None]
    valid = in_range & ~has_n[..., None] & (diag >= 0)
    if owned is not None:
        valid = valid & (diag < owned)
    return torch.where(valid, diag, I32_MAX).reshape(B, S * H), overflow


def dedup_pack_plain(srt, overflow, reads, lengths, rc: bool, cand_cap: int,
                     occ_skip: bool):
    B, SH = srt.shape
    dev = srt.device
    dup = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                     srt[:, 1:] == srt[:, :-1]], dim=1)
    v = (srt != I32_MAX) & ~dup
    C = min(cand_cap, SH)
    if C < SH:
        trunc = v[:, C:].any(dim=1)
        srt, v = srt[:, :C], v[:, :C]
    else:
        trunc = torch.zeros(B, dtype=torch.bool, device=dev)
    if occ_skip:
        # skipped cores weaken the pigeonhole bound (inexact_rows)
        n_over = overflow.sum(dim=1, dtype=torch.int32)
    else:
        n_over = torch.zeros(B, dtype=torch.int32, device=dev)
        trunc = trunc | overflow.any(dim=1)
    rcodes, rnlane = pack_reads(rc_reads(reads, lengths) if rc else reads,
                                lengths)
    return srt, v, n_over, trunc, rcodes, rnlane


def _check(name: str, device, *want) -> None:
    """Raise unless each (arg, tensor, dtype, shape or None) matches and
    lies on `device`, a CPU or CUDA device."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    for arg, t, dtype, shape in want:
        if (t.dtype != dtype or t.device != device
                or (shape is not None and t.shape != shape)):
            raise ValueError(f"{name}: {arg} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, want {shape} {dtype} on "
                             f"{device}")


def _check_out(name: str, out, like, device) -> None:
    if len(out) != len(like):
        raise ValueError(f"{name}: out holds {len(out)} tensors, want "
                         f"{len(like)}")
    _check(name, device, *(("out", o, dtype, shape)
                           for o, (dtype, shape) in zip(out, like)))
    if not all(o.is_contiguous() for o in out):
        raise ValueError(f"{name}: out holds a tensor that is not "
                         f"contiguous")


def _into(out, got):
    if out is None:
        return got
    for o, g in zip(out, got):
        o.copy_(g)
    return tuple(out)


def seed_rows(didx, reads: torch.Tensor, lengths: torch.Tensor, rc: bool,
              offs: torch.Tensor, core_len: int, H: int, owned,
              occ_skip: bool, *, out=None):
    """(flat (B, S*H) int32, overflow (B, S) bool) of one strand (into
    the pair `out`); see the module's note."""
    B, L = reads.shape
    S = offs.shape[0]
    dev = reads.device
    _check("seed_rows", dev, ("reads", reads, torch.int8, None),
           ("lengths", lengths, torch.int32, (B,)),
           ("offs", offs, torch.int32, (S,)),
           ("key_hi", didx.key_hi, torch.int32, None),
           ("key_lo", didx.key_lo, torch.int32, didx.key_hi.shape),
           ("lut", didx.lut, torch.int32, (4 ** didx.lut_bases + 1,)),
           ("pos_sorted", didx.pos_sorted, torch.int32, None))
    if not 1 <= core_len <= 32 or not 0 <= didx.lut_bases <= 16:
        raise ValueError(f"seed_rows: core_len {core_len} outside 1..32 or "
                         f"lut_bases {didx.lut_bases} outside 0..16")
    shapes = ((torch.int32, (B, S * H)), (torch.bool, (B, S)))
    if out is not None:
        _check_out("seed_rows", out, shapes, dev)
    if dev.type == "cpu":
        return _into(out, seed_rows_plain(didx, reads, lengths, rc, offs,
                                          core_len, H, owned, occ_skip))
    if S > MAX_SEED_CORES:
        raise ValueError(f"seed_rows: {S} cores, the kernel takes at most "
                         f"{MAX_SEED_CORES}")
    if out is None:
        out = tuple(torch.empty(shape, dtype=dtype, device=dev)
                    for dtype, shape in shapes)
    if B and S and H:
        args = [t.contiguous() for t in (reads, lengths, offs, didx.key_hi,
                                         didx.key_lo, didx.lut,
                                         didx.pos_sorted)]
        lib = kernels.library()
        with torch.cuda.device(dev):
            err = lib.seed_rows(
                args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(),
                B, L, S, core_len, H, int(rc), int(occ_skip),
                _ALL_OWNED if owned is None else int(owned),
                args[3].data_ptr(), args[4].data_ptr(), args[3].shape[0],
                args[5].data_ptr(), didx.lut_bases,
                min(didx.max_bsearch_steps, 31), args[6].data_ptr(),
                args[6].shape[0], out[0].data_ptr(), out[1].data_ptr(),
                kernels.stream_ptr(dev))
        kernels.check(err, "seed_rows")
        seed_rows.launches += 1
        count("seed.kernel_calls", 1)
    return tuple(out)


seed_rows.launches = 0


def dedup_pack(srt: torch.Tensor, overflow: torch.Tensor,
               reads: torch.Tensor, lengths: torch.Tensor, rc: bool,
               cand_cap: int, occ_skip: bool, *, out=None):
    """(loci, valid, n_over, trunc, rcodes, rnlane) of one strand's sorted
    rows (into the tuple `out`); see the module's note."""
    B, SH = srt.shape
    S = overflow.shape[1] if overflow.dim() == 2 else -1
    L = reads.shape[1]
    dev = srt.device
    _check("dedup_pack", dev, ("srt", srt, torch.int32, None),
           ("overflow", overflow, torch.bool, (B, S)),
           ("reads", reads, torch.int8, (B, L)),
           ("lengths", lengths, torch.int32, (B,)))
    C = min(cand_cap, SH)
    W = -(-L // BASES_PER_WORD)
    shapes = ((torch.int32, (B, C)), (torch.bool, (B, C)),
              (torch.int32, (B,)), (torch.bool, (B,)),
              (torch.int32, (B, W)), (torch.int32, (B, W)))
    if out is not None:
        _check_out("dedup_pack", out, shapes, dev)
    if dev.type == "cpu":
        return _into(out, dedup_pack_plain(srt, overflow, reads, lengths, rc,
                                           cand_cap, occ_skip))
    if out is None:
        out = tuple(torch.empty(shape, dtype=dtype, device=dev)
                    for dtype, shape in shapes)
    if B:
        args = [t.contiguous() for t in (srt, overflow, reads, lengths)]
        lib = kernels.library()
        with torch.cuda.device(dev):
            err = lib.dedup_pack(
                *[t.data_ptr() for t in args], B, SH, S, C, L, W, int(rc),
                int(occ_skip), *[t.data_ptr() for t in out],
                kernels.stream_ptr(dev))
        kernels.check(err, "dedup_pack")
        dedup_pack.launches += 1
    return tuple(out)


dedup_pack.launches = 0
