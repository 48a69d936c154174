"""Index build on the device, and the chunk-cycling big-genome aligner.

Counterpart of biokanga_tpu/index/device_build.py: `device_build_index`
(:142), its packed rows (`_packed_rows`, which also serves as the JAX
package's `_pack_only`) and `DeviceBuildChunkedAligner` (:187), which
builds a chunk each time it is needed; `build_resident_chunks` builds
every chunk once and keeps them all on the device.  Only
the int8 codes go to the device; the 32-base keys, their sorted order,
the prefix LUT and the packed 2-bit rows are computed there, and the
result is a DeviceIndex like the one `index/device.to_device` makes from
a host build.  The JAX package sorts (key_hi, key_lo, pos) in one 3-key
`jax.lax.sort`; here two stable `torch.sort` passes, by key_lo and then
by key_hi, over positions in ascending order give that order exactly.
The keys are sorted and kept as int32 `device.key32` keys, whose signed
order is the unsigned order of the JAX package's uint32 words.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..align.params import AlignParams, min_core_len
from ..device import i32_bits, key32, resolve_device
from ..utils.trace import count
from ..ops.extend_packed import (
    BASES_PER_WORD,
    PAD_ROWS,
    ROW_STRIDE_BASES,
    ROW_WORDS,
    PackedGenome,
)
from .chunked import ResidentChunks, plan_chunks
from .device import MAX_CAND_PER_CORE, DeviceIndex


def _keys(codes: torch.Tensor):
    """(hi, lo) int64 unsigned 32-bit keys of every position, views of one
    tensor: hi packs
    bases [i, i+16), lo bases [i+16, i+32); N and bases past the end
    pack as 0 (A)."""
    n = codes.shape[0]
    b = torch.where(codes >= 4, 0, codes).to(torch.int64)
    bp = torch.cat([b, torch.zeros(32, dtype=torch.int64, device=b.device)])
    hi = torch.zeros(n + 16, dtype=torch.int64, device=b.device)
    for j in range(16):
        hi += bp[j : j + n + 16] << (2 * (15 - j))
    return hi[:n], hi[16 : n + 16]


def _packed_rows(codes: torch.Tensor, with_n: bool):
    """ops/extend_packed.pack_genome on the device: (rows, n_rows or None),
    both (R, 16) int32 bits of uint32 words.  As in the JAX device build,
    the N plane marks every base past the genome's end as N."""
    n = codes.shape[0]
    n_words = 8 * (n // ROW_STRIDE_BASES + PAD_ROWS)
    total = n_words * BASES_PER_WORD
    dev = codes.device
    shifts = 2 * (15 - torch.arange(BASES_PER_WORD, device=dev))

    def rows_of(v: torch.Tensor) -> torch.Tensor:
        words = i32_bits((v.reshape(-1, BASES_PER_WORD) << shifts).sum(1))
        wp = torch.cat([words, torch.zeros(16, dtype=torch.int32,
                                           device=dev)])
        return wp.unfold(0, ROW_WORDS, 8)[: n_words // 8].contiguous()

    is_n = codes >= 4
    bb = torch.zeros(total, dtype=torch.int64, device=dev)
    bb[:n] = torch.where(is_n, 0, codes)
    rows = rows_of(bb)
    if not with_n:
        return rows, None
    del bb
    nn = torch.full((total,), 3, dtype=torch.int64, device=dev)
    nn[:n] = is_n.to(torch.int64) * 3
    return rows, rows_of(nn)


def device_build_index(codes: np.ndarray, entry_starts: np.ndarray,
                       lut_bases: int = 12, owned: int | None = None,
                       device: torch.device | str = "cuda",
                       true_len: int | None = None,
                       with_keys: bool = True) -> DeviceIndex:
    """Build a DeviceIndex on `device` from host int8 codes (N = 4) and
    the (E+1,) entry starts.

    `owned` sets the chunk ownership limit (index/chunked.py).
    `true_len` is the real sequence length when `codes` arrives N-padded
    to a fixed shape: the packed genome's length bounds valid windows to
    it, and when [0, true_len) holds no N the N plane is left out.
    `with_keys=False` builds a LUT-only index: positions sorted by the
    16-base hi key alone and one-element key tensors; the engine then
    serves only cores of at most lut_bases bases."""
    device = torch.device(device)
    codes_h = np.ascontiguousarray(codes, np.int8)
    n = len(codes_h)
    tl = n if true_len is None else int(true_len)
    interior_has_n = bool(np.any(codes_h[:tl] >= 4))
    codes_d = torch.from_numpy(codes_h).to(device)
    hi, lo = _keys(codes_d)

    # LUT: bucket starts by P-base prefix, counted over the unsorted keys
    P = lut_bases
    cnt = torch.bincount(hi >> (32 - 2 * P), minlength=4**P)
    lut = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                     torch.cumsum(cnt, 0)]).to(torch.int32)
    del cnt

    # 32-bit keys from here on: half the memory of the sorts and the index
    hi32 = key32(hi)
    lo32 = key32(lo) if with_keys else None
    del hi, lo
    # (key_hi, key_lo, pos) order: stable sorts, least significant key first
    if with_keys:
        order = torch.sort(lo32, stable=True).indices
        order = order[torch.sort(hi32[order], stable=True).indices]
        key_hi, key_lo = hi32[order], lo32[order]
    else:
        order = torch.sort(hi32, stable=True).indices
        key_hi = hi32[order[:1]]
        key_lo = key_hi
    del hi32, lo32

    pad = MAX_CAND_PER_CORE + (-(n + MAX_CAND_PER_CORE) % 64)
    pos = torch.cat([order.to(torch.int32),
                     torch.zeros(pad, dtype=torch.int32, device=device)])
    del order
    rows, n_rows = _packed_rows(codes_d, interior_has_n)
    max_bucket = int(torch.diff(lut).max()) if n else 0
    return DeviceIndex(
        genome=codes_d,
        entry_starts=torch.from_numpy(
            np.asarray(entry_starts, np.int32)).to(device),
        pos_sorted=pos,
        key_hi=key_hi,
        key_lo=key_lo,
        lut=lut,
        lut_bases=P,
        entry_names=[],
        packed=PackedGenome(rows=rows, n_rows=n_rows, length=tl),
        max_bsearch_steps=max(1, int(np.ceil(np.log2(max_bucket + 1))) + 1),
        owned=None if owned is None else int(owned),
    )


def chunk_pad(plans) -> int:
    """The one length every chunk is N-padded to: past the longest slice,
    a multiple of 128 (as the JAX package pads it)."""
    return (max(p[2] for p in plans) // 128 + 1) * 128


def chunk_codes(codes: np.ndarray, entry_starts: np.ndarray, plan,
                pad_n: int):
    """(codes (pad_n,) int8, local entry starts) of one chunk's slice."""
    base, _, slice_len = plan
    out = np.full(pad_n, 4, np.int8)
    out[:slice_len] = codes[base: base + slice_len]
    es = np.clip(np.asarray(entry_starts, np.int64) - base, 0, slice_len)
    return out, es


def build_resident_chunks(codes: np.ndarray, entry_starts: np.ndarray,
                          entry_names: list[str], lut_bases: int = 12,
                          max_chunk: int = 256_000_000,
                          overlap: int = 2048,
                          device: torch.device | str = "cuda"
                          ) -> ResidentChunks:
    """Build every chunk of plan_chunks(total, max_chunk, overlap) on
    `device` with `device_build_index`, one after another, and keep them
    all there.  `codes`: the whole genome's int8 codes (N = 4);
    `entry_starts`, `entry_names`: its (E+1,) global entry starts and its
    entries' names.  Each chunk is N-padded to one length and carries its
    ownership limit and true length, as DeviceBuildChunkedAligner builds
    it, with its keys; each build's temporaries are freed before the next
    starts."""
    device = resolve_device(device)
    starts = np.asarray(entry_starts, np.int64)
    plans = plan_chunks(int(starts[-1]), max_chunk, overlap)
    pad_n = chunk_pad(plans)
    chunks = []
    for plan in plans:
        c, es = chunk_codes(codes, starts, plan, pad_n)
        chunks.append(device_build_index(c, es, lut_bases, owned=plan[1],
                                         device=device, true_len=plan[2]))
        del c
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
    return ResidentChunks(
        chunks=chunks, bases=np.asarray([p[0] for p in plans], np.int64),
        owned=np.asarray([p[1] for p in plans], np.int64),
        entry_names=list(entry_names), entry_starts=starts, overlap=overlap)


class DeviceBuildChunkedAligner:
    """Big-genome aligner on one device: cycle genome-range chunks through
    device memory, building each chunk's index on the device (only its
    codes are uploaded), align every read block against it, then merge
    exactly (parallel/chunked.merge_chunk_results).  The form of the
    reference's block-at-a-time SetTargBlock sweep
    (libbiokanga/SfxArrayV2.cpp:1903) at > 2^31-base scale.

    Every chunk is N-padded to one length, `pad_n`, as in the JAX package;
    the engine derives its core length from that padded length, so the
    padding is part of the result (index/chunked.py).
    """

    def __init__(self, seqs: list[tuple[str, np.ndarray]],
                 params: AlignParams | None = None,
                 max_chunk: int = 256_000_000, overlap: int = 2048,
                 lut_bases: int = 12, device: torch.device | str = "cuda",
                 with_keys: bool | None = None):
        self.params = params or AlignParams()
        self.lut_bases = lut_bases
        self.device = resolve_device(device)
        # None: LUT-only chunks whenever every core of the classic ladder
        # fits the LUT prefix (_auto_with_keys)
        self.with_keys = with_keys
        self.overlap = overlap
        self.entry_names = [nm for nm, _ in seqs]
        starts = np.zeros(len(seqs) + 1, np.int64)
        for i, (_, s) in enumerate(seqs):
            starts[i + 1] = starts[i] + len(s)
        self.entry_starts = starts
        total = int(starts[-1])
        self._codes = (
            seqs[0][1] if len(seqs) == 1
            else np.concatenate([s for _, s in seqs])
        )
        self.plans = plan_chunks(total, max_chunk, overlap)
        self.bases = np.asarray([p[0] for p in self.plans], np.int64)
        self.pad_n = chunk_pad(self.plans)
        self._engine = None
        self.build_s: list[float] = []  # wall per engine_for chunk build
        # build timing synchronises the device after each chunk build
        self.time_builds: bool = False

    @property
    def num_chunks(self) -> int:
        return len(self.plans)

    def engine_for(self, k: int):
        """Build chunk k on the device and return the shared AlignEngine
        pointed at it (the previous chunk is dropped first)."""
        from ..align.pipeline import AlignEngine

        if self._engine is not None:
            self._engine.didx = None
        t0 = time.monotonic()
        count("chunked.uploads", 1)
        didx = self.build_chunk(k)
        if self.time_builds and didx.device.type == "cuda":
            torch.cuda.synchronize(didx.device)
        if len(self.build_s) >= 4096:
            del self.build_s[: 2048]  # bound unattended growth
        self.build_s.append(time.monotonic() - t0)
        if self._engine is None:
            self._engine = AlignEngine(didx, self.params)
        else:
            self._engine.didx = didx
        return self._engine

    def _chunk_codes(self, k: int):
        codes, es = chunk_codes(self._codes, self.entry_starts,
                                self.plans[k], self.pad_n)
        return codes, es, self.plans[k][1]

    def _auto_with_keys(self) -> bool:
        if self.with_keys is not None:
            return self.with_keys
        # keys are read only when a lookup's core exceeds the LUT prefix:
        # classic core_len = max(ladder, read_len // (max_tot_mm + delta)),
        # over every read length the engine takes
        if self.params.max_subs_per100 == 0:
            return True
        delta = 1 if self.params.min_edit_dist == 1 else 2
        read_term = max(
            L // (min(max(1, int(0.5 + L * self.params.max_subs_per100
                              / 100.0)), 63) + delta)
            for L in range(20, 4097)
        )
        need = max(min_core_len(self.pad_n, self.params.mode),
                   min(read_term, 32))
        return need > self.lut_bases

    def build_chunk(self, k: int) -> DeviceIndex:
        codes, es, own = self._chunk_codes(k)
        return device_build_index(codes, es, self.lut_bases, owned=own,
                                  device=self.device,
                                  true_len=self.plans[k][2],
                                  with_keys=self._auto_with_keys())

    def packed_chunk(self, k: int):
        """(codes tensor, PackedGenome, local entry starts) of chunk k
        without the suffix sort: all the PE windowed rescue and the SNP
        pileup need."""
        codes, es, _ = self._chunk_codes(k)
        codes_d = torch.from_numpy(codes).to(self.device)
        rows, n_rows = _packed_rows(
            codes_d, bool(np.any(codes[: self.plans[k][2]] >= 4)))
        return codes_d, PackedGenome(rows=rows, n_rows=n_rows,
                                     length=self.plans[k][2]), es

    def align_blocks(self, blocks, progress=None,
                     checkpoint_dir: str | None = None):
        """Chunk-major streaming; returns merged dicts per block (int64
        global loci).  checkpoint_dir: resumable sweep — completed
        (chunk, block) cells load from disk, and a chunk is built only
        while it still has missing cells."""
        from ..parallel.chunked import merge_chunk_results

        ckpt = None
        if checkpoint_dir:
            from ..utils.checkpoint import SweepCheckpoint, config_signature

            sig = config_signature(
                [self.bases, np.asarray([p[1] for p in self.plans]),
                 self.params, self.lut_bases,
                 [(r.shape, int(l.sum())) for r, l in blocks]]
            )
            ckpt = SweepCheckpoint(checkpoint_dir, sig)

        engine = None
        per_block = [[] for _ in blocks]
        for k in range(self.num_chunks):
            need = [b for b in range(len(blocks))
                    if ckpt is None or not ckpt.has(k, b)]
            if need:
                engine = self.engine_for(k)
            for b, (reads, lengths) in enumerate(blocks):
                if ckpt is not None and b not in need:
                    per_block[b].append(ckpt.load(k, b))
                    continue
                res = engine.align_with_rescue(reads, lengths)
                if ckpt is not None:
                    ckpt.save(k, b, res)
                per_block[b].append(res)
            if progress:
                progress(k)
        return [merge_chunk_results(per_block[b], self.bases, lengths,
                                    self.params, self.device)
                for b, (_, lengths) in enumerate(blocks)]

    def align(self, reads: np.ndarray, lengths: np.ndarray) -> dict:
        return self.align_blocks([(reads, lengths)])[0]
