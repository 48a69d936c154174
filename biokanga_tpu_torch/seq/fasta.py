"""Copy of biokanga_tpu/seq/fasta.py: FASTA/FASTQ streaming IO.

Host-side input pipeline feeding the device aligner — the analogue of the
reference's CFasta (libbiokanga/Fasta.cpp: gzip-transparent fasta/fastq
reader with Phred-schema autodetect) but designed as a batching iterator
producing fixed-width padded numpy blocks ready for device transfer.
"""
from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .encode import ascii_to_codes, codes_to_ascii


def _open_text(path: str) -> io.BufferedReader:
    """Open a possibly-gzipped file for binary reading (magic-byte sniff)."""
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")  # type: ignore[return-value]
    return f


@dataclass
class SeqRecord:
    name: str
    codes: np.ndarray  # int8 codes
    qual: np.ndarray | None = None  # raw phred+33 bytes if fastq


def _sniff_fastq(path: str) -> bool:
    with _open_text(path) as f:
        for line in f:
            line = line.strip()
            if line:
                return line.startswith(b"@")
    return False


def read_seqs(path: str) -> Iterator[SeqRecord]:
    """Stream records from a FASTA or FASTQ file (gzip transparent)."""
    if _sniff_fastq(path):
        yield from read_fastq(path)
    else:
        yield from read_fasta(path)


def read_fasta(path: str) -> Iterator[SeqRecord]:
    name = None
    chunks: list[bytes] = []
    with _open_text(path) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    yield SeqRecord(name, ascii_to_codes(b"".join(chunks)))
                name = line[1:].split()[0].decode() if line[1:] else ""
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield SeqRecord(name, ascii_to_codes(b"".join(chunks)))


def read_fastq(path: str) -> Iterator[SeqRecord]:
    with _open_text(path) as f:
        while True:
            hdr = f.readline()
            if not hdr:
                return
            hdr = hdr.rstrip()
            if not hdr:
                continue
            seq = f.readline().rstrip()
            f.readline()  # '+'
            qual = f.readline().rstrip()
            name = hdr[1:].split()[0].decode()
            yield SeqRecord(
                name,
                ascii_to_codes(seq),
                np.frombuffer(qual, dtype=np.uint8).copy(),
            )


_CS_LUT = np.full(256, -1, dtype=np.int8)
for _i, _c in enumerate(b"0123"):
    _CS_LUT[_c] = _i
_CS_LUT[ord(".")] = 4


def read_csfasta(path: str) -> Iterator[SeqRecord]:
    """Stream SOLiD .csfasta records: fasta-style headers, sequence lines
    of a primer base followed by color digits 0-3 ('.' = no-call).  The
    primer base and the primer-dependent first color are stripped; codes
    are color values 0..3 (4 = no-call), directly alignable against a
    colorspace index (the reference's colorspace read handling,
    SfxArrayV2.cpp:300-380)."""
    name = None
    chunks: list[bytes] = []

    def emit():
        raw = b"".join(chunks)
        colors = _CS_LUT[np.frombuffer(raw, dtype=np.uint8)]
        if len(colors) and colors[0] < 0:  # leading primer base char
            colors = colors[1:]
        if len(colors):  # drop primer-dependent first color
            colors = colors[1:]
        colors = np.where(colors < 0, 4, colors).astype(np.int8)
        return SeqRecord(name, colors)

    with _open_text(path) as f:
        for line in f:
            line = line.rstrip()
            if not line or line.startswith(b"#"):
                continue
            if line.startswith(b">"):
                if name is not None:
                    yield emit()
                name = line[1:].split()[0].decode() if line[1:] else ""
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield emit()


def write_csfasta(path: str, records, primer: str = "T") -> None:
    """records: iterable of (name, base_codes).  Each record is emitted as
    primer base + first color (primer->base0) + internal colors."""
    from .encode import to_colorspace

    pcode = ascii_to_codes(primer.encode())[0]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        for name, codes in records:
            full = np.concatenate(
                [np.array([pcode], dtype=np.int8),
                 np.asarray(codes, dtype=np.int8)]
            )
            colors = to_colorspace(full)
            txt = "".join("." if c >= 4 else str(int(c)) for c in colors)
            f.write(b">" + name.encode() + b"\n"
                    + primer.encode() + txt.encode() + b"\n")


def write_fasta(path: str, records, width: int = 70) -> None:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        for name, codes in records:
            f.write(b">" + name.encode() + b"\n")
            s = codes_to_ascii(codes)
            for i in range(0, len(s), width):
                f.write(s[i : i + width] + b"\n")


def write_fastq(path: str, records) -> None:
    """records: iterable of (name, codes, qual_bytes|None)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        for name, codes, qual in records:
            s = codes_to_ascii(codes)
            if qual is None:
                q = b"I" * len(s)
            elif isinstance(qual, (bytes, bytearray)):
                q = bytes(qual)
            else:
                q = np.asarray(qual, dtype=np.uint8).tobytes()
            f.write(b"@" + name.encode() + b"\n" + s + b"\n+\n" + q + b"\n")


@dataclass
class ReadBlock:
    """A fixed-width padded block of reads ready for device transfer."""

    names: list[str]
    codes: np.ndarray  # (B, Lmax) int8, padded with N (4)
    lengths: np.ndarray  # (B,) int32
    quals: np.ndarray | None = None  # (B, Lmax) uint8 phred+33, 0-padded


def read_blocks(
    path: str,
    block_size: int = 4096,
    max_len: int | None = None,
) -> Iterator[ReadBlock]:
    """Batch reads into fixed-width blocks (cf. reference cMaxReadsPerBlock=4096
    thread-dispatch blocks, biokanga/Aligner.h:16).

    FASTQ inputs go through the native C++ block parser when available
    (native/kanga_native.cpp parse_fastq_block — the CFasta hot path)."""
    if max_len is not None and _sniff_fastq(path):
        gen = _read_blocks_native(path, block_size, max_len)
        if gen is not None:
            yield from gen
            return
    elif _sniff_fastq(path):
        gen = _read_blocks_native(path, block_size, None)
        if gen is not None:
            yield from gen
            return
    yield from _read_blocks_py(path, block_size, max_len)


def _read_blocks_native(path, block_size, max_len):
    from ..utils.native import get_lib, parse_fastq_native

    if get_lib() is None:
        return None

    def gen():
        CHUNK = 32 << 20
        rem = b""
        eof = False
        with _open_text(path) as f:
            while True:
                # keep roughly enough buffered bytes for one full block
                need = block_size * ((max_len or 256) * 2 + 96)
                while not eof and len(rem) < need:
                    data = f.read(CHUNK)
                    if not data:
                        eof = True
                        break
                    rem += data
                if not rem.strip():
                    break
                if max_len is None:
                    # infer width from the first ~1000 records (sequence =
                    # every 4th line); variable-length tails beyond this
                    # sample would be clamped, so take a small margin
                    lines = rem[: 1 << 20].split(b"\n")
                    seqlens = [len(l) for l in lines[1:4000:4]]
                    w = max(seqlens[:1000] or [1])
                else:
                    w = max_len
                out = parse_fastq_native(rem, block_size, w)
                if out is None:
                    return
                names, codes, lengths, quals, consumed = out
                if len(names) == 0:
                    if eof:
                        break
                    continue
                rem = rem[consumed:]
                yield ReadBlock(names, codes, lengths, quals)
                if eof and not rem.strip():
                    break

    return gen()


def _read_blocks_py(
    path: str,
    block_size: int = 4096,
    max_len: int | None = None,
    records: Iterator[SeqRecord] | None = None,
) -> Iterator[ReadBlock]:
    names: list[str] = []
    seqs: list[np.ndarray] = []
    quals: list[np.ndarray | None] = []
    any_qual = False

    def flush() -> ReadBlock:
        nonlocal names, seqs, quals, any_qual
        lmax = max_len or max(len(s) for s in seqs)
        B = len(seqs)
        codes = np.full((B, lmax), 4, dtype=np.int8)
        lengths = np.zeros(B, dtype=np.int32)
        qarr = np.zeros((B, lmax), dtype=np.uint8) if any_qual else None
        for i, s in enumerate(seqs):
            L = min(len(s), lmax)
            codes[i, :L] = s[:L]
            lengths[i] = L
            if qarr is not None and quals[i] is not None:
                qarr[i, :L] = quals[i][:L]
        blk = ReadBlock(names, codes, lengths, qarr)
        names, seqs, quals, any_qual = [], [], [], False
        return blk

    for rec in records if records is not None else read_seqs(path):
        names.append(rec.name)
        seqs.append(rec.codes)
        quals.append(rec.qual)
        any_qual = any_qual or rec.qual is not None
        if len(seqs) >= block_size:
            yield flush()
    if seqs:
        yield flush()


def read_csfasta_blocks(
    path: str, block_size: int = 4096, max_len: int | None = None
) -> Iterator[ReadBlock]:
    """Batch SOLiD .csfasta color reads into fixed-width blocks."""
    yield from _read_blocks_py(path, block_size, max_len,
                               records=read_csfasta(path))
