"""Copy of biokanga_tpu/align/bam.py: the BAM/BGZF writer and its BAI
or CSI index, for `align -o *.bam`.

Parity role: CSAMfile + bgzf (libbiokanga/SAMfile.cpp, bgzf.cpp) — BAM
output with BGZF blocks and BAI indexes, auto-switching to CSI when any
reference exceeds 512 Mbp (ChangeLog:20 behavior).  Implemented against
the SAM/BAM spec v1.6 with stdlib zlib.  The readers (`read_bam`,
`read_bai`, `bgzf_decompress`) are not copied.
"""
from __future__ import annotations

import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
MAX_BLOCK = 0x10000 - 256

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_NIBBLE = {
    "=": 0, "A": 1, "C": 2, "M": 3, "G": 4, "R": 5, "S": 6, "V": 7,
    "T": 8, "W": 9, "Y": 10, "H": 11, "K": 12, "D": 13, "B": 14, "N": 15,
}
CSI_MIN_LEN = 1 << 29  # refs longer than this need CSI instead of BAI


def _bgzf_block(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    # 12B gzip header + 6B BSIZE extra field + cdata + 8B crc/isize
    bsize = len(cdata) + 26
    header = (
        b"\x1f\x8b\x08\x04" + b"\x00" * 6
        + struct.pack("<HBBHH", 6, 66, 67, 2, bsize - 1)
    )
    return (
        header + cdata
        + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    )


class BGZFWriter:
    def __init__(self, fileobj):
        self.f = fileobj
        self.buf = bytearray()
        self.coffset = 0  # compressed bytes flushed so far

    def vtell(self) -> int:
        """BGZF virtual file offset of the next byte to be written:
        (compressed offset of current block) << 16 | intra-block offset."""
        return (self.coffset << 16) | len(self.buf)

    def write(self, data: bytes):
        self.buf += data
        while len(self.buf) >= MAX_BLOCK:
            blk = _bgzf_block(bytes(self.buf[:MAX_BLOCK]))
            self.f.write(blk)
            self.coffset += len(blk)
            del self.buf[:MAX_BLOCK]

    def close(self):
        if self.buf:
            blk = _bgzf_block(bytes(self.buf))
            self.f.write(blk)
            self.coffset += len(blk)
            self.buf.clear()
        self.f.write(BGZF_EOF)


def _encode_cigar(cigar: str) -> list[int]:
    out = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            out.append((int(num) << 4) | _CIGAR_OPS.index(ch))
            num = ""
    return out


def _encode_record(
    qname: str, flag: int, ref_id: int, pos: int, mapq: int, cigar: str,
    next_ref: int, next_pos: int, tlen: int, seq: str, qual: bytes | None,
    tags: bytes = b"",
) -> bytes:
    name = qname.encode() + b"\x00"
    cig = _encode_cigar(cigar) if cigar not in ("*", "") else []
    l_seq = 0 if seq in ("*", "") else len(seq)
    packed_seq = bytearray()
    for i in range(0, l_seq, 2):
        hi = _SEQ_NIBBLE.get(seq[i], 15) << 4
        lo = _SEQ_NIBBLE.get(seq[i + 1], 15) if i + 1 < l_seq else 0
        packed_seq.append(hi | lo)
    q = b"\xff" * l_seq if not qual else bytes(qual[:l_seq])
    body = struct.pack(
        "<iiBBHHHiiii",
        ref_id, pos,
        len(name), mapq,
        _reg2bin(pos, pos + max(1, _ref_span(cig, l_seq))),
        len(cig), flag, l_seq, next_ref, next_pos, tlen,
    )
    body += name
    body += b"".join(struct.pack("<I", c) for c in cig)
    body += bytes(packed_seq) + q + tags
    return struct.pack("<i", len(body)) + body


def _ref_span(cig: list[int], l_seq: int) -> int:
    if not cig:
        return l_seq
    span = 0
    for c in cig:
        op = c & 0xF
        if _CIGAR_OPS[op] in "MDN=X":
            span += c >> 4
    return span


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _reg2bin_csi(beg: int, end: int, min_shift: int, depth: int) -> int:
    """Generalized reg2bin for CSI (htslib hts_reg2bin semantics)."""
    end -= 1
    level, s, t = depth, min_shift, 0
    while level > 0:
        if beg >> s == end >> s:
            # offset of this level's first bin: sum of 8^k for k<level
            t = ((1 << (3 * level)) - 1) // 7
            return t + (beg >> s)
        s += 3
        level -= 1
    return 0


class BAMIndexer:
    """Accumulates per-record (ref, beg, end, voffset) spans and writes a
    BAI (refs ≤512 Mbp) or CSI index — the reference's CSAMfile BAI/CSI
    generation with auto-switch (libbiokanga/SAMfile.h:21-53, ChangeLog:20).

    Requires records fed in coordinate-sorted order per standard BAM
    indexing semantics (chunks within a bin are merged when adjacent)."""

    LINEAR_SHIFT = 14  # 16 kb linear-index windows (BAI)
    CSI_MIN_SHIFT = 14
    CSI_DEPTH = 6  # covers refs up to 2^(14+3*6) = 4 Gbp

    def __init__(self, n_ref: int, ref_lengths):
        self.n_ref = n_ref
        self.use_csi = any(int(l) > CSI_MIN_LEN for l in ref_lengths)
        # per ref: {bin: [ [cnk_beg, cnk_end], ... ]}
        self.bins = [dict() for _ in range(n_ref)]
        self.linear = [dict() for _ in range(n_ref)]  # window -> min voffset
        self.loffset = [dict() for _ in range(n_ref)]  # bin -> min voffset
        self.n_no_coor = 0
        self.mapped = [0] * n_ref
        self.unmapped = [0] * n_ref

    def add(self, ref_id: int, beg: int, end: int, vbeg: int, vend: int,
            unmapped: bool = False):
        if ref_id < 0 or beg < 0:
            self.n_no_coor += 1
            return
        if unmapped:
            self.unmapped[ref_id] += 1
        else:
            self.mapped[ref_id] += 1
        if self.use_csi:
            b = _reg2bin_csi(beg, end, self.CSI_MIN_SHIFT, self.CSI_DEPTH)
        else:
            b = _reg2bin(beg, end)
        chunks = self.bins[ref_id].setdefault(b, [])
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1][1] = vend  # merge adjacent chunks
        else:
            chunks.append([vbeg, vend])
        lo = self.loffset[ref_id]
        if b not in lo or vbeg < lo[b]:
            lo[b] = vbeg
        lin = self.linear[ref_id]
        for w in range(beg >> self.LINEAR_SHIFT,
                       (max(beg, end - 1) >> self.LINEAR_SHIFT) + 1):
            if w not in lin or vbeg < lin[w]:
                lin[w] = vbeg

    def write(self, path: str):
        if self.use_csi:
            self._write_csi(path)
        else:
            self._write_bai(path)

    def _write_bai(self, path: str):
        out = bytearray(b"BAI\x01" + struct.pack("<i", self.n_ref))
        for r in range(self.n_ref):
            out += struct.pack("<i", len(self.bins[r]))
            for b in sorted(self.bins[r]):
                chunks = self.bins[r][b]
                out += struct.pack("<Ii", b, len(chunks))
                for cb, ce in chunks:
                    out += struct.pack("<QQ", cb, ce)
            lin = self.linear[r]
            n_intv = (max(lin) + 1) if lin else 0
            out += struct.pack("<i", n_intv)
            filled = 0
            for w in range(n_intv):
                filled = lin.get(w, filled)
                out += struct.pack("<Q", filled)
        out += struct.pack("<Q", self.n_no_coor)
        with open(path, "wb") as f:
            f.write(bytes(out))

    def _write_csi(self, path: str):
        body = bytearray(
            b"CSI\x01"
            + struct.pack("<iii", self.CSI_MIN_SHIFT, self.CSI_DEPTH, 0)
            + struct.pack("<i", self.n_ref)
        )
        for r in range(self.n_ref):
            body += struct.pack("<i", len(self.bins[r]))
            for b in sorted(self.bins[r]):
                chunks = self.bins[r][b]
                body += struct.pack(
                    "<IQi", b, self.loffset[r].get(b, 0), len(chunks)
                )
                for cb, ce in chunks:
                    body += struct.pack("<QQ", cb, ce)
        body += struct.pack("<Q", self.n_no_coor)
        with open(path, "wb") as f:
            w = BGZFWriter(f)
            w.write(bytes(body))
            w.close()


class BAMWriter:
    """Streams SAM-equivalent records into a BAM file."""

    def __init__(self, path: str, ref_names, ref_lengths, header_text="",
                 index: bool = False):
        self.path = path
        self.f = open(path, "wb")
        self.w = BGZFWriter(self.f)
        self.ref_index = {n: i for i, n in enumerate(ref_names)}
        self.indexer = (
            BAMIndexer(len(ref_names), ref_lengths) if index else None
        )
        text = header_text.encode()
        hdr = b"BAM\x01" + struct.pack("<i", len(text)) + text
        hdr += struct.pack("<i", len(ref_names))
        for n, l in zip(ref_names, ref_lengths):
            nb = n.encode() + b"\x00"
            hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", int(l))
        self.w.write(hdr)

    def write_record(self, qname, flag, rname, pos1, mapq, cigar,
                     rnext="*", pnext1=0, tlen=0, seq="*", qual=None,
                     nm=None):
        ref_id = self.ref_index.get(rname, -1)
        if rnext == "=":
            nref = ref_id
        else:
            nref = self.ref_index.get(rnext, -1)
        tags = b""
        if nm is not None:
            tags = b"NMC" + struct.pack("<B", min(int(nm), 255))
        vbeg = self.w.vtell()
        self.w.write(
            _encode_record(qname, flag, ref_id, pos1 - 1, mapq, cigar,
                           nref, pnext1 - 1, tlen, seq, qual, tags)
        )
        if self.indexer is not None:
            cig = _encode_cigar(cigar) if cigar not in ("*", "") else []
            l_seq = 0 if seq in ("*", "") else len(seq)
            span = max(1, _ref_span(cig, l_seq))
            self.indexer.add(ref_id, pos1 - 1, pos1 - 1 + span,
                             vbeg, self.w.vtell(), unmapped=bool(flag & 4))

    def close(self):
        self.w.close()
        self.f.close()
        if self.indexer is not None:
            ext = ".csi" if self.indexer.use_csi else ".bai"
            self.indexer.write(self.path + ext)


def sam_to_bam(sam_path: str, bam_path: str, index: bool = True) -> int:
    """Convert a SAM text file to BAM (+ .bai/.csi index when `index`).
    Records are coordinate-sorted (required for the index), matching the
    reference's sorted-BAM-with-index output path (libbiokanga/SAMfile.cpp)."""
    ref_names, ref_lens = [], []
    header_lines = []
    n = 0
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                header_lines.append(line)
                if line.startswith("@SQ"):
                    import re

                    m = re.search(r"SN:(\S+)", line)
                    l = re.search(r"LN:(\d+)", line)
                    ref_names.append(m.group(1))
                    ref_lens.append(int(l.group(1)))
    w = BAMWriter(bam_path, ref_names, ref_lens, "".join(header_lines),
                  index=index)
    ref_order = {name: i for i, name in enumerate(ref_names)}
    rows = []
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fl = line.rstrip("\n").split("\t")
            rows.append(fl)
    if index:
        rows.sort(key=lambda fl: (ref_order.get(fl[2], 1 << 30), int(fl[3])))
    for fl in rows:
        qual = None
        if fl[10] != "*":
            qual = bytes(ord(c) - 33 for c in fl[10])
        nm = None
        for tag in fl[11:]:
            if tag.startswith("NM:i:"):
                nm = int(tag[5:])
        w.write_record(
            fl[0], int(fl[1]), fl[2], int(fl[3]), int(fl[4]), fl[5],
            fl[6], int(fl[7]), int(fl[8]), fl[9], qual, nm,
        )
        n += 1
    w.close()
    return n
