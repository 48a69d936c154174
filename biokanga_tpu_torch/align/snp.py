"""Copy of biokanga_tpu/align/snp.py: SNP calling from accepted
alignments (`align -O`), with the pileup on the index's device.

Capability match for CAligner::ProcessSNPs/OutputSNPs
(biokanga/Aligner.cpp:7609,6803): per-locus pileup -> binomial p-value
against a LOCAL background substitution rate -> Benjamini-Hochberg FDR ->
CSV (reference column layout, Aligner.cpp:7648) and VCF output.

Reference numeric behavior reproduced:
- MinSNPreads default 5 (Aligner.h:50), NonRefPcnt default 25%
- local background window 51 bp (cSNPBkgndRateWindow, Aligner.h:27),
  locus' own counts excluded (Aligner.cpp:6985-6994)
- rate floors: GlobalSeqErrRate = max(0.01, TotMM/(1+TotM+TotMM))
  (cMinSeqErrRate Aligner.h:54, Aligner.cpp:6881); local rate floored by
  global; loci with local rate > 0.20 skipped (cMaxBkgdNoiseThres)
- PValue = 1 - BinomialCDF(TotBases, NumNonRefBases, LocalSeqErrRate)
  (Aligner.cpp:7093)
- BH step-down: sorted ascending, accept while P < rank/N * QValue
  (Aligner.cpp:7120-7126), QValue default 0.05

The pileup planes (counts (n, 4), match (n,), mismatch (n,), int32) live
on the index's device; one batch is one scatter-add per plane, exact in
any order because the adds are integers, and `finalize` copies the planes
to the host once.  The window and statistics pass, the haplotypes, the
centroids and the writers are the JAX package's host numpy, copied as
they are.

`ChunkedPileup` is the pileup of a chunked-index run: one chunk's planes
on the device at a time, the overlap tail folded into the next chunk,
and candidate compaction on the device in segments of SNP_SEGMENT bases
(`_seg_candidates`), so only candidates reach the host.  The JAX
package's chunk planes are uint16, whose counts wrap past 65,535; torch
has little uint16 support on CUDA, so the planes here are int32 and the
wrap is applied where the planes are read (`& 0xFFFF`): the values read
equal the JAX package's at any depth.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy.stats import binom as _binom

from ..seq.encode import revcomp
from .pipeline import _rc_reads

C_SNP_BKGND_RATE_WINDOW = 51   # Aligner.h:27
C_MAX_BKGD_NOISE_THRES = 0.20  # Aligner.h:51
C_MIN_SEQ_ERR_RATE = 0.01      # Aligner.h:54

# ChunkedPileup: plane bases compacted at a time (with a window flank on
# each side), and the mask that gives the JAX package's uint16 plane value
SNP_SEGMENT = 1 << 25
U16_MASK = 0xFFFF


@dataclass(frozen=True)
class SNPParams:
    min_snp_reads: int = 5       # -p MinSNPreads (Aligner.h:50)
    snp_nonref_pcnt: float = 0.25  # -1 snpnonrefpcnt/100 (default 25)
    qvalue: float = 0.05         # -P qvalue


def pileup_batch(counts, match, mismatch, genome, loci, seqs, lengths,
                 accept):
    """Accumulate one batch of accepted alignments into the pileup planes,
    in place; returns (counts, match, mismatch).

    counts: (n, 4) int32; match/mismatch: (n,) int32; genome: (n,) int8,
    all on one device.  loci: (B,) int32 alignment starts; seqs: (B, L)
    int8 ALIGNED-strand codes (revcomp already applied for '-' hits);
    lengths: (B,) int32; accept: (B,) bool.  Positions outside [0, n),
    past a read's length, or holding an N add nothing.
    """
    n = genome.shape[0]
    L = seqs.shape[1]
    dev = seqs.device
    col = torch.arange(L, device=dev)
    pos = loci.to(torch.int64)[:, None] + col                 # (B, L)
    live = (accept[:, None] & (col[None, :] < lengths[:, None])
            & (seqs < 4) & (pos >= 0) & (pos < n))
    posc = pos.clamp(0, n - 1)
    base = seqs.clamp(0, 3).to(torch.int64)
    ones = live.to(counts.dtype)
    is_mm = (base != genome[posc]) & live
    counts.view(-1).scatter_add_(0, (posc * 4 + base).reshape(-1),
                                 ones.reshape(-1))
    match.scatter_add_(0, posc.reshape(-1),
                       (live & ~is_mm).reshape(-1).to(match.dtype))
    mismatch.scatter_add_(0, posc.reshape(-1),
                          is_mm.reshape(-1).to(mismatch.dtype))
    return counts, match, mismatch


class PileupAccumulator:
    """Streams accepted alignment batches into pileup planes on the
    index's device."""

    def __init__(self, didx):
        self.didx = didx
        n = didx.total_len
        dev = didx.device
        self.counts = torch.zeros((n, 4), dtype=torch.int32, device=dev)
        self.match = torch.zeros(n, dtype=torch.int32, device=dev)
        self.mismatch = torch.zeros(n, dtype=torch.int32, device=dev)

    def _tensor(self, a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
            self.didx.device)

    def add_batch(self, loci, aligned_seqs, lengths, accept):
        pileup_batch(
            self.counts, self.match, self.mismatch, self.didx.genome,
            self._tensor(loci, np.int32), self._tensor(aligned_seqs, np.int8),
            self._tensor(lengths, np.int32), self._tensor(accept, np.bool_),
        )

    def add_alignments(self, reads, lengths, result):
        """Feed an AlignEngine result dict (SE): accepted reverse-strand
        reads are reverse-complemented on the device."""
        r = self._tensor(reads, np.int8)
        ln = self._tensor(lengths, np.int32)
        acc = self._tensor(result["unique"], np.bool_)
        flip = acc & self._tensor(result["is_rc"], np.bool_)
        seqs = torch.where(flip[:, None], _rc_reads(r, ln), r)
        pileup_batch(self.counts, self.match, self.mismatch,
                     self.didx.genome,
                     self._tensor(result["locus"], np.int32), seqs, ln, acc)

    def finalize(self):
        return (
            self.counts.cpu().numpy(),
            self.match.cpu().numpy(),
            self.mismatch.cpu().numpy(),
        )


def _seg_candidates(counts, match, mismatch, genome, entry_starts_local,
                    seg_base: int, min_reads: int, nonref_frac: float,
                    cap: int, core_lo: int, core_hi: int):
    """Candidates of one flank-extended plane segment (copy of the JAX
    package's `_seg_candidates`, biokanga_tpu/align/snp.py:114): windows
    use the whole segment, candidates and per-entry totals only its CORE
    [core_lo, core_hi), so flanks never count twice.

    Planes are int32 read as uint16 (U16_MASK).  Returns host arrays: the
    first `cap` candidate positions in ascending order, their counts
    (uint16), totals, non-reference counts and 51-base window match and
    mismatch sums, and the core's int32 match and mismatch totals per
    entry."""
    n = genome.shape[0]
    dev = genome.device
    flank = C_SNP_BKGND_RATE_WINDOW // 2
    c16 = counts & U16_MASK
    m16 = match & U16_MASK
    mm16 = mismatch & U16_MASK
    tot = c16.sum(dim=1, dtype=torch.int32)
    ref = genome.clamp(0, 3).to(torch.int64)
    nonref = tot - torch.gather(c16, 1, ref[:, None])[:, 0]

    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    cs_m = torch.cat([zero, torch.cumsum(m16, 0, dtype=torch.int64)])
    cs_mm = torch.cat([zero, torch.cumsum(mm16, 0, dtype=torch.int64)])
    i = torch.arange(n, device=dev)
    lo = (i - flank).clamp(0, n)
    hi = (i + flank + 1).clamp(0, n)

    core = (i >= core_lo) & (i < core_hi)
    # the JAX package compares in float32 (a weakly typed float argument)
    frac = torch.tensor(nonref_frac, dtype=torch.float32, device=dev)
    cand = (core & (tot >= min_reads) & (nonref >= 1)
            & (nonref.to(torch.float32) >= frac * tot.to(torch.float32))
            & (genome < 4))
    idx = cand.nonzero()[:cap, 0]
    E = entry_starts_local.shape[0] - 1
    ent = (torch.searchsorted(entry_starts_local.to(torch.int64),
                              seg_base + i, right=True) - 1).clamp(0, E - 1)
    ent_m = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, ent, torch.where(core, m16, 0).to(torch.int64))
    ent_mm = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, ent, torch.where(core, mm16, 0).to(torch.int64))
    host = lambda t, dt: t.cpu().numpy().astype(dt)
    return (host(idx, np.int64), host(c16[idx], np.uint16),
            host(tot[idx], np.int32), host(nonref[idx], np.int32),
            host(cs_m[hi[idx]] - cs_m[lo[idx]], np.int32),
            host(cs_mm[hi[idx]] - cs_mm[lo[idx]], np.int32),
            host(ent_m, np.int32), host(ent_mm, np.int32))


class ChunkedPileup:
    """SNP pileup over a genome-range chunk sweep (ChunkedAligner /
    DeviceBuildChunkedAligner), following biokanga_tpu/align/snp.py:165:
    per-chunk local planes on the device while a chunk is resident, exact
    boundary folding (chunk k's overlap-tail counts are added into chunk
    k+1's head), and candidate compaction on the device."""

    def __init__(self, bases: np.ndarray, slice_lens, owned,
                 overlap: int, cand_cap: int = 1 << 18):
        self.bases = np.asarray(bases, np.int64)
        self.slice_lens = np.asarray(slice_lens, np.int64)
        self.owned = np.asarray(owned, np.int64)
        self.overlap = int(overlap)
        self.cap = cand_cap
        self._cur = None          # (chunk_id, counts, match, mismatch)
        self._pending_tail = None  # (counts_tail, m_tail, mm_tail)
        self.cand_rows = []        # accumulated host candidate tuples
        self.ent_m = None
        self.ent_mm = None

    def start_chunk(self, k: int, pad_n: int,
                    device: torch.device | str = "cuda"):
        assert self._cur is None or self._cur[0] != k
        counts = torch.zeros((pad_n, 4), dtype=torch.int32, device=device)
        match = torch.zeros(pad_n, dtype=torch.int32, device=device)
        mismatch = torch.zeros(pad_n, dtype=torch.int32, device=device)
        if self._pending_tail is not None:
            tc, tm, tmm = self._pending_tail
            counts[: tc.shape[0]] += tc.to(counts.device)
            match[: tm.shape[0]] += tm.to(counts.device)
            mismatch[: tmm.shape[0]] += tmm.to(counts.device)
            self._pending_tail = None
        self._cur = [k, counts, match, mismatch]

    def add_batch(self, genome_d, loci_local, aligned_seqs, lengths,
                  accept):
        _, counts, match, mismatch = self._cur
        dev = genome_d.device
        t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(
            dev)
        pileup_batch(counts, match, mismatch, genome_d,
                     t(loci_local, np.int32), t(aligned_seqs, np.int8),
                     t(lengths, np.int32), t(accept, np.bool_))

    def finish_chunk(self, genome_d, entry_starts_local,
                     params: "SNPParams"):
        k, counts, match, mismatch = self._cur
        own = int(self.owned[k])
        last = k == len(self.bases) - 1
        if not last:
            # the overlap tail, for the next chunk's head
            t0, t1 = own, min(own + self.overlap, counts.shape[0])
            self._pending_tail = (counts[t0:t1].clone(),
                                  match[t0:t1].clone(),
                                  mismatch[t0:t1].clone())
        es32 = torch.as_tensor(np.asarray(entry_starts_local, np.int32),
                               device=genome_d.device)
        n_pad = int(counts.shape[0])
        n = int(self.slice_lens[k])
        flank = C_SNP_BKGND_RATE_WINDOW // 2
        SEG = SNP_SEGMENT
        if n_pad <= SEG:
            segs = [(0, 0, n_pad)]         # (slice_start, core_lo, core_hi)
            W = n_pad
        else:
            W = SEG + 2 * flank
            segs = []
            for s0 in range(0, n_pad, SEG):
                a = min(max(0, s0 - flank), n_pad - W)
                segs.append((a, s0 - a, min(s0 + SEG, n_pad) - a))
        ent_m_acc = ent_mm_acc = None
        for a, clo, chi in segs:
            (idx, ccounts, tot, nonref, win_m, win_mm, ent_m,
             ent_mm) = _seg_candidates(
                counts[a : a + W], match[a : a + W], mismatch[a : a + W],
                genome_d[a : a + W], es32, a, params.min_snp_reads,
                params.snp_nonref_pcnt, min(self.cap, W), clo, chi)
            gidx = idx + a
            keep = (idx < W) & (gidx < min(own, n))
            for j in np.nonzero(keep)[0]:
                self.cand_rows.append((
                    int(self.bases[k] + gidx[j]), ccounts[j], int(tot[j]),
                    int(nonref[j]), int(win_m[j]), int(win_mm[j]),
                ))
            ent_m_acc = ent_m if ent_m_acc is None else ent_m_acc + ent_m
            ent_mm_acc = (ent_mm if ent_mm_acc is None
                          else ent_mm_acc + ent_mm)
        self.ent_m = (ent_m_acc if self.ent_m is None
                      else self.ent_m + ent_m_acc)
        self.ent_mm = (ent_mm_acc if self.ent_mm is None
                       else self.ent_mm + ent_mm_acc)
        self._cur = None

    def finalize_calls(self, genome_codes_by_entry, entry_names,
                       entry_starts, params: "SNPParams"):
        """Host tail: per-candidate binomial p-values with per-entry
        global rate floors (same math as call_snps)."""
        starts = np.asarray(entry_starts)
        calls = []
        gl_rate = {}
        for e in range(len(entry_names)):
            tm = int(self.ent_m[e]) if self.ent_m is not None else 0
            tmm = int(self.ent_mm[e]) if self.ent_mm is not None else 0
            gl_rate[e] = max(C_MIN_SEQ_ERR_RATE, tmm / (1 + tm + tmm))
        for g, cnts, tot, nonref, win_m, win_mm, in self.cand_rows:
            e = int(np.searchsorted(starts, g, side="right")) - 1
            loc_tmm = max(win_mm - nonref, 0)
            loc_tm = max(win_m - (tot - nonref), 0)
            denom = loc_tmm + loc_tm
            rate = (gl_rate[e] if denom == 0
                    else max(loc_tmm / max(denom, 1), gl_rate[e]))
            if rate > C_MAX_BKGD_NOISE_THRES:
                continue
            loci = g - int(starts[e])
            ref = int(genome_codes_by_entry(e, loci))
            pv = float(1.0 - _binom.cdf(nonref, tot, rate))
            calls.append(SNPCall(
                chrom=entry_names[e], loci=loci, ref_base=ref,
                tot_bases=tot, nonref=nonref, base_cnts=cnts.copy(),
                pvalue=pv, bkgnd_rate=rate,
                win_bases=int(loc_tm + loc_tmm), win_mm=int(loc_tmm),
            ))
        return apply_bh_fdr(calls, params.qvalue)


@dataclass
class SNPCall:
    chrom: str
    loci: int              # 0-based within chrom
    ref_base: int
    tot_bases: int
    nonref: int
    base_cnts: np.ndarray  # (4,)
    pvalue: float
    bkgnd_rate: float
    win_bases: int
    win_mm: int
    rank: int = 0


def call_snps(
    counts: np.ndarray, match: np.ndarray, mismatch: np.ndarray,
    genome_codes: np.ndarray, entry_names, entry_starts,
    params: SNPParams | None = None,
) -> list[SNPCall]:
    p = params or SNPParams()
    n = len(genome_codes)
    tot = counts.sum(axis=1)
    ref = np.clip(genome_codes, 0, 3).astype(np.int64)
    refcnt = counts[np.arange(n), ref]
    nonref = tot - refcnt

    calls: list[SNPCall] = []
    flank = C_SNP_BKGND_RATE_WINDOW // 2
    starts = np.asarray(entry_starts)
    for ei, name in enumerate(entry_names):
        a, b = int(starts[ei]), int(starts[ei + 1])
        ctot = tot[a:b]
        cnon = nonref[a:b]
        cmatch = match[a:b]
        cmm = mismatch[a:b]
        tot_m = int(cmatch.sum())
        tot_mm = int(cmm.sum())
        global_rate = max(C_MIN_SEQ_ERR_RATE, tot_mm / (1 + tot_m + tot_mm))

        cand = np.nonzero(
            (ctot >= p.min_snp_reads)
            & (cnon >= 1)
            & (cnon / np.maximum(ctot, 1) >= p.snp_nonref_pcnt)
            & (genome_codes[a:b] < 4)
        )[0]
        if len(cand) == 0:
            continue
        # local window sums (excluding the locus' own contribution)
        cs_m = np.concatenate([[0], np.cumsum(cmatch, dtype=np.int64)])
        cs_mm = np.concatenate([[0], np.cumsum(cmm, dtype=np.int64)])
        L_ = len(ctot)
        lo = np.maximum(cand - flank, 0)
        hi = np.minimum(cand + flank + 1, L_)
        win_m = cs_m[hi] - cs_m[lo]
        win_mm = cs_mm[hi] - cs_mm[lo]
        loc_tmm = np.maximum(win_mm - cnon[cand], 0)
        loc_tm = np.maximum(win_m - (ctot[cand] - cnon[cand]), 0)
        denom = loc_tmm + loc_tm
        local_rate = np.where(
            denom == 0, global_rate,
            np.maximum(loc_tmm / np.maximum(denom, 1), global_rate),
        )
        ok = local_rate <= C_MAX_BKGD_NOISE_THRES
        cand, local_rate = cand[ok], local_rate[ok]
        loc_tmm, loc_tm = loc_tmm[ok], loc_tm[ok]
        if len(cand) == 0:
            continue
        pv = 1.0 - _binom.cdf(cnon[cand], ctot[cand], local_rate)
        for j, c in enumerate(cand):
            calls.append(
                SNPCall(
                    chrom=name, loci=int(c), ref_base=int(ref[a + c]),
                    tot_bases=int(ctot[c]), nonref=int(cnon[c]),
                    base_cnts=counts[a + c].copy(),
                    pvalue=float(pv[j]), bkgnd_rate=float(local_rate[j]),
                    win_bases=int(loc_tm[j] + loc_tmm[j]),
                    win_mm=int(loc_tmm[j]),
                )
            )

    return apply_bh_fdr(calls, p.qvalue)


def apply_bh_fdr(calls: list, qvalue: float) -> list:
    """Benjamini-Hochberg step-down exactly as the reference
    (Aligner.cpp:7118-7126): ascending P, accept while P < rank/N * Q."""
    calls.sort(key=lambda c: c.pvalue)
    N = len(calls)
    accepted = []
    for i, c in enumerate(calls):
        if c.pvalue >= ((i + 1) / N) * qvalue:
            break
        c.rank = i + 1
        accepted.append(c)
    accepted.sort(key=lambda c: (c.chrom, c.loci))
    return accepted


class HaplotypeTracker:
    """Collects accepted alignments so DiSNP/TriSNP haplotype counts can
    be derived after SNP calling (reference: the DiSNP/TriSNP emission in
    OutputSNPs, Aligner.cpp:7135+/9741 — joint base combinations of reads
    covering 2 or 3 accepted SNP loci within read range)."""

    def __init__(self):
        self.loci: list[np.ndarray] = []
        self.lens: list[np.ndarray] = []
        self.seqs: list[np.ndarray] = []

    def add_alignments(self, reads, lengths, result):
        acc = np.asarray(result["unique"])
        if not acc.any():
            return
        rows = np.nonzero(acc)[0]
        seqs = reads[rows].copy()
        for j, i in enumerate(rows):
            if result["is_rc"][i]:
                L = int(lengths[i])
                seqs[j, :L] = revcomp(reads[i, :L])
        self.loci.append(np.asarray(result["locus"])[rows].astype(np.int64))
        self.lens.append(np.asarray(lengths)[rows].astype(np.int64))
        self.seqs.append(seqs)

    def haplotypes(self, calls: list["SNPCall"], entry_names, entry_starts,
                   order: int = 2):
        """Joint base counts at consecutive SNP pairs (order=2, DiSNP) or
        triples (order=3, TriSNP) within read range."""
        if not self.loci or len(calls) < order:
            return []
        starts = np.asarray(entry_starts)
        name_to_e = {n: i for i, n in enumerate(entry_names)}
        snp_abs = np.array(
            [starts[name_to_e[c.chrom]] + c.loci for c in calls], np.int64
        )
        o = np.argsort(snp_abs)
        snp_abs = snp_abs[o]
        calls_s = [calls[i] for i in o]

        groups = []
        for i in range(len(calls_s) - order + 1):
            span = snp_abs[i + order - 1] - snp_abs[i]
            if span < 512:  # within any plausible read span
                groups.append(tuple(range(i, i + order)))

        loci = np.concatenate(self.loci)
        lens = np.concatenate(self.lens)
        seqs = np.concatenate(self.seqs, axis=0)
        out = []
        for g in groups:
            g_abs = snp_abs[list(g)]
            lo, hi = g_abs[0], g_abs[-1]
            cover = (loci <= lo) & (loci + lens > hi)
            rows = np.nonzero(cover)[0]
            if len(rows) == 0:
                continue
            combos: dict[str, int] = {}
            for r in rows:
                bases = []
                ok = True
                for ga in g_abs:
                    off = int(ga - loci[r])
                    b = int(seqs[r, off]) if off < lens[r] else 4
                    if b >= 4:
                        ok = False
                        break
                    bases.append("ACGT"[b])
                if ok:
                    key = "".join(bases)
                    combos[key] = combos.get(key, 0) + 1
            if combos:
                out.append((tuple(calls_s[i] for i in g), combos))
        return out


def write_haplotypes_csv(path, haps, order=2):
    label = "DiSNP" if order == 2 else "TriSNP"
    with open(path, "w") as f:
        f.write(f'"{label}_ID","Chrom","Loci","Haplotype","Count"\n')
        hid = 0
        for snps, combos in haps:
            hid += 1
            lstr = "|".join(str(s.loci) for s in snps)
            for hap, cnt in sorted(combos.items(), key=lambda x: -x[1]):
                f.write(f'{hid},"{snps[0].chrom}","{lstr}","{hap}",{cnt}\n')


_B2A = "ACGTN"


CENTROID_FLANK = 3  # cSNPCentfFlankLen (Aligner.h:30)
CENTROID_LEN = CENTROID_FLANK * 2 + 1


def snp_centroids(counts: np.ndarray, genome_codes: np.ndarray,
                  calls: list["SNPCall"], entry_names, entry_starts,
                  min_reads: int = 5):
    """SNP centroid distribution (Aligner.cpp:6936-6952,7559-7587,8003):
    per 7-mer genome context, the number of adequately-covered loci
    (NumInsts) and per-SNP ref/non-ref base count sums.

    Returns (num_insts, num_snps, ref_cnt, nonref_cnts) arrays of shape
    (4^7,) / (4^7, 5); vectorized sliding-window packing (no per-locus
    Python loop)."""
    g = np.asarray(genome_codes, dtype=np.int64)
    n = g.shape[0]
    K = CENTROID_LEN
    n_els = 4 ** K
    num_insts = np.zeros(n_els, dtype=np.int64)
    num_snps = np.zeros(n_els, dtype=np.int64)
    ref_cnt = np.zeros(n_els, dtype=np.int64)
    nonref = np.zeros((n_els, 5), dtype=np.int64)
    if n < K:
        return num_insts, num_snps, ref_cnt, nonref

    # centroid index for every center locus (first base most significant,
    # matching the reference's shift order)
    valid = np.ones(n - K + 1, dtype=bool)
    cidx = np.zeros(n - K + 1, dtype=np.int64)
    for j in range(K):
        b = g[j : n - K + 1 + j]
        valid &= b < 4
        cidx = (cidx << 2) | np.clip(b, 0, 3)
    centers = np.arange(CENTROID_FLANK, n - CENTROID_FLANK)
    covered = np.asarray(counts).sum(axis=1)[centers] >= min_reads
    sel = covered & valid
    np.add.at(num_insts, cidx[sel], 1)

    starts = np.asarray(entry_starts)
    name_to_ent = {nm: i for i, nm in enumerate(entry_names)}
    cnts = np.asarray(counts)
    for c in calls:
        gpos = int(starts[name_to_ent[c.chrom]]) + c.loci
        w = gpos - CENTROID_FLANK
        if w < 0 or w >= len(cidx) or not valid[w]:
            continue
        ci = cidx[w]
        num_snps[ci] += 1
        ref_cnt[ci] += int(cnts[gpos, c.ref_base])
        for b in range(4):
            if b != c.ref_base:
                nonref[ci, b] += int(cnts[gpos, b])
    return num_insts, num_snps, ref_cnt, nonref


def write_snp_centroids_csv(path_or_file, num_insts, num_snps, ref_cnt,
                            nonref):
    """Reference centroid CSV layout (Aligner.cpp:8014-8027)."""
    close = False
    f = path_or_file
    if isinstance(f, str):
        f = open(f, "w")
        close = True
    try:
        f.write('"CentroidID","Seq","NumInsts","NumSNPs","RefBase",'
                '"RefBaseCnt","BaseA","BaseC","BaseG","BaseT","BaseN"\n')
        K = CENTROID_LEN
        for ci in range(4 ** K):
            seq = "".join(
                _B2A[(ci >> (2 * (K - 1 - j))) & 3] for j in range(K)
            )
            f.write(
                f'{ci + 1},"{seq}",{int(num_insts[ci])},{int(num_snps[ci])},'
                f'"{seq[CENTROID_FLANK]}",{int(ref_cnt[ci])},'
                f"{int(nonref[ci, 0])},{int(nonref[ci, 1])},"
                f"{int(nonref[ci, 2])},{int(nonref[ci, 3])},"
                f"{int(nonref[ci, 4])}\n"
            )
    finally:
        if close:
            f.close()


def write_snps_csv(path_or_file, calls, species="TargSpecies"):
    """Reference CSV column layout (Aligner.cpp:7648)."""
    close = False
    f = path_or_file
    if isinstance(f, str):
        f = open(f, "w")
        close = True
    try:
        f.write(
            '"SNP_ID","ElType","Species","Chrom","StartLoci","EndLoci","Len",'
            '"Strand","Rank","PValue","Bases","Mismatches","RefBase",'
            '"MMBaseA","MMBaseC","MMBaseG","MMBaseT","MMBaseN",'
            '"BackgroundSubRate","TotWinBases","TotWinMismatches","MarkerID",'
            '"NumPolymorphicSites"\n'
        )
        for i, c in enumerate(calls, 1):
            mm = [int(c.base_cnts[b]) if b != c.ref_base else 0 for b in range(4)]
            f.write(
                f'{i},"SNP","{species}","{c.chrom}",{c.loci},{c.loci},1,'
                f'"+",{c.rank},{c.pvalue:.6g},{c.tot_bases},{c.nonref},'
                f'"{_B2A[c.ref_base]}",{mm[0]},{mm[1]},{mm[2]},{mm[3]},0,'
                f"{c.bkgnd_rate:.6g},{c.win_bases},{c.win_mm},0,0\n"
            )
    finally:
        if close:
            f.close()


def write_snps_vcf(path_or_file, calls, entry_names, entry_lengths):
    close = False
    f = path_or_file
    if isinstance(f, str):
        f = open(f, "w")
        close = True
    try:
        f.write("##fileformat=VCFv4.2\n")
        for nm, ln in zip(entry_names, entry_lengths):
            f.write(f"##contig=<ID={nm},length={int(ln)}>\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for i, c in enumerate(calls, 1):
            alts = [
                (int(c.base_cnts[b]), b)
                for b in range(4)
                if b != c.ref_base and c.base_cnts[b] > 0
            ]
            alts.sort(reverse=True)
            alt = ",".join(_B2A[b] for _, b in alts) or "."
            qual = min(999, int(-10 * np.log10(max(c.pvalue, 1e-100))))
            f.write(
                f"{c.chrom}\t{c.loci + 1}\t.\t{_B2A[c.ref_base]}\t{alt}\t"
                f"{qual}\tPASS\tDP={c.tot_bases};NR={c.nonref}\n"
            )
    finally:
        if close:
            f.close()
