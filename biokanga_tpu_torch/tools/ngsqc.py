"""Copy of biokanga_tpu/tools/ngsqc.py (host numpy).

Read QC — capability match for `biokanga ngsqc` (CReadStats,
biokanga/ReadStats.cpp): Phred/length/duplicate/K-mer distributions,
error-free-read probabilities, and an HTML report with inline SVG charts
(the reference renders SVG via its vendored PLplot; we emit standalone
SVG — SURVEY §7.4 explicitly drops libBKPLPlot).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from ..seq.fasta import read_blocks


@dataclass
class QCStats:
    n_reads: int = 0
    n_bases: int = 0
    len_hist: dict = field(default_factory=dict)
    per_pos_phred_sum: np.ndarray | None = None
    per_pos_count: np.ndarray | None = None
    per_pos_base: np.ndarray | None = None  # (L, 5)
    gc_hist: np.ndarray | None = None       # 101 bins
    kmer_counts: np.ndarray | None = None   # 4^k
    kmer_k: int = 5
    dup_groups: dict = field(default_factory=dict)
    err_free_prob_sum: float = 0.0
    contam_rows: list = field(default_factory=list)
    contam_reads5: int = 0
    contam_reads3: int = 0
    contam_vector: int = 0
    err_free_by_pos: np.ndarray | None = None  # sum of P(error-free..p)


def collect_qc(paths, kmer_k: int = 5, max_reads: int | None = None,
               contaminants=None) -> QCStats:
    """contaminants: optional seq.contaminants.Contaminants DB — flank
    overlay + vector containment checks per read block (the ReadStats
    contaminant QC role, biokanga/ReadStats.cpp:2412)."""
    if isinstance(paths, str):
        paths = [paths]
    st = QCStats(kmer_k=kmer_k)
    st.gc_hist = np.zeros(101, dtype=np.int64)
    st.kmer_counts = np.zeros(4**kmer_k, dtype=np.int64)
    seen: dict[bytes, int] = {}
    Lmax = 0
    for path in paths:
        for blk in read_blocks(path, block_size=8192):
            B, L = blk.codes.shape
            if L > Lmax:
                newL = L
                for name in ("per_pos_phred_sum", "per_pos_count"):
                    old = getattr(st, name)
                    arr = np.zeros(newL, dtype=np.float64)
                    if old is not None:
                        arr[: len(old)] = old
                    setattr(st, name, arr)
                base = np.zeros((newL, 5), dtype=np.int64)
                if st.per_pos_base is not None:
                    base[: st.per_pos_base.shape[0]] = st.per_pos_base
                st.per_pos_base = base
                Lmax = newL
            live = np.arange(L)[None, :] < blk.lengths[:, None]
            st.n_reads += B
            st.n_bases += int(blk.lengths.sum())
            for l in blk.lengths:
                st.len_hist[int(l)] = st.len_hist.get(int(l), 0) + 1
            # per-position base composition
            codes = np.clip(blk.codes, 0, 4)
            for b in range(5):
                st.per_pos_base[:L, b] += ((codes == b) & live).sum(axis=0)
            # Phred
            if blk.quals is not None:
                q = blk.quals.astype(np.float64) - 33.0
                st.per_pos_phred_sum[:L] += np.where(live, q, 0).sum(axis=0)
                st.per_pos_count[:L] += live.sum(axis=0)
                perr = np.where(live, 10.0 ** (-np.maximum(q, 0) / 10.0), 0.0)
                logp = np.log1p(-np.clip(perr, 0, 0.999999))
                st.err_free_prob_sum += float(np.exp(logp.sum(axis=1)).sum())
                # per-phase error-free distribution (ReadStats
                # error-free-read probability role, ReadStats.cpp:1149):
                # expected fraction of reads error-free THROUGH position p
                cum = np.exp(np.cumsum(logp, axis=1))
                if st.err_free_by_pos is None or len(
                        st.err_free_by_pos) < L:
                    old = st.err_free_by_pos
                    st.err_free_by_pos = np.zeros(L, np.float64)
                    if old is not None:
                        st.err_free_by_pos[: len(old)] = old
                st.err_free_by_pos[:L] += np.where(live, cum, 0).sum(axis=0)
            else:
                st.per_pos_count[:L] += live.sum(axis=0)
            # GC distribution
            acgt = ((codes < 4) & live).sum(axis=1)
            gc = ((codes == 1) | (codes == 2)) & live
            pct = np.round(100.0 * gc.sum(axis=1) / np.maximum(acgt, 1)).astype(int)
            st.gc_hist += np.bincount(np.clip(pct, 0, 100), minlength=101)
            # K-mers (first position of each read window, vectorised)
            k = kmer_k
            val = np.zeros(B, dtype=np.int64)
            ok = np.ones(B, dtype=bool)
            for ofs in range(L - k + 1):
                val[:] = 0
                ok[:] = blk.lengths >= ofs + k
                for j in range(k):
                    c = codes[:, ofs + j]
                    ok &= c < 4
                    val = val * 4 + np.clip(c, 0, 3)
                sel = val[ok]
                if len(sel):
                    st.kmer_counts += np.bincount(sel, minlength=4**k)
            # contaminant checks (flank overlays + vector containment)
            if contaminants is not None:
                from ..seq.contaminants import T_3PE1, T_5PE1

                t5 = contaminants.match_flank(blk.codes, blk.lengths,
                                              T_5PE1)
                t3 = contaminants.match_flank(blk.codes, blk.lengths,
                                              T_3PE1)
                st.contam_reads5 += int((t5 > 0).sum())
                st.contam_reads3 += int((t3 > 0).sum())
                if contaminants.num_vectors:
                    st.contam_vector += int(
                        contaminants.match_vectors(blk.codes,
                                                   blk.lengths).sum()
                    )
            # duplicates
            for i in range(B):
                key = blk.codes[i, : blk.lengths[i]].tobytes()
                seen[key] = seen.get(key, 0) + 1
            if max_reads and st.n_reads >= max_reads:
                break
    # duplicate-count distribution
    cnts = np.array(list(seen.values()))
    for c in cnts:
        st.dup_groups[int(c)] = st.dup_groups.get(int(c), 0) + 1
    if contaminants is not None:
        st.contam_rows = contaminants.report_rows()
    return st


def _svg_line(xs, ys, title, width=640, height=220, color="#2266cc"):
    if len(xs) == 0:
        return f"<svg width='{width}' height='{height}'></svg>"
    xs = np.asarray(xs, dtype=float)
    ys = np.asarray(ys, dtype=float)
    x0, x1 = xs.min(), max(xs.max(), xs.min() + 1)
    y0, y1 = 0.0, max(ys.max(), 1e-9)
    px = 40 + (xs - x0) / (x1 - x0) * (width - 60)
    py = height - 25 - ys / y1 * (height - 50)
    pts = " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(px, py))
    return (
        f"<svg width='{width}' height='{height}' "
        f"xmlns='http://www.w3.org/2000/svg'>"
        f"<text x='8' y='14' font-size='13'>{title}</text>"
        f"<polyline fill='none' stroke='{color}' stroke-width='1.5' "
        f"points='{pts}'/>"
        f"<line x1='40' y1='{height-25}' x2='{width-20}' y2='{height-25}' "
        f"stroke='#999'/>"
        f"<text x='40' y='{height-8}' font-size='10'>{x0:.0f}</text>"
        f"<text x='{width-50}' y='{height-8}' font-size='10'>{x1:.0f}</text>"
        f"<text x='2' y='30' font-size='10'>{y1:.3g}</text>"
        "</svg>"
    )


def write_html_report(st: QCStats, path: str, title="ngsqc report") -> None:
    mean_phred = np.divide(
        st.per_pos_phred_sum, np.maximum(st.per_pos_count, 1)
    ) if st.per_pos_phred_sum is not None else np.zeros(0)
    lens = sorted(st.len_hist)
    dup1 = st.dup_groups.get(1, 0)
    dup_total = sum(st.dup_groups.values())
    dup_rate = 1.0 - dup1 / max(dup_total, 1)
    top_kmers = np.argsort(st.kmer_counts)[::-1][:10]
    k = st.kmer_k

    def kmer_str(v):
        return "".join("ACGT"[(v >> (2 * (k - 1 - j))) & 3] for j in range(k))

    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{title}</title></head><body>",
        f"<h1>{title}</h1>",
        "<table border='1' cellpadding='4'>",
        f"<tr><td>reads</td><td>{st.n_reads:,}</td></tr>",
        f"<tr><td>bases</td><td>{st.n_bases:,}</td></tr>",
        f"<tr><td>mean length</td><td>{st.n_bases/max(st.n_reads,1):.1f}</td></tr>",
        f"<tr><td>distinct-sequence duplication rate</td>"
        f"<td>{100*dup_rate:.2f}%</td></tr>",
        f"<tr><td>expected error-free reads</td>"
        f"<td>{st.err_free_prob_sum:,.0f}</td></tr>",
        "</table>",
        _svg_line(np.arange(len(mean_phred)), mean_phred,
                  "Mean Phred by position"),
        _svg_line(lens, [st.len_hist[l] for l in lens],
                  "Read length distribution", color="#22aa66"),
        _svg_line(np.arange(101), st.gc_hist, "GC%% distribution",
                  color="#cc6622"),
        (
            _svg_line(
                np.arange(len(st.err_free_by_pos)),
                st.err_free_by_pos / max(st.n_reads, 1),
                "Expected error-free fraction through position",
                color="#884488",
            )
            if st.err_free_by_pos is not None else ""
        ),
        "<h3>Top K-mers</h3><table border='1' cellpadding='3'>",
    ]
    for v in top_kmers:
        parts.append(
            f"<tr><td><code>{kmer_str(int(v))}</code></td>"
            f"<td>{int(st.kmer_counts[v]):,}</td></tr>"
        )
    parts.append("</table>")
    if st.contam_rows:
        parts.append(
            "<h3>Contaminants</h3><table border='1' cellpadding='3'>"
            "<tr><th>class</th><th>name</th><th>types</th><th>rc</th>"
            "<th>len</th><th>hits</th></tr>"
        )
        for r in st.contam_rows:
            parts.append(
                f"<tr><td>{r['class']}</td><td>{r['name']}</td>"
                f"<td>{r['types']}</td><td>{r['rc']}</td>"
                f"<td>{r['len']}</td><td>{r['hits']:,}</td></tr>"
            )
        parts.append(
            f"<tr><td colspan='5'>reads with 5' contaminant overlay</td>"
            f"<td>{st.contam_reads5:,}</td></tr>"
            f"<tr><td colspan='5'>reads with 3' contaminant overlay</td>"
            f"<td>{st.contam_reads3:,}</td></tr>"
            f"<tr><td colspan='5'>reads contained in vector</td>"
            f"<td>{st.contam_vector:,}</td></tr></table>"
        )
    parts.append("</body></html>")
    with open(path, "w") as f:
        f.write("\n".join(parts))
