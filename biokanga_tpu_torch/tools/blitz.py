"""Port of biokanga_tpu/tools/blitz.py: Blitz, BLAT-like local alignment
(`biokanga blitz`, CBlitz, biokanga/Blitz.cpp: Process :594,
ProcAlignQuerySeqs :1243, IdentifyHighScorePaths/HighScoreSW :1495/:1407).

Seed cores of CoreLen (default 20, looked up as k = min(CoreLen, 16)) are
slid at CoreDelta, cores past 1,500 occurrences are dropped and each core
keeps its first 64; seeds merge along diagonals into exact blocks, and
blocks chain into collinear paths with the reference's scoring (match +1,
gap open 5, gap extend 1 a 10 bp capped at 10, gaps past 100 kbp break a
path).  A path is kept with a score of 75 or more over 25% of the query.
PSL, PSLX, BED and MAF rows.

The seed lookup of a batch of queries is one rolling-key lookup over
their concatenation (ops/lookup.rolling_seed_lookup), and the chain DP of
every (query, strand, entry) chain of the batch is one call of
ops/blitz_chain.chain_scan (kernel #8 on the card); diagonal merging and
path extraction stay host numpy, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..index.device import DeviceIndex
from ..ops.blitz_chain import chain_scan
from ..ops.lookup import rolling_seed_lookup
from ..seq.encode import codes_to_ascii, revcomp

# Blitz.h scoring constants
C_DFLT_CORE_LEN = 20
C_DFLT_PATH_SCORE = 75
C_DFLT_MATCH = 1
C_DFLT_MISMATCH = 2
C_DFLT_GAP_OPEN = 5
C_DFLT_MIN_ALIGNED_PCT = 25
C_DFLT_CORE_ITERS = 1500
C_DFLT_MAX_PATHS = 10


@dataclass(frozen=True)
class BlitzParams:
    core_len: int = C_DFLT_CORE_LEN
    core_delta: int = 0                 # 0 = per-sensitivity default
    sensitivity: str = "default"        # default|more|ultra|less
    min_path_score: int = C_DFLT_PATH_SCORE
    min_aligned_pct: int = C_DFLT_MIN_ALIGNED_PCT
    max_paths: int = C_DFLT_MAX_PATHS
    match_score: int = C_DFLT_MATCH
    mismatch_score: int = C_DFLT_MISMATCH
    gap_open: int = C_DFLT_GAP_OPEN
    max_occs: int = 64                  # per-core occurrence cap (device)
    max_nodes: int = 512                # chain DP node cap per query/strand

    def effective_delta(self) -> int:
        if self.core_delta:
            return self.core_delta
        cl = self.core_len
        return {
            "default": (cl + 1) // 2,
            "more": (cl + 2) // 3,
            "ultra": (cl + 3) // 4,
            "less": cl,
        }[self.sensitivity]


@dataclass
class BlitzPath:
    qname: str
    qsize: int
    strand: str
    qstart: int            # 0-based, on + strand of the query
    qend: int
    tname: str
    tsize: int
    tstart: int
    tend: int
    score: int
    matches: int
    block_sizes: list = field(default_factory=list)
    q_starts: list = field(default_factory=list)
    t_starts: list = field(default_factory=list)


def _seed_nodes(didx: DeviceIndex, queries: list[np.ndarray],
                p: BlitzParams) -> list[np.ndarray]:
    """Exact-core seed (qofs, tloci) pairs of each query, (N, 2) int64 in
    (core, occurrence) order: one rolling-key lookup over the queries laid
    end to end, each from an offset that is a multiple of the core stride,
    so every core inside a query reads that query's bases alone."""
    k = min(p.core_len, 16)
    delta = p.effective_delta()
    n_cores = [max((len(q) - k) // delta + 1, 0) for q in queries]
    spans = [-(-len(q) // delta) * delta for q in queries]
    offs = np.concatenate([[0], np.cumsum(spans)]).astype(np.int64)
    row = np.full(int(offs[-1]) + k, 4, np.int8)
    for q, o in zip(queries, offs[:-1]):
        row[o:o + len(q)] = q
    dev = didx.device
    seq = torch.from_numpy(row).to(dev)[None]
    S = max((row.shape[0] - k) // delta + 1, 1)
    pos, valid, size = rolling_seed_lookup(
        didx.key_hi, didx.key_lo, didx.lut, didx.pos_sorted, seq, k, delta,
        S, p.max_occs, didx.lut_bases, didx.max_bsearch_steps)
    keep = valid[0] & (size[0] <= C_DFLT_CORE_ITERS)[:, None]
    core, j = keep.nonzero(as_tuple=True)
    loci = pos[0][core, j].to(torch.int64).cpu().numpy()
    core = core.cpu().numpy()
    out = []
    for o, s in zip(offs[:-1] // delta, n_cores):
        a, b = np.searchsorted(core, [o, o + s])
        out.append(np.stack([(core[a:b] - o) * delta, loci[a:b]], axis=1)
                   .astype(np.int64).reshape(-1, 2))
    return out


def _merge_diag_blocks(nodes: np.ndarray, core_len: int):
    """Merge exact-core seeds on the same diagonal into maximal blocks —
    vectorised (lexsort + run detection; no per-seed loop).
    nodes: (N, 2) [qofs, tofs]. Returns (M, 3) [qstart, tstart, length]."""
    if len(nodes) == 0:
        return np.zeros((0, 3), dtype=np.int64)
    diag = nodes[:, 1] - nodes[:, 0]
    order = np.lexsort((nodes[:, 0], diag))
    q = nodes[order, 0]
    t = nodes[order, 1]
    d = diag[order]
    # cores sorted by q within a diagonal each cover [q, q+core_len), so a
    # run extends while the next core starts within the previous cover
    brk = np.concatenate(
        [[True], (d[1:] != d[:-1]) | (q[1:] > q[:-1] + core_len)]
    )
    starts = np.nonzero(brk)[0]
    ends = np.concatenate([starts[1:], [len(q)]]) - 1
    return np.stack(
        [q[starts], t[starts], q[ends] + core_len - q[starts]], axis=1
    ).astype(np.int64)


def _chain_all(chains: list[np.ndarray], p: BlitzParams, device):
    """(f, pred) of every chain, each a block set sorted by (t, q), from
    one chain_scan call over a (C, max M) batch."""
    C = len(chains)
    M = max((len(b) for b in chains), default=0)
    q0 = np.zeros((C, M), np.int32)
    t0 = np.zeros((C, M), np.int32)
    ln = np.zeros((C, M), np.int32)
    valid = np.zeros((C, M), bool)
    for c, b in enumerate(chains):
        q0[c, :len(b)], t0[c, :len(b)], ln[c, :len(b)] = b[:, 0], b[:, 1], b[:, 2]
        valid[c, :len(b)] = True
    score = ln * p.match_score
    f, pred = chain_scan(*(torch.from_numpy(x).to(device)
                           for x in (q0, t0, ln, score, valid)), p.gap_open)
    return f.cpu().numpy(), pred.cpu().numpy()


def _extract_paths(f: np.ndarray, pred: np.ndarray, order: np.ndarray,
                   p: BlitzParams):
    """Up to max_paths non-overlapping chains best-first, as (score,
    [block indices])."""
    M = len(order)
    # int64 on host: np.where would WRAP the -1e12 mask value into an
    # int32 result (NumPy 2 casts the scalar to the array dtype)
    f = f[:M].astype(np.int64)
    used = np.zeros(M, dtype=bool)
    paths = []
    for _ in range(p.max_paths):
        masked = np.where(used, -(10**12), f)
        i = int(np.argmax(masked))
        if masked[i] < p.min_path_score:
            break
        chain = []
        while i >= 0 and not used[i]:
            chain.append(i)
            used[i] = True
            i = int(pred[i])
        chain.reverse()
        if not chain:
            break
        paths.append((int(f[chain[-1]]), [order[c] for c in chain]))
    return paths


def blitz_queries(didx: DeviceIndex, queries: list[tuple[str, np.ndarray]],
                  p: BlitzParams | None = None) -> list[list[BlitzPath]]:
    """Align each query (both strands); the accepted paths of each."""
    p = p or BlitzParams()
    starts = didx.entry_starts.cpu().numpy().astype(np.int64)
    strands = ("+", "-")
    seeds = {s: _seed_nodes(didx, [q if s == "+" else revcomp(q)
                                   for _, q in queries], p)
             for s in strands}
    jobs, chains = [], []
    for qi in range(len(queries)):
        for strand in strands:
            blocks = _merge_diag_blocks(seeds[strand][qi], min(p.core_len, 16))
            if len(blocks) > p.max_nodes:
                # keep the longest blocks (explore-depth style suppression)
                blocks = blocks[np.argsort(blocks[:, 2])[::-1][: p.max_nodes]]
            # split blocks by target entry so paths never span entries
            ent = np.searchsorted(starts, blocks[:, 1], side="right") - 1
            for e in np.unique(ent):
                eb = blocks[ent == e]
                order = np.lexsort((eb[:, 0], eb[:, 1]))
                jobs.append((qi, strand, int(e), eb, order))
                chains.append(eb[order])
    f, pred = _chain_all(chains, p, didx.device) if chains else (None, None)
    out: list[list[BlitzPath]] = [[] for _ in queries]
    for c, (qi, strand, e, eb, order) in enumerate(jobs):
        qname, q = queries[qi]
        qsize = len(q)
        for score, chain in _extract_paths(f[c], pred[c], order, p):
            rows = eb[np.asarray(chain)]
            qstart = int(rows[0][0])
            qend = int(rows[-1][0] + rows[-1][2])
            if (qend - qstart) * 100 < p.min_aligned_pct * qsize:
                continue
            tstart = int(rows[0][1])
            tend = int(rows[-1][1] + rows[-1][2])
            e0 = int(starts[e])
            out[qi].append(BlitzPath(
                qname=qname, qsize=qsize, strand=strand,
                qstart=qstart, qend=qend,
                tname=didx.entry_names[e],
                tsize=int(starts[e + 1] - e0),
                tstart=tstart - e0, tend=tend - e0,
                score=score,
                matches=int(rows[:, 2].sum()),
                block_sizes=[int(x) for x in rows[:, 2]],
                q_starts=[int(x) for x in rows[:, 0]],
                t_starts=[int(x - e0) for x in rows[:, 1]],
            ))
    for paths in out:
        paths.sort(key=lambda x: -x.score)
        del paths[p.max_paths:]
    return out


def blitz_query(didx: DeviceIndex, qname: str, q: np.ndarray,
                p: BlitzParams | None = None) -> list[BlitzPath]:
    """Align one query (both strands) and return accepted paths: the
    reference's one-query entry point, kept with its signature;
    blitz_queries batches many."""
    return blitz_queries(didx, [(qname, q)], p)[0]


# ---------------------------------------------------------------- output --

PSL_HEADER = (
    "psLayout version 3\n\n"
    "match\tmis- \trep. \tN's\tQ gap\tQ gap\tT gap\tT gap\tstrand\tQ        "
    "\tQ   \tQ    \tQ  \tT        \tT   \tT    \tT  \tblock\tblockSizes "
    "\tqStarts\t tStarts\n"
    "     \tmatch\tmatch\t   \tcount\tbases\tcount\tbases\t      \tname     "
    "\tsize\tstart\tend\tname     \tsize\tstart\tend\tcount\n"
    + "-" * 159 + "\n"
)


def psl_row(p: BlitzPath) -> str:
    qnum_ins = tnum_ins = qbase_ins = tbase_ins = 0
    for i in range(1, len(p.block_sizes)):
        dq = p.q_starts[i] - (p.q_starts[i - 1] + p.block_sizes[i - 1])
        dt = p.t_starts[i] - (p.t_starts[i - 1] + p.block_sizes[i - 1])
        if dq > 0:
            qnum_ins += 1
            qbase_ins += dq
        if dt > 0:
            tnum_ins += 1
            tbase_ins += dt
    # PSL: for '-' strand, qStarts are in rc-query coords (BLAT convention)
    return "\t".join(
        str(x)
        for x in (
            p.matches, 0, 0, 0, qnum_ins, qbase_ins, tnum_ins, tbase_ins,
            p.strand, p.qname, p.qsize,
            p.qstart if p.strand == "+" else p.qsize - p.qend,
            p.qend if p.strand == "+" else p.qsize - p.qstart,
            p.tname, p.tsize, p.tstart, p.tend,
            len(p.block_sizes),
            ",".join(map(str, p.block_sizes)) + ",",
            ",".join(map(str, p.q_starts)) + ",",
            ",".join(map(str, p.t_starts)) + ",",
        )
    )


def pslx_row(p: BlitzPath, idx, q: np.ndarray) -> str:
    """PSLX = PSL + per-block query and target sequences (Blitz.h:84-91
    eBLZRsltsPSLX role).  `idx` is the host GenomeIndex."""
    e0 = int(idx.entry_starts[idx.entry_names.index(p.tname)])
    qs = q if p.strand == "+" else revcomp(q)
    qseqs, tseqs = [], []
    for qstart, tstart, bl in zip(p.q_starts, p.t_starts, p.block_sizes):
        qseqs.append(
            codes_to_ascii(qs[qstart : qstart + bl]).decode().lower()
        )
        tseqs.append(
            codes_to_ascii(
                idx.codes[e0 + tstart : e0 + tstart + bl]
            ).decode().lower()
        )
    return (psl_row(p) + "\t" + ",".join(qseqs) + ",\t"
            + ",".join(tseqs) + ",")


def bed_row(p: BlitzPath) -> str:
    sizes = ",".join(map(str, p.block_sizes)) + ","
    rel = ",".join(str(t - p.tstart) for t in p.t_starts) + ","
    return "\t".join(
        str(x)
        for x in (
            p.tname, p.tstart, p.tend, p.qname, min(p.score, 1000), p.strand,
            p.tstart, p.tend, 0, len(p.block_sizes), sizes, rel,
        )
    )


def maf_block(p: BlitzPath, idx, q: np.ndarray) -> str:
    """MAF block of one path; `idx` is the host GenomeIndex."""
    e0 = int(idx.entry_starts[idx.entry_names.index(p.tname)])
    tseq = codes_to_ascii(idx.codes[e0 + p.tstart : e0 + p.tend]).decode()
    qs = q if p.strand == "+" else revcomp(q)
    qseq = codes_to_ascii(qs[p.qstart : p.qend]).decode()
    return (
        f"a score={p.score}\n"
        f"s {p.tname} {p.tstart} {p.tend - p.tstart} + {p.tsize} {tseq}\n"
        f"s {p.qname} {p.qstart} {p.qend - p.qstart} {p.strand} {p.qsize} "
        f"{qseq}\n\n"
    )
