"""Copy of biokanga_tpu/tools/pescaffold.py: PE-SAM contig scaffolding
without sequence (pescaffold; host code).

Capability match for CPEScaffold (biokanga/PEScaffold.cpp): mate pairs
aligned to different contigs (two SAM files, PE1 and PE2) vote for
oriented contig links; the identifier graph's components and linear
paths are reported as a scaffold ordering CSV — no sequence handling,
unlike `scaffold`.
"""
from __future__ import annotations

from collections import defaultdict


def _sam_by_qname(path: str):
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fl = line.rstrip("\n").split("\t")
            if int(fl[1]) & 4:
                continue
            qn = fl[0]
            # normalise mate suffixes
            for suf in ("/1", "/2", ".1", ".2"):
                if qn.endswith(suf):
                    qn = qn[: -2]
                    break
            out[qn] = (fl[2], int(fl[3]) - 1, bool(int(fl[1]) & 16))
    return out


def pe_scaffold_links(sam1: str, sam2: str, min_votes: int = 2):
    """Oriented contig link votes from PE mates on different contigs."""
    a = _sam_by_qname(sam1)
    b = _sam_by_qname(sam2)
    votes = defaultdict(int)
    for qn, (c1, p1, rc1) in a.items():
        m = b.get(qn)
        if m is None:
            continue
        c2, p2, rc2 = m
        if c1 == c2:
            continue
        e1 = 1 if not rc1 else -1
        e2 = 1 if not rc2 else -1
        votes[(c1, e1, c2, e2)] += 1
    return {k: v for k, v in votes.items() if v >= min_votes}


def pe_scaffold(sam1: str, sam2: str, min_votes: int = 2):
    """Walk mutual-best links into scaffold paths.
    Returns list of paths; each path is [(contig, orientation)]."""
    links = pe_scaffold_links(sam1, sam2, min_votes)
    best = {}
    for (c1, e1, c2, e2), v in links.items():
        for key, other in (((c1, e1), (c2, e2)), ((c2, e2), (c1, e1))):
            cur = best.get(key)
            if cur is None or v > cur[1]:
                best[key] = ((key, other), v)

    used = set()
    paths = []
    contigs = sorted({c for (c, _, _, _) in links} |
                     {c for (_, _, c, _) in links})
    for c0 in contigs:
        if c0 in used:
            continue
        path = [(c0, 1)]
        used.add(c0)
        cur, cur_end = c0, 1
        while True:
            e = best.get((cur, cur_end))
            if e is None:
                break
            (_, (nxt, nxt_end)), v = e
            back = best.get((nxt, nxt_end))
            if back is None or back[0][1] != (cur, cur_end) or nxt in used:
                break
            used.add(nxt)
            path.append((nxt, -nxt_end))
            cur, cur_end = nxt, -nxt_end
        paths.append(path)
    return paths


def write_pescaffold_csv(path: str, paths):
    with open(path, "w") as f:
        f.write('"ScaffoldID","Order","Contig","Orientation"\n')
        for si, p in enumerate(paths, 1):
            for oi, (c, orient) in enumerate(p, 1):
                f.write(f'{si},{oi},"{c}","{"+" if orient > 0 else "-"}"\n')
