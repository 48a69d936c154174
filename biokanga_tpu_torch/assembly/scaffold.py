"""Contig scaffolding from paired-end links.

Counterpart of biokanga_tpu/assembly/scaffold.py, with the same
scaffolds; the mates are aligned by the port's AlignEngine on `device`.

Capability match for `biokanga scaffold` (CScaffolder::ScaffoldAssemble /
GenScaffoldedContigs, biokanga/Scaffolder.cpp:772,885) and the overlap
graph machinery (CAssembGraph, biokanga/AssembGraph.cpp: AddEdges :284,
IdentifyDiscComponent :1300), plus `pescaffold` (CPEScaffold,
biokanga/PEScaffold.cpp — identifier graph from PE SAM alignments).

Design: PE reads are aligned to the contig set with the standard
AlignEngine (contigs ARE the genome index); mate pairs landing on two
different contigs vote for an oriented edge with a gap estimate; the
scaffold graph keeps mutually-best edges, components are walked into
linear paths, and scaffolds emit with N-gap joins.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch

from ..align.params import AlignParams
from ..align.pipeline import AlignEngine, pad_rows
from ..index.build import build_index
from ..index.device import to_device
from ..seq.encode import revcomp


@dataclass
class ScaffoldEdge:
    a: int          # contig index
    a_end: int      # +1: link leaves a's 3' end; -1: a's 5' end
    b: int
    b_end: int
    votes: int
    gap: int        # estimated gap (can be negative = overlap)


def pe_links(
    contigs: list[np.ndarray],
    reads1: np.ndarray, len1: np.ndarray,
    reads2: np.ndarray, len2: np.ndarray,
    insert_size: int = 400,
    min_votes: int = 2,
    device: torch.device | str = "cuda",
):
    """Collect inter-contig PE link edges."""
    idx = build_index([(f"ctg{i}", c) for i, c in enumerate(contigs)],
                      lut_bases=8)
    didx = to_device(idx, device)
    engine = AlignEngine(didx, AlignParams())
    r1, l1 = pad_rows(reads1, len1)
    r2, l2 = pad_rows(reads2, len2)
    res1 = engine.align_with_rescue(r1, l1)
    res2 = engine.align_with_rescue(r2, l2)
    starts = idx.entry_starts
    lens = np.diff(starts)

    votes = defaultdict(list)
    n = len(reads1)
    for i in range(n):
        if not (res1["unique"][i] and res2["unique"][i]):
            continue
        e1 = int(np.searchsorted(starts, res1["locus"][i], "right")) - 1
        e2 = int(np.searchsorted(starts, res2["locus"][i], "right")) - 1
        if e1 == e2:
            continue
        p1 = int(res1["locus"][i] - starts[e1])
        p2 = int(res2["locus"][i] - starts[e2])
        rc1 = bool(res1["is_rc"][i])
        rc2 = bool(res2["is_rc"][i])
        # FR library: mate points INTO the gap. A forward mate near a
        # contig 3' end links that 3' end; a reverse mate near the 5' end
        # links the 5' end.
        a_end = 1 if not rc1 else -1
        b_end = 1 if not rc2 else -1
        d1 = (int(lens[e1]) - p1) if not rc1 else (p1 + int(len1[i]))
        d2 = (int(lens[e2]) - p2) if not rc2 else (p2 + int(len2[i]))
        gap = insert_size - d1 - d2
        key = (e1, a_end, e2, b_end)
        votes[key].append(gap)

    edges = []
    for (a, ae, b, be), gaps in votes.items():
        if len(gaps) >= min_votes:
            edges.append(
                ScaffoldEdge(a, ae, b, be, len(gaps), int(np.median(gaps)))
            )
    return edges


def components(n: int, edges: list[ScaffoldEdge]):
    """Disconnected-component identification (AssembGraph.cpp:1300 role)."""
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e in edges:
        ra, rb = find(e.a), find(e.b)
        if ra != rb:
            parent[ra] = rb
    comps = defaultdict(list)
    for i in range(n):
        comps[find(i)].append(i)
    return list(comps.values())


def scaffold(
    contigs: list[np.ndarray],
    reads1: np.ndarray, len1: np.ndarray,
    reads2: np.ndarray, len2: np.ndarray,
    insert_size: int = 400,
    min_votes: int = 2,
    gap_n: int = 10,
    device: torch.device | str = "cuda",
) -> tuple[list[np.ndarray], list[list[int]]]:
    """Scaffold contigs with PE links; returns (scaffolds, paths).

    Paths are walked through mutually-best end links; joins insert
    max(gap, gap_n) Ns (the reference emits estimated-gap Ns)."""
    edges = pe_links(contigs, reads1, len1, reads2, len2, insert_size,
                     min_votes, device)
    n = len(contigs)
    # best edge per (contig, end)
    best: dict[tuple, ScaffoldEdge] = {}
    for e in edges:
        for key, rev in (((e.a, e.a_end), False), ((e.b, e.b_end), True)):
            cur = best.get(key)
            if cur is None or e.votes > cur.votes:
                best[key] = e

    def partner(e: ScaffoldEdge, c: int):
        return (e.b, e.b_end) if e.a == c else (e.a, e.a_end)

    used = np.zeros(n, bool)
    paths = []
    # heads: contigs whose 5' end has no mutual link
    for c0 in range(n):
        if used[c0]:
            continue
        # try to walk from this contig's 3' end; first rewind via 5' end
        path = [(c0, +1)]
        used[c0] = True
        # extend forward through 3' links
        cur, cur_end = c0, 1
        while True:
            e = best.get((cur, cur_end))
            if e is None:
                break
            nxt, nxt_end = partner(e, cur)
            # mutual best check
            if best.get((nxt, nxt_end)) is not e or used[nxt]:
                break
            used[nxt] = True
            # entering via nxt_end; orientation: if we enter via 5' (-1)
            # the contig reads forward, else reversed
            path.append((nxt, -nxt_end))
            cur, cur_end = nxt, -nxt_end
        paths.append(path)

    scaffolds = []
    out_paths = []
    for path in paths:
        parts = []
        ids = []
        for ci, orient in path:
            seq = contigs[ci] if orient > 0 else revcomp(contigs[ci])
            if parts:
                parts.append(np.full(gap_n, 4, dtype=np.int8))
            parts.append(seq)
            ids.append(ci if orient > 0 else -ci - 1)
        scaffolds.append(np.concatenate(parts))
        out_paths.append(ids)
    return scaffolds, out_paths
