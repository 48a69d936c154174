"""Reads for the single-end option tests: a "sample" genome with planted
SNPs, reads carrying micro-indels and splice junctions, and reads whose
tail is junk (numpy and the port's numpy-only base codes, no jax:
chip_smoke.py imports it too).

The indels and junctions are events of the sample, each carried by
several reads, as in a resequencing or RNA-seq run: `align` demotes an
indel or a junction that no second read supports (the orphan filters),
so a read with an indel of its own would never stay aligned.  Events sit
away from the planted SNPs, because `align -O` piles each read up
ungapped from its locus (as the JAX package does), so the bases past an
event's split pile up shifted and raise the local background there.
"""
import sqlite3

import numpy as np

from biokanga_tpu_torch.seq.encode import revcomp

BASES = "ACGT"


def plant_snps(seqs, every: int, rng, margin: int = 300):
    """Copy of `seqs` with one substitution about every `every` bases of
    each entry, `margin` from its ends.  Returns (sample, truth) with
    truth {(entry name, 0-based locus): (ref code, sample code)}."""
    sample, truth = [], {}
    for name, g in seqs:
        s = g.copy()
        n = max(1, (len(g) - 2 * margin) // every)
        loci = np.sort(rng.choice(len(g) - 2 * margin, n, replace=False)
                       + margin)
        for p in loci:
            new = (s[p] + 1 + rng.integers(0, 3)) % 4
            truth[(name, int(p))] = (int(s[p]), int(new))
            s[p] = new
        sample.append((name, s))
    return sample, truth


def plan_events(seqs, n_indel: int, n_splice: int, snps, rng,
                read_len: int = 100, max_intron: int = 5_000,
                spacing: int = 300, clear: int = 150):
    """Event sites: one slot every `spacing` bases, none within `clear`
    bases of a planted SNP (or, for a junction, with its acceptor past
    the entry's end).  Returns a list of (kind, entry index, site, size,
    inserted codes): kind "D" (deletion of `size` genome bases), "I"
    (insertion of `size` bases) or "N" (intron of `size` bases)."""
    snp_at = {}
    for (name, p) in snps:
        snp_at.setdefault(name, []).append(p)
    slots = []
    for e, (name, g) in enumerate(seqs):
        near = np.sort(np.asarray(snp_at.get(name, []), np.int64))
        for site in range(read_len + spacing, len(g) - read_len - spacing,
                          spacing):
            k = np.searchsorted(near, site)
            if ((k < len(near) and near[k] - site < clear)
                    or (k > 0 and site - near[k - 1] < clear)):
                continue
            slots.append((e, site))
    events = []
    for si in rng.permutation(len(slots)):
        if len(events) == n_indel + n_splice:
            break
        e, site = slots[si]
        if len(events) < n_indel:
            size = int(rng.integers(1, 11))
            if len(events) % 2 == 0:
                events.append(("D", e, site, size, None))
            else:
                ins = rng.integers(0, 4, size).astype(np.int8)
                events.append(("I", e, site, size, ins))
            continue
        room = len(seqs[e][1]) - site - read_len
        if room <= 500:
            continue                      # no intron fits before the end
        size = int(rng.integers(500, min(max_intron, room - 1) + 1))
        events.append(("N", e, site, size, None))
    if len(events) < n_indel + n_splice:
        raise ValueError(f"{n_indel + n_splice} events need more than "
                         f"{len(slots)} slots")
    return events


def _event_read(sample, ev, L: int, rng):
    """(origin, split, forward codes) of one read across event `ev`, both
    segments at least 20 bases."""
    kind, e, site, size, ins = ev
    g = sample[e][1]
    if kind == "I":
        s = int(rng.integers(20, L - 20 - size + 1))
        p = site - s
        fwd = np.concatenate([g[p:site], ins, g[site:site + L - s - size]])
    else:
        s = int(rng.integers(20, L - 20 + 1))
        p = site - s
        gap = size
        fwd = np.concatenate([g[p:site], g[site + gap:site + gap + L - s]])
    return p, s, fwd.astype(np.int8)


def alter_reads(names, reads, sample, events, rng, indel_share: float,
                splice_share: float, junk_share: float, block: int,
                sub_rate: float = 0.002, junk_len: int = 30):
    """Replace shares of simulated reads (rows of `reads`, renamed in
    `names`) by event reads, and junk the last `junk_len` bases of
    another share.  The event reads take the events round robin, a
    random strand and substitutions at `sub_rate`; the reads of one
    event lie at random rows of one `block` of rows, since `align`
    filters orphans a block at a time (as the JAX CLI does).  Returns the
    truth rows {"D"/"I"/"N": [(row, entry, origin, strand, size)],
    "junk": [rows]}."""
    n, L = reads.shape
    pools = [list(rng.permutation(np.arange(a, min(n, a + block))))
             for a in range(0, n, block)]
    indel_ev = [ev for ev in events if ev[0] != "N"]
    splice_ev = [ev for ev in events if ev[0] == "N"]
    truth = {"D": [], "I": [], "N": [], "junk": []}
    for count, evs in ((int(round(indel_share * n)), indel_ev),
                       (int(round(splice_share * n)), splice_ev)):
        per = -(-count // len(evs))
        done = 0
        for ev in evs:
            k = min(per, count - done)
            pool = pools[int(rng.integers(0, len(pools)))]
            if len(pool) < k:
                pool = max(pools, key=len)
            for _ in range(k):
                row = int(pool.pop())
                p, s, fwd = _event_read(sample, ev, L, rng)
                sub = rng.random(L) < sub_rate
                fwd[sub] = (fwd[sub] + 1
                            + rng.integers(0, 3, int(sub.sum()))) % 4
                strand = "+" if rng.random() < 0.5 else "-"
                reads[row] = fwd if strand == "+" else revcomp(fwd)
                name = sample[ev[1]][0]
                names[row] = (f"ev|{ev[0]}{ev[3]}|{name}|{p}|{strand}|{s}|"
                              f"{row}")
                truth[ev[0]].append((row, name, p, strand, ev[3]))
            done += k
    rest = np.concatenate([np.asarray(pl, np.int64) for pl in pools])
    for row in rng.permutation(rest)[:int(round(junk_share * n))]:
        reads[row, L - junk_len:] = rng.integers(0, 4, junk_len)
        truth["junk"].append(int(row))
    return truth


def loci_constraints_csv(path, seqs, rng, n: int = 6):
    """A --lociconstraints file: `n` short ranges, some allowing only the
    reference base ("R"), some a fixed pair of bases."""
    with open(path, "w") as f:
        f.write("# chrom,start,end,bases\n")
        for j in range(n):
            name, g = seqs[j % len(seqs)]
            a = int(rng.integers(100, len(g) - 120))
            bases = "R" if j % 2 == 0 else "AC"
            f.write(f"{name},{a},{a + int(rng.integers(0, 4))},{bases}\n")


def priority_bed(path, seqs, rng, n: int = 8, width: int = 4_000):
    """A -Y BED file of `n` regions of `width` bases."""
    with open(path, "w") as f:
        for j in range(n):
            name, g = seqs[j % len(seqs)]
            a = int(rng.integers(0, max(1, len(g) - width)))
            f.write(f"{name}\t{a}\t{a + width}\tregion{j}\n")


def sumrslts_rows(db) -> list:
    """The rows of the four `-q` tables without their time fields (the
    Started and Finished columns and the value of the `seconds` result)."""
    con = sqlite3.connect(db)
    try:
        return [con.execute(q).fetchall() for q in (
            "SELECT ExprID, ExprName, ExprDescr FROM TblExperiments",
            "SELECT ProcessID, ExprID, ProcName, ResultCode FROM "
            "TblProcesses",
            "SELECT * FROM TblParameters",
            "SELECT ResultID, ExprID, ProcessID, ResultName, CASE WHEN "
            "ResultName = 'seconds' THEN NULL ELSE ResultValue END FROM "
            "TblResults")]
    finally:
        con.close()
