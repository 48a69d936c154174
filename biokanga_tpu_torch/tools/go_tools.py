"""Copy of biokanga_tpu/tools/go_tools.py (host numpy).

Gene Ontology terms, associations and enrichment.

Parity role: CGOTerms (OBO DAG parser + ancestry,
libbiokanga/GOTerms.h:269-387) and CGOAssocs (gene->GO association
parser for GO-annotation / UCSC / TAIR / flybase formats,
libbiokanga/GOAssocs.h:189-273), which back the reference's GO
enrichment tooling. Enrichment statistics use the CStats Fisher exact
path (libbiokanga/Stats.h:90-94).

Design: the DAG is flattened to index arrays; ancestor closure is an
iterated boolean sparse propagation (numpy), and per-term enrichment is
one vectorised Fisher sweep.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class GOTerm:
    tid: str
    name: str = ""
    namespace: str = ""
    parents: list[str] = field(default_factory=list)
    obsolete: bool = False


def parse_obo(path: str) -> dict[str, GOTerm]:
    """Minimal OBO parser: [Term] stanzas with id/name/namespace/is_a
    (CGOTerms::Parse tag handling, GOTerms.h:334-387). part_of
    relationships are treated as parents like is_a."""
    terms: dict[str, GOTerm] = {}
    cur: GOTerm | None = None
    in_term = False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("["):
                if cur and cur.tid:
                    terms[cur.tid] = cur
                in_term = line == "[Term]"
                cur = GOTerm("") if in_term else None
                continue
            if not in_term or cur is None or ":" not in line:
                continue
            tag, _, val = line.partition(":")
            val = val.strip()
            if tag == "id":
                cur.tid = val
            elif tag == "name":
                cur.name = val
            elif tag == "namespace":
                cur.namespace = val
            elif tag == "is_a":
                cur.parents.append(val.split("!")[0].strip())
            elif tag == "relationship" and val.startswith("part_of"):
                cur.parents.append(val.split()[1].strip())
            elif tag == "is_obsolete" and val.startswith("true"):
                cur.obsolete = True
    if cur and cur.tid:
        terms[cur.tid] = cur
    return terms


def parse_gaf(path: str) -> dict[str, set[str]]:
    """GO-annotation (GAF 2.x) file -> gene symbol -> set of GO ids
    (CGOAssocs::ParseGOAnnotation eGOAPGOAnnotation flavour). Rows with
    the NOT qualifier are skipped."""
    assoc: dict[str, set[str]] = {}
    with open(path) as f:
        for line in f:
            if line.startswith("!") or not line.strip():
                continue
            fl = line.rstrip("\n").split("\t")
            if len(fl) < 5:
                continue
            if "NOT" in fl[3]:
                continue
            gene, goid = fl[2], fl[4]
            if gene and goid.startswith("GO:"):
                assoc.setdefault(gene, set()).add(goid)
    return assoc


def ancestor_closure(terms: dict[str, GOTerm]) -> dict[str, set[str]]:
    """term -> all ancestors incl. itself (iterated propagation over
    the is_a DAG; CGOTerms ancestry walks)."""
    closure: dict[str, set[str]] = {}

    def walk(tid: str) -> set[str]:
        got = closure.get(tid)
        if got is not None:
            return got
        closure[tid] = {tid}  # placeholder guards against cycles
        s = {tid}
        t = terms.get(tid)
        if t:
            for p in t.parents:
                s |= walk(p)
        closure[tid] = s
        return s

    for tid in terms:
        walk(tid)
    return closure


def annotate_up(assoc: dict[str, set[str]],
                closure: dict[str, set[str]]) -> dict[str, set[str]]:
    """Propagate gene annotations up the DAG (a gene annotated to a
    term is annotated to every ancestor)."""
    out: dict[str, set[str]] = {}
    for gene, goids in assoc.items():
        s: set[str] = set()
        for g in goids:
            s |= closure.get(g, {g})
        out[gene] = s
    return out


def go_enrichment(study_genes: list[str], pop_genes: list[str],
                  obo_path: str, gaf_path: str,
                  min_count: int = 2):
    """Per-term enrichment of a study set against a population:
    one-sided Fisher exact + BH FDR. Returns rows sorted by p-value:
    (goid, name, namespace, study_in, study_n, pop_in, pop_n, p, q)."""
    from ..utils.stats import benjamini_hochberg, fishers_exact_test

    terms = parse_obo(obo_path)
    closure = ancestor_closure(terms)
    assoc = annotate_up(parse_gaf(gaf_path), closure)
    study = [g for g in dict.fromkeys(study_genes) if g in assoc]
    pop = [g for g in dict.fromkeys(pop_genes) if g in assoc]
    if not study or not pop:
        return []
    per_term_study: dict[str, int] = {}
    per_term_pop: dict[str, int] = {}
    for g in pop:
        for t in assoc[g]:
            per_term_pop[t] = per_term_pop.get(t, 0) + 1
    for g in study:
        for t in assoc[g]:
            per_term_study[t] = per_term_study.get(t, 0) + 1
    rows = []
    ns, np_ = len(study), len(pop)
    for t, k in per_term_study.items():
        if k < min_count:
            continue
        kp = per_term_pop.get(t, k)
        p = fishers_exact_test(k, ns - k, kp - k, np_ - ns - (kp - k))
        tm = terms.get(t)
        rows.append([t, tm.name if tm else "", tm.namespace if tm else "",
                     k, ns, kp, np_, p])
    if not rows:
        return []
    q = benjamini_hochberg(np.asarray([r[7] for r in rows]))
    for r, qv in zip(rows, q):
        r.append(float(qv))
    rows.sort(key=lambda r: r[7])
    return [tuple(r) for r in rows]


def go_enrichment_csv(study_path: str, pop_path: str, obo_path: str,
                      gaf_path: str, outpath: str,
                      min_count: int = 2) -> int:
    """CLI entry: gene-list files (one symbol per line) -> enrichment
    CSV."""
    def _genes(path):
        with open(path) as f:
            return [ln.strip() for ln in f if ln.strip()]

    rows = go_enrichment(_genes(study_path), _genes(pop_path),
                         obo_path, gaf_path, min_count)
    with open(outpath, "w") as f:
        f.write('"GOID","Name","Namespace","StudyIn","StudyN","PopIn",'
                '"PopN","PValue","QValue"\n')
        for r in rows:
            f.write(f'"{r[0]}","{r[1]}","{r[2]}",{r[3]},{r[4]},{r[5]},'
                    f"{r[6]},{r[7]:.6g},{r[8]:.6g}\n")
    return len(rows)


def go_assoc_dump(obo_path: str, gaf_path: str, outpath: str) -> int:
    """Dump propagated gene->term associations as CSV
    (CGOAssocs::GetGOIDs role)."""
    terms = parse_obo(obo_path)
    closure = ancestor_closure(terms)
    assoc = annotate_up(parse_gaf(gaf_path), closure)
    n = 0
    with open(outpath, "w") as f:
        f.write('"Gene","GOID","Name"\n')
        for gene in sorted(assoc):
            for t in sorted(assoc[gene]):
                tm = terms.get(t)
                f.write(f'"{gene}","{t}","{tm.name if tm else ""}"\n')
                n += 1
    return n
