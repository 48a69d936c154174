"""Judge the aligner's paired-end output against the reference.

For each sampled pair the program's final fields of both mates (after
its orphan rescue) and its proper-pair flag are compared with what the
reference derives from its exhaustive hit lists (aligner.py) under the
search guarantee the settings state (guarantee.py):

- soundness, for every mate: a hit the program reports (its first hit
  where it calls the mate placed or unique, and every multi-hit entry)
  is a true placement with its true mismatch count;
- exactness, for a pair whose mates both have their best placement
  within the guarantee (or no placement at all): unique, any_hit, and
  where placed the locus, strand and count of the first hit, the
  multi-hit entries within the guarantee's multi-hit level, and the
  proper flag all equal the reference's, the orphan rescue included;
- consistency, for the other pairs: the proper flag is what the pair
  rule gives on the program's own final placements.

Returns the number of mates and of pairs that fail.
"""
from __future__ import annotations

import numpy as np

from .aligner import Hits, answers, classify, pair_and_rescue
from .guarantee import Guarantee

FIELDS = ("unique", "any_hit", "best_mm", "locus", "is_rc", "ml_loci",
          "ml_mm", "ml_rc")


def _hit_sets(hits: Hits, n: int):
    sets = [set() for _ in range(n)]
    for r, m, c, l in zip(hits.read.tolist(), hits.mm.tolist(),
                          hits.is_rc.tolist(), hits.locus.tolist()):
        sets[r].add((int(l), bool(c), int(m)))
    return sets


def _mate_faults(prog: dict, ref: dict, sets, exact: np.ndarray,
                 g: Guarantee) -> np.ndarray:
    """Per mate: True where a reported hit is false, or where an exact
    mate's fields differ from the reference's."""
    n = len(prog["unique"])
    bad = np.zeros(n, bool)
    for i in range(n):
        placed = bool(prog["unique"][i] or prog["any_hit"][i])
        first = (int(prog["locus"][i]), bool(prog["is_rc"][i]),
                 int(prog["best_mm"][i]))
        if placed and first not in sets[i]:
            bad[i] = True
        ml = [(int(l), bool(c), int(m)) for l, c, m in zip(
            prog["ml_loci"][i], prog["ml_rc"][i], prog["ml_mm"][i]) if l >= 0]
        if any(h not in sets[i] for h in ml):
            bad[i] = True
        if not exact[i] or bad[i]:
            continue
        if (bool(prog["unique"][i]) != bool(ref["unique"][i])
                or bool(prog["any_hit"][i]) != bool(ref["any_hit"][i])):
            bad[i] = True
            continue
        if placed and first != (int(ref["locus"][i]), bool(ref["is_rc"][i]),
                                int(ref["best_mm"][i])):
            bad[i] = True
            continue
        want = [(int(l), bool(c), int(m)) for l, c, m in zip(
            ref["ml_loci"][i], ref["ml_rc"][i], ref["ml_mm"][i])
            if l >= 0 and m <= g.multi_mm]
        if [h for h in ml if h[2] <= g.multi_mm] != want:
            bad[i] = True
    return bad


def judge(prog1: dict, prog2: dict, proper: np.ndarray, hits1: Hits,
          hits2: Hits, genome, entry_starts, reads1: np.ndarray,
          reads2: np.ndarray, g: Guarantee, settings: dict,
          unstable: np.ndarray | None = None) -> dict:
    """Counts of wrong mates and wrong pairs among the sampled pairs.
    prog*: the program's final per-mate fields (numpy, one row a pair);
    settings: min_edit_dist, max_multi, pair_min_len, pair_max_len;
    unstable: pairs whose output differed between passes of the window,
    which count as wrong."""
    n = len(proper)
    ref1 = answers(hits1, n, settings["min_edit_dist"], settings["max_multi"])
    ref2 = answers(hits2, n, settings["min_edit_dist"], settings["max_multi"])
    exact1 = ~ref1["any_hit"] | (ref1["best_mm"] <= g.best_mm)
    exact2 = ~ref2["any_hit"] | (ref2["best_mm"] <= g.best_mm)
    pair_exact = exact1 & exact2
    ref_cls = pair_and_rescue(genome, entry_starts, ref1, ref2, reads1,
                              reads2, settings["pair_min_len"],
                              settings["pair_max_len"], g.max_mm)
    own_cls = classify(prog1, prog2, reads1.shape[1], reads2.shape[1],
                       entry_starts, settings["pair_min_len"],
                       settings["pair_max_len"])
    bad1 = _mate_faults(prog1, ref1, _hit_sets(hits1, n), pair_exact, g)
    bad2 = _mate_faults(prog2, ref2, _hit_sets(hits2, n), pair_exact, g)
    proper = np.asarray(proper, bool)
    bad_flag = np.where(pair_exact, proper != ref_cls["proper"],
                        proper != own_cls["proper"])
    bad_pair = bad1 | bad2 | bad_flag
    if unstable is not None:
        bad_pair |= unstable
    return {"wrong_mates": int(bad1.sum() + bad2.sum()),
            "wrong_pairs": int(bad_pair.sum()),
            "checked_pairs": int(n),
            "pairs_past_guarantee": int((~pair_exact).sum())}


def control_output(hits1: Hits, hits2: Hits, genome, entry_starts,
                   reads1, reads2, g: Guarantee, settings: dict,
                   span: int) -> tuple[dict, dict, np.ndarray]:
    """The reference in the program's place, counting mismatches over the
    first `span` bases only: the control, which breaks the guarantee that
    a count covers the whole read.  hits* must come from find_hits with
    the same span."""
    n = len(reads1)
    m1 = answers(hits1, n, settings["min_edit_dist"], settings["max_multi"])
    m2 = answers(hits2, n, settings["min_edit_dist"], settings["max_multi"])
    cls = pair_and_rescue(genome, entry_starts, m1, m2, reads1, reads2,
                          settings["pair_min_len"], settings["pair_max_len"],
                          g.max_mm, span)
    return m1, m2, cls["proper"]
