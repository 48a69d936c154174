"""Bisulfite (methylation-context) alignment.

Counterpart of biokanga_tpu/align/bisulfite.py, with the same results.
Parity role: the reference's bisulfite mode — a T/C- and A/G-collapsed
index copy is built at SfxBlock2Disk time (libbiokanga/SfxArrayV2.cpp:
440-459) and reads are aligned in collapsed space (kanga align bisulfite
processing mode).

Two collapsed indexes (CT for the converted top strand, GA for the
converted bottom strand), each searched by the standard engine
(align/pipeline.AlignEngine: kernels #1-#3) with the READ also C->T
collapsed:

  pass 1: CT(read)  vs CT(genome), sense strand only
  pass 2: rc(CT(read)) vs GA(genome) (the engine's antisense path)

A true top-strand read matches pass 1 exactly; a bottom-strand read
satisfies rc(CT(read)) == GA(genome window).  Both passes are enqueued
before either is fetched, their top-K lists come to the host in one copy
a batch (or as the engine's staged copies, on a CUDA index), and `merge_two_pass` merges them there in numpy with the same
best/next-best MMDelta margin rule as the primary aligner.
"""
from __future__ import annotations

import numpy as np
import torch

from ..seq.encode import ct_collapse
from .pipeline import AlignEngine, result_tensors

# the keys of an engine result that merge_two_pass reads
_MERGE_KEYS = ("ml_mm", "ml_loci", "overflow", "n_over", "cap_trunc")
_NP_DTYPES = {torch.uint8: np.uint8, torch.int32: np.int32,
              torch.bool: np.bool_}


def fetch_results(*outs) -> list[dict]:
    """The merge keys of several launches' results as host dicts, brought
    over in one device-to-host copy where they are still on the device."""
    outs = [result_tensors(o) for o in outs]
    cols = [o[k].reshape(o[k].shape[0], -1).to(torch.int32)
            for o in outs for k in _MERGE_KEYS]
    host = torch.cat(cols, dim=1).cpu().numpy()
    res, at = [], 0
    for o in outs:
        r = {}
        for k in _MERGE_KEYS:
            t = o[k]
            w = t.reshape(t.shape[0], -1).shape[1]
            r[k] = host[:, at:at + w].reshape(t.shape).astype(
                _NP_DTYPES[t.dtype])
            at += w
        res.append(r)
    return res


class BisulfiteAligner:
    """Two-engine bisulfite aligner (CT sense + GA antisense)."""

    def __init__(self, engine_ct: AlignEngine, engine_ga: AlignEngine):
        if (engine_ct.params.strand, engine_ga.params.strand) != (
                "sense", "antisense"):
            raise ValueError("BisulfiteAligner takes a sense CT engine and "
                             "an antisense GA engine")
        self.ct = engine_ct
        self.ga = engine_ga

    def align_batch(self, reads: np.ndarray, lengths: np.ndarray) -> dict:
        creads = ct_collapse(reads)
        out_ct, _ = self.ct.launch(creads, lengths)
        out_ga, _ = self.ga.launch(creads, lengths)
        r_ct, r_ga = fetch_results(out_ct, out_ga)
        return merge_two_pass(r_ct, r_ga, lengths, self.ct.params)


def merge_two_pass(r_fwd: dict, r_alt: dict, lengths: np.ndarray,
                   ap) -> dict:
    """Union two engines' top-K lists (forward pass + alternate-strand
    pass) and re-apply the best/next-best MMDelta margin rule.  Shared by
    the bisulfite (CT/GA) and SOLiD colorspace (fwd/reversed) aligners
    (copy of biokanga_tpu/align/bisulfite.py:50-102)."""
    mm = np.concatenate([r_fwd["ml_mm"], r_alt["ml_mm"]], axis=1).astype(
        np.int32)
    loci = np.concatenate([r_fwd["ml_loci"], r_alt["ml_loci"]], axis=1)
    K = r_fwd["ml_mm"].shape[1]
    strand = np.zeros_like(mm, dtype=bool)
    strand[:, K:] = True  # alternate pass == bottom strand (reported as rc)

    order = np.argsort(mm, axis=1, kind="stable")
    mm_s = np.take_along_axis(mm, order, axis=1)
    loci_s = np.take_along_axis(loci, order, axis=1)
    str_s = np.take_along_axis(strand, order, axis=1)

    if ap.max_subs_per100 == 0:
        max_tot = np.zeros(len(lengths), np.int32)
    else:
        max_tot = np.clip(
            np.floor(lengths * (ap.max_subs_per100 / 100.0) + 0.5
                     ).astype(np.int32), 1, 63)
    Ko = max(1, ap.max_multi)
    best = mm_s[:, 0]
    next_mm = mm_s[:, 1] if mm_s.shape[1] > 1 else np.full_like(best, 255)
    inst = (mm == best[:, None]).sum(axis=1)
    any_hit = best <= max_tot
    unique = any_hit & ((next_mm - best) >= ap.min_edit_dist)
    return {
        "unique": unique,
        "any_hit": any_hit,
        "best_mm": np.minimum(best, 255).astype(np.uint8),
        "inst": inst.astype(np.int32),
        "locus": loci_s[:, 0].astype(np.int32),
        "is_rc": str_s[:, 0],
        "overflow": np.asarray(r_fwd["overflow"]) | np.asarray(
            r_alt["overflow"]),
        "n_over": np.maximum(np.asarray(r_fwd["n_over"]),
                             np.asarray(r_alt["n_over"])),
        "cap_trunc": np.asarray(r_fwd["cap_trunc"]) | np.asarray(
            r_alt["cap_trunc"]),
        # valid-hit masking as in the accept stage (align/pipeline.py):
        # rows beyond the per-read budget are not alignments
        "ml_loci": np.where(mm_s[:, :Ko] <= max_tot[:, None],
                            loci_s[:, :Ko], -1),
        "ml_mm": np.where(mm_s[:, :Ko] <= max_tot[:, None],
                          np.minimum(mm_s[:, :Ko], 255), 255
                          ).astype(np.uint8),
        "ml_rc": np.where(mm_s[:, :Ko] <= max_tot[:, None],
                          str_s[:, :Ko], False),
    }
