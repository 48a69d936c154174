"""Copy of biokanga_tpu/align/reports.py: alignment statistics reports.

Parity role: ReportAlignStats / WriteSubDist / PE insert distributions
(biokanga/Aligner.cpp:3493,6275,5340) — per-run category counts,
NM (substitution-count) distribution and PE insert-size histogram
written as CSV (`align --stats` and `--peinsertdist`).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class AlignStats:
    total: int = 0
    unique: int = 0
    multi: int = 0
    multi_assigned: int = 0
    chimeric: int = 0
    indel: int = 0
    spliced: int = 0
    unaligned: int = 0
    nm_hist: dict = field(default_factory=dict)
    insert_hist: dict = field(default_factory=dict)

    def add_batch(self, res: dict, n_real: int):
        self.total += n_real
        u = res["unique"][:n_real]
        self.unique += int(u.sum())
        hit = res["any_hit"][:n_real]
        self.multi += int((hit & ~u).sum())
        self.unaligned += int((~hit).sum())
        for nm in res["best_mm"][:n_real][u]:
            self.nm_hist[int(nm)] = self.nm_hist.get(int(nm), 0) + 1
        if "cigar_op" in res:
            ops = res["cigar_op"][:n_real][u]
            self.spliced += int((ops == (1 << 30)).sum())
            self.indel += int(((ops != 0) & (ops != (1 << 30))).sum())

    def add_inserts(self, inserts, proper):
        for v in np.asarray(inserts)[np.asarray(proper)]:
            b = (int(v) // 10) * 10
            self.insert_hist[b] = self.insert_hist.get(b, 0) + 1

    def write_csv(self, path: str):
        with open(path, "w") as f:
            f.write('"Stat","Value"\n')
            for k in ("total", "unique", "multi", "multi_assigned",
                      "chimeric", "indel", "spliced", "unaligned"):
                f.write(f'"{k}",{getattr(self, k)}\n')
            f.write('"NM","Count"\n')
            for nm in sorted(self.nm_hist):
                f.write(f"{nm},{self.nm_hist[nm]}\n")
            if self.insert_hist:
                f.write('"InsertBin","Count"\n')
                for b in sorted(self.insert_hist):
                    f.write(f"{b},{self.insert_hist[b]}\n")
