"""Copy of biokanga_tpu/align/reports.py: the PE insert-size report.

Parity role: ReportAlignStats / WriteSubDist / PE insert distributions
(biokanga/Aligner.cpp:3493,6275,5340).  Only what `align --peinsertdist`
uses is copied: the insert-size histogram of proper pairs and the CSV
writer.  The CSV equals the JAX CLI's byte for byte, so the category
counts and the NM histogram that this mode never fills keep their (zero
or empty) rows.
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
