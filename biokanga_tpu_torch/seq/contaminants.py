"""Copy of biokanga_tpu/seq/contaminants.py: the adaptor/vector
contaminant database, CContaminants parity (libbiokanga/Contaminants.h:31,
95-110; Contaminants.cpp:195-1260).

Two contaminant classes, selected by the reference's sequence-naming
convention in the contaminants multifasta:

- FLANK ('@' suffix codes): adaptor-style sequences that overlay a read
  flank.  Codes (any combination): '1' 5'PE1, '2' 5'PE2, '3' 3'PE1,
  '4' 3'PE2, '5'..'8' the same four after reverse-complementing the
  contaminant.  No suffix defaults to 5' PE1+PE2 (Contaminants.cpp:197).
  A 5' overlay means a contaminant SUFFIX covers the read PREFIX; a 3'
  overlay means a contaminant PREFIX covers the read SUFFIX.  Allowed
  substitutions: max(1, overlap*rate/25) when rate > 0.  Host numpy,
  one (B, k) compare per (contaminant, overlap length).
- VECTOR ('&' suffix codes '1','2','5','6'): long sequences expected to
  completely CONTAIN a read (cloning-vector contamination).  The
  containment search is the port's aligner (`AlignEngine.align_with_rescue`
  over an index of the vectors) on the device the database was given:
  on a CUDA device it launches the sort and extension kernels, on the
  CPU their plain versions.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..device import resolve_device
from .encode import revcomp
from .fasta import read_seqs

C_MIN_CONTAM_QUERY_LEN = 20     # cMinContamQuerySeqLen
C_MAX_CONTAM_QUERY_LEN = 2000   # cMaxContamQuerySeqLen
C_MIN_CONTAM_LEN = 4            # cMinContaminantLen
C_MAX_CONTAM_LEN = 200          # cMaxContaminantLen
C_MIN_VECTOR_LEN = 100          # cMinVectorSeqLen

# flank overlay types (teContamType)
T_5PE1, T_5PE2, T_3PE1, T_3PE2 = 0, 1, 2, 3
TYPE_NAMES = ("5'PE1", "5'PE2", "3'PE1", "3'PE2")


@dataclass
class FlankContam:
    contam_id: int
    name: str
    codes: np.ndarray        # int8, possibly already revcomp'd
    types: tuple[int, ...]   # overlay types this sequence applies to
    rc: bool
    hit_tot: int = 0
    hit_dist: np.ndarray = None  # (len+1,) overlap-length distribution


@dataclass
class VectorContam:
    contam_id: int
    name: str
    codes: np.ndarray
    pe1: bool
    pe2: bool
    rc: bool
    hit_tot: int = 0


class Contaminants:
    """Loaded contaminant DB + vectorised matchers."""

    def __init__(self, device=None):
        self.flank: list[FlankContam] = []
        self.vectors: list[VectorContam] = []
        # the vector screen's device (None: the database only matches
        # flanks)
        self.device = None if device is None else resolve_device(device)
        self._vec_engine = None

    @staticmethod
    def load(path: str, device=None) -> "Contaminants":
        """Load a contaminants multifasta.  `device` is where
        match_vectors runs the aligner; "cuda" raises without CUDA."""
        db = Contaminants(device)
        cid = 0
        for rec in read_seqs(path):
            name = rec.name
            codes = rec.codes
            if "&" in name:                     # vector class
                base, suffix = name.split("&", 1)
                codesets = set(suffix)
                for rc in (False, True):
                    want = {"5", "6"} if rc else {"1", "2"}
                    if not (codesets & want):
                        continue
                    cid += 1
                    db.vectors.append(VectorContam(
                        contam_id=cid, name=base,
                        codes=revcomp(codes) if rc else codes.copy(),
                        pe1=("5" if rc else "1") in codesets,
                        pe2=("6" if rc else "2") in codesets,
                        rc=rc,
                    ))
                continue
            if "@" in name:
                base, suffix = name.split("@", 1)
                codesets = set(suffix)
            else:                               # default: 5' PE1 + PE2
                base, codesets = name, {"1", "2"}
            ty_plain = [t for c, t in (("1", T_5PE1), ("2", T_5PE2),
                                       ("3", T_3PE1), ("4", T_3PE2))
                        if c in codesets]
            ty_rc = [t for c, t in (("5", T_5PE1), ("6", T_5PE2),
                                    ("7", T_3PE1), ("8", T_3PE2))
                     if c in codesets]
            for rc, tys in ((False, ty_plain), (True, ty_rc)):
                if not tys:
                    continue
                cid += 1
                seq = revcomp(codes) if rc else codes.copy()
                if not (C_MIN_CONTAM_LEN <= len(seq) <= C_MAX_CONTAM_LEN):
                    continue
                db.flank.append(FlankContam(
                    contam_id=cid, name=base, codes=seq,
                    types=tuple(tys), rc=rc,
                    hit_dist=np.zeros(len(seq) + 1, np.int64),
                ))
        return db

    @property
    def num_flank(self) -> int:
        return len(self.flank)

    @property
    def num_vectors(self) -> int:
        return len(self.vectors)

    def match_flank(self, reads: np.ndarray, lengths: np.ndarray,
                    ctype: int, min_overlap: int = 1,
                    subs_rate: int = 1) -> np.ndarray:
        """(B,) longest accepted overlap per read for overlay type `ctype`
        (0 where none).  5' types compare contaminant suffixes against
        read prefixes; 3' types contaminant prefixes against read
        suffixes.  Updates per-contaminant hit stats."""
        B, L = reads.shape
        best = np.zeros(B, np.int64)
        ok_len = (lengths >= C_MIN_CONTAM_QUERY_LEN) & (
            lengths <= C_MAX_CONTAM_QUERY_LEN
        )
        is5 = ctype in (T_5PE1, T_5PE2)
        for fc in self.flank:
            if ctype not in fc.types:
                continue
            clen = len(fc.codes)
            kmax = int(min(clen, lengths.max() if B else 0, L))
            for k in range(kmax, max(min_overlap, 1) - 1, -1):
                allowed = max(1, (k * subs_rate) // 25) if subs_rate else 0
                if is5:
                    mm = (reads[:, :k] != fc.codes[None, clen - k:]).sum(1)
                    fit = np.full(B, True)
                else:
                    # 3' overlay at the read's true end (per-read offset)
                    idx = lengths[:, None] - k + np.arange(k)[None, :]
                    fit = lengths >= k
                    idxc = np.clip(idx, 0, L - 1)
                    mm = (np.take_along_axis(reads, idxc, 1)
                          != fc.codes[None, :k]).sum(1)
                hit = ok_len & fit & (mm <= allowed) & (best < k)
                if hit.any():
                    n = int(hit.sum())
                    fc.hit_tot += n
                    fc.hit_dist[k] += n
                    best[hit] = k
        return best

    def _vector_engine(self):
        """Lazy bounded-key index + align engine over the vector set, on
        the database's device."""
        if self._vec_engine is None and self.vectors:
            if self.device is None:
                raise ValueError("the vector screen needs a device: "
                                 "Contaminants.load(path, device)")
            from ..align.params import AlignParams
            from ..align.pipeline import AlignEngine
            from ..index.build import build_index
            from ..index.device import to_device

            seqs = [(f"v{v.contam_id}", v.codes) for v in self.vectors]
            idx = build_index(seqs, lut_bases=8)
            self._vec_engine = (
                AlignEngine(
                    to_device(idx, self.device),
                    AlignParams(max_subs_per100=8, strand="sense",
                                min_edit_dist=0),
                ),
                idx,
            )
        return self._vec_engine

    def match_vectors(self, reads: np.ndarray, lengths: np.ndarray,
                      is_pe2: bool = False) -> np.ndarray:
        """(B,) bool — read completely contained in a vector contaminant
        (any accepted alignment against the vector index; sense covers
        both vector orientations since rc copies are loaded per flags)."""
        eng = self._vector_engine()
        if eng is None:
            return np.zeros(len(reads), bool)
        engine, idx = eng
        use = [v for v in self.vectors if (v.pe2 if is_pe2 else v.pe1)]
        if not use:
            return np.zeros(len(reads), bool)
        from ..align.pipeline import pad_rows

        r, l = pad_rows(reads, lengths)
        res = engine.align_with_rescue(r, l)
        hit = np.asarray(res["any_hit"][: len(reads)]).copy()
        if len(use) != len(self.vectors):
            # restrict hits to vectors enabled for this mate
            starts = idx.entry_starts
            ent = np.searchsorted(starts, res["locus"][: len(reads)],
                                  side="right") - 1
            enabled = np.array([
                (v.pe2 if is_pe2 else v.pe1) for v in self.vectors
            ])
            hit &= enabled[np.clip(ent, 0, len(self.vectors) - 1)]
        for v in use:
            v.hit_tot += int(hit.sum())
        return hit

    def report_rows(self):
        """Per-contaminant summary rows (ngsqc contaminants section)."""
        rows = []
        for fc in self.flank:
            rows.append({
                "class": "flank", "name": fc.name,
                "types": "+".join(TYPE_NAMES[t] for t in fc.types),
                "rc": int(fc.rc), "len": len(fc.codes),
                "hits": int(fc.hit_tot),
            })
        for v in self.vectors:
            rows.append({
                "class": "vector", "name": v.name,
                "types": ("PE1" if v.pe1 else "")
                + ("+PE2" if v.pe2 else ""),
                "rc": int(v.rc), "len": len(v.codes),
                "hits": int(v.hit_tot),
            })
        return rows
