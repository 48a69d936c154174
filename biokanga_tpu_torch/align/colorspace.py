"""SOLiD colorspace alignment.

Counterpart of biokanga_tpu/align/colorspace.py, with the same results.
Parity role: the reference's colorspace mode — the genome is transformed
to dibase color codes when the index is built (`kangax -C`;
SfxArrayV2.cpp:300-380) and SOLiD color reads are aligned in color space
(`kanga align -C`), with the standard Hamming-margin acceptance applied
to COLOR mismatches.

Colors are strand-symmetric (the colorspace of a reverse complement is
simply the reversed color string), so ONE sense-strand engine over the
color-transformed genome serves both strands:

  pass 1: colors(read)          vs colors(genome)   -> top-strand hits
  pass 2: reverse(colors(read)) vs colors(genome)   -> bottom-strand hits

A color locus p maps directly to base-space start p (color[i] covers
bases i, i+1), for both passes.  Both passes are enqueued before either
is fetched; results merge on the host with the same best/next-best
MMDelta margin rule as the primary aligner (bisulfite.merge_two_pass).
"""
from __future__ import annotations

import numpy as np

from .bisulfite import fetch_results, merge_two_pass
from .pipeline import AlignEngine


def reverse_rows(reads: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Per-row reversal of the first `lengths[i]` codes (padding stays at
    the tail).  Vectorized gather — no Python per-read loop."""
    B, L = reads.shape
    cols = np.arange(L)[None, :]
    src = lengths[:, None] - 1 - cols
    src = np.where(cols < lengths[:, None], src, cols)
    return np.take_along_axis(reads, src, axis=1)


class ColorspaceAligner:
    """Two-pass colorspace aligner over a color-transformed index."""

    def __init__(self, engine: AlignEngine):
        if engine.params.strand != "sense":
            raise ValueError("colorspace engine must be sense-only; the "
                             "reversed-read pass covers the bottom strand")
        self.engine = engine

    def align_batch(self, color_reads: np.ndarray,
                    lengths: np.ndarray) -> dict:
        out_f, _ = self.engine.launch(color_reads, lengths)
        out_r, _ = self.engine.launch(
            reverse_rows(color_reads, lengths), lengths)
        r_f, r_r = fetch_results(out_f, out_r)
        return merge_two_pass(r_f, r_r, lengths, self.engine.params)
