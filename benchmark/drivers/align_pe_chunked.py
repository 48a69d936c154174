"""The paired-end aligner over a genome-range chunked index, as
`biokanga_tpu_torch align` runs it on a chunked index (`cli._align_chunked`).

Set-up makes the genome on the device from the seed, builds every chunk
of plan_chunks(genome, max_chunk, overlap) on the device through the
program's `index/device_build.build_resident_chunks`, one after another,
and keeps all of them there; then `ChunkedPEAligner` over a
`ChunkedAligner` of that resident set, the read pool, and warm-up
batches, which capture every chunk's graphs before the window.  A
program without a resident chunked index fails at that import, in
set-up.

The window runs the chunked paired-end loop of `cli._align_chunked`:
one batch in flight, `ChunkedPEAligner.launch_pairs` of batch k + 1
enqueued before `finish_pairs` of batch k, cycling the pool: every
pair's mates through every chunk's fast pass and classic pass, the
exact merge across chunks, pairing and the orphan rescue on the anchor's
chunk.  The harness copies a sample of pairs from each finished batch,
and the check judges them against the blocked reference
(reference/blocked.py), which finds every placement by a lemma whose
index fits one card, under the guarantee of the whole genome's length.
The check also counts the sample's orphans (pairs with one mate unique
in the reference) and the mates the program placed of those.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..genome import make_genome
from ..reference import blocked
from ..reference.aligner import answers
from ..reference.guarantee import guarantee
from ..reference.judge import FIELDS, judge
from .align_pe import WARMUP_BATCHES, AlignPE, _sync, draw_sample

DRIVER = "AlignPEChunked"
REF_BLOCK = 256_000_000     # start positions a block of the reference


class AlignPEChunked(AlignPE):
    def __init__(self, config: dict, traffic: dict, generator, seed: int,
                 device: torch.device):
        from biokanga_tpu_torch.align.params import AlignParams, Sensitivity
        from biokanga_tpu_torch.align.pe import PEParams
        from biokanga_tpu_torch.index.device_build import \
            build_resident_chunks
        from biokanga_tpu_torch.parallel.chunked import (ChunkedAligner,
                                                         ChunkedPEAligner)

        self.device = device
        self.config, self.traffic = config, traffic
        self.parts = {}
        t = time.perf_counter()
        codes, self.starts = make_genome(config["entries"], seed, device)
        self.genome = codes.cpu().numpy()
        del codes
        if device.type == "cuda":
            torch.cuda.empty_cache()
        self.parts["genome_s"] = time.perf_counter() - t
        t = time.perf_counter()
        resident = build_resident_chunks(
            self.genome, self.starts, [name for name, _ in config["entries"]],
            int(config["lut_bases"]), max_chunk=int(config["max_chunk"]),
            overlap=int(config["overlap"]), device=device)
        _sync(device)
        self.parts["index_s"] = time.perf_counter() - t
        self.parts["chunks"] = resident.num_chunks
        self.parts["index_gib"] = resident.nbytes() / 2**30
        a = config["align"]
        self.params = AlignParams(
            max_subs_per100=int(a["subs_per100"]),
            min_edit_dist=int(a["min_edit_dist"]),
            max_multi=int(a["max_multi"]), mode=Sensitivity(a["mode"]),
            strand=a["strand"])
        self.ca = ChunkedAligner(resident, self.params, device)
        del resident
        self.pe = ChunkedPEAligner(self.ca, PEParams(
            pair_min_len=int(traffic["pair_min_len"]),
            pair_max_len=int(traffic["pair_max_len"])))
        t = time.perf_counter()
        pool = generator.make_pool(self.genome, self.starts, traffic, seed)
        self.parts["pool_s"] = time.perf_counter() - t
        self.reads1, self.reads2 = pool["reads1"], pool["reads2"]
        self.lengths = pool["lengths"]
        del pool
        P = len(self.reads1)
        self.B = int(traffic["batch_pairs"])
        if P % self.B:
            raise ValueError(f"pool of {P} pairs is not whole batches of "
                             f"{self.B}")
        self.n_batches = P // self.B
        self.ln = self.lengths[: self.B]
        self.sample = draw_sample(seed, P, int(traffic["sample_pairs"]))
        bounds = np.searchsorted(self.sample,
                                 np.arange(self.n_batches + 1) * self.B)
        self.sample_of = [np.arange(bounds[b], bounds[b + 1])
                          for b in range(self.n_batches)]
        self.rows_of = [self.sample[s] - b * self.B
                        for b, s in enumerate(self.sample_of)]
        self._reset_sample()
        self.failed = 0
        t = time.perf_counter()
        self._run(min(WARMUP_BATCHES, self.n_batches))
        _sync(device)
        self.parts["warmup_s"] = time.perf_counter() - t
        self._reset_sample()

    def close(self) -> None:
        """Free every chunk's engine, graphs and index on the device."""
        self.pe = None
        self.ca.close()
        self.ca = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """Judge the sampled pairs the window returned against the blocked
        reference."""
        idx = np.nonzero(self.seen)[0]
        pairs = self.sample[idx]
        prog = [{f: self.got[(m, f)][idx] for f in FIELDS} for m in (1, 2)]
        r1, r2 = self.reads1[pairs], self.reads2[pairs]
        a = self.config["align"]
        g = guarantee(r1.shape[1], len(self.genome),
                      int(self.config["lut_bases"]), int(a["subs_per100"]),
                      int(a["min_edit_dist"]), a["mode"])
        genome = torch.from_numpy(self.genome).to(self.device)
        hits = [blocked.find_hits(genome, self.starts,
                                  torch.from_numpy(r).to(self.device),
                                  g.max_mm, block_len=REF_BLOCK)
                for r in (r1, r2)]
        settings = {"min_edit_dist": int(a["min_edit_dist"]),
                    "max_multi": int(a["max_multi"]),
                    "pair_min_len": int(self.traffic["pair_min_len"]),
                    "pair_max_len": int(self.traffic["pair_max_len"])}
        out = judge(prog[0], prog[1], self.got["proper"][idx], hits[0],
                    hits[1], genome, self.starts, r1, r2, g, settings,
                    unstable=self.unstable[idx])
        out["guarantee"] = g
        past = int(sum(((p["any_hit"] | p["unique"])
                        & (p["locus"] >= 2**31)).sum() for p in prog))
        self.parts["sample_mates_past_2_31"] = past
        ref = [answers(h, len(idx), int(a["min_edit_dist"]),
                       int(a["max_multi"])) for h in hits]
        orphan = ref[0]["unique"] ^ ref[1]["unique"]
        placed = orphan & prog[0]["unique"] & prog[1]["unique"]
        self.parts["sample_orphan_pairs"] = int(orphan.sum())
        self.parts["sample_orphan_mates_placed"] = int(placed.sum())
        print(f"sampled mates placed past 2^31: {past}; orphan pairs "
              f"{int(orphan.sum())}, their mates placed {int(placed.sum())}",
              file=sys.stderr)
        return out
