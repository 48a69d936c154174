"""The control of the chunked cell's check (control.py's, with the
blocked reference of reference/blocked.py in place of the whole-genome
seed index that a genome past 2^31 bases does not fit): the reference in
the program's place, counting mismatches over the read's whole 16-base
words only.  Judged like the program, it has to come out not correct.

    python3 -m benchmark.control_chunked --workload <cell> --seeds 1 2 3 [--device cuda]

Builds each seed's genome, pool and sample as a run of the cell does, and
prints one JSON line a seed with the compared numbers.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .drivers.align_pe import draw_sample
from .genome import make_genome
from .reference import blocked
from .reference.guarantee import guarantee
from .reference.judge import control_output, judge
from .spec import ROOT, Bench


def control(bench: Bench, cell: str, seed: int, device) -> dict:
    w = bench.workload(cell)
    config, traffic = bench.config(w["config"]), bench.traffic(w["traffic"])
    t0 = time.monotonic()
    codes, starts = make_genome(config["entries"], seed, device)
    genome_h = codes.cpu().numpy()
    del codes
    pool = bench.generator(traffic["generator"]).make_pool(
        genome_h, starts, traffic, seed)
    pairs = draw_sample(seed, len(pool["reads1"]),
                        int(traffic["sample_pairs"]))
    r1, r2 = pool["reads1"][pairs], pool["reads2"][pairs]
    del pool
    L = r1.shape[1]
    span = L // 16 * 16
    a = config["align"]
    g = guarantee(L, len(genome_h), int(config["lut_bases"]),
                  int(a["subs_per100"]), int(a["min_edit_dist"]), a["mode"])
    settings = {"min_edit_dist": int(a["min_edit_dist"]),
                "max_multi": int(a["max_multi"]),
                "pair_min_len": int(traffic["pair_min_len"]),
                "pair_max_len": int(traffic["pair_max_len"])}
    genome = torch.from_numpy(genome_h).to(device)
    reads = [torch.from_numpy(r).to(device) for r in (r1, r2)]
    hits = [blocked.find_hits(genome, starts, r, g.max_mm) for r in reads]
    bad = [blocked.find_hits(genome, starts, r, g.max_mm, span=span)
           for r in reads]
    p1, p2, proper = control_output(bad[0], bad[1], genome, starts, r1, r2,
                                    g, settings, span)
    out = judge(p1, p2, proper, hits[0], hits[1], genome, starts, r1, r2, g,
                settings)
    return {"workload": cell, "seed": seed, "span": span,
            "wrong_mates": out["wrong_mates"],
            "wrong_pairs": out["wrong_pairs"],
            "checked_pairs": out["checked_pairs"],
            "correct": out["wrong_mates"] == 0 and out["wrong_pairs"] == 0,
            "seconds": time.monotonic() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = Bench(ROOT)
    for seed in args.seeds:
        print(json.dumps(control(bench, args.workload, seed,
                                 torch.device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
