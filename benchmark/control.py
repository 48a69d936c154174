"""The control of a cell's check: the reference in the program's place,
counting mismatches over the read's whole 16-base words only (the last,
partial word of a 100 or 150 bp read left out), which breaks the stated
guarantee that a count covers the whole read.  Judged like the program,
it has to come out not correct.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 [--device cuda]

Builds each seed's genome, pool and sample as a run of the cell does, and
prints one JSON line a seed with the compared numbers.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .drivers.align_pe import check_pairs, draw_sample
from .genome import make_genome
from .spec import ROOT, Bench


def control(bench: Bench, cell: str, seed: int, device) -> dict:
    w = bench.workload(cell)
    config, traffic = bench.config(w["config"]), bench.traffic(w["traffic"])
    t0 = time.monotonic()
    codes, starts = make_genome(config["entries"], seed, device)
    genome = codes.cpu().numpy()
    del codes
    pool = bench.generator(traffic["generator"]).make_pool(
        genome, starts, traffic, seed)
    pairs = draw_sample(seed, len(pool["reads1"]),
                        int(traffic["sample_pairs"]))
    r1, r2 = pool["reads1"][pairs], pool["reads2"][pairs]
    span = r1.shape[1] // 16 * 16
    out = check_pairs(config, traffic, genome, starts, r1, r2, None, None,
                      None, device, control_span=span)
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
