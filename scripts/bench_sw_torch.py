"""Device times of the SW kernels and the traceback decode at EC shapes.

    python3 scripts/bench_sw_torch.py [--root DIR] [--pairs 1024 1300]
        [--band 96 ...]

Times, with CUDA events (mean of --iters launches after a warm-up),
banded_sw_moves, banded_sw_score and traceback_cols_packed on chunks of
overlap-like CLR pairs of 10,240 bases at W = 96, or at each --band
(chip_smoke.py's `_sw_pairs`, seed 7).  --root names
the directory that holds the `biokanga_tpu_torch` package to time, so an
older copy unpacked with `git archive` can be timed in the same process
run as the current one (run them in turns: old, new, new, old).  Prints
one JSON line.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _timed_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--pairs", type=int, nargs="+", default=[1024, 1300])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--band", type=int, nargs="+", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("bench_sw_torch: no CUDA card", file=sys.stderr)
        return 1
    from biokanga_tpu_torch.ops import banded_sw as bsw
    from biokanga_tpu_torch.ops import sw_trace
    from chip_smoke import SW_LA, SW_W, _sw_inputs, _sw_pairs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    La = SW_LA
    bands = args.band or [SW_W]
    out = {"root": str(Path(bsw.__file__).resolve().parents[2]), "card": smi,
           "package": str(Path(bsw.__file__).resolve().parents[1]), "La": La,
           "W": bands[0], "chunks": {}, "bands": {}}
    for W in bands:
        pairs = _sw_pairs(np.random.default_rng(7), max(args.pairs), La, W)
        chunks = {}
        for n in args.pairs:
            sw_args = _sw_inputs(dev, *(x[:n] for x in pairs), La, W)
            best, bi, bk, mv = bsw.banded_sw_moves(*sw_args, W)
            res = {"moves_ms": _timed_ms(
                lambda: bsw.banded_sw_moves(*sw_args, W), args.iters)}
            res["score_ms"] = _timed_ms(
                lambda: bsw.banded_sw_score(*sw_args, W), args.iters)
            res["trace_ms"] = _timed_ms(
                lambda: sw_trace.traceback_cols_packed(
                    mv, bi, bk, sw_args[1], W, La), args.iters)
            dec = sw_trace.traceback_cols_packed(mv, bi, bk, sw_args[1], W,
                                                 La)
            res["path_rows"] = int((dec[0] != 6).sum())
            res["cells"] = float(sw_args[2].clamp(max=La).sum()) * (2 * W + 1)
            chunks[str(n)] = res
            print(f"W {W}, {n} pairs: {res}", file=sys.stderr)
            del sw_args, best, bi, bk, mv, dec
            torch.cuda.empty_cache()
        out["bands"][str(W)] = chunks
    out["chunks"] = out["bands"][str(bands[0])]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
