"""Device times of the row sorts (dedup and accept) of this tree and of
older copies, on random rows and on the align cells' own rows.

    python3 scripts/bench_sort_torch.py [--root DIR ...] [--iters N]

Loads the `biokanga_tpu_torch/kernels` module of this tree and of every
--root (a directory holding an older `biokanga_tpu_torch`, e.g. unpacked
with `git archive`), builds each one's library and calls its C entry
points `sort_rows_i32` and `sort2_rows_i32` directly, on the same input
tensors into preallocated outputs, so every version runs the same call.
Each input is timed in turns: the roots in order, this tree twice, the
roots in reverse (old, new, new, old with one root); CUDA events, mean of
--iters launches after a warm-up.  Every version's output must equal the
plain sort (`torch.sort`) of the input.

Inputs:
  random rows, as chip_smoke.py phase 3 makes them (`_sort_values`: ties,
    bit 31 set in about half, 30% INT32_MAX; pair keys 0..511), at the
    align path's widths: dedup rows of 384-1,440 values and rescue rows
    of 8,192 and 24,576, accept rows of 192-4,096 pairs, and rows past
    the block path through the scratch-row path (`sort_rows_wide_i32`):
    the rescue ladder's step 2 at 500 bp and at 4,096 bp reads;
  captured rows: the inputs that `align/pipeline.py` hands to sort_rows
    and sort2_rows in the first batch of the SE cell (65,536 x 100 bp
    reads, chip_smoke.py phase 6), in one batch of 65,536 x 150 bp reads
    from the same genome (the 150 bp fast pass, dedup rows of 720) and in
    the first batch of the PE cell (one fused batch of 131,072 mates,
    phase 13), caught by wrapping the pipeline module's two names from
    this script; the package is not changed.
Prints one JSON line.  Needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ONE_KEY = ((65_536, 384), (65_536, 480), (131_072, 480), (65_536, 576),
           (65_536, 720), (65_536, 1_152), (65_536, 1_440), (2_048, 8_192),
           (512, 24_576))
WIDE = ((512, 40_960), (512, 377_856))
PAIRS = ((65_536, 192), (131_072, 192), (65_536, 384), (16_384, 1_024),
         (512, 4_096))


def _kernels_module(root: Path, tag: str):
    """The kernels module of the package under `root`, by file path."""
    path = root / "biokanga_tpu_torch" / "kernels" / "__init__.py"
    spec = importlib.util.spec_from_file_location(f"_sort_bench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture():
    """(label, args) of every sort call in the first SE batch and the
    first fused PE batch of the align cells."""
    import torch

    from biokanga_tpu_torch.align import pipeline
    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.align.pe import PEAligner, PEParams
    from biokanga_tpu_torch.index.build import build_index
    from biokanga_tpu_torch.index.device import to_device
    from biokanga_tpu_torch.sim.simreads import random_genome, simulate_reads
    from chip_smoke import (BATCH, GENOME_BP, N_PAIRS, N_READS, PE_INSERT,
                            READ_LEN)

    seqs = random_genome([("chr", GENOME_BP)], seed=42)
    idx = build_index(seqs, lut_bases=10)
    dev = torch.device("cuda")
    engine = pipeline.AlignEngine(to_device(idx, dev),
                                  AlignParams(batch_size=BATCH))
    calls = []
    cell = [""]
    plain = (pipeline.sort_rows, pipeline.sort2_rows)

    def dedup(x):
        calls.append((f"{cell[0]} dedup", (x.clone(),)))
        return plain[0](x)

    def accept(key, val):
        calls.append((f"{cell[0]} accept", (key.clone(), val.clone())))
        return plain[1](key, val)

    pipeline.sort_rows, pipeline.sort2_rows = dedup, accept
    try:
        _, reads, _ = simulate_reads(seqs, N_READS, read_len=READ_LEN,
                                     sub_rate=0.01, seed=9)
        cell[0] = "se"
        engine.align_with_rescue(reads[:BATCH],
                                 np.full(BATCH, READ_LEN, np.int32))
        # the same reads at 150 bp: dedup rows of 720, the 150 bp fast pass
        _, reads, _ = simulate_reads(seqs, BATCH, read_len=150,
                                     sub_rate=0.01, seed=9)
        cell[0] = "se150"
        engine.align_with_rescue(reads, np.full(BATCH, 150, np.int32))
        _, reads, _ = simulate_reads(seqs, N_PAIRS, read_len=READ_LEN,
                                     sub_rate=0.01, seed=17, pe=True,
                                     insert_min=PE_INSERT[0],
                                     insert_max=PE_INSERT[1])
        ln = np.full(BATCH, READ_LEN, np.int32)
        m1 = np.ascontiguousarray(reads[0::2][:BATCH])
        m2 = np.ascontiguousarray(reads[1::2][:BATCH])
        cell[0] = "pe"
        PEAligner(engine, PEParams(pair_min_len=100, pair_max_len=600)
                  ).align_pairs(m1, ln, m2, ln)
    finally:
        pipeline.sort_rows, pipeline.sort2_rows = plain
    torch.cuda.synchronize()
    return calls


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", default=[],
                    help="older tree to time beside this one (repeatable)")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_sort_torch: no CUDA card", file=sys.stderr)
        return 1
    from biokanga_tpu_torch.ops import sort
    from chip_smoke import I32_MAX, _sort_values, _timed_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, file=sys.stderr)
    dev = torch.device("cuda", 0)
    roots = [Path(r).resolve() for r in args.root]
    names = [str(r) for r in roots] + ["this tree"]
    libs = []
    for i, root in enumerate(roots + [ROOT]):
        mod = _kernels_module(root, str(i))
        libs.append(ctypes.CDLL(str(mod.build())))
        for fn in ("sort_rows_i32", "sort2_rows_i32", "sort_rows_wide_i32"):
            getattr(libs[-1], fn).argtypes = list(mod._SIGNATURES[fn])
            getattr(libs[-1], fn).restype = ctypes.c_int
    new = len(libs) - 1
    order = list(range(new)) + [new, new] + list(reversed(range(new)))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def runner(lib, inputs, outs):
        B, C = inputs[0].shape
        ptrs = [t.data_ptr() for t in (*inputs, *outs)]
        if len(inputs) == 1 and C > 32_768:
            P = 1 << (C - 1).bit_length()
            scratch = torch.empty((B, P), dtype=torch.int32, device=dev)
            return lambda: lib.sort_rows_wide_i32(*ptrs, scratch.data_ptr(),
                                                  B, C, P, stream)
        if len(inputs) == 1:
            return lambda: lib.sort_rows_i32(*ptrs, B, C, stream)
        return lambda: lib.sort2_rows_i32(*ptrs, B, C, stream)

    def bench(label, inputs):
        want = (sort.sort_rows_plain(*inputs) if len(inputs) == 1 else
                sort.sort2_rows_plain(*inputs))
        want = (want,) if len(inputs) == 1 else want
        outs = [torch.empty_like(t) for t in inputs]
        for i, lib in enumerate(libs):
            for o in outs:
                o.fill_(-1)
            if runner(lib, inputs, outs)():
                raise RuntimeError(f"{names[i]}: launch failed on {label}")
            if not all(torch.equal(o, w) for o, w in zip(outs, want)):
                raise AssertionError(f"{names[i]} disagrees with torch.sort "
                                     f"on {label}")
        ms = [[] for _ in libs]
        for i in order:
            ms[i].append(_timed_ms(runner(libs[i], inputs, outs),
                                   args.iters))
        B, C = inputs[0].shape
        res = {"label": label, "B": B, "C": C, "ms": ms}
        if len(inputs) == 1:
            res["real_per_row"] = float((inputs[0] != I32_MAX).sum()) / B
        print(f"{label} ({B}, {C}): " + "; ".join(
            f"{n} {' / '.join(f'{t:.4f}' for t in m)}"
            for n, m in zip(names, ms)), file=sys.stderr)
        return res

    out = {"card": smi, "versions": names, "iters": args.iters,
           "random": [], "captured": []}
    rng = np.random.default_rng(2024)
    for B, C in ONE_KEY:
        x = torch.from_numpy(_sort_values(rng, B, C)).to(dev)
        out["random"].append(bench("dedup random", (x,)))
        del x
    for B, C in WIDE:
        x = torch.from_numpy(_sort_values(rng, B, C)).to(dev)
        out["random"].append(bench("dedup wide random", (x,)))
        del x
    torch.cuda.empty_cache()
    for B, C in PAIRS:
        key = torch.from_numpy(rng.integers(0, 512, size=(B, C),
                                            dtype=np.int32)).to(dev)
        val = torch.from_numpy(_sort_values(rng, B, C)).to(dev)
        out["random"].append(bench("accept random", (key, val)))
        del key, val
    torch.cuda.empty_cache()
    for label, inputs in _capture():
        out["captured"].append(bench(label, inputs))
    # per cell and version: the sorts' device ms for the batch, each turn
    sums = {}
    for r in out["captured"]:
        cell = r["label"].split()[0]
        sums.setdefault(cell, [[0.0] * len(m) for m in r["ms"]])
        for v, m in enumerate(r["ms"]):
            for k, t in enumerate(m):
                sums[cell][v][k] += t
    out["captured_sum_ms"] = sums
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
