"""Device times of kernels #7 (the uhamming sweep) and #8 (the blitz
chain DP) of this tree and of older copies, on the inputs of
chip_smoke.py phases 25 and 26.

    python3 scripts/bench_tools_torch.py [--root DIR ...]

Loads the `biokanga_tpu_torch` package of every --root (a directory
holding an older copy, e.g. unpacked with `git archive`) under another
name, builds each one's kernel library, and calls each version's wrapper
(`ops.uhamming_sweep.uhamming_sweep`, `ops.blitz_chain.chain_scan`) on
the same tensors.  Beside them run variants of this tree, each built
from a copy under build/variants/<name>/ with one line of a kernel
source changed (VARIANTS): #7 with room for 85 or 128 registers a thread
instead of 64, and #8 with its layout rule set to a warp a chain, or a
block a chain, at every shape.  Each input is timed in turns: the roots
in order, this tree twice, the roots in reverse (old, new, new, old with
one root), then #7's register variants for #7's inputs; CUDA events
around each call (the mean of several calls for the short ones); #8's
layout variants are timed against each other on their own inputs.
Every version's output must equal this tree's, and this tree's its
plain version where that is cheap.

#7 inputs: phase 25's 65,536 bp genome (-m 0 with the reverse
complement, K 100), its 1 Mbp genome with planted repeats (the same),
and the node `-m 2 -n 64 -N 1` of the 4.6 Mbp SE genome (watson shifts
[1, 1 + (n-K)/64), K 100).  #8 inputs: the chain batches of phase 26's
`blitz` CLI run (2,064 queries on the 4.6 Mbp genome, captured by
wrapping the tool module's `chain_scan` from this script), and wide sets
of collinear chains of M 4,096 and 16,384 blocks; this tree's two
layouts (the two layout variants) at M 74-1,024 and 16-2,112 chains.
#8's times are given twice: CUDA events around the wrapper (host-bound
where the kernel is short), and the kernel alone from torch.profiler's
device activity; its dependent-chain floor uses one step's latency
measured by chip_smoke.py's probe.  Prints the card, one line a
measurement and one JSON line.  Needs one card.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# name: (source, line, its replacement)
_RULE = ("    const bool warp = M <= 32 * kRegRows || (M <= kNarrowMaxM && "
         "C >= 8 * sms);")
VARIANTS = {
    "min_blocks_3": ("uhamming_sweep.cu", "constexpr int kMinBlocks = 4;",
                     "constexpr int kMinBlocks = 3;"),
    "min_blocks_2": ("uhamming_sweep.cu", "constexpr int kMinBlocks = 4;",
                     "constexpr int kMinBlocks = 2;"),
    "chain_warp": ("blitz_chain.cu", _RULE,
                   "    const bool warp = sms > 0;"),
    "chain_block": ("blitz_chain.cu", _RULE,
                    "    const bool warp = sms < 0;"),
}
WIDE = ((16, 4_096), (4, 16_384))
SPLIT_M = (74, 128, 256, 512, 1_024)
SPLIT_C = (16, 264, 1_056, 2_112)


def _package(root: Path, alias: str):
    """(uhamming_sweep, blitz_chain) ops modules of the package under root."""
    pkg = root / "biokanga_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{alias}.ops.uhamming_sweep"),
            importlib.import_module(f"{alias}.ops.blitz_chain"))


def _variant(name: str) -> Path:
    """A copy of this tree's kernels with VARIANTS[name] applied."""
    root = ROOT / "build" / "variants" / name
    dst = root / "biokanga_tpu_torch"
    shutil.rmtree(root, ignore_errors=True)
    src = ROOT / "biokanga_tpu_torch"
    for d in ("kernels", "ops", "csrc"):
        shutil.copytree(src / d, dst / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(src / "__init__.py", dst / "__init__.py")
    src_name, old, new = VARIANTS[name]
    cu = dst / "csrc" / src_name
    text = cu.read_text()
    if old not in text:
        raise AssertionError(f"{src_name}: no {old!r}")
    cu.write_text(text.replace(old, new))
    return root


def _ms(fn, iters: int) -> float:
    import torch

    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _kernel_ms(fn, iters: int, part: str) -> float:
    """Device time a call of the kernels whose name holds `part`, from
    torch.profiler's CUDA activity over `iters` calls (0.0 where the
    profiler saw none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if part in e.key)
    return us / 1e3 / iters


def _turns(versions, fn, iters: int, want, same, variants=()) -> dict:
    """Times of fn(version) in turns (roots, this twice, roots reversed,
    the named variants); each output must equal `want`."""
    roots = [v for v in versions if v[0].startswith("root")]
    this = [v for v in versions if v[0] == "this"]
    order = (roots + this * 2 + roots[::-1]
             + [v for v in versions if v[0] in variants])
    times: dict[str, list] = {}
    for name, mods in order:
        try:
            out = fn(mods)
        except ValueError as e:           # an older copy's width limit
            times.setdefault(name, []).append(f"not run: {e}")
            continue
        if not same(out, want):
            raise AssertionError(f"{name}: output differs from this tree's")
        times.setdefault(name, []).append(_ms(lambda: fn(mods), iters))
    return times


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from biokanga_tpu_torch.index.build import build_index, save_index
    from biokanga_tpu_torch.seq.fasta import write_fasta
    from biokanga_tpu_torch.sim.simreads import random_genome
    from biokanga_tpu_torch.tools import blitz
    from biokanga_tpu_torch.tools.uhamming import window_validity

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_tools_torch: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    import biokanga_tpu_torch.ops.blitz_chain as this_bc
    import biokanga_tpu_torch.ops.uhamming_sweep as this_us

    versions = [(f"root:{r}", _package(Path(r).resolve(), f"_bench_root{k}"))
                for k, r in enumerate(args.root)]
    versions.append(("this", (this_us, this_bc)))
    versions += [(name, _package(_variant(name), f"_bench_{name}"))
                 for name in VARIANTS]
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(versions)) as pool:
        list(pool.map(lambda v: v[1][0].kernels.build(), versions))
    for _, (us, _) in versions:
        us.kernels.library()
    print(f"libraries built in {time.monotonic() - t0:.1f} s")
    result = {"card": smi, "uhamming_sweep": {}, "blitz_chain": {}}

    # #7
    def uh_args(g, starts, K):
        return (torch.from_numpy(g).to(dev),
                torch.from_numpy(window_validity(starts, len(g), K)).to(dev),
                torch.full((len(g),), this_us.H_INVALID, dtype=torch.uint8,
                           device=dev))

    K = cs.UH_K
    line = random_genome([("chr", cs.UH_LINE_BP)], seed=252)[0][1]
    big = cs._uh_big_genome()[0][1]
    se = random_genome([("chr", cs.GENOME_BP)], seed=42)[0][1]
    top_se = cs.GENOME_BP - K + 1
    cases = [("65536bp_m0", line, 1, cs.UH_LINE_BP - K + 1, True, 3),
             ("1mbp_m0", big, 1, cs.UH_BP - K + 1, True, 1),
             ("4.6mbp_m2_n64_N1", se, 1, 1 + (top_se - 1) // cs.UH_NODES,
              False, 1)]
    for tag, g, lo, hi, rc, iters in cases:
        a = uh_args(g, np.array([0, len(g)]), K)
        want = this_us.uhamming_sweep(*a, K, lo, hi, rc)
        if tag == "65536bp_m0" and not torch.equal(
                want, this_us.uhamming_sweep_plain(*a, K, lo, hi, rc)):
            raise AssertionError("#7 differs from its plain version")
        times = _turns(versions,
                       lambda m: m[0].uhamming_sweep(*a, K, lo, hi, rc),
                       iters, want, torch.equal,
                       ("min_blocks_3", "min_blocks_2"))
        bound, by = cs._uh_bound(np.array([0, len(g)]), len(g), K, lo, hi,
                                 rc)
        result["uhamming_sweep"][tag] = {"ms": times, "bound_ms": bound,
                                         "bound_by": by}
        print(f"#7 {tag}: {times} ms; bound {bound:.4f} ms ({by}) ({smi})")
        del a, want
        torch.cuda.empty_cache()

    # #8: phase 26's CLI chain batches
    work = ROOT / "build" / "bench_tools"
    work.mkdir(parents=True, exist_ok=True)
    seqs = random_genome([("chr", cs.GENOME_BP)], seed=42)
    write_fasta(str(work / "ref.fa"), seqs)
    save_index(build_index(seqs, lut_bases=10), str(work / "ref.npz"))
    recs, _ = cs._bz_queries(seqs[0][1])
    write_fasta(str(work / "q.fa"), recs)
    captured = []
    real = blitz.chain_scan

    def record(*x):
        captured.append(x)
        return real(*x)

    blitz.chain_scan = record
    try:
        from biokanga_tpu_torch import cli

        if cli.main(["blitz", "-i", str(work / "q.fa"), "-I",
                     str(work / "ref.npz"), "-o", str(work / "q.psl"),
                     "--device", "cuda"]) != 0:
            raise AssertionError("blitz failed")
    finally:
        blitz.chain_scan = real
    rng = np.random.default_rng(260)
    sets = [(f"cli_batch{k}_{x[0].shape[0]}x{x[0].shape[1]}", x)
            for k, x in enumerate(captured)]
    for C, M in WIDE:
        sets.append((f"wide_{C}x{M}", cs._bz_wide_chains(rng, C, M, dev)))

    def same(x, y):
        return torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])

    step_ms = cs._chain_step_ms(dev)
    print(f"#8 dependent step, measured: {step_ms * 1e6:.2f} ns ({smi})")
    result["blitz_chain"]["step_ms"] = step_ms
    for tag, x in sets:
        want = this_bc.chain_scan(*x)
        if not same(want, this_bc.chain_scan_plain(*x)):
            raise AssertionError(f"#8 differs from its plain version: {tag}")
        times = _turns(versions, lambda m: m[1].chain_scan(*x), 10, want,
                       same)
        alone = {name: _kernel_ms(lambda: m[1].chain_scan(*x), 10, "chain")
                 for name, m in versions
                 if name in times and not (name.startswith("root") and
                                           "not run" in str(times[name][0]))}
        bound, by, pairs = cs._chain_bound(x[0], x[4])
        floor = cs._chain_floor(x[4], step_ms)
        result["blitz_chain"][tag] = {"ms": times, "kernel_ms": alone,
                                      "bound_ms": bound, "bound_by": by,
                                      "pairs": pairs, "floor_ms": floor}
        print(f"#8 {tag}: {times} ms; kernel alone {alone} ms; bound "
              f"{bound:.4f} ms ({by}), floor {floor:.4f} ms ({smi})")

    # #8: the two layouts of this tree by width and chain count
    layouts = {name: m[1] for name, m in versions
               if name in ("chain_warp", "chain_block")}
    split = {}
    for M in SPLIT_M:
        for C in SPLIT_C:
            x = cs._bz_wide_chains(rng, C, M, dev)
            want = this_bc.chain_scan(*x)
            row = {}
            for name, bc in layouts.items():
                if not same(bc.chain_scan(*x), want):
                    raise AssertionError(f"#8 {name} differs at {C}x{M}")
                row[name] = _kernel_ms(lambda: bc.chain_scan(*x), 5,
                                       "chain")
            split[f"{C}x{M}"] = {"warp_ms": row["chain_warp"],
                                 "block_ms": row["chain_block"]}
            print(f"#8 layouts at {C} x {M}, kernel alone: a warp a chain "
                  f"{row['chain_warp']:.4f} ms, a block a chain "
                  f"{row['chain_block']:.4f} ms")
    result["blitz_chain"]["layouts"] = split
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
