"""Device times of the packed Hamming extension (TPU kernel #3) of this
tree and of older copies, on random candidates and on the align cells' own.

    python3 scripts/bench_extend_torch.py [--root DIR ...] [--iters N]

Loads the `biokanga_tpu_torch/kernels` module of this tree and of every
--root (a directory holding an older `biokanga_tpu_torch`, e.g. unpacked
with `git archive`), builds each one's library and calls its C entry
point `hamming_extend_packed` directly, on the same input tensors into a
preallocated output, so every version runs the same call.  Each input is
timed in turns: the roots in order, this tree twice, the roots in reverse
(old, new, new, old with one root); CUDA events, mean of --iters launches
after a warm-up.  Every version's output must equal the plain version's.

Inputs:
  random candidates as chip_smoke.py phase 3 makes them (`_extend_args`:
    true origins, near misses, entry boundaries, invalid loci), 100 bp
    reads against the 4.6 Mbp cell genome (two entries) at (65,536, 96)
    and (131,072, 96), 150 bp reads at (65,536, 96), and 100 bp reads
    against a 100 Mbp genome of 100,000 entries of 1 kb;
  two floors of the (65,536, 96) call: every flag off (no row is read)
    and every candidate of a read at its first locus (one row a read);
  the orphan rescue's shape, 2,048 windows of 500 consecutive loci, on
    the cell genome and on the same genome with an N run and 0.1% Ns (the
    N plane), and random candidates on the latter;
  captured candidates: the inputs that `align/pipeline.py` hands to the
    extension in the first batch of the SE cell (65,536 x 100 bp reads)
    and in the first fused batch of the PE cell (131,072 mates), caught by
    wrapping the pipeline module's name from this script; the package is
    not changed.
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


def load_library(root: Path, tag: str) -> ctypes.CDLL:
    """The kernel library of the package under `root` (its kernels module
    loaded by file path and built), with `hamming_extend_packed` typed."""
    path = root / "biokanga_tpu_torch" / "kernels" / "__init__.py"
    spec = importlib.util.spec_from_file_location(f"_ext_bench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = ctypes.CDLL(str(mod.build()))
    lib.hamming_extend_packed.argtypes = list(
        mod._SIGNATURES["hamming_extend_packed"])
    lib.hamming_extend_packed.restype = ctypes.c_int
    return lib


def _capture():
    """(label, args) of every extension call in the first SE batch and
    the first fused PE batch of the align cells."""
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
    plain = pipeline.hamming_extend_packed

    def extend(*args):
        calls.append((cell[0], tuple(a.clone() if torch.is_tensor(a) else a
                                     for a in args)))
        return plain(*args)

    pipeline.hamming_extend_packed = extend
    try:
        _, reads, _ = simulate_reads(seqs, N_READS, read_len=READ_LEN,
                                     sub_rate=0.01, seed=9)
        cell[0] = "se"
        engine.align_with_rescue(reads[:BATCH],
                                 np.full(BATCH, READ_LEN, np.int32))
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
        pipeline.hamming_extend_packed = plain
    torch.cuda.synchronize()
    return calls


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", default=[],
                    help="older tree to time beside this one (repeatable)")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_extend_torch: no CUDA card", file=sys.stderr)
        return 1
    from biokanga_tpu_torch.ops import extend_packed as ep
    from chip_smoke import (BATCH, CONTIGS, GENOME_BP, READ_LEN,
                            RESCUE_SHAPE, _extend_args, _timed_ms,
                            contig_genome, extend_runner)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, file=sys.stderr)
    dev = torch.device("cuda", 0)
    roots = [Path(r).resolve() for r in args.root]
    names = [str(r) for r in roots] + ["this tree"]
    libs = [load_library(root, str(i))
            for i, root in enumerate(roots + [ROOT])]
    new = len(libs) - 1
    order = list(range(new)) + [new, new] + list(reversed(range(new)))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def bench(label, a):
        a = tuple(t.contiguous() if torch.is_tensor(t) else t for t in a)
        want = ep.hamming_extend_packed_plain(*a)
        out = torch.empty_like(want)
        for i, lib in enumerate(libs):
            out.fill_(7)
            if extend_runner(lib, a, out, stream)():
                raise RuntimeError(f"{names[i]}: launch failed on {label}")
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{names[i]} disagrees with the plain "
                                     f"version on {label}")
        ms = [[] for _ in libs]
        for i in order:
            ms[i].append(_timed_ms(extend_runner(libs[i], a, out, stream),
                                   args.iters))
        B, C = a[2].shape
        res = {"label": label, "B": B, "C": C, "words": a[4].shape[1],
               "valid_share": float((want != 255).float().mean()), "ms": ms}
        print(f"{label} ({B}, {C}): " + "; ".join(
            f"{n} {' / '.join(f'{t:.4f}' for t in m)}"
            for n, m in zip(names, ms)), file=sys.stderr)
        return res

    out = {"card": smi, "versions": names, "iters": args.iters,
           "random": [], "captured": []}
    rng = np.random.default_rng(2024)
    genome = rng.integers(0, 4, size=GENOME_BP, dtype=np.int8)
    starts = np.array([0, GENOME_BP // 2, GENOME_BP], np.int64)
    pg = ep.pack_genome(genome, dev)
    for L, B in ((READ_LEN, BATCH), (READ_LEN, 2 * BATCH), (150, BATCH)):
        a = _extend_args(dev, rng, pg, genome, starts, L, B, 96)
        out["random"].append(bench(f"random {L} bp", a))
        if B == BATCH and L == READ_LEN:
            # floors of the same call: no candidate valid (no row read),
            # and every candidate of a read at its first locus (one row)
            out["random"].append(bench("flags off", (
                *a[:3], torch.zeros_like(a[3]), *a[4:])))
            one = a[2][:, :1].expand(-1, a[2].shape[1]).contiguous()
            out["random"].append(bench("one locus a read", (
                *a[:2], one, torch.ones_like(a[3]), *a[4:])))
        del a
    # the rescue's windows of consecutive loci; then the same genome with
    # an N run and 0.1% Ns, so that the N plane is read
    gn = genome.copy()
    gn[200_000:200_500] = 4
    gn[rng.random(GENOME_BP) < 0.001] = 4
    for tag, g, p in (("", genome, pg), (", N plane", gn, None)):
        p = p or ep.pack_genome(g, dev)
        Bw, Wlen = RESCUE_SHAPE
        win = np.linspace(-Wlen + 50, GENOME_BP - 60, Bw).astype(np.int64)
        src = np.clip(win + rng.integers(0, Wlen - READ_LEN, Bw), 0,
                      GENOME_BP - READ_LEN)
        reads = g[src[:, None] + np.arange(READ_LEN)]
        loci = torch.from_numpy(
            (win[:, None] + np.arange(Wlen)).astype(np.int32)).to(dev)
        ln = torch.full((Bw,), READ_LEN, dtype=torch.int32, device=dev)
        rc, rn = ep.pack_reads(torch.from_numpy(reads).to(dev), ln)
        es = torch.from_numpy(starts.astype(np.int32)).to(dev)
        out["random"].append(bench(f"rescue windows{tag}", (
            p, es, loci, torch.ones_like(loci, dtype=torch.bool), rc, rn,
            ln)))
        if tag:
            a = _extend_args(dev, rng, p, g, starts, READ_LEN, BATCH, 96)
            out["random"].append(bench(f"random {READ_LEN} bp{tag}", a))
            del a
    del pg, p
    g2, s2 = contig_genome(rng)
    a = _extend_args(dev, rng, ep.pack_genome(g2, dev), g2, s2, READ_LEN,
                     BATCH, 96)
    out["random"].append(bench(f"{CONTIGS} contigs", a))
    del a, g2
    torch.cuda.empty_cache()
    for label, a in _capture():
        out["captured"].append(bench(label, a))
    sums = {}
    for r in out["captured"]:
        sums.setdefault(r["label"], [[0.0] * len(m) for m in r["ms"]])
        for v, m in enumerate(r["ms"]):
            for k, t in enumerate(m):
                sums[r["label"]][v][k] += t
    out["captured_sum_ms"] = sums
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
