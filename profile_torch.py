"""Stage profiles of the port's cells on one CUDA card.

    python3 profile_torch.py            # all cells
    python3 profile_torch.py ec         # or some: ec | align | pe_repeat
                                        #   | asm

ec: the error-correction head-to-head read set of chip_smoke.py phase 9
(500 x 10 kb CLR reads of a 200 kb genome, seed 3) through `ec_reads`
with the CLI's defaults (2 rounds, 48 targets, W 96).  align: the
single-end cell of chip_smoke.py phase 6 (262,144 x 100 bp reads against
a 4.6 Mbp genome, batch 65,536) through `AlignEngine.align_with_rescue`.
pe_repeat: the 2,048 repeat-genome pairs of 2 x 150 bp of chip_smoke.py
phase 12 through `PEAligner` as one batch, pairs that reach the orphan
rescue (the paired-end loop at scale is the benchmark's, `python3 -m
benchmark.run`).  asm: the assembly cell of chip_smoke.py phase 24
(50,000 error-free pairs of 2 x 150 bp from a 0.5 Mbp genome,
BENCH_ASM.json's 0.5mbp_30x_r4) through `assemble` with its defaults;
its `asm.pass` ranges hold the scaled passes' `asm.index` (the device
index build) and `asm.sweep` (candidates, #3w, the winner scatters)
ranges, the rest of a pass is the host's chain merge, and `asm.contain`
is the containment sweep.

Each cell runs once unprofiled (the wall time users see) and once under
`torch.profiler` with CPU and CUDA activities.  It prints one JSON line
per cell: the wall times, the device busy time (CUDA kernels and copies
summed) and the idle share of the profiled wall, the host time of each
`ec.*`, `pe.*`, `engine.*` or `asm.*` stage range and the time its range
spans on the device timeline, and the device time of the busiest
kernels.  Needs one card; exits
non-zero without CUDA.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np


STAGE_PREFIXES = ("ec.", "pe.", "engine.", "asm.")  # the port's spans


def _on_device(evt) -> bool:
    """A kernel, copy or range on the device's timeline (not a host op)."""
    from torch.autograd import DeviceType

    return evt.device_type == DeviceType.CUDA


def _device_us(evt) -> float:
    return evt.device_time_total


def _profiled(fn):
    """(wall s, key_averages) of fn() under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return wall, prof.key_averages()


def _summary(cell: str, wall: float, wall_prof: float, events,
             extra: dict) -> dict:
    kernels = [e for e in events
               if _on_device(e) and not e.key.startswith(STAGE_PREFIXES)]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    stages: dict = {}
    for e in events:
        if e.key.startswith(STAGE_PREFIXES):
            st = stages.setdefault(e.key, {"count": e.count, "host_ms": 0.0,
                                           "device_ms": 0.0})
            if _on_device(e):
                st["device_ms"] += _device_us(e) / 1e3
            else:
                st["host_ms"] += e.cpu_time_total / 1e3
    return {"cell": cell, "wall_s": wall, "profiled_wall_s": wall_prof,
            "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / 1e3 / wall_prof,
            "stages": stages,
            "top_device": [{"name": e.key[:80], "count": e.count,
                            "ms": _device_us(e) / 1e3} for e in top],
            **extra}


def profile_ec() -> dict:
    import torch

    from biokanga_tpu_torch.pacbio.ecreads import ECParams, ec_reads
    from chip_smoke import (EC_ERR, EC_GENOME_KB, EC_READ_LEN, EC_READS,
                            EC_SEED, gen_reads)

    from biokanga_tpu_torch.ops import banded_sw, sw_trace

    reads, _ = gen_reads(EC_READS, EC_READ_LEN, EC_GENOME_KB, EC_ERR,
                         seed=EC_SEED)
    p = ECParams(max_targets=48)
    dev = torch.device("cuda")
    ec_reads(reads[:40], p, rounds=1, device=dev)             # warm-up
    torch.cuda.synchronize()
    banded_sw.banded_sw_moves.launches = 0
    sw_trace.traceback_cols_packed.launches = 0
    t0 = time.monotonic()
    _, st = ec_reads(reads, p, rounds=2, device=dev)
    wall = time.monotonic() - t0
    launches = {"banded_sw_moves": banded_sw.banded_sw_moves.launches,
                "sw_trace": sw_trace.traceback_cols_packed.launches}
    wall_prof, events = _profiled(
        lambda: ec_reads(reads, p, rounds=2, device=dev))
    return _summary("ec", wall, wall_prof, events,
                    {"pairs": st["pairs"],
                     "overlaps_used": st["overlaps_used"],
                     "sw_ms": st["sw_ms"], "trace_ms": st["trace_ms"],
                     "launches": launches})


def profile_align() -> dict:
    import torch

    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.align.pipeline import AlignEngine
    from biokanga_tpu_torch.index.build import build_index
    from biokanga_tpu_torch.index.device import to_device
    from biokanga_tpu_torch.sim.simreads import random_genome, simulate_reads
    from chip_smoke import BATCH, GENOME_BP, N_READS, READ_LEN

    seqs = random_genome([("chr", GENOME_BP)], seed=42)
    idx = build_index(seqs, lut_bases=10)
    _, reads, _ = simulate_reads(seqs, N_READS, read_len=READ_LEN,
                                 sub_rate=0.01, seed=9)
    lengths = np.full(N_READS, READ_LEN, np.int32)
    engine = AlignEngine(to_device(idx, torch.device("cuda")),
                         AlignParams(batch_size=BATCH))

    def run():
        for s in range(0, N_READS, BATCH):
            engine.align_with_rescue(reads[s:s + BATCH],
                                     lengths[s:s + BATCH])

    engine.align_with_rescue(reads[:BATCH], lengths[:BATCH])  # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    wall_prof, events = _profiled(run)
    return _summary("align", wall, wall_prof, events,
                    {"reads": N_READS})


def _profile_pairs(cell: str, idx, reads, batch: int) -> dict:
    """PEAligner over interleaved mates `reads` (2N, L), one batch in
    flight, unprofiled and profiled."""
    import torch

    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.align.pe import PEAligner, PEParams
    from biokanga_tpu_torch.align.pipeline import AlignEngine, pad_rows
    from biokanga_tpu_torch.index.device import to_device

    n_pairs, L = len(reads) // 2, reads.shape[1]
    ln = np.full(n_pairs, L, np.int32)
    blocks = []
    for s in range(0, n_pairs, batch):
        m1 = pad_rows(np.ascontiguousarray(reads[0::2][s:s + batch]),
                      ln[s:s + batch])
        m2 = pad_rows(np.ascontiguousarray(reads[1::2][s:s + batch]),
                      ln[s:s + batch])
        blocks.append((*m1, *m2))
    pea = PEAligner(AlignEngine(to_device(idx, torch.device("cuda")),
                                AlignParams(batch_size=batch)),
                    PEParams(pair_min_len=100, pair_max_len=600))
    proper = 0

    def run():
        nonlocal proper
        proper, inflight = 0, None
        for b in blocks:
            nxt = pea.launch_pairs(*b)
            if inflight is not None:
                proper += int(pea.finish_pairs(inflight)["proper"].sum())
            inflight = nxt
        proper += int(pea.finish_pairs(inflight)["proper"].sum())

    pea.align_pairs(*blocks[0])                                # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    pea.rescued = pea.rescue_calls = 0
    wall_prof, events = _profiled(run)
    return _summary(cell, wall, wall_prof, events,
                    {"pairs": n_pairs, "proper": proper,
                     "rescued": pea.rescued,
                     "rescue_calls": pea.rescue_calls})


def profile_pe_repeat() -> dict:
    from biokanga_tpu_torch.index.build import build_index
    from chip_smoke import BATCH, _pe_repeat_case

    seqs, _, reads = _pe_repeat_case()
    return _profile_pairs("pe_repeat", build_index(seqs, lut_bases=9), reads,
                          BATCH)


def profile_asm() -> dict:
    import torch

    from biokanga_tpu_torch.assembly.assemble import assemble
    from biokanga_tpu_torch.sim.simreads import random_genome, simulate_reads
    from chip_smoke import ASM_GENOME_BP, ASM_PAIRS

    seqs = random_genome([("chr1", ASM_GENOME_BP)], seed=33)
    _, reads, _ = simulate_reads(seqs, ASM_PAIRS, read_len=150,
                                 sub_rate=0.0, seed=44, pe=True,
                                 insert_min=250, insert_max=500)
    reads = [np.asarray(r, np.int8) for r in reads]
    dev = torch.device("cuda")
    assemble(reads[:6_000], device=dev, max_passes=2)          # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    contigs, st = assemble(reads, device=dev)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    wall_prof, events = _profiled(lambda: assemble(reads, device=dev))
    return _summary("asm", wall, wall_prof, events,
                    {"reads": len(reads), "passes": st.passes,
                     "contigs": st.n_contigs, "max_contig": st.max_contig})


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    cells = argv or ["ec", "align", "pe_repeat"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    for cell in cells:
        fn = {"ec": profile_ec, "align": profile_align,
              "pe_repeat": profile_pe_repeat,
              "asm": profile_asm}[cell]
        print(json.dumps({**fn(), "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
