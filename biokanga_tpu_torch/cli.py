"""CLI of the PyTorch port: single-end `align` and PacBio `ecreads`.

Usage:  python -m biokanga_tpu_torch align -i reads.fq -I ref.npz \
            -o out.sam [--device cuda]
        python -m biokanga_tpu_torch ecreads -i reads.fa -o out.fa \
            [--device cuda]

`align` reads the index that `python -m biokanga_tpu index` writes and
gives the SAM that `python -m biokanga_tpu align` gives on the same
inputs; `ecreads` gives the FASTA of `python -m biokanga_tpu ecreads`.
The device is explicit: `--device cuda` (the default) raises when CUDA is
absent, and `--device cpu` runs the kernels' plain versions.  Paired
ends, SNP calling, indel/splice/chimeric modes, bisulfite, colorspace and
chunked indexes are not in this package yet; argparse rejects their
flags and the index checks below reject their index files.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .device import resolve_device
from .utils.diagnostics import StopWatch, open_diagnostics


def _expand_response_files(argv: list[str]) -> list[str]:
    """`@file` arguments expand to the whitespace-split words of the file
    (copy of biokanga_tpu/cli.py:23-31)."""
    out: list[str] = []
    for a in argv:
        if a.startswith("@") and len(a) > 1:
            with open(a[1:]) as f:
                out.extend(f.read().split())
        else:
            out.append(a)
    return out


def cmd_align(argv: list[str]) -> int:
    """Single-end `align`, following biokanga_tpu/cli.py:510-857."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch align")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-I", "--sfx", required=True,
                   help="index file from `python -m biokanga_tpu index`")
    p.add_argument("-o", "--out", required=True, help="output SAM path")
    p.add_argument("-s", "--substitutions", type=int, default=10,
                   help="max subs per 100bp (default 10)")
    p.add_argument("-e", "--editdelta", type=int, default=1, choices=(1, 2))
    p.add_argument("-m", "--mode", default="default",
                   choices=("ultra", "more", "default", "less"))
    p.add_argument("-Q", "--strand", default="both",
                   choices=("both", "sense", "antisense"))
    p.add_argument("-R", "--maxmulti", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--no-mlassign", action="store_true",
                   help="disable multi-hit assignment clustering")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without CUDA) "
                        "or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    log = open_diagnostics(None, name="biokanga-tpu-torch")
    sw = StopWatch()

    from .align.multihit import assign_multihits
    from .align.params import AlignParams, Sensitivity
    from .align.pipeline import AlignEngine, pad_rows
    from .align.sam import SamRecord, write_alignments_sam
    from .index.build import is_bisulfite_index, load_index
    from .index.chunked import is_chunked_index
    from .index.device import to_device
    from .seq.encode import codes_to_ascii, revcomp
    from .seq.fasta import read_blocks
    from .seq.rds import is_rds, rds_info, read_rds_blocks

    if args.out.endswith(".bam"):
        p.error("BAM output is not ported yet; write .sam")
    if is_bisulfite_index(args.sfx) or is_chunked_index(args.sfx):
        p.error(f"{args.sfx}: bisulfite and chunked indexes are not "
                f"ported yet")
    for path in args.inreads:
        if is_rds(path) and rds_info(path).is_pe:
            p.error(f"{path}: paired-end input is not ported yet")

    def _input_blocks(path):
        """FASTA/FASTQ or packed .rds container."""
        if is_rds(path):
            return read_rds_blocks(path, block_size=args.batch_size)
        return read_blocks(path, block_size=args.batch_size)

    idx = load_index(args.sfx)
    if idx.space == "color":
        p.error(f"{args.sfx}: colorspace indexes are not ported yet")
    didx = to_device(idx, device)
    log.info("index loaded on %s: %d bp, %d entries (%.1fs)",
             device, idx.total_len, idx.num_entries, sw.mark("load"))

    params = AlignParams(
        max_subs_per100=args.substitutions,
        min_edit_dist=args.editdelta,
        max_multi=args.maxmulti,
        mode=Sensitivity(args.mode),
        strand=args.strand,
        batch_size=args.batch_size,
    )
    engine = AlignEngine(didx, params)

    mh_loci, mh_rows = [], []   # pending multi-hit reads for assignment
    uq_loci, uq_lens = [], []
    n_total = n_unique = n_multi = n_none = 0
    with open(args.out, "w") as out:
        first = True
        for path in args.inreads:
            for blk in _input_blocks(path):
                codes, lens = pad_rows(blk.codes, blk.lengths)
                res = engine.align_with_rescue(codes, lens)
                n = len(blk.names)
                u_mask = res["unique"][:n]
                uq_loci.append(res["locus"][:n][u_mask])
                uq_lens.append(lens[:n][u_mask])
                if not args.no_mlassign:
                    m_mask = res["any_hit"][:n] & ~u_mask & (
                        res["inst"][:n] <= args.maxmulti
                    )
                    for ri in np.nonzero(m_mask)[0]:
                        mh_rows.append(
                            (blk.names[ri], blk.codes[ri, : blk.lengths[ri]],
                             int(lens[ri]), res["ml_mm"][ri].copy(),
                             res["ml_rc"][ri].copy())
                        )
                        # only the tied-best loci are assignment candidates
                        cand_row = res["ml_loci"][ri].astype(np.int64)
                        cand_row[res["ml_mm"][ri]
                                 != res["best_mm"][ri]] = -1
                        mh_loci.append(cand_row)
                write_alignments_sam(
                    out, idx.entry_names, idx.entry_starts,
                    blk.names, blk.codes, blk.lengths, res,
                    write_header=first,
                )
                first = False
                u = int(res["unique"].sum())
                h = int(res["any_hit"].sum())
                n_total += n
                n_unique += u
                n_multi += h - u
                n_none += n - h

        # multi-hit assignment clustering (AssignMultiMatches role)
        if mh_rows:
            uql = np.concatenate(uq_loci) if uq_loci else np.zeros(0, int)
            uqn = np.concatenate(uq_lens) if uq_lens else np.zeros(0, int)
            cand = np.stack(mh_loci)
            assigned, okm = assign_multihits(uql, uqn, cand, idx.total_len)
            starts = idx.entry_starts
            lines = []
            for mi in np.nonzero(okm)[0]:
                name, rcodes, ln, mlmm, mlrc = mh_rows[mi]
                locus = int(assigned[mi])
                ent = int(np.searchsorted(starts, locus, "right")) - 1
                kk = int(np.argmin(np.abs(cand[mi] - locus)))
                rc = bool(mlrc[kk])
                seq = codes_to_ascii(
                    revcomp(rcodes) if rc else rcodes
                ).decode()
                lines.append(SamRecord(
                    qname=name, flag=16 if rc else 0,
                    rname=idx.entry_names[ent],
                    pos=locus - int(starts[ent]) + 1, mapq=3,
                    cigar=f"{len(rcodes)}M", seq=seq, qual="*",
                    tags=(f"NM:i:{int(mlmm[kk])}",),
                ).line())
            if lines:
                out.write("\n".join(lines) + "\n")
            n_unique += int(okm.sum())
            n_multi -= int(okm.sum())

    log.info(
        "aligned %d reads: %d unique (%.2f%%), %d multi, %d unaligned in %.1fs"
        " (%.0f reads/s)",
        n_total, n_unique, 100.0 * n_unique / max(n_total, 1), n_multi, n_none,
        sw.elapsed(), n_total / max(sw.elapsed(), 1e-9),
    )
    return 0


def cmd_ecreads(argv: list[str]) -> int:
    """`pacbiokanga ecreads` parity, following biokanga_tpu/cli.py:1571-1617."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch ecreads")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-o", "--out", required=True, help="corrected FASTA")
    p.add_argument("--seed-len", type=int, default=12)
    p.add_argument("--min-seed-votes", type=int, default=8)
    p.add_argument("--sw-band", type=int, default=96)
    p.add_argument("--min-score", type=int, default=60)
    p.add_argument("--max-targets", type=int, default=48,
                   help="overlap candidates per probe")
    p.add_argument("--rounds", type=int, default=2,
                   help="iterated-consensus rounds (round 2 corrects "
                        "round 1's output)")
    p.add_argument("--target-chunk", type=int, default=0,
                   help="index at most this many target reads at a time "
                        "(bounds device memory; 0 = all)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="not ported yet (see ROADMAP.md)")
    p.add_argument("-F", "--log", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without CUDA) "
                        "or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)
    if args.checkpoint_dir:
        p.error("--checkpoint-dir: resumable EC (utils/checkpoint) is not "
                "ported yet; see ROADMAP.md, queue 1")
    device = resolve_device(args.device)
    log = open_diagnostics(args.log, name="biokanga-tpu-torch")
    sw = StopWatch()
    from .pacbio.ecreads import ECParams, ec_reads
    from .seq.fasta import read_seqs, write_fasta

    names, reads = [], []
    for path in args.inreads:
        for r in read_seqs(path):
            names.append(r.name)
            reads.append(r.codes)
    ecp = ECParams(seed_len=args.seed_len,
                   min_seed_votes=args.min_seed_votes,
                   sw_band=args.sw_band, min_overlap_score=args.min_score,
                   max_targets=args.max_targets)
    corrected, stats = ec_reads(reads, ecp,
                                target_chunk=args.target_chunk or None,
                                rounds=max(1, args.rounds), device=device)
    write_fasta(args.out, zip(names, corrected))
    device_time = ("; device time: SW {sw_ms} ms, traceback {trace_ms} ms"
                   .format(**stats) if "sw_ms" in stats else "")
    log.info("ecreads: %d reads, %d pairs aligned, %d overlaps used, %.1fs%s",
             stats["reads"], stats["pairs"], stats["overlaps_used"],
             sw.elapsed(), device_time)
    return 0


SUBCOMMANDS = {"align": cmd_align, "ecreads": cmd_ecreads}


def main(argv: list[str] | None = None) -> int:
    argv = _expand_response_files(list(sys.argv[1:] if argv is None else argv))
    if not argv or argv[0] in ("-h", "--help"):
        print("biokanga-tpu-torch\nsubcommands: " + ", ".join(SUBCOMMANDS))
        return 0
    if argv[0] not in SUBCOMMANDS:
        print(f"unknown subcommand '{argv[0]}'", file=sys.stderr)
        return 2
    return SUBCOMMANDS[argv[0]](argv[1:])
