"""CLI of the PyTorch port: `align` (single and paired ends) and PacBio
`ecreads`.

Usage:  python -m biokanga_tpu_torch align -i reads.fq -I ref.npz \
            -o out.sam [--device cuda]
        python -m biokanga_tpu_torch align -i r1.fq -u r2.fq -I ref.npz \
            -o out.sam [-d 100 -D 1000 -E --peinsertdist ins.csv]
        python -m biokanga_tpu_torch ecreads -i reads.fa -o out.fa \
            [--device cuda]

`align` reads the index that `python -m biokanga_tpu index` writes and
gives the SAM that `python -m biokanga_tpu align` gives on the same
inputs; `ecreads` gives the FASTA of `python -m biokanga_tpu ecreads`.
The device is explicit: `--device cuda` (the default) raises when CUDA is
absent, and `--device cpu` runs the kernels' plain versions.  Paired
ends come as `-u` mate files beside `-i`, or as one PE-interleaved `.rds`
container.  SNP calling, indel/splice/chimeric modes, bisulfite,
colorspace and chunked indexes are not in this package yet; argparse
rejects their flags and the index checks below reject their index files.
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
    """`align`, single and paired ends, following
    biokanga_tpu/cli.py:510-857."""
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
    p.add_argument("-u", "--pair", action="append", default=None,
                   help="PE 3' mate file(s); enables paired-end processing")
    p.add_argument("-d", "--pairminlen", type=int, default=100)
    p.add_argument("-D", "--pairmaxlen", type=int, default=1000)
    p.add_argument("-E", "--pairstrand", action="store_true",
                   help="accept PE mates on the same strand")
    p.add_argument("--peinsertdist", default=None,
                   help="PE insert-size distribution CSV")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--no-mlassign", action="store_true",
                   help="disable multi-hit assignment clustering")
    p.add_argument("-F", "--log", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without CUDA) "
                        "or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    log = open_diagnostics(args.log, name="biokanga-tpu-torch")
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

    def _input_blocks(path, mate=None):
        """FASTA/FASTQ or packed .rds container."""
        if is_rds(path):
            return read_rds_blocks(path, block_size=args.batch_size,
                                   mate=mate)
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

    # PE-interleaved rds container with no -u: split mates internally
    pe_mates = None
    if (not args.pair and len(args.inreads) == 1
            and is_rds(args.inreads[0]) and rds_info(args.inreads[0]).is_pe):
        args.pair = list(args.inreads)
        pe_mates = (0, 1)

    if args.pair:
        return _align_pairs(args, engine, idx, _input_blocks, pe_mates, log,
                            sw)

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


def _align_pairs(args, engine, idx, input_blocks, pe_mates, log, sw) -> int:
    """The paired-end loop of `align` (biokanga_tpu/cli.py:534-603): one
    batch in flight on the device while the previous one is paired,
    rescued and written on the host.  PE mode skips multi-hit assignment,
    as in the JAX CLI."""
    from .align.pe import PEAligner, PEParams
    from .align.pipeline import pad_rows
    from .align.reports import AlignStats
    from .align.sam import write_pe_sam

    pe = PEAligner(
        engine,
        PEParams(
            pair_min_len=args.pairminlen,
            pair_max_len=args.pairmaxlen,
            pair_same_strand=args.pairstrand,
        ),
    )
    pe_stats = AlignStats()
    n_pairs = n_proper = 0
    with open(args.out, "w") as out:
        first = True

        def emit(pending, blk1, blk2):
            nonlocal first, n_pairs, n_proper
            res = pe.finish_pairs(pending)
            nb = len(blk1.names)
            sub = lambda d: {
                k: (v[:nb] if hasattr(v, "__len__") else v)
                for k, v in d.items()
            }
            res_v = {
                "res1": sub(res["res1"]), "res2": sub(res["res2"]),
                "proper": res["proper"][:nb],
                "insert": res["insert"][:nb],
            }
            write_pe_sam(
                out, idx.entry_names, idx.entry_starts,
                blk1.names, blk1.codes, blk1.lengths,
                blk2.names, blk2.codes, blk2.lengths,
                res_v, write_header=first,
            )
            first = False
            n_pairs += nb
            n_proper += int(res["proper"][:nb].sum())
            if args.peinsertdist:
                pe_stats.add_inserts(res["insert"][:nb],
                                     res["proper"][:nb])

        # the next block's fused align is enqueued before this block's
        # results are fetched, paired, rescued and written on the host
        inflight = None
        for p1, p2 in zip(args.inreads, args.pair):
            m1, m2 = pe_mates if pe_mates else (None, None)
            for blk1, blk2 in zip(
                input_blocks(p1, mate=m1),
                input_blocks(p2, mate=m2),
            ):
                r1, l1 = pad_rows(blk1.codes, blk1.lengths)
                r2, l2 = pad_rows(blk2.codes, blk2.lengths)
                nxt = (pe.launch_pairs(r1, l1, r2, l2), blk1, blk2)
                if inflight is not None:
                    emit(*inflight)
                inflight = nxt
        if inflight is not None:
            emit(*inflight)
    if args.peinsertdist:
        pe_stats.write_csv(args.peinsertdist)
    log.info(
        "paired %d pairs: %d proper (%.2f%%), %d mates rescued in %d window "
        "scans, in %.1fs",
        n_pairs, n_proper, 100.0 * n_proper / max(n_pairs, 1), pe.rescued,
        pe.rescue_calls, sw.elapsed(),
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
