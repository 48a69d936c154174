"""CLI of the PyTorch port: `index`, `align` (single and paired ends,
bisulfite and colorspace), PacBio `ecreads`, `pbfilter`, `contigs` and
`swservice`, and de novo assembly (`assemb`, `scaffold`, `pescaffold`);
the tools and simulators of cli_tools.py (`simreads`, `uhamming`,
`blitz`, `mergeoverlaps`, `findapproxmatches`, the marker tools,
`rnafragsim`, `usimdiffexpr`, `kangarg`) and the read preparation and
host tools of cli_host.py (`filter`, `ngsqc`, `kangar`, the converters,
the expression, zygosity and misc tools, the SQLite loaders) join them
in SUBCOMMANDS.  `-v` prints the version; every subcommand but `index`
and `align` (which log richer rows of their own) takes `-q DB`, which
logs the run to SQLite as the JAX CLI's dispatch does.

Usage:  python -m biokanga_tpu_torch index -i ref.fa -o ref.npz \
            [-m 0|1|2 -C -s <Mbp> --lut-bases 0 --chunks 0
             --chunk-overlap 2048 -q runs.db]
        python -m biokanga_tpu_torch align -i reads.fq -I ref.npz \
            -o out.sam|out.bam [--device cuda]
            [-O snps.csv --snpvcf --disnp --trisnp --snpcentroid -p -P]
            [-a 10 -A 50000 -C 50 -x -y --min-accept-len -k
             --minflankexacts --pcrprimersubs --lociconstraints -Y
             --stats --checkpoint-dir -q]
        python -m biokanga_tpu_torch align -i r1.fq -u r2.fq -I ref.npz \
            -o out.sam [-d 100 -D 1000 -E --peinsertdist ins.csv]
        python -m biokanga_tpu_torch ecreads -i reads.fa -o out.fa \
            [--checkpoint-dir ck --device cuda]
        python -m biokanga_tpu_torch pbfilter -i raw.fa -o subreads.fa
        python -m biokanga_tpu_torch contigs -i ec.fa -o contigs.fa
        python -m biokanga_tpu_torch assemb -i r1.fa -i r2.fa -o contigs.fa
        python -m biokanga_tpu_torch scaffold -c contigs.fa -i r1.fq \
            -u r2.fq -o scaffolds.fa
        python -m biokanga_tpu_torch pescaffold -i pe1.sam -u pe2.sam \
            -o scaffolds.csv
        python -m biokanga_tpu_torch swservice -a probes.fa -b targets.fa \
            -o scores.csv [--sw-band 96 --pairs zip|cross -n N --device cuda]

Each subcommand gives the files of the same subcommand of
`python -m biokanga_tpu` on the same inputs: the index arrays, the SAM
or BAM, the SNP, haplotype, centroid and stats CSVs, the VCF, the
`-q` rows outside their time fields, and the FASTA.  `index` is host
numpy and takes no device.  For `align`, `ecreads` and `swservice` the
device is explicit: `--device cuda` (the default) raises when CUDA is
absent, and `--device cpu` runs the kernels' plain versions; the SNP
pileup and the indel and splice scans run on the index's device.  Paired
ends come as `-u` mate files beside `-i`, or as one PE-interleaved `.rds`
container; as in the JAX CLI they take none of the single-end passes.
`index --chunks N` (and any genome of 2^31 bases or more) writes a
genome-range chunked index; `align` against it sweeps the chunks and
merges exactly, for single ends (with -a -A -O --checkpoint-dir) and
pairs, and ignores what the JAX CLI's chunked branch ignores.  Reads past 4,096 bases align
on the dense extension path.  `index -m 1` writes a bisulfite index pair
and `index -C` a colorspace index; `align` against either runs the
two-pass aligner of its kind (`-i` colour reads as `.csfasta` for the
latter).  `pbfilter` and `pescaffold` are host code and take no device;
`assemb`, `scaffold` and `contigs` take `--device` as `align` does.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import __version__
from .cli_host import HOST_SUBCOMMANDS
from .cli_tools import TOOL_SUBCOMMANDS
from .cli_tools import add_device as _add_device
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


def cmd_index(argv: list[str]) -> int:
    """`index`: genome FASTA -> on-disk index, following
    biokanga_tpu/cli.py:36-158 (reference front-end biokanga/kangax.cpp:59).

    The index build is host numpy (no device work), so `index` takes no
    --device."""
    p = argparse.ArgumentParser(
        prog="biokanga-tpu-torch index",
        description="Build an index on the host (numpy; no device work, "
                    "so there is no --device).")
    p.add_argument("-i", "--infasta", action="append", default=None,
                   help="input FASTA file(s), gzip ok (repeatable)")
    p.add_argument("-o", "--out", required=True, help="output index file (.npz)")
    p.add_argument("-r", "--ref", default="", help="reference species/tag")
    p.add_argument("-m", "--mode", type=int, default=0, choices=(0, 1, 2),
                   help="0 standard; 1 bisulfite methylation index "
                        "(kangax -m1 role); 2 synthetic pseudorandom "
                        "genome benchmark (kangax -m2 role)")
    p.add_argument("-C", "--colorspace", action="store_true",
                   help="SOLiD colorspace index (kangax -C role): genome "
                        "is dibase-color transformed before indexing")
    p.add_argument("-s", "--synthetic-mbp", type=int, default=100,
                   help="mode 2: synthetic genome size in Mbp")
    p.add_argument("--lut-bases", type=int, default=0,
                   help="prefix LUT width in bases (0 = auto: 10 for "
                        "genomes <= 20 Mbp, else 12)")
    p.add_argument("--chunks", type=int, default=0,
                   help="force this many genome-range chunks; 0 = auto "
                        "(chunked only from 2^31 bases)")
    p.add_argument("--chunk-overlap", type=int, default=2048,
                   help="chunk slice overlap in bases; must cover the "
                        "longest alignment window (PE: >= pairmaxlen)")
    p.add_argument("-q", "--sumrslts", default=None,
                   help="log experiment/params/results to this SQLite DB")
    p.add_argument("-F", "--log", default=None)
    args = p.parse_args(argv)
    # the JAX CLI's branches: -m 2 ignores -C and --chunks, -m 1 ignores -C
    # and --chunks, -C ignores --chunks
    log = open_diagnostics(args.log, name="biokanga-tpu-torch")
    sw = StopWatch()
    from .index.build import build_index, save_index

    def auto_lut(total_bp: int) -> int:
        if args.lut_bases:
            return args.lut_bases
        return 10 if total_bp <= 20_000_000 else 12

    def read_all(flag: str) -> list:
        """(name, codes) of every record of every -i file."""
        if not args.infasta:
            p.error(f"-i/--infasta required {flag}")
        from .seq.fasta import read_seqs

        return [(r.name, r.codes) for path in args.infasta
                for r in read_seqs(path)]

    if args.mode == 2:
        from .sim.simreads import random_genome

        nbp = args.synthetic_mbp * 1_000_000
        seqs = random_genome([("synth", nbp)], seed=1)
        log.info("synthetic genome: %d Mbp (RAM-only benchmark mode)",
                 args.synthetic_mbp)
        idx = build_index(seqs, lut_bases=auto_lut(nbp))
    elif args.mode == 1:
        from .index.build import build_bisulfite_indexes, save_bisulfite_index

        seqs = read_all("for -m1")
        ct, ga = build_bisulfite_indexes(
            seqs, lut_bases=auto_lut(sum(len(x) for _, x in seqs)))
        log.info("bisulfite-indexed %d entries, %d bp in %.1fs",
                 ct.num_entries, ct.total_len, sw.mark("build"))
        save_bisulfite_index(ct, ga, args.out)
        log.info("bisulfite index written to %s (%.1fs)", args.out,
                 sw.elapsed())
        return 0
    elif args.colorspace:
        from .index.build import build_colorspace_index

        seqs = read_all("for -C")
        idx = build_colorspace_index(
            seqs, lut_bases=auto_lut(sum(len(x) for _, x in seqs)))
    else:
        seqs = read_all("unless -m2")
        total = sum(len(s) for _, s in seqs)
        if args.chunks > 0 or total >= 2**31:
            from .index.chunked import build_chunked_index, save_chunked_index

            nchunks = args.chunks or -(-total // ((1 << 31) - 2**20))
            ci = build_chunked_index(
                seqs, num_chunks=nchunks, overlap=args.chunk_overlap,
                lut_bases=args.lut_bases or 12,
            )
            log.info(
                "chunk-indexed %d entries, %d bp total across %d chunks "
                "in %.1fs", len(ci.entry_names), ci.total_len,
                ci.num_chunks, sw.mark("build"),
            )
            save_chunked_index(ci, args.out)
            log.info("chunked index written to %s (%.1fs)", args.out,
                     sw.elapsed())
            return 0
        idx = build_index(seqs, lut_bases=auto_lut(total))
    log.info(
        "indexed %d entries, %d bp total in %.1fs",
        idx.num_entries, idx.total_len, sw.mark("build"),
    )
    save_index(idx, args.out)
    log.info("index written to %s (%.1fs)", args.out, sw.elapsed())
    if args.sumrslts:
        from .utils.sqlite_summaries import SQLiteSummaries

        db = SQLiteSummaries(args.sumrslts)
        db.log_run("index", {"infasta": args.infasta, "out": args.out,
                             "lut_bases": args.lut_bases},
                   {"entries": idx.num_entries, "total_bp": idx.total_len,
                    "seconds": round(sw.elapsed(), 2)})
        db.close()
    return 0


def cmd_align(argv: list[str]) -> int:
    """`align`, single and paired ends, following
    biokanga_tpu/cli.py:161-857."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch align")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-u", "--pair", action="append", default=None,
                   help="PE 3' mate file(s); enables paired-end processing")
    p.add_argument("-d", "--pairminlen", type=int, default=100)
    p.add_argument("-D", "--pairmaxlen", type=int, default=1000)
    p.add_argument("-E", "--pairstrand", action="store_true",
                   help="accept mates on the same strand")
    p.add_argument("-I", "--sfx", required=True, help="index file from `index`")
    p.add_argument("-o", "--out", required=True,
                   help="output SAM path (.bam: BAM with a BAI/CSI index)")
    p.add_argument("-O", "--snpfile", default=None,
                   help="call SNPs and write reference-layout CSV here")
    p.add_argument("--snpvcf", default=None, help="also write SNPs as VCF")
    p.add_argument("--disnp", default=None,
                   help="write DiSNP haplotype CSV here (needs -O)")
    p.add_argument("--trisnp", default=None,
                   help="write TriSNP haplotype CSV here (needs -O)")
    p.add_argument("--snpcentroid", default=None,
                   help="write SNP centroid (7-mer context) distribution "
                        "CSV here (needs -O; Aligner.cpp:8003 role)")
    p.add_argument("-q", "--sumrslts", default=None,
                   help="log experiment/params/results to this SQLite DB")
    p.add_argument("-p", "--minsnpreads", type=int, default=5)
    p.add_argument("-P", "--qvalue", type=float, default=0.05)
    p.add_argument("--snpnonrefpcnt", type=float, default=25.0)
    p.add_argument("-s", "--substitutions", type=int, default=10,
                   help="max subs per 100bp (default 10)")
    p.add_argument("-e", "--editdelta", type=int, default=1, choices=(1, 2))
    p.add_argument("-m", "--mode", default="default",
                   choices=("ultra", "more", "default", "less"))
    p.add_argument("-Q", "--strand", default="both",
                   choices=("both", "sense", "antisense"))
    p.add_argument("-R", "--maxmulti", type=int, default=5)
    p.add_argument("-a", "--microindellen", type=int, default=0,
                   help="accept microInDels up to this length (0..20)")
    p.add_argument("-A", "--splicejunctlen", type=int, default=0,
                   help="RNA mode: accept splice junctions separated by up"
                        " to this distance (25..100000)")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("-F", "--log", default=None)
    p.add_argument("-x", "--trim5", type=int, default=0)
    p.add_argument("-y", "--trim3", type=int, default=0)
    p.add_argument("--min-accept-len", type=int, default=0)
    p.add_argument("-C", "--minchimericlen", type=int, default=0,
                   help="accept chimeric flank-trimmed alignments covering"
                        " at least this %% of the read (50..99; 0 off)")
    p.add_argument("--stats", default=None,
                   help="write alignment stats CSV here")
    p.add_argument("--no-mlassign", action="store_true",
                   help="disable multi-hit assignment clustering")
    p.add_argument("-k", "--pcrdedupe", type=int, default=0,
                   help="demote PCR duplicates at identical (locus,strand)"
                        " beyond this many copies (0 off)")
    p.add_argument("-Y", "--priorityregionbed", default=None,
                   help="only accept hits overlapping these BED regions")
    p.add_argument("--peinsertdist", default=None,
                   help="PE mode: write insert-size distribution CSV here")
    p.add_argument("--minflankexacts", type=int, default=0,
                   help="autotrim aligned flanks until at least this many "
                        "exactly matching flank bases (AutoTrimFlanks, "
                        "Aligner.cpp:1608; reference -x)")
    p.add_argument("--pcrprimersubs", type=int, default=0,
                   help="align with subs+this budget, then correct 5' PCR "
                        "primer artefacts over the first 12bp back to subs "
                        "(PCR5PrimerCorrect, Aligner.cpp:2000; ref -6)")
    p.add_argument("--lociconstraints", default=None,
                   help="loci base constraints CSV chrom,start,end,bases "
                        "(IdentifyConstraintViolations, Aligner.cpp:2599; "
                        "reference -5)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="persist each block's result here and resume a "
                        "killed single-end run at the first missing block")
    _add_device(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    log = open_diagnostics(args.log, name="biokanga-tpu-torch")
    sw = StopWatch()

    from .align.params import AlignParams, Sensitivity
    from .align.pipeline import AlignEngine
    from .index.build import is_bisulfite_index, load_index
    from .index.chunked import is_chunked_index
    from .index.device import to_device
    from .seq.fasta import read_blocks
    from .seq.rds import is_rds, rds_info, read_rds_blocks

    def _input_blocks(path, mate=None):
        """FASTA/FASTQ or packed .rds container."""
        if is_rds(path):
            return read_rds_blocks(path, block_size=args.batch_size,
                                   mate=mate)
        return read_blocks(path, block_size=args.batch_size)

    # .bam output: write SAM to a temp path and convert it at the end
    bam_out = None
    if args.out.endswith(".bam"):
        bam_out = args.out
        args.out = args.out + ".tmp.sam"

    def finish_bam() -> None:
        if bam_out:
            from .align.bam import sam_to_bam

            sam_to_bam(args.out, bam_out)
            os.remove(args.out)

    if is_bisulfite_index(args.sfx):
        _align_bisulfite(args, device, log, sw)
        finish_bam()
        return 0

    if is_chunked_index(args.sfx):
        _align_chunked(args, device, _input_blocks, log, sw)
        finish_bam()
        return 0

    idx = load_index(args.sfx)
    didx = to_device(idx, device)
    log.info("index loaded on %s: %d bp, %d entries (%.1fs)",
             device, idx.total_len, idx.num_entries, sw.mark("load"))

    if idx.space == "color":
        _align_colorspace(args, idx, didx, log, sw)
        finish_bam()
        return 0

    params = AlignParams(
        # PCR5PrimerCorrect mode aligns with a widened sub budget, then
        # corrects back to -s (reference -6 semantics, kanga.cpp:251)
        max_subs_per100=args.substitutions + args.pcrprimersubs,
        min_edit_dist=args.editdelta,
        max_multi=args.maxmulti,
        mode=Sensitivity(args.mode),
        strand=args.strand,
        batch_size=args.batch_size,
    )
    engine = AlignEngine(didx, params)
    constraints = None
    if args.lociconstraints:
        from .align.postpass import load_loci_constraints

        constraints = load_loci_constraints(args.lociconstraints)

    # PE-interleaved rds container with no -u: split mates internally
    pe_mates = None
    if (not args.pair and len(args.inreads) == 1
            and is_rds(args.inreads[0]) and rds_info(args.inreads[0]).is_pe):
        args.pair = list(args.inreads)
        pe_mates = (0, 1)

    if args.pair:
        # paired ends take none of the single-end passes below, as in
        # the JAX CLI (its PE branch returns before them)
        rc = _align_pairs(args, engine, idx, _input_blocks, pe_mates, log,
                          sw)
        finish_bam()
        return rc

    counts = _align_single(args, engine, idx, constraints, _input_blocks,
                           log, sw)
    finish_bam()
    if args.sumrslts:
        from .utils.sqlite_summaries import SQLiteSummaries

        db = SQLiteSummaries(args.sumrslts)
        db.log_run("align", {"inreads": args.inreads, "sfx": args.sfx,
                             "substitutions": args.substitutions,
                             "editdelta": args.editdelta, "mode": args.mode},
                   {**counts, "seconds": round(sw.elapsed(), 2)})
        db.close()
    return 0


def _align_single(args, engine, idx, constraints, input_blocks, log,
                  sw) -> dict:
    """The single-end loop of `align` (biokanga_tpu/cli.py:605-836): the
    engine (or the indel/splice aligner) on each block, the post-passes
    in the JAX CLI's order, SAM, multi-hit assignment, then --stats and
    the SNP outputs.  Returns the read counts that `-q` logs."""
    from .align.multihit import assign_multihits, chimeric_pass
    from .align.pipeline import pad_rows
    from .align.reports import AlignStats
    from .align.sam import SamRecord, write_alignments_sam
    from .seq.encode import codes_to_ascii, revcomp

    didx = engine.didx
    pileup = None
    hap = None
    if args.snpfile:
        from .align.snp import HaplotypeTracker, PileupAccumulator

        pileup = PileupAccumulator(didx)
        if args.disnp or args.trisnp:
            hap = HaplotypeTracker()

    ext = None
    if args.microindellen or args.splicejunctlen:
        from .align.pipeline import ExtendedAligner

        ext = ExtendedAligner(engine, args.microindellen, args.splicejunctlen)

    prio = None
    if args.priorityregionbed:
        from .align.postpass import PriorityRegionFilter

        prio = PriorityRegionFilter(args.priorityregionbed,
                                    idx.entry_names, idx.entry_starts)
    stats = AlignStats()
    ckpt = None
    if args.checkpoint_dir:
        # per-block resumability; the post-passes are deterministic in
        # (codes, lens, res) and replay on resume
        from .utils.checkpoint import SweepCheckpoint, config_signature

        ckpt = SweepCheckpoint(
            args.checkpoint_dir,
            config_signature(["se_single", args.sfx, engine.params,
                              list(args.inreads), args.batch_size,
                              args.trim5, args.trim3]),
        )
    blk_i = 0
    mh_loci, mh_rows = [], []   # pending multi-hit reads for assignment
    uq_loci, uq_lens = [], []
    n_total = n_unique = n_multi = n_none = 0
    with open(args.out, "w") as out:
        first = True
        for path in args.inreads:
            for blk in input_blocks(path):
                if args.trim5 or args.trim3:
                    blk.codes = blk.codes[:, args.trim5:]
                    if args.trim3:
                        blk.codes = blk.codes[:, : -args.trim3 or None]
                    blk.lengths = np.clip(
                        blk.lengths - args.trim5 - args.trim3, 0, None
                    )
                codes, lens = pad_rows(blk.codes, blk.lengths)
                if ckpt is not None and ckpt.has(0, blk_i):
                    res = ckpt.load(0, blk_i)
                elif ext is not None:
                    res = ext.align(codes, lens)
                else:
                    res = engine.align_with_rescue(codes, lens)
                if ckpt is not None and not ckpt.has(0, blk_i):
                    ckpt.save(0, blk_i, res)
                blk_i += 1
                if args.min_accept_len:
                    res["unique"] &= lens >= args.min_accept_len
                if args.minchimericlen:
                    res = chimeric_pass(idx.codes, codes, lens, res,
                                        args.minchimericlen)
                    stats.chimeric += int(
                        (res.get("clip5", np.zeros(1)) > 0).sum()
                        + (res.get("clip3", np.zeros(1)) > 0).sum()
                    )
                if args.pcrdedupe:
                    from .align.postpass import reduce_pcr_duplicates

                    reduce_pcr_duplicates(res, lens, keep=args.pcrdedupe)
                if constraints:
                    from .align.postpass import (
                        identify_constraint_violations,
                    )

                    identify_constraint_violations(
                        codes, lens, res, idx.codes, idx.entry_names,
                        idx.entry_starts, constraints,
                    )
                if args.pcrprimersubs:
                    from .align.postpass import pcr5_primer_correct

                    pcr5_primer_correct(codes, lens, res, idx.codes,
                                        args.substitutions, klen=12)
                    n0 = len(blk.names)
                    blk.codes[:n0] = codes[:n0, : blk.codes.shape[1]]
                if args.minflankexacts:
                    from .align.postpass import auto_trim_flanks

                    auto_trim_flanks(codes, lens, res, idx.codes,
                                     args.minflankexacts)
                if args.splicejunctlen:
                    from .align.postpass import remove_orphan_splice_juncts

                    remove_orphan_splice_juncts(res, lens)
                if args.microindellen:
                    from .align.postpass import remove_orphan_microindels

                    remove_orphan_microindels(res, lens)
                if prio is not None:
                    prio.apply(res, lens)
                if pileup is not None:
                    pileup.add_alignments(codes, lens, res)
                    if hap is not None:
                        hap.add_alignments(codes, lens, res)
                n = len(blk.names)
                stats.add_batch(res, n)
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
            stats.multi_assigned = int(okm.sum())
            n_unique += int(okm.sum())
            n_multi -= int(okm.sum())

    if args.stats:
        stats.write_csv(args.stats)
        log.info("stats written to %s", args.stats)
    log.info(
        "aligned %d reads: %d unique (%.2f%%), %d multi, %d unaligned in %.1fs"
        " (%.0f reads/s)",
        n_total, n_unique, 100.0 * n_unique / max(n_total, 1), n_multi, n_none,
        sw.elapsed(), n_total / max(sw.elapsed(), 1e-9),
    )

    if pileup is not None:
        from .align.snp import (
            SNPParams,
            call_snps,
            write_snps_csv,
            write_snps_vcf,
        )

        counts, match, mismatch = pileup.finalize()
        calls = call_snps(
            counts, match, mismatch, idx.codes, idx.entry_names,
            idx.entry_starts,
            SNPParams(
                min_snp_reads=args.minsnpreads,
                snp_nonref_pcnt=args.snpnonrefpcnt / 100.0,
                qvalue=args.qvalue,
            ),
        )
        write_snps_csv(args.snpfile, calls)
        if hap is not None:
            from .align.snp import write_haplotypes_csv

            if args.disnp:
                write_haplotypes_csv(
                    args.disnp,
                    hap.haplotypes(calls, idx.entry_names, idx.entry_starts, 2),
                    order=2,
                )
            if args.trisnp:
                write_haplotypes_csv(
                    args.trisnp,
                    hap.haplotypes(calls, idx.entry_names, idx.entry_starts, 3),
                    order=3,
                )
        if args.snpvcf:
            write_snps_vcf(args.snpvcf, calls, idx.entry_names,
                           np.diff(idx.entry_starts))
        if args.snpcentroid:
            from .align.snp import snp_centroids, write_snp_centroids_csv

            write_snp_centroids_csv(
                args.snpcentroid,
                *snp_centroids(counts, idx.codes, calls, idx.entry_names,
                               idx.entry_starts,
                               min_reads=args.minsnpreads),
            )
        log.info("called %d SNPs -> %s", len(calls), args.snpfile)
    return {"total": n_total, "unique": n_unique, "multi": n_multi,
            "unaligned": n_none}


def _align_chunked(args, device, input_blocks, log, sw) -> None:
    """`align` against a genome-range chunked index
    (biokanga_tpu/cli.py:314-468): chunk sweeps with an exact merge.  As
    in the JAX CLI, this branch takes -s -e -R -m -Q --batch-size, the
    mate files with -d -D -E, and for single ends -a -A, -O with -p -P
    --snpnonrefpcnt, and --checkpoint-dir; it ignores every other
    option (no insert CSV, side files but the SNP CSV, post-passes, trims
    or -q rows).  Every chunk stays on the device, uploaded once, where
    the index fits there (parallel/chunked.ChunkedAligner); else the
    chunks cycle through it."""
    from .align.params import AlignParams, Sensitivity
    from .align.pipeline import pad_rows
    from .align.sam import write_alignments_sam
    from .index.chunked import load_chunked_index
    from .parallel.chunked import ChunkedAligner

    ci = load_chunked_index(args.sfx)
    log.info("chunked index loaded: %d bp, %d entries, %d chunks (%.1fs)",
             ci.total_len, len(ci.entry_names), ci.num_chunks,
             sw.mark("load"))
    params = AlignParams(
        max_subs_per100=args.substitutions,
        min_edit_dist=args.editdelta, max_multi=args.maxmulti,
        mode=Sensitivity(args.mode), strand=args.strand,
        batch_size=args.batch_size,
    )
    ca = ChunkedAligner(ci, params, device)
    if ca.resident is not None:
        log.info("%d chunks resident on %s: %.2f GiB (%.1fs)",
                 ca.num_chunks, device, ca.index_bytes() / 2**30,
                 sw.mark("upload"))
    else:
        log.info("index larger than the free memory of %s: chunks cycle",
                 device)
    if args.pair:
        from .align.pe import PEParams
        from .parallel.chunked import ChunkedPEAligner

        pea = ChunkedPEAligner(ca, PEParams(
            pair_min_len=args.pairminlen,
            pair_max_len=args.pairmaxlen,
            pair_same_strand=args.pairstrand,
        ))
        n_pairs, n_proper = _pe_loop(
            pea, args.out, ci.entry_names, ci.entry_starts,
            (blks for p1, p2 in zip(args.inreads, args.pair)
             for blks in zip(input_blocks(p1), input_blocks(p2))), None)
        log.info("chunk-aligned %d pairs: %d proper (%.2f%%) in %.1fs",
                 n_pairs, n_proper, 100.0 * n_proper / max(n_pairs, 1),
                 sw.elapsed())
        return
    # SE: chunk-major streaming over all blocks
    blocks, names_list = [], []
    for path in args.inreads:
        for blk in input_blocks(path):
            blocks.append(pad_rows(blk.codes, blk.lengths))
            names_list.append((blk.names, blk.codes, blk.lengths))
    results = ca.align_blocks(blocks, checkpoint_dir=args.checkpoint_dir)
    if args.microindellen or args.splicejunctlen:
        from .parallel.chunked import ChunkedExtendedAligner

        cea = ChunkedExtendedAligner(ca, args.microindellen,
                                     args.splicejunctlen)
        log.info("chunked indel/splice fall-through rescued %d reads",
                 cea.fallthrough_blocks(blocks, results))
    n_total = n_unique = 0
    with open(args.out, "w") as out:
        first = True
        for (names, codes0, lens0), res in zip(names_list, results):
            write_alignments_sam(out, ci.entry_names, ci.entry_starts,
                                 names, codes0, lens0, res,
                                 write_header=first)
            first = False
            n_total += len(names)
            n_unique += int(res["unique"][: len(names)].sum())
    if args.snpfile:
        _chunked_snps(args, ci, ca, blocks, results, log)
    log.info("chunk-aligned %d reads: %d unique (%.2f%%) in %.1fs",
             n_total, n_unique, 100.0 * n_unique / max(n_total, 1),
             sw.elapsed())


def _chunked_snps(args, ci, ca, blocks, results, log) -> None:
    """`-O` on a chunked index: a second chunk sweep piles up each chunk's
    accepted reads on the device and compacts candidates there
    (align/snp.ChunkedPileup); only the SNP CSV is written, as in the JAX
    CLI."""
    from .align.pe import _orient_mates
    from .align.snp import ChunkedPileup, SNPParams, write_snps_csv
    from .parallel.chunked import chunk_of

    sp = SNPParams(
        min_snp_reads=args.minsnpreads,
        snp_nonref_pcnt=args.snpnonrefpcnt / 100.0,
        qvalue=args.qvalue,
    )
    cp = ChunkedPileup(ci.bases, [c.total_len for c in ci.chunks], ci.owned,
                       ci.overlap)
    for k in range(ci.num_chunks):
        eng = ca.engine_for(k)
        genome = eng.didx.genome
        cp.start_chunk(k, int(genome.shape[0]), genome.device)
        esl = np.clip(ci.entry_starts - ci.bases[k], 0,
                      ci.chunks[k].total_len)
        for (codes, lens), res in zip(blocks, results):
            acc = res["unique"] & (chunk_of(ci.bases, res["locus"]) == k)
            if not acc.any():
                continue
            aligned = _orient_mates(codes, lens, res["is_rc"] & acc)
            cp.add_batch(genome, (res["locus"] - ci.bases[k]).astype(np.int64),
                         aligned, lens, acc)
        cp.finish_chunk(genome, esl, sp)

    def ref_base(e, loci):
        g = int(ci.entry_starts[e]) + int(loci)
        kk = int(chunk_of(ci.bases, g))
        return int(ci.chunks[kk].codes[g - int(ci.bases[kk])])

    calls = cp.finalize_calls(ref_base, ci.entry_names, ci.entry_starts, sp)
    write_snps_csv(args.snpfile, calls)
    log.info("chunked SNP calling: %d accepted calls -> %s", len(calls),
             args.snpfile)


def _pe_loop(pe, out_path, entry_names, entry_starts, block_pairs,
             inserts) -> tuple[int, int]:
    """Write the SAM of every (mate 1, mate 2) block pair through `pe`, a
    PEAligner over a single or a chunked index, with one batch in flight:
    the next pair's align is enqueued before this one's results are
    fetched, paired, rescued and written on the host.  `inserts`: an
    AlignStats that takes each block's insert sizes, or None.  Returns
    (pairs, proper pairs)."""
    from .align.pipeline import pad_rows
    from .align.sam import write_pe_sam

    n_pairs = n_proper = 0
    with open(out_path, "w") as out:
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
                out, entry_names, entry_starts,
                blk1.names, blk1.codes, blk1.lengths,
                blk2.names, blk2.codes, blk2.lengths,
                res_v, write_header=first,
            )
            first = False
            n_pairs += nb
            n_proper += int(res["proper"][:nb].sum())
            if inserts is not None:
                inserts.add_inserts(res["insert"][:nb], res["proper"][:nb])

        inflight = None
        for blk1, blk2 in block_pairs:
            r1, l1 = pad_rows(blk1.codes, blk1.lengths)
            r2, l2 = pad_rows(blk2.codes, blk2.lengths)
            nxt = (pe.launch_pairs(r1, l1, r2, l2), blk1, blk2)
            if inflight is not None:
                emit(*inflight)
            inflight = nxt
        if inflight is not None:
            emit(*inflight)
    return n_pairs, n_proper


def _align_pairs(args, engine, idx, input_blocks, pe_mates, log, sw) -> int:
    """The paired-end loop of `align` (biokanga_tpu/cli.py:534-603) over a
    single index.  PE mode skips multi-hit assignment, as in the JAX
    CLI."""
    from .align.pe import PEAligner, PEParams
    from .align.reports import AlignStats

    pe = PEAligner(
        engine,
        PEParams(
            pair_min_len=args.pairminlen,
            pair_max_len=args.pairmaxlen,
            pair_same_strand=args.pairstrand,
        ),
    )
    pe_stats = AlignStats() if args.peinsertdist else None
    m1, m2 = pe_mates if pe_mates else (None, None)
    n_pairs, n_proper = _pe_loop(
        pe, args.out, idx.entry_names, idx.entry_starts,
        (blks for p1, p2 in zip(args.inreads, args.pair)
         for blks in zip(input_blocks(p1, mate=m1),
                         input_blocks(p2, mate=m2))), pe_stats)
    if pe_stats is not None:
        pe_stats.write_csv(args.peinsertdist)
    log.info(
        "paired %d pairs: %d proper (%.2f%%), %d mates rescued in %d window "
        "scans, in %.1fs",
        n_pairs, n_proper, 100.0 * n_proper / max(n_pairs, 1), pe.rescued,
        pe.rescue_calls, sw.elapsed(),
    )
    return 0


def _two_pass_sam(args, aligner, idx, blocks, kind, log, sw,
                  space="base") -> None:
    """The SAM of a two-pass aligner (bisulfite or colorspace) over every
    block of every input, as the JAX CLI writes it."""
    from .align.pipeline import pad_rows
    from .align.sam import write_alignments_sam

    n_total = n_unique = 0
    with open(args.out, "w") as out:
        first = True
        for path in args.inreads:
            for blk in blocks(path, block_size=args.batch_size):
                codes, lens = pad_rows(blk.codes, blk.lengths)
                res = aligner.align_batch(codes, lens)
                write_alignments_sam(
                    out, idx.entry_names, idx.entry_starts,
                    blk.names, blk.codes, blk.lengths, res,
                    write_header=first, space=space,
                )
                first = False
                n_total += len(blk.names)
                n_unique += int(res["unique"].sum())
    log.info("%s-aligned %d reads: %d unique (%.2f%%) in %.1fs", kind,
             n_total, n_unique, 100.0 * n_unique / max(n_total, 1),
             sw.elapsed())


def _align_bisulfite(args, device, log, sw) -> None:
    """`align` against a bisulfite index pair, following
    biokanga_tpu/cli.py:273-312: every read C->T collapsed through a CT
    sense engine and a GA antisense engine, merged on the host."""
    import dataclasses

    from .align.bisulfite import BisulfiteAligner
    from .align.params import AlignParams, Sensitivity
    from .align.pipeline import AlignEngine
    from .index.build import load_bisulfite_index
    from .index.device import to_device
    from .seq.fasta import read_blocks

    ict, iga = load_bisulfite_index(args.sfx)
    params_ct = AlignParams(
        max_subs_per100=args.substitutions,
        min_edit_dist=args.editdelta, max_multi=args.maxmulti,
        mode=Sensitivity(args.mode), strand="sense",
        batch_size=args.batch_size,
    )
    params_ga = dataclasses.replace(params_ct, strand="antisense")
    bs = BisulfiteAligner(
        AlignEngine(to_device(ict, device), params_ct),
        AlignEngine(to_device(iga, device), params_ga),
    )
    log.info("bisulfite index loaded on %s: %d bp, %d entries (%.1fs)",
             device, ict.total_len, ict.num_entries, sw.mark("load"))
    _two_pass_sam(args, bs, ict, read_blocks, "bisulfite", log, sw)


def _align_colorspace(args, idx, didx, log, sw) -> None:
    """`align` of SOLiD .csfasta colour reads against a colorspace index,
    following biokanga_tpu/cli.py:476-508: one sense engine on the colours
    and on the reversed colours."""
    from .align.colorspace import ColorspaceAligner
    from .align.params import AlignParams, Sensitivity
    from .align.pipeline import AlignEngine
    from .seq.fasta import read_csfasta_blocks

    cs_params = AlignParams(
        max_subs_per100=args.substitutions,
        min_edit_dist=args.editdelta, max_multi=args.maxmulti,
        mode=Sensitivity(args.mode), strand="sense",
        batch_size=args.batch_size,
    )
    cs = ColorspaceAligner(AlignEngine(didx, cs_params))
    _two_pass_sam(args, cs, idx, read_csfasta_blocks, "colorspace", log, sw,
                  space="color")


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
                   help="resumable per-group correction checkpoints (one "
                        "round, as in the JAX CLI)")
    p.add_argument("-F", "--log", default=None)
    _add_device(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    log = open_diagnostics(args.log, name="biokanga-tpu-torch")
    sw = StopWatch()
    from .pacbio.ecreads import ECParams, ec_reads, ec_reads_checkpointed
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
    if args.checkpoint_dir:
        corrected, stats = ec_reads_checkpointed(
            reads, ecp, checkpoint_dir=args.checkpoint_dir, device=device)
    else:
        corrected, stats = ec_reads(reads, ecp,
                                    target_chunk=args.target_chunk or None,
                                    rounds=max(1, args.rounds),
                                    device=device)
    write_fasta(args.out, zip(names, corrected))
    device_time = ("; device time: SW {sw_ms} ms, traceback {trace_ms} ms"
                   .format(**stats) if "sw_ms" in stats else "")
    log.info("ecreads: %d reads, %d pairs aligned, %d overlaps used, %.1fs%s",
             stats["reads"], stats["pairs"], stats["overlaps_used"],
             sw.elapsed(), device_time)
    return 0


def _swservice_rank(rank, n, backend, init_method, device, jobs, W, out,
                    pair_names) -> None:
    """One rank of `swservice`: join the ranks, align this rank's share
    of the jobs, report on stderr how often it launched each SW kernel
    and, on rank 0, write the CSV."""
    import torch.distributed as dist

    from .ops.banded_sw import banded_sw_moves, banded_sw_score
    from .parallel.dist import init_ranks
    from .parallel.swservice import make_sw_mesh, run_sw_jobs

    init_ranks(backend, init_method, n, rank)
    try:
        mesh = make_sw_mesh(n, device)
        res = run_sw_jobs(mesh, jobs if rank == 0 else None, W)
        print(f"swservice: rank {rank} on {mesh.device}: kernel launches "
              f"banded_sw_score={banded_sw_score.launches} "
              f"banded_sw_moves={banded_sw_moves.launches}",
              file=sys.stderr, flush=True)
        if rank == 0:
            with open(out, "w") as f:
                f.write('"Probe","Target","Score","EndProbeOfs",'
                        '"EndTargOfs"\n')
                for r, (pn, tn) in enumerate(pair_names):
                    f.write(f'"{pn}","{tn}",{int(res["score"][r])},'
                            f'{int(res["best_i"][r])},'
                            f'{int(res["best_k"][r])}\n')
    finally:
        dist.destroy_process_group()


def cmd_swservice(argv: list[str]) -> int:
    """`pacbiokanga swservice` parity (biokanga_tpu/cli.py:1891-1950).

    The job batch (probe/target FASTA pairs) is aligned by N ranks, one
    process each (parallel/swservice.py): NCCL when every rank has a card
    of its own, gloo otherwise (several ranks on one card, or the CPU).
    The CSV is the JAX CLI's for any N."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch swservice")
    p.add_argument("-a", "--probes", required=True, help="probe FASTA")
    p.add_argument("-b", "--targets", required=True, help="target FASTA")
    p.add_argument("-o", "--out", required=True, help="scores CSV")
    p.add_argument("--sw-band", type=int, default=96)
    p.add_argument("--pairs", default="zip", choices=("zip", "cross"),
                   help="pair probes/targets 1:1 (zip) or all-vs-all")
    p.add_argument("-n", "--ndevices", type=int, default=None,
                   help="ranks to spawn (default: one a visible card, or "
                        "1 with --device cpu)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: rank r on card r %% cards; raises "
                        "without CUDA), a named device, or cpu")
    args = p.parse_args(argv)
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from .parallel.swservice import SWJobBatch
    from .seq.fasta import read_seqs

    device = resolve_device(args.device)
    probes = [(r.name, r.codes) for r in read_seqs(args.probes)]
    targets = [(r.name, r.codes) for r in read_seqs(args.targets)]
    if args.pairs == "zip":
        if len(probes) != len(targets):
            print("zip pairing needs equal probe/target counts",
                  file=sys.stderr)
            return 2
        pairs = list(zip(range(len(probes)), range(len(targets))))
    else:
        pairs = [(i, j) for i in range(len(probes))
                 for j in range(len(targets))]
    La = max(len(c) for _, c in probes)
    Lb = max(len(c) for _, c in targets)
    B = len(pairs)
    a = np.full((B, La), 4, np.int8)
    b = np.full((B, Lb), 4, np.int8)
    alen = np.zeros(B, np.int32)
    blen = np.zeros(B, np.int32)
    for r, (i, j) in enumerate(pairs):
        pa, pb = probes[i][1], targets[j][1]
        a[r, : len(pa)] = pa
        b[r, : len(pb)] = pb
        alen[r], blen[r] = len(pa), len(pb)
    # a rank a card under `--device cuda`; a named device holds them all
    cards = (0 if device.type != "cuda" else
             torch.cuda.device_count() if args.device == "cuda" else 1)
    n = args.ndevices or max(cards, 1)
    backend = "nccl" if n <= cards else "gloo"
    print(f"swservice: {n} ranks over {backend} on {args.device}",
          file=sys.stderr)
    jobs = SWJobBatch(a, b, alen, blen, np.zeros(B, np.int32))
    names = [(probes[i][0], targets[j][0]) for i, j in pairs]
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_swservice_rank, nprocs=n, args=(
            n, backend, f"file://{tmp}/rendezvous",
            None if args.device == "cuda" else args.device, jobs,
            args.sw_band, args.out, names))
    print(f"swservice: {B} SW jobs over {n} devices")
    return 0


def cmd_pbfilter(argv: list[str]) -> int:
    """`pacbiokanga filter` parity (CPBFilter): retained-SMRTbell removal,
    following biokanga_tpu/cli.py:1953-1979.  Host numpy: no --device."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch pbfilter")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--min-subread-len", type=int, default=500)
    p.add_argument("--max-adapter-mm", type=int, default=9)
    p.add_argument("--trim-ends", type=int, default=0)
    args = p.parse_args(argv)
    from .pacbio.pbfilter import PBFilterParams, pb_filter
    from .seq.fasta import read_seqs, write_fasta

    reads = []
    for path in args.inreads:
        reads.extend((r.name, r.codes) for r in read_seqs(path))
    kept, st = pb_filter(
        reads,
        PBFilterParams(min_subread_len=args.min_subread_len,
                       max_adapter_mm=args.max_adapter_mm,
                       trim_ends=args.trim_ends),
    )
    write_fasta(args.out, kept)
    print(f"pbfilter: {st.reads_in} reads in, {st.reads_with_adapter} with "
          f"retained adapter, {st.subreads_out} subreads out "
          f"({st.bases_out}/{st.bases_in} bases)")
    return 0


def cmd_assemb(argv: list[str]) -> int:
    """`biokanga assemb` parity (CdeNovoAssemb, deNovoAssemb.cpp:109),
    following biokanga_tpu/cli.py:1504-1536."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch assemb")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-o", "--out", required=True, help="contig FASTA")
    p.add_argument("--init-overlap", type=int, default=150)
    p.add_argument("--final-overlap", type=int, default=25)
    p.add_argument("--min-seq-len", type=int, default=80)
    p.add_argument("--max-subs-100", type=float, default=1.0)
    p.add_argument("-F", "--log", default=None)
    _add_device(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    log = open_diagnostics(args.log, name="biokanga-tpu-torch")
    sw = StopWatch()
    from .assembly.assemble import assemble
    from .seq.fasta import read_seqs, write_fasta

    seqs = []
    for path in args.inreads:
        seqs.extend(r.codes for r in read_seqs(path))
    contigs, st = assemble(
        seqs, init_overlap=args.init_overlap,
        final_overlap=args.final_overlap, min_seq_len=args.min_seq_len,
        max_subs_per_100=args.max_subs_100, device=device,
    )
    contigs.sort(key=len, reverse=True)
    write_fasta(args.out, ((f"contig{i+1}", c)
                           for i, c in enumerate(contigs)))
    log.info(
        "assembled %d seqs -> %d contigs (%d bp, max %d) in %d passes,"
        " %.1fs", len(seqs), st.n_contigs, st.total_bp, st.max_contig,
        st.passes, sw.elapsed(),
    )
    return 0


def cmd_scaffold(argv: list[str]) -> int:
    """`biokanga scaffold` parity (CScaffolder, Scaffolder.cpp:772),
    following biokanga_tpu/cli.py:1539-1566."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch scaffold")
    p.add_argument("-c", "--contigs", required=True)
    p.add_argument("-i", "--pe1", required=True)
    p.add_argument("-u", "--pe2", required=True)
    p.add_argument("-o", "--out", required=True, help="scaffold FASTA")
    p.add_argument("--insert-size", type=int, default=400)
    p.add_argument("--min-votes", type=int, default=2)
    p.add_argument("-F", "--log", default=None)
    _add_device(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    log = open_diagnostics(args.log, name="biokanga-tpu-torch")
    from .assembly.scaffold import scaffold
    from .seq.fasta import read_blocks, read_seqs, write_fasta

    contigs = [r.codes for r in read_seqs(args.contigs)]
    b1 = next(read_blocks(args.pe1, block_size=1 << 30))
    b2 = next(read_blocks(args.pe2, block_size=1 << 30))
    scaffolds, paths = scaffold(
        contigs, b1.codes, b1.lengths, b2.codes, b2.lengths,
        insert_size=args.insert_size, min_votes=args.min_votes,
        device=device,
    )
    write_fasta(args.out, ((f"scaffold{i+1}", s)
                           for i, s in enumerate(scaffolds)))
    n_joined = sum(1 for p_ in paths if len(p_) > 1)
    log.info("%d contigs -> %d scaffolds (%d joined paths)",
             len(contigs), len(scaffolds), n_joined)
    return 0


def cmd_contigs(argv: list[str]) -> int:
    """`pacbiokanga contigs` parity (CPBAssemb): assemble error-corrected
    long reads with a relaxed-identity overlap schedule, following
    biokanga_tpu/cli.py:1620-1657."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch contigs")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--min-overlap", type=int, default=500)
    p.add_argument("--final-overlap", type=int, default=100)
    p.add_argument("--max-subs-100", type=float, default=5.0)
    p.add_argument("--no-kmer-dedup", action="store_true",
                   help="skip the indel-tolerant k-mer containment "
                        "collapse of redundant contigs")
    _add_device(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    from .assembly.assemble import assemble, kmer_containment_dedup
    from .seq.fasta import read_seqs, write_fasta

    seqs = []
    for path in args.inreads:
        seqs.extend(r.codes for r in read_seqs(path))
    contigs, st = assemble(
        seqs, init_overlap=args.min_overlap,
        final_overlap=args.final_overlap, min_seq_len=200,
        max_subs_per_100=args.max_subs_100, device=device,
    )
    if not args.no_kmer_dedup:
        # corrected CLR reads carry residual indels that defeat the
        # Hamming containment pass; collapse contigs whose canonical
        # 32-mers are already covered by kept longer contigs
        contigs = kmer_containment_dedup(contigs)
        st.n_contigs = len(contigs)
        st.total_bp = int(sum(len(c) for c in contigs))
        st.max_contig = int(max((len(c) for c in contigs), default=0))
    contigs.sort(key=len, reverse=True)
    write_fasta(args.out, ((f"contig{i+1}", c)
                           for i, c in enumerate(contigs)))
    print(f"{len(seqs)} reads -> {st.n_contigs} contigs (max {st.max_contig})")
    return 0


def cmd_pescaffold(argv: list[str]) -> int:
    """`biokanga pescaffold` parity (CPEScaffold, PEScaffold.cpp),
    following biokanga_tpu/cli.py:2504-2518.  It reads two SAM files on
    the host and runs nothing on a device, so it takes no --device."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch pescaffold")
    p.add_argument("-i", "--pe1sam", required=True)
    p.add_argument("-u", "--pe2sam", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--min-votes", type=int, default=2)
    args = p.parse_args(argv)
    from .tools.pescaffold import pe_scaffold, write_pescaffold_csv

    paths = pe_scaffold(args.pe1sam, args.pe2sam, args.min_votes)
    write_pescaffold_csv(args.out, paths)
    joined = sum(1 for x in paths if len(x) > 1)
    print(f"{len(paths)} scaffold paths ({joined} multi-contig)")
    return 0


SUBCOMMANDS = {"index": cmd_index, "align": cmd_align,
               "ecreads": cmd_ecreads, "swservice": cmd_swservice,
               "pbfilter": cmd_pbfilter, "assemb": cmd_assemb,
               "scaffold": cmd_scaffold, "contigs": cmd_contigs,
               "pescaffold": cmd_pescaffold, **TOOL_SUBCOMMANDS,
               **HOST_SUBCOMMANDS}

# subcommands whose own parser defines -q/--sumrslts and logs a richer
# row than the generic dispatch wrapper would
_OWN_SUMRSLTS = {"index", "align"}


def _extract_sumrslts(argv: list[str]):
    """Pop a -q/--sumrslts DB path from a subcommand's argv (copy of
    biokanga_tpu/cli.py:2904-2923; the reference's gExperimentID rows,
    biokanga/biokanga.cpp:134-137)."""
    out, db = [], None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-q", "--sumrslts") and i + 1 < len(argv):
            db = argv[i + 1]
            i += 2
            continue
        if a.startswith("--sumrslts="):
            db = a.split("=", 1)[1]
            i += 1
            continue
        out.append(a)
        i += 1
    return out, db


def main(argv: list[str] | None = None) -> int:
    """Dispatch to a subcommand, after biokanga_tpu/cli.py:2926-2966:
    `-v` prints the version, and every subcommand but `index` and `align`
    takes `-q DB`, which logs the run (argv, result code, seconds)."""
    argv = _expand_response_files(list(sys.argv[1:] if argv is None else argv))
    if not argv or argv[0] in ("-h", "--help"):
        print(f"biokanga-tpu-torch {__version__}\nsubcommands: "
              + ", ".join(SUBCOMMANDS))
        return 0
    if argv[0] in ("-v", "--version"):
        print(__version__)
        return 0
    cmd = argv[0]
    if cmd not in SUBCOMMANDS:
        print(f"unknown subcommand '{cmd}'", file=sys.stderr)
        return 2
    sub_argv = argv[1:]
    db_path = None
    if cmd not in _OWN_SUMRSLTS:
        sub_argv, db_path = _extract_sumrslts(sub_argv)
    if db_path is None:
        return SUBCOMMANDS[cmd](sub_argv)
    import time

    t0 = time.monotonic()
    rc = 1
    try:
        rc = SUBCOMMANDS[cmd](sub_argv)
        return rc
    finally:
        from .utils.sqlite_summaries import SQLiteSummaries

        db = SQLiteSummaries(db_path)
        db.log_run(cmd, {"argv": " ".join(sub_argv)},
                   {"result_code": int(rc) if rc is not None else 0,
                    "seconds": round(time.monotonic() - t0, 2)})
        db.close()
