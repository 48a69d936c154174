"""The port's read-preparation and host tool subcommands, after
biokanga_tpu/cli.py: `fasta2nxx`, `xfasta`, `pseudogenome` (:944-1001),
`filter` and `ngsqc` (:1002, :1061), `ssr`, `filtchrom`, `remaploci`
(:1123-1173), the expression tools (:1363-1460), the SQLite loaders
(:1461-1503), `kmerdist`, `kangar`, `kangapr`, `filterreads`
(:1702-1890), the converter table and the misc tools (:1981-2187),
`csv2sqlite`, `alignvalidate` (:2188, :2254), `genzygosity` and
`alignsbs` (:2487, :2521), and the chromatin/structure, conservation and
GO families (:2552-2785).

Each writes the files of the same subcommand of `python -m biokanga_tpu`
on the same inputs.  All are host numpy but `filter -c` and `ngsqc -c`,
whose contaminant database screens reads against its vectors with the
aligner on `--device`, and `predconfnucs` and `genstructprofile`, which
gather their conformation profiles on `--device` (default cuda, which
raises without CUDA; cpu runs the plain versions).
"""
from __future__ import annotations

import argparse

from .cli_tools import add_device


def cmd_fasta2nxx(argv):
    """`biokanga fasta2nxx` parity (biokanga/FastaNxx.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch fasta2nxx")
    p.add_argument("-i", "--infasta", action="append", required=True)
    p.add_argument("-o", "--out", default=None, help="stats CSV (default stdout)")
    args = p.parse_args(argv)
    from .tools.fasta_tools import fasta_nxx

    st = fasta_nxx(args.infasta)
    rows = [
        ("NumSeqs", st.num_seqs), ("TotalBp", st.total_bp),
        ("MinLen", st.min_len), ("MaxLen", st.max_len),
        ("MeanLen", round(st.mean_len, 1)), ("GCPcnt", round(st.gc_pcnt, 2)),
    ] + [(f"N{p_}", v) for p_, v in st.nxx.items()]
    text = "\n".join(f"{k},{v}" for k, v in rows) + "\n"
    if args.out:
        open(args.out, "w").write(text)
    else:
        print(text, end="")
    return 0


def cmd_xfasta(argv):
    """`biokanga xfasta` parity (biokanga/fastaextract.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch xfasta")
    p.add_argument("-i", "--infasta", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-r", "--regex", default=None, help="name filter regex")
    p.add_argument("--min-len", type=int, default=0)
    p.add_argument("--max-len", type=int, default=None)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=None)
    args = p.parse_args(argv)
    from .tools.fasta_tools import xfasta_extract

    n = xfasta_extract(args.infasta, args.out, args.regex, args.min_len,
                       args.max_len, args.start, args.end)
    print(f"extracted {n} sequences")
    return 0


def cmd_pseudogenome(argv):
    """`biokanga pseudogenome` parity (biokanga/genpseudogenome.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch pseudogenome")
    p.add_argument("-i", "--infasta", action="append", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-O", "--outbed", default=None)
    p.add_argument("-n", "--name", default="PseudoG")
    p.add_argument("--sep-ns", type=int, default=100)
    args = p.parse_args(argv)
    from .tools.fasta_tools import gen_pseudogenome

    n, total = gen_pseudogenome(args.infasta, args.out, args.outbed,
                                args.name, args.sep_ns)
    print(f"concatenated {n} sequences, {total} bp")
    return 0


def cmd_filter(argv):
    """`biokanga filter` parity (CArtefactReduce, biokanga/ArtefactReduce.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch filter")
    p.add_argument("-i", "--inreads", required=True)
    p.add_argument("-u", "--pair", default=None)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-U", "--outpair", default=None)
    p.add_argument("--trim5", type=int, default=0)
    p.add_argument("--trim3", type=int, default=0)
    p.add_argument("-n", "--maxns", type=int, default=1)
    p.add_argument("--min-phred", type=int, default=0)
    p.add_argument("--min-len", type=int, default=50)
    p.add_argument("--no-dedupe", action="store_true")
    p.add_argument("--near-dedupe", action="store_true",
                   help="also drop NEAR-duplicate reads (Hamming <= "
                        "--near-max-subs; ArtefactReduce sparse-index "
                        "near-dup role, Kangadna.h:100-107)")
    p.add_argument("--near-max-subs", type=int, default=2)
    p.add_argument("-c", "--contaminants", default=None,
                   help="adaptor/contaminant FASTA")
    add_device(p)
    args = p.parse_args(argv)
    from .seq.fasta import read_seqs
    from .tools.filter_reads import FilterParams, filter_reads

    adapters = []
    contam_db = None
    if args.contaminants:
        # sequences using the reference naming convention ('@' flank /
        # '&' vector codes, Contaminants.cpp:195-203) load as a full
        # CContaminants DB; plain adaptor FASTAs keep the legacy
        # treat-as-3'-adaptor behavior
        heads = [l for l in open(args.contaminants)
                 if l.startswith(">")]
        if any(("@" in h) or ("&" in h) for h in heads):
            from .seq.contaminants import Contaminants

            contam_db = Contaminants.load(args.contaminants, args.device)
        else:
            adapters = [r.codes for r in read_seqs(args.contaminants)]
    st = filter_reads(
        args.inreads, args.out,
        FilterParams(
            trim5=args.trim5, trim3=args.trim3, max_ns=args.maxns,
            min_phred=args.min_phred, min_len=args.min_len,
            dedupe=not args.no_dedupe, adapters=adapters,
            contaminants=contam_db,
            near_dedupe=args.near_dedupe,
            near_max_subs=args.near_max_subs,
        ),
        pair_inpath=args.pair, pair_outpath=args.outpair,
    )
    print(
        f"filter: {st.accepted}/{st.total} accepted "
        f"(dups {st.rej_dup}, Ns {st.rej_ns}, phred {st.rej_phred}, "
        f"len {st.rej_len}, adapter-trimmed {st.trimmed_adapter})"
    )
    return 0


def cmd_ngsqc(argv):
    """`biokanga ngsqc` parity (CReadStats, biokanga/ReadStats.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch ngsqc")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-o", "--out", required=True, help="HTML report path")
    p.add_argument("-k", "--kmer", type=int, default=5)
    p.add_argument("--max-reads", type=int, default=None)
    p.add_argument("-c", "--contaminants", default=None,
                   help="contaminants multifasta ('@'/'&' overlay-code "
                        "naming convention, Contaminants.cpp:195-203)")
    add_device(p)
    args = p.parse_args(argv)
    from .tools.ngsqc import collect_qc, write_html_report

    cdb = None
    if args.contaminants:
        from .seq.contaminants import Contaminants

        cdb = Contaminants.load(args.contaminants, args.device)
    st = collect_qc(args.inreads, kmer_k=args.kmer,
                    max_reads=args.max_reads, contaminants=cdb)
    write_html_report(st, args.out)
    print(f"ngsqc: {st.n_reads} reads, {st.n_bases} bases -> {args.out}")
    return 0


def cmd_ssr(argv):
    """`biokanga ssr` parity (CSSRDiscovery, biokanga/SSRdiscovery.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch ssr")
    p.add_argument("-i", "--infasta", action="append", required=True)
    p.add_argument("-o", "--out", required=True, help="CSV output")
    p.add_argument("-O", "--outbed", default=None)
    p.add_argument("--min-unit", type=int, default=1)
    p.add_argument("--max-unit", type=int, default=6)
    p.add_argument("-r", "--min-repeats", type=int, default=5)
    args = p.parse_args(argv)
    from .tools.ssr import discover_ssrs, write_ssrs_bed, write_ssrs_csv

    hits = discover_ssrs(args.infasta, args.min_unit, args.max_unit,
                         args.min_repeats)
    write_ssrs_csv(args.out, hits)
    if args.outbed:
        write_ssrs_bed(args.outbed, hits)
    print(f"found {len(hits)} SSRs")
    return 0


def cmd_filtchrom(argv):
    """`biokanga filtchrom` parity (CFilterSAMAlignments)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch filtchrom")
    p.add_argument("-i", "--insam", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-z", "--chrom", required=True, help="chrom regex")
    p.add_argument("-Z", "--exclude", action="store_true")
    args = p.parse_args(argv)
    from .tools.sam_tools import filter_sam_by_chrom

    total, kept = filter_sam_by_chrom(args.insam, args.out, args.chrom,
                                      args.exclude)
    print(f"kept {kept}/{total} records")
    return 0


def cmd_remaploci(argv):
    """`biokanga remaploci` parity (CRemapLoci)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch remaploci")
    p.add_argument("-i", "--insam", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-b", "--bed", required=True, help="parts BED")
    args = p.parse_args(argv)
    from .tools.sam_tools import remap_sam

    remapped, dropped = remap_sam(args.insam, args.out, args.bed)
    print(f"remapped {remapped}, dropped {dropped}")
    return 0


def cmd_maploci(argv):
    """`biokanga maploci` parity (CMapLoci2Feat)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch maploci")
    p.add_argument("-i", "--insam", required=True)
    p.add_argument("-b", "--bed", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--strand", action="store_true",
                   help="require matching strand")
    args = p.parse_args(argv)
    from .seq.annotations import read_bed
    from .tools.expression import (
        map_loci_to_features, read_sam_loci, write_maploci_csv,
    )

    feats = read_bed(args.bed)
    counts, unm = map_loci_to_features(read_sam_loci(args.insam), feats,
                                       args.strand)
    write_maploci_csv(args.out, feats, counts, unm)
    print(f"mapped onto {len(feats)} features ({unm} unmatched)")
    return 0


def cmd_gendeseq(argv):
    """`biokanga gendeseq` parity (genDESeq.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch gendeseq")
    p.add_argument("-c", "--control", action="append", required=True)
    p.add_argument("-e", "--experiment", action="append", required=True)
    p.add_argument("-b", "--bed", required=True)
    p.add_argument("-o", "--out", required=True)
    args = p.parse_args(argv)
    from .seq.annotations import read_bed
    from .tools.expression import gen_deseq_table

    feats = read_bed(args.bed)
    gen_deseq_table(feats, args.control, args.experiment, args.out)
    print(f"count table: {len(feats)} features x "
          f"{len(args.control) + len(args.experiment)} samples")
    return 0


def cmd_rnade(argv):
    """`biokanga rnade` parity (kangade.cpp DE characterisation)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch rnade")
    p.add_argument("-c", "--control", required=True)
    p.add_argument("-e", "--experiment", required=True)
    p.add_argument("-b", "--bed", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--bins", type=int, default=10)
    p.add_argument("--min-cnts", type=int, default=10)
    p.add_argument("--confidence-iters", type=int, default=1000,
                   help="Poisson-noise bootstrap iterations for CIs + "
                        "p-values (kangade cMaxConfidenceIterations role;"
                        " 0 disables)")
    p.add_argument("-r", "--region", default="feature",
                   choices=("feature", "exons", "introns", "cds", "utr",
                            "utr5", "utr3"),
                   help="functional region to count (kangade -r 0..6)")
    args = p.parse_args(argv)
    from .seq.annotations import read_bed
    from .tools.expression import rnade, write_rnade_csv

    res = rnade(read_bed(args.bed), args.control, args.experiment,
                num_bins=args.bins, min_feat_cnts=args.min_cnts,
                confidence_iters=args.confidence_iters,
                region=args.region)
    write_rnade_csv(args.out, res)
    print(f"rnade: {len(res)} features characterised")
    return 0


def cmd_locateroi(argv):
    """`biokanga locateroi` parity (CLocateROI)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch locateroi")
    p.add_argument("-i", "--insam", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--min-cov", type=int, default=2)
    p.add_argument("--min-len", type=int, default=100)
    args = p.parse_args(argv)
    import re as _re

    from .tools.expression import locate_roi, write_roi_csv

    chrom_lens = {}
    with open(args.insam) as f:
        for line in f:
            if not line.startswith("@"):
                break
            if line.startswith("@SQ"):
                name = _re.search(r"SN:(\S+)", line)
                ln = _re.search(r"LN:(\d+)", line)
                if name and ln:
                    chrom_lens[name.group(1)] = int(ln.group(1))
    rois = locate_roi(args.insam, chrom_lens, args.min_cov, args.min_len)
    write_roi_csv(args.out, rois)
    print(f"{len(rois)} regions of interest")
    return 0


def cmd_snps2sqlite(argv):
    """`biokanga snps2sqlite` parity (csv2sqlite SNP schema loader)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch snps2sqlite")
    p.add_argument("-i", "--incsv", required=True)
    p.add_argument("-o", "--db", required=True)
    p.add_argument("-n", "--name", default="experiment")
    p.add_argument("-c", "--cultivar", default="cultivar")
    args = p.parse_args(argv)
    from .utils.sqlite_summaries import snps_to_sqlite

    n = snps_to_sqlite(args.db, args.incsv, args.name, args.cultivar)
    print(f"loaded {n} SNPs into {args.db}")
    return 0


def cmd_psl2sqlite(argv):
    """`biokanga psl2sqlite` parity (CSQLitePSL loader)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch psl2sqlite")
    p.add_argument("-i", "--inpsl", required=True)
    p.add_argument("-o", "--db", required=True)
    p.add_argument("-n", "--name", default="experiment")
    args = p.parse_args(argv)
    from .utils.sqlite_summaries import psl_to_sqlite

    n = psl_to_sqlite(args.db, args.inpsl, args.name)
    print(f"loaded {n} alignments into {args.db}")
    return 0


def cmd_de2sqlite(argv):
    """`biokanga de2sqlite` parity (CSQLiteDE loader)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch de2sqlite")
    p.add_argument("-i", "--incsv", required=True)
    p.add_argument("-o", "--db", required=True)
    p.add_argument("-n", "--name", default="experiment")
    args = p.parse_args(argv)
    from .utils.sqlite_summaries import de_to_sqlite

    n = de_to_sqlite(args.db, args.incsv, args.name)
    print(f"loaded {n} DE rows into {args.db}")
    return 0


def cmd_kmerdist(argv):
    """`pacbiokanga kmerdist` parity (CMAFKMerDist): exact-match K-mer
    distribution comparison between sequence sets."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch kmerdist")
    p.add_argument("-i", "--infasta", action="append", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-k", "--kmerlen", type=int, default=4)
    args = p.parse_args(argv)
    import numpy as _np

    from .seq.fasta import read_seqs

    k = args.kmerlen
    with open(args.out, "w") as f:
        hdr = ['"KMer"'] + [f'"{path}"' for path in args.infasta]
        f.write(",".join(hdr) + "\n")
        tables = []
        for path in args.infasta:
            counts = _np.zeros(4**k, dtype=_np.int64)
            for rec in read_seqs(path):
                c = rec.codes
                val = _np.zeros(len(c), _np.int64)
                ok = _np.ones(len(c), bool)
                if len(c) < k:
                    continue
                v = _np.zeros(len(c) - k + 1, _np.int64)
                good = _np.ones(len(c) - k + 1, bool)
                for j in range(k):
                    cj = c[j : len(c) - k + 1 + j]
                    good &= cj < 4
                    v = v * 4 + _np.clip(cj, 0, 3)
                counts += _np.bincount(v[good], minlength=4**k)
            tables.append(counts)
        for m in range(4**k):
            kmer = "".join(
                "ACGT"[(m >> (2 * (k - 1 - j))) & 3] for j in range(k)
            )
            f.write(
                f'"{kmer}",' + ",".join(str(int(t[m])) for t in tables) + "\n"
            )
    print(f"kmerdist: {4**k} {k}-mers x {len(args.infasta)} sets")
    return 0


def cmd_kangar(argv):
    """`kangar` tool parity (kangar/kangar.cpp): raw-read preprocessor —
    FASTA/FASTQ -> packed `.rds` container (CProcRawReads V5/V6 role,
    libbiokanga/ProcRawReads.h:53,75)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch kangar")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-u", "--pair", action="append", default=None,
                   help="PE mate files; writes a PE-interleaved container")
    p.add_argument("-o", "--out", required=True, help="output .rds.npz")
    p.add_argument("-x", "--trim5", type=int, default=0)
    p.add_argument("-y", "--trim3", type=int, default=0)
    p.add_argument("--max-ns", type=int, default=None,
                   help="drop reads with more than this many N bases")
    args = p.parse_args(argv)
    from .seq.fasta import read_seqs
    from .seq.rds import write_rds

    def prep(codes):
        c = codes[args.trim5: len(codes) - args.trim3 or None]
        if args.max_ns is not None and int((c == 4).sum()) > args.max_ns:
            return None
        return c

    def gen():
        if args.pair:
            for p1, p2 in zip(args.inreads, args.pair):
                for r1, r2 in zip(read_seqs(p1), read_seqs(p2)):
                    c1, c2 = prep(r1.codes), prep(r2.codes)
                    if c1 is None or c2 is None:
                        continue
                    yield (r1.name, c1)
                    yield (r2.name, c2)
        else:
            for path in args.inreads:
                for r in read_seqs(path):
                    c = prep(r.codes)
                    if c is not None:
                        yield (r.name, c)

    n = write_rds(args.out, gen(), pe_interleaved=bool(args.pair))
    print(f"kangar: {n} reads packed -> {args.out}"
          + (" (PE interleaved)" if args.pair else ""))
    return 0


def cmd_kangapr(argv):
    """`kangapr` tool parity (kangapr/kangapr.cpp:113-127, SampleReads.cpp):
    NGS preprocess-reads sampler — emit every Nth read starting at an offset,
    capped at a max sample count, SE (-m0) or PE (-m1) with both mates kept
    in lockstep."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch kangapr")
    p.add_argument("-m", "--mode", type=int, default=0, choices=[0, 1],
                   help="0 SE reads in -i files, 1 PE reads in -i/-I files")
    p.add_argument("-s", "--sampleof", type=int, default=1,
                   help="start sampling from this read (1-based)")
    p.add_argument("-S", "--samplenth", type=int, default=1,
                   help="sample every Nth read")
    p.add_argument("-M", "--maxsamples", type=int, default=0,
                   help="max samples (0 = until last read)")
    p.add_argument("-i", "--in1", action="append", required=True)
    p.add_argument("-I", "--in2", action="append", default=None)
    p.add_argument("-o", "--out1", required=True)
    p.add_argument("-O", "--out2", default=None)
    args = p.parse_args(argv)
    from .seq.fasta import read_seqs, write_fasta, write_fastq

    if args.mode == 1 and (not args.in2 or not args.out2):
        p.error("PE mode needs -I and -O")

    def sample(records):
        kept = 0
        for i, rec in enumerate(records, start=1):
            if i < args.sampleof or (i - args.sampleof) % args.samplenth:
                continue
            if args.maxsamples and kept >= args.maxsamples:
                return
            kept += 1
            yield rec

    def chain(paths):
        for path in paths:
            yield from read_seqs(path)

    def emit(out_path, recs):
        rows = [(r.name, r.codes, r.qual) for r in recs]
        if rows and rows[0][2] is not None:
            write_fastq(out_path, rows)
        else:
            write_fasta(out_path, [(n, c) for n, c, _ in rows])
        return len(rows)

    if args.mode == 0:
        n = emit(args.out1, sample(chain(args.in1)))
        print(f"kangapr: sampled {n} SE reads -> {args.out1}")
    else:
        pairs = list(sample(zip(chain(args.in1), chain(args.in2))))
        n = emit(args.out1, (a for a, _ in pairs))
        emit(args.out2, (b for _, b in pairs))
        print(f"kangapr: sampled {n} PE pairs -> {args.out1},{args.out2}")
    return 0


def cmd_filterreads(argv):
    """`filterreads` tool parity (filterreads/): filter a packed `.rds`
    container by length / N-count / exact-duplicate status."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch filterreads")
    p.add_argument("-i", "--inrds", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--min-len", type=int, default=0)
    p.add_argument("--max-len", type=int, default=None)
    p.add_argument("--max-ns", type=int, default=None)
    p.add_argument("--dedupe", action="store_true",
                   help="drop exact duplicate sequences (keep first)")
    p.add_argument("-x", "--trim5", type=int, default=0)
    p.add_argument("-y", "--trim3", type=int, default=0)
    args = p.parse_args(argv)
    from .seq.rds import FLAG_PE2, RDSFile, write_rds

    f = RDSFile(args.inrds)
    seen: set[bytes] = set()
    kept = dropped = 0
    out_recs = []
    for name, codes, fl in f.records():
        c = codes[args.trim5: len(codes) - args.trim3 or None]
        ok = len(c) >= args.min_len
        if args.max_len is not None:
            ok &= len(c) <= args.max_len
        if ok and args.max_ns is not None:
            ok = int((c == 4).sum()) <= args.max_ns
        if ok and args.dedupe:
            key = c.tobytes()
            if key in seen:
                ok = False
            else:
                seen.add(key)
        if ok:
            out_recs.append((name, c, fl))
            kept += 1
        else:
            dropped += 1
    write_rds(args.out, out_recs)
    print(f"filterreads: {kept} kept, {dropped} dropped -> {args.out}")
    return 0


def _simple_cmd(fn_name, arg_specs, result_fmt="{n} records",
                module="converters", device=False):
    """Factory for thin converter subcommands over tools/ modules; with
    `device`, the subcommand also takes --device and passes it on."""

    def cmd(argv):
        p = argparse.ArgumentParser(prog=f"biokanga-tpu-torch {fn_name}")
        for flags, kw in arg_specs:
            p.add_argument(*flags, **kw)
        if device:
            add_device(p)
        args = p.parse_args(argv)
        import importlib

        mod = importlib.import_module(f".tools.{module}", __package__)
        fn = getattr(mod, fn_name)
        kwargs = {k: v for k, v in vars(args).items()}
        n = fn(**kwargs)
        print(result_fmt.format(n=n))
        return 0

    cmd.__doc__ = f"converter: tools/{module}.{fn_name}"
    return cmd


_IO = [(("-i", "--inpath"), dict(required=True)),
       (("-o", "--outpath"), dict(required=True))]

cmd_bed2csv = _simple_cmd("bed2csv", _IO)
cmd_csv2bed = _simple_cmd("csv2bed", _IO)
cmd_csv2fasta = _simple_cmd(
    "csv2fasta", _IO + [(("--seq-col",), dict(default="seq")),
                        (("--name-col",), dict(default="name"))])
cmd_fasta2bed = _simple_cmd("fasta2bed", _IO)
cmd_bedfilter = _simple_cmd(
    "bed_filter", _IO + [(("-z", "--chrom-regex"), dict(default=None)),
                         (("--min-len",), dict(type=int, default=0)),
                         (("--max-len",), dict(type=int, default=None))])
cmd_bedmerge = _simple_cmd(
    "bed_merge", _IO + [(("-g", "--max-gap"), dict(type=int, default=0))])
cmd_gfffilter = _simple_cmd(
    "gff_filter", _IO + [(("-t", "--feature-types"), dict(action="append",
                                                          default=None)),
                         (("-r", "--attr-regex"), dict(default=None))])
cmd_genwiggle = _simple_cmd(
    "gen_wiggle",
    [(("-i", "--sam-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-n", "--normalise"), dict(action="store_true")),
     (("-s", "--span"), dict(type=int, default=1))],
    "{n} wiggle values")
cmd_splitmultifasta = _simple_cmd(
    "split_multifasta",
    [(("-i", "--inpath"), dict(required=True)),
     (("-o", "--outdir"), dict(required=True)),
     (("-p", "--prefix"), dict(default=""))],
    "{n} files")
cmd_fastafilter = _simple_cmd(
    "fasta_filter", _IO + [(("--min-len",), dict(type=int, default=0))])
cmd_fastatope = _simple_cmd(
    "fasta_to_pe",
    [(("-i", "--inpath"), dict(required=True)),
     (("-o", "--out1"), dict(required=True)),
     (("-O", "--out2"), dict(required=True))],
    "{n} pairs")
cmd_psl2csv = _simple_cmd("psl2csv", _IO, "{n} PSL rows", "converters2")
cmd_blast2csv = _simple_cmd("blast2csv", _IO, "{n} BLAST rows",
                            "converters2")
cmd_csv2stats = _simple_cmd("csv2stats", _IO, "{n} numeric columns",
                            "converters2")
cmd_csvfilter = _simple_cmd(
    "csvfilter",
    _IO + [(("-c", "--column"), dict(required=True)),
           (("-p", "--op"), dict(default="eq",
                                 choices=("eq", "ne", "lt", "le", "gt",
                                          "ge", "match"))),
           (("-V", "--value"), dict(required=True))],
    "{n} rows kept", "converters2")
cmd_csvmerge = _simple_cmd(
    "csvmerge",
    [(("-i", "--inpaths"), dict(action="append", required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-k", "--key"), dict(required=True))],
    "{n} merged keys", "converters2")
cmd_csv2feat = _simple_cmd("csv2feat", _IO, "{n} features", "converters2")
cmd_fasta2dist = _simple_cmd(
    "fasta2dist", _IO + [(("-k", "--kmerlen"), dict(type=int, default=4))],
    "{n} x {n} distance matrix", "converters2")
cmd_agp2genome = _simple_cmd(
    "agp2genome",
    [(("-a", "--agp-path"), dict(required=True)),
     (("-c", "--contigs-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True))],
    "{n} assembled objects", "converters2")
cmd_dmpbioseq = _simple_cmd(
    "dmpbioseq", _IO + [(("-n", "--max-seqs"), dict(type=int, default=None))],
    "{n} sequences dumped", "converters2")
cmd_hammingdist = _simple_cmd(
    "hamming_dist", _IO + [(("-w", "--window"), dict(type=int, default=0))],
    "{n} rows", "converters2")
cmd_genbioseq = _simple_cmd(
    "genbioseq",
    [(("-i", "--inpaths"), dict(action="append", required=True)),
     (("-o", "--outpath"), dict(required=True))],
    "{n} sequences packed", "converters3")
cmd_genbiobed = _simple_cmd(
    "genbiobed", _IO, "{n} features packed", "converters3")
cmd_genbiomultialign = _simple_cmd(
    "genbiomultialign",
    [(("-i", "--inpaths"), dict(action="append", required=True)),
     (("-o", "--outpath"), dict(required=True))],
    "{n} alignment blocks packed", "converters3")
cmd_fasta2struct = _simple_cmd(
    "fasta2struct",
    _IO + [(("-c", "--param"), dict(default="minorgroove",
                                    choices=("energy", "minorgroove",
                                             "majorgroove", "twist", "roll",
                                             "tilt", "rise", "slide",
                                             "shift"))),
           (("-p", "--params-file"), dict(default=None)),
           (("-C", "--winlen"), dict(type=int, default=0)),
           (("-n", "--trunc"), dict(type=int, default=0))],
    "{n} conformation profiles", "converters3")


cmd_quickcount = _simple_cmd(
    "quickcount",
    _IO + [(("-k", "--kmerlen"), dict(type=int, default=4)),
           (("-m", "--mode"), dict(default="all",
                                   choices=("all", "perseq", "norm")))],
    "{n} N-mer rows", "misc_tools")
cmd_loci2dist = _simple_cmd(
    "loci2dist", _IO + [(("-b", "--bin-size"), dict(type=int, default=10))],
    "{n} length bins", "misc_tools")
cmd_ufilter = _simple_cmd(
    "ufilter",
    _IO + [(("-z", "--include"), dict(default=None)),
           (("-Z", "--exclude"), dict(default=None))],
    "{n} rows kept", "misc_tools")
cmd_gensampler = _simple_cmd(
    "gensampler",
    _IO + [(("-n", "--n-samples"), dict(type=int, required=True)),
           (("-l", "--sample-len"), dict(type=int, required=True)),
           (("-b", "--bed-path"), dict(default=None)),
           (("-x", "--exclude"), dict(action="store_true")),
           (("-S", "--seed"), dict(type=int, default=1))],
    "{n} samples", "misc_tools")


def cmd_kangahrdx(argv):
    """`kangahrdx` tool parity (CHomozyReduce): homozygotic-region read
    reduction via canonical seed-key grouping."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch kangahrdx")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--max-copies", type=int, default=2)
    p.add_argument("--seed-len", type=int, default=32)
    args = p.parse_args(argv)
    from .seq.fasta import read_seqs, write_fasta
    from .tools.misc_tools import homozy_reduce

    reads = []
    for path in args.inreads:
        reads.extend((r.name, r.codes) for r in read_seqs(path))
    kept, st = homozy_reduce(reads, max_copies=args.max_copies,
                             seed_len=args.seed_len)
    write_fasta(args.out, kept)
    print(f"kangahrdx: {st['reads_in']} reads in, {st['reads_out']} kept "
          f"({st['groups']} region groups)")
    return 0


def cmd_kangaradseq(argv):
    """`KangaRADSeq` tool parity: barcode demux + restriction-site check."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch kangaradseq")
    p.add_argument("-i", "--inreads", action="append", required=True)
    p.add_argument("-b", "--barcodes", required=True,
                   help="CSV of sample,barcode rows")
    p.add_argument("-O", "--outdir", required=True)
    p.add_argument("-e", "--enzyme", default="sbfI")
    p.add_argument("--max-bc-mm", type=int, default=1)
    args = p.parse_args(argv)
    import csv as _csv
    import os

    from .seq.fasta import read_seqs, write_fasta
    from .tools.misc_tools import radseq_demux

    barcodes = {}
    with open(args.barcodes) as f:
        for row in _csv.reader(f):
            if len(row) >= 2 and row[1].strip('"').strip():
                s = row[0].strip('"')
                if s.lower() in ("sample", "name"):
                    continue
                barcodes[s] = row[1].strip('"')
    reads = []
    for path in args.inreads:
        reads.extend((r.name, r.codes) for r in read_seqs(path))
    groups, st = radseq_demux(reads, barcodes, enzyme=args.enzyme,
                              max_bc_mm=args.max_bc_mm)
    os.makedirs(args.outdir, exist_ok=True)
    for sample, recs in groups.items():
        if recs:
            write_fasta(os.path.join(args.outdir, f"{sample}.fa"), recs)
    print(f"kangaradseq: {st['assigned']}/{st['reads_in']} assigned "
          f"({st['bad_site']} bad site, {st['no_barcode']} no barcode)")
    return 0


def cmd_csv2sqlite(argv):
    """`csv2sqlite` tool parity (csv2sqlite/, 3,624 LoC): load any CSV
    into a SQLite table, types inferred per column."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch csv2sqlite")
    p.add_argument("-i", "--incsv", required=True)
    p.add_argument("-o", "--db", required=True)
    p.add_argument("-t", "--table", default=None,
                   help="table name (default: CSV basename)")
    args = p.parse_args(argv)
    import csv as _csv
    import os
    import re as _re
    import sqlite3

    table = args.table or _re.sub(
        r"\W", "_", os.path.splitext(os.path.basename(args.incsv))[0])
    with open(args.incsv) as f:
        rd = _csv.reader(f)
        header = [c.strip('"') for c in next(rd)]
        rows = [r for r in rd if r]

    def coltype(j):
        intish = floatish = True
        for r in rows:
            v = r[j].strip('"') if j < len(r) else ""
            if not v:
                continue
            try:
                float(v)
            except ValueError:
                return "TEXT"
            floatish = True
            try:
                int(v)
            except ValueError:
                intish = False
        return "INTEGER" if intish else ("REAL" if floatish else "TEXT")

    types = [coltype(j) for j in range(len(header))]
    con = sqlite3.connect(args.db)
    cols = ", ".join(f'"{h}" {t}' for h, t in zip(header, types))
    con.execute(f'DROP TABLE IF EXISTS "{table}"')
    con.execute(f'CREATE TABLE "{table}" ({cols})')
    ph = ",".join("?" * len(header))

    def conv(v, t):
        v = v.strip('"')
        if v == "":
            return None
        if t == "INTEGER":
            return int(v)
        if t == "REAL":
            return float(v)
        return v

    con.executemany(
        f'INSERT INTO "{table}" VALUES ({ph})',
        ([conv(r[j] if j < len(r) else "", types[j])
          for j in range(len(header))] for r in rows),
    )
    con.commit()
    con.close()
    print(f"csv2sqlite: {len(rows)} rows -> {args.db}:{table}")
    return 0


def cmd_alignvalidate(argv):
    """CAlignValidate parity (libbiokanga/AlignValidate.h:67-96): score a
    SAM result set against simreads ground-truth descriptors, or compute
    reciprocal-overlap stats between two SAM result sets."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch alignvalidate")
    p.add_argument("-i", "--insam", required=True)
    p.add_argument("-r", "--refsam", default=None,
                   help="second SAM to compare against (else use simreads"
                        " descriptors as truth)")
    p.add_argument("-o", "--out", default=None, help="optional CSV report")
    p.add_argument("--tolerance", type=int, default=2,
                   help="max locus offset still counted correct")
    args = p.parse_args(argv)

    def read_sam(path):
        hits = {}
        for line in open(path):
            if line.startswith("@"):
                continue
            f = line.rstrip("\n").split("\t")
            if int(f[1]) & 0x900:  # secondary/supplementary
                continue
            if f[2] == "*":
                hits[f[0]] = None
            else:
                hits[f[0]] = (f[2], int(f[3]) - 1, (int(f[1]) & 16) != 0)
        return hits

    got = read_sam(args.insam)
    rows = []
    if args.refsam:
        ref = read_sam(args.refsam)
        both = agree = only_a = only_b = 0
        for name, h in got.items():
            r = ref.get(name)
            if h and r:
                both += 1
                if (h[0] == r[0] and abs(h[1] - r[1]) <= args.tolerance
                        and h[2] == r[2]):
                    agree += 1
            elif h:
                only_a += 1
        for name, r in ref.items():
            if r and got.get(name) is None:
                only_b += 1
        rows = [("AlignedBoth", both), ("Agree", agree),
                ("OnlyIn", only_a), ("OnlyInRef", only_b)]
        print(f"alignvalidate: {agree}/{both} agree "
              f"({100.0 * agree / max(both, 1):.2f}%), "
              f"{only_a} only in -i, {only_b} only in -r")
    else:
        from .sim.simreads import SimReadTruth

        tot = correct = wrong = unaligned = 0
        for name, h in got.items():
            try:
                t = SimReadTruth.parse(name)
            except Exception:
                continue
            tot += 1
            if h is None:
                unaligned += 1
            elif (h[0] == t.chrom and abs(h[1] - t.start) <= args.tolerance
                  and h[2] == (t.strand == "-")):
                correct += 1
            else:
                wrong += 1
        rows = [("Total", tot), ("Correct", correct), ("Wrong", wrong),
                ("Unaligned", unaligned)]
        print(f"alignvalidate: {correct}/{tot} correct "
              f"({100.0 * correct / max(tot, 1):.2f}%), {wrong} wrong, "
              f"{unaligned} unaligned")
    if args.out:
        with open(args.out, "w") as f:
            f.write('"Metric","Value"\n')
            for k, v in rows:
                f.write(f'"{k}",{v}\n')
    return 0


def cmd_genzygosity(argv):
    """`genzygosity` tool parity: chrom-vs-chrom K-mer sharing matrix."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch genzygosity")
    p.add_argument("-I", "--sfx", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-k", "--kmerlen", type=int, default=20)
    args = p.parse_args(argv)
    from .index.build import load_index
    from .tools.zygosity import write_zygosity_csv, zygosity_matrix

    idx = load_index(args.sfx)
    M, totals = zygosity_matrix(idx, K=args.kmerlen)
    write_zygosity_csv(args.out, idx.entry_names, M)
    print(f"{len(idx.entry_names)}x{len(idx.entry_names)} zygosity matrix")
    return 0


def cmd_alignsbs(argv):
    """`biokanga alignsbs` parity (CAlignsBootstrap)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch alignsbs")
    p.add_argument("-a", "--sama", required=True)
    p.add_argument("-b", "--samb", required=True)
    p.add_argument("-B", "--bed", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-n", "--iterations", type=int, default=1000)
    p.add_argument("--no-replacement", action="store_true")
    args = p.parse_args(argv)
    import numpy as _np

    from .seq.annotations import read_bed
    from .tools.expression import map_loci_to_features, read_sam_loci
    from .tools.zygosity import aligns_bootstrap

    feats = read_bed(args.bed)
    ca, _ = map_loci_to_features(read_sam_loci(args.sama), feats)
    cb, _ = map_loci_to_features(read_sam_loci(args.samb), feats)
    obs, pvals = aligns_bootstrap(
        ca, cb, iterations=args.iterations,
        with_replacement=not args.no_replacement,
    )
    with open(args.out, "w") as f:
        f.write('"Feature","CntsA","CntsB","ObsDiff","PValue"\n')
        for ft, a_, b_, o, pv in zip(feats, ca, cb, obs, pvals):
            f.write(f'"{ft.name}",{int(a_)},{int(b_)},{o:.6g},{pv:.4f}\n')
    print(f"bootstrapped {len(feats)} features x {args.iterations} iters")
    return 0


# --------------------------------------------- chromatin/structure family --
# (biokanga_tpu/cli.py:2552-2785; per-tool reference citations in
# tools/chromatin_tools.py, tools/conservation.py and tools/go_tools.py)

cmd_dnasitepotential = _simple_cmd(
    "dna_site_potential",
    [(("-i", "--reads-path"), dict(required=True)),
     (("-I", "--genome-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-s", "--strand"), dict(default=None, choices=("+", "-")))],
    "{n} octamer rows", "chromatin_tools")
cmd_rnasitepotential = _simple_cmd(
    "rna_site_potential",
    [(("-i", "--reads-path"), dict(required=True)),
     (("-I", "--genome-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-s", "--strand"), dict(default=None, choices=("+", "-")))],
    "{n} octamer rows", "chromatin_tools")
cmd_simulatemnase = _simple_cmd(
    "simulate_mnase",
    [(("-i", "--genome-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-I", "--prefs-path"), dict(default=None)),
     (("-m", "--mode"), dict(type=int, default=0, choices=(0, 1, 2))),
     (("-n", "--numreads"), dict(type=int, default=10000)),
     (("-l", "--readlen"), dict(type=int, default=36)),
     (("-c", "--cutmin"), dict(type=int, default=122)),
     (("-C", "--cutmax"), dict(type=int, default=172)),
     (("-s", "--strand"), dict(default=None, choices=("+", "-"))),
     (("--seed",), dict(type=int, default=1))],
    "{n} simulated MNase reads", "chromatin_tools")
cmd_prednucleosomes = _simple_cmd(
    "pred_nucleosomes",
    [(("-i", "--reads-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-g", "--genome-path"), dict(default=None)),
     (("-I", "--prefs-path"), dict(default=None)),
     (("-M", "--fmt"), dict(type=int, default=0)),
     (("-a", "--movavg"), dict(type=int, default=10)),
     (("-A", "--basewin"), dict(type=int, default=250)),
     (("-t", "--title"), dict(default="prednucs")),
     (("--min-score",), dict(type=float, default=1.0))],
    "{n} track rows", "chromatin_tools")
cmd_predconfnucs = _simple_cmd(
    "pred_conf_nucs",
    [(("-i", "--genome-path"), dict(required=True)),
     (("-I", "--conf-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-M", "--fmt"), dict(type=int, default=0)),
     (("-a", "--movavg"), dict(type=int, default=10)),
     (("-A", "--basewin"), dict(type=int, default=250)),
     (("-t", "--title"), dict(default="confnucs"))],
    "{n} track rows", "chromatin_tools", device=True)
cmd_genstructprofile = _simple_cmd(
    "gen_struct_profile",
    [(("-i", "--fasta-path"), dict(required=True)),
     (("-p", "--params-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("--param",), dict(default="minorgroove")),
     (("-T", "--trunclength"), dict(type=int, default=147)),
     (("-u", "--ofsstart"), dict(type=int, default=0)),
     (("-n", "--nsamples"), dict(type=int, default=0))],
    "{n} profiles", "chromatin_tools", device=True)
cmd_genstructstats = _simple_cmd(
    "gen_struct_stats",
    [(("-i", "--params-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-s", "--sort-flanking"), dict(action="store_true"))],
    "{n} octamer rows", "chromatin_tools")
cmd_gennucstats = _simple_cmd(
    "gen_nuc_stats",
    [(("-i", "--bkg-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-I", "--sample-path"), dict(default=None)),
     (("-b", "--bkgdyadofs"), dict(type=int, default=73)),
     (("-s", "--smpldyadofs"), dict(type=int, default=73)),
     (("-w", "--winddyad"), dict(type=int, default=5))],
    "{n} dyads", "chromatin_tools")
cmd_gencomposition = _simple_cmd(
    "gen_composition",
    [(("-i", "--genome-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-n", "--nmer"), dict(type=int, default=2))],
    "{n} composition rows", "chromatin_tools")
cmd_gencentroidmetrics = _simple_cmd(
    "gen_centroid_metrics",
    [(("-i", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-n", "--nmer"), dict(type=int, default=5)),
     (("-r", "--ref-species"), dict(default=None))],
    "{n} oligo rows", "chromatin_tools")
cmd_proccentroids = _simple_cmd(
    "proc_centroids",
    [(("-i", "--inpath"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-m", "--mode"), dict(type=int, default=0))],
    "{n} centroid rows", "chromatin_tools")


# --------------------------------------------------- conservation family --
# (SURVEY §2.6 comparative-genomics/conservation tools; per-tool reference
# citations in tools/conservation.py)

cmd_genhyperconserved = _simple_cmd(
    "gen_hyperconserved",
    [(("-i", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-O", "--cores-path"), dict(default=None)),
     (("-r", "--ref-species"), dict(default=None)),
     (("-s", "--species"), dict(action="append", default=None)),
     (("-y", "--min-ident"), dict(type=int, default=90)),
     (("-n", "--min-ultra-len"), dict(type=int, default=50)),
     (("-N", "--min-hyper-len"), dict(type=int, default=0)),
     (("-X", "--max-mismatches"), dict(type=int, default=100)),
     (("-j", "--indels-as-mismatches"), dict(action="store_true")),
     (("-k", "--slough-ref-indels"), dict(action="store_true"))],
    "{n} conserved elements", "conservation")
cmd_genultras = _simple_cmd(
    "gen_ultras",
    [(("-i", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-O", "--cores-path"), dict(default=None)),
     (("-r", "--ref-species"), dict(default=None)),
     (("-s", "--species"), dict(action="append", default=None)),
     (("-n", "--min-ultra-len"), dict(type=int, default=50))],
    "{n} ultra elements", "conservation")
cmd_genhyperdropouts = _simple_cmd(
    "gen_hyperdropouts",
    [(("-i", "--ref-path"), dict(required=True)),
     (("-I", "--rel-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-p", "--mode"), dict(type=int, default=0, choices=(0, 1, 2, 3)))],
    "{n} elements", "conservation")
cmd_genalignstats = _simple_cmd(
    "gen_align_stats",
    [(("-i", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True))],
    "{n} species rows", "conservation")
cmd_genalignconf = _simple_cmd(
    "gen_align_conf",
    [(("-i", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-m", "--mode"), dict(type=int, default=0, choices=(0, 1, 2)))],
    "{n} blocks", "conservation")
cmd_genalignref2relloci = _simple_cmd(
    "gen_align_ref2relloci",
    [(("-i", "--loci-path"), dict(required=True)),
     (("-I", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-r", "--ref-species"), dict(default=None))],
    "{n} mapped loci", "conservation")
cmd_genalignloci2core = _simple_cmd(
    "gen_align_loci2core",
    [(("-i", "--loci-path"), dict(required=True)),
     (("-I", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-d", "--dist-segs"), dict(type=int, default=10))],
    "{n} profile rows", "conservation")
cmd_loci2phylip = _simple_cmd(
    "loci2phylip",
    [(("-i", "--loci-path"), dict(required=True)),
     (("-I", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-x", "--mode"), dict(type=int, default=0, choices=(0, 1)))],
    "{n} phylip blocks", "conservation")
cmd_genrollups = _simple_cmd(
    "gen_rollups",
    [(("-i", "--inpaths"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-m", "--mode"), dict(type=int, default=0))],
    "{n} files rolled up", "conservation")
cmd_genelementseq = _simple_cmd(
    "gen_element_seq",
    [(("-i", "--loci-path"), dict(required=True)),
     (("-I", "--genome-path"), dict(required=True)),
     (("-o", "--out-fasta"), dict(required=True)),
     (("-f", "--flank"), dict(type=int, default=0))],
    "{n} element sequences", "conservation")
cmd_genloci2gene = _simple_cmd(
    "gen_loci2gene",
    [(("-i", "--loci-path"), dict(required=True)),
     (("-b", "--bed-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-L", "--updnstream"), dict(type=int, default=2000))],
    "{n} loci classified", "conservation")
cmd_genseqcandidates = _simple_cmd(
    "gen_seq_candidates",
    [(("-i", "--fasta-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("--min-len",), dict(type=int, default=50)),
     (("--max-len",), dict(type=int, default=1 << 30)),
     (("--max-n-pct",), dict(type=float, default=5.0)),
     (("--min-gc",), dict(type=float, default=0.0)),
     (("--max-gc",), dict(type=float, default=100.0))],
    "{n} candidates", "conservation")
cmd_genelementprofiles = _simple_cmd(
    "gen_element_profiles",
    [(("-i", "--loci-path"), dict(required=True)),
     (("-I", "--algn-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-d", "--segs"), dict(type=int, default=10))],
    "{n} element profiles", "conservation")
cmd_processcsvfiles = _simple_cmd(
    "process_csv_files",
    [(("-i", "--inpaths"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-m", "--op"), dict(default="merge", choices=("merge", "common")))],
    "{n} loci", "conservation")
cmd_gennormwiggle = _simple_cmd(
    "gen_norm_wiggle",
    [(("-i", "--loci-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-m", "--mode"), dict(type=int, default=0, choices=(0, 1))),
     (("-s", "--span"), dict(type=int, default=1))],
    "{n} wiggle values", "conservation")


cmd_goenrichment = _simple_cmd(
    "go_enrichment_csv",
    [(("-i", "--study-path"), dict(required=True)),
     (("-I", "--pop-path"), dict(required=True)),
     (("-b", "--obo-path"), dict(required=True)),
     (("-a", "--gaf-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True)),
     (("-n", "--min-count"), dict(type=int, default=2))],
    "{n} enriched terms", "go_tools")
cmd_goassoc = _simple_cmd(
    "go_assoc_dump",
    [(("-b", "--obo-path"), dict(required=True)),
     (("-a", "--gaf-path"), dict(required=True)),
     (("-o", "--outpath"), dict(required=True))],
    "{n} associations", "go_tools")


HOST_SUBCOMMANDS = {
    "genzygosity": cmd_genzygosity,
    "csv2sqlite": cmd_csv2sqlite,
    "alignvalidate": cmd_alignvalidate,
    "alignsbs": cmd_alignsbs,
    "bed2csv": cmd_bed2csv,
    "csv2bed": cmd_csv2bed,
    "csv2fasta": cmd_csv2fasta,
    "fasta2bed": cmd_fasta2bed,
    "bedfilter": cmd_bedfilter,
    "bedmerge": cmd_bedmerge,
    "gfffilter": cmd_gfffilter,
    "gtffilter": cmd_gfffilter,
    "genwiggle": cmd_genwiggle,
    "splitmultifasta": cmd_splitmultifasta,
    "fastafilter": cmd_fastafilter,
    "fasta2pe": cmd_fastatope,
    "psl2csv": cmd_psl2csv,
    "blast2csv": cmd_blast2csv,
    "csv2stats": cmd_csv2stats,
    "csvfilter": cmd_csvfilter,
    "csvmerge": cmd_csvmerge,
    "csv2feat": cmd_csv2feat,
    "fasta2dist": cmd_fasta2dist,
    "agp2genome": cmd_agp2genome,
    "dmpbioseq": cmd_dmpbioseq,
    "hammingdist": cmd_hammingdist,
    "genbioseq": cmd_genbioseq,
    "genbiobed": cmd_genbiobed,
    "genbiomultialign": cmd_genbiomultialign,
    "fasta2struct": cmd_fasta2struct,
    "kangar": cmd_kangar,
    "kangapr": cmd_kangapr,
    "filterreads": cmd_filterreads,
    "kmerdist": cmd_kmerdist,
    "snps2sqlite": cmd_snps2sqlite,
    "snpm2sqlite": cmd_snps2sqlite,
    "psl2sqlite": cmd_psl2sqlite,
    "de2sqlite": cmd_de2sqlite,
    "maploci": cmd_maploci,
    "gendeseq": cmd_gendeseq,
    "rnade": cmd_rnade,
    "locateroi": cmd_locateroi,
    "quickcount": cmd_quickcount,
    "loci2dist": cmd_loci2dist,
    "ufilter": cmd_ufilter,
    "gensampler": cmd_gensampler,
    "kangahrdx": cmd_kangahrdx,
    "kangaradseq": cmd_kangaradseq,
    "fasta2nxx": cmd_fasta2nxx,
    "xfasta": cmd_xfasta,
    "pseudogenome": cmd_pseudogenome,
    "filter": cmd_filter,
    "ngsqc": cmd_ngsqc,
    "ssr": cmd_ssr,
    "filtchrom": cmd_filtchrom,
    "remaploci": cmd_remaploci,
    "maploci2features": cmd_maploci,
    "dnaseqsitepotential": cmd_dnasitepotential,
    "rnaseqsitepotential": cmd_rnasitepotential,
    "simulatemnase": cmd_simulatemnase,
    "prednucleosomes": cmd_prednucleosomes,
    "predconfnucs": cmd_predconfnucs,
    "genstructprofile": cmd_genstructprofile,
    "genstructstats": cmd_genstructstats,
    "gennucstats": cmd_gennucstats,
    "gencomposition": cmd_gencomposition,
    "gencentroidmetrics": cmd_gencentroidmetrics,
    "proccentroids": cmd_proccentroids,
    "genhyperconserved": cmd_genhyperconserved,
    "genultras": cmd_genultras,
    "genhyperdropouts": cmd_genhyperdropouts,
    "genalignstats": cmd_genalignstats,
    "genalignconf": cmd_genalignconf,
    "genalignref2relloci": cmd_genalignref2relloci,
    "genalignloci2core": cmd_genalignloci2core,
    "loci2phylip": cmd_loci2phylip,
    "genrollups": cmd_genrollups,
    "genelementseq": cmd_genelementseq,
    "genloci2gene": cmd_genloci2gene,
    "genseqcandidates": cmd_genseqcandidates,
    "genelementprofiles": cmd_genelementprofiles,
    "processcsvfiles": cmd_processcsvfiles,
    "gennormwiggle": cmd_gennormwiggle,
    "goenrichment": cmd_goenrichment,
    "goassoc": cmd_goassoc,
}
