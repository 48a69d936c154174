"""The port's tool subcommands, after biokanga_tpu/cli.py: `simreads`
(:862), `mergeoverlaps` (:1086), `blitz` (:1174), `uhamming` (:1231),
`kmarkers`/`prekmarkers`/`locmarkers` (:1290), `snpmarkers`/`genmarkers`
(:1320), `markerseqs` (:1340), `rnafragsim` (:2334), `usimdiffexpr`
(:2370), `kangarg` (:2410) and `findapproxmatches` (:2433).

Each writes the files of the same subcommand of `python -m biokanga_tpu`
on the same inputs.  `blitz`, `uhamming`, `mergeoverlaps` and
`findapproxmatches` run on `--device` (default cuda, which raises
without CUDA); the simulators and the marker tools are host numpy.
"""
from __future__ import annotations

import argparse

import numpy as np

from .device import resolve_device
from .utils.diagnostics import StopWatch, open_diagnostics

# blitz queries aligned together: one seed lookup and one chain call
BLITZ_BATCH_BASES = 4_000_000
BLITZ_BATCH_QUERIES = 2_048


def add_device(p: argparse.ArgumentParser) -> None:
    """The --device argument of the commands that run on a device."""
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without CUDA) "
                        "or cpu (the kernels' plain versions)")


def cmd_simreads(argv: list[str]) -> int:
    """`biokanga simreads` parity (biokanga/SimReads.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch simreads")
    p.add_argument("-i", "--infasta", required=True)
    p.add_argument("-o", "--out", required=True, help="output FASTA/FASTQ")
    p.add_argument("-O", "--out2", default=None,
                   help="PE mate-2 output file (with --pe)")
    p.add_argument("-n", "--numreads", type=int, default=10000)
    p.add_argument("-l", "--readlen", type=int, default=100)
    p.add_argument("--sub-rate", type=float, default=0.0)
    p.add_argument("--pe", action="store_true")
    p.add_argument("--insert-min", type=int, default=200)
    p.add_argument("--insert-max", type=int, default=500)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("-H", "--hammings", default=None,
                   help=".hmg.npz from uhamming; read descriptors carry "
                        "the source window's min-Hamming")
    p.add_argument("-C", "--colorspace", action="store_true",
                   help="emit SOLiD colorspace reads (.csfasta, primer T)")
    p.add_argument("-N", "--snprate", type=int, default=0,
                   help="plant simulated SNPs at this rate per Mbp")
    p.add_argument("--outsnps", default=None,
                   help="write simulated-SNP truth BED here (with -N)")
    p.add_argument("-X", "--indelrate", type=float, default=0.0,
                   help="per-read InDel probability 0..1")
    p.add_argument("-x", "--indelsize", type=int, default=3,
                   help="max InDel size 1..9")
    p.add_argument("-g", "--generrmode", default="none",
                   choices=("none", "fixed", "static", "dyn"),
                   help="induced sequencer-error mode (etSEMode)")
    p.add_argument("-z", "--seqerrrate", type=float, default=0.01,
                   help="dyn mode per-base error rate / fixed mode count")
    p.add_argument("-Z", "--unifomdist", action="store_true",
                   help="uniform error placement (default: Illumina "
                        "3'-weighted spatial profile when -g is set)")
    p.add_argument("-R", "--proprandreads", type=float, default=0.0,
                   help="proportion of completely random reads 0..0.9")
    args = p.parse_args(argv)
    from .seq.fasta import read_seqs, write_csfasta, write_fasta, write_fastq
    from .sim.simreads import plant_snps, simulate_reads

    seqs = [(r.name, r.codes) for r in read_seqs(args.infasta)]
    if args.snprate:
        seqs, _snps = plant_snps(seqs, args.snprate, seed=args.seed,
                                 bed_path=args.outsnps)
    hmg = None
    if args.hammings:
        from .tools.uhamming import load_hmg

        hmg, _, _, _ = load_hmg(args.hammings)
    names, codes, _ = simulate_reads(
        seqs, args.numreads, read_len=args.readlen,
        sub_rate=args.sub_rate, seed=args.seed, pe=args.pe,
        insert_min=args.insert_min, insert_max=args.insert_max,
        hammings=hmg,
        indel_rate=args.indelrate, indel_size=args.indelsize,
        error_mode=args.generrmode, error_rate=args.seqerrrate,
        error_uniform=args.unifomdist or args.generrmode == "none",
        prop_random=args.proprandreads,
    )

    def write(path, recs):
        if args.colorspace:
            write_csfasta(path, recs)
        elif path.endswith((".fastq", ".fq", ".fastq.gz", ".fq.gz")):
            write_fastq(path, ((n, c, None) for n, c in recs))
        else:
            write_fasta(path, recs)

    if args.pe and args.out2:
        write(args.out, ((names[i], codes[i]) for i in range(0, len(names), 2)))
        write(args.out2, ((names[i], codes[i]) for i in range(1, len(names), 2)))
    else:
        write(args.out, zip(names, codes))
    return 0


def cmd_mergeoverlaps(argv: list[str]) -> int:
    """`biokanga mergeoverlaps` parity (CMergeReadPairs)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch mergeoverlaps")
    p.add_argument("-i", "--in1", required=True)
    p.add_argument("-u", "--in2", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--unmerged1", default=None)
    p.add_argument("--unmerged2", default=None)
    p.add_argument("-l", "--min-overlap", type=int, default=16)
    p.add_argument("-s", "--max-subs-pcnt", type=float, default=5.0)
    p.add_argument("-m", "--mode", type=int, default=0, choices=(0, 1, 2, 3),
                   help="0 combined, 1 separate, 2 amplicon with 5'/3' MID "
                        "barcode well demux + merging, 3 amplicon no-merge")
    add_device(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    from .tools.mergeoverlaps import (
        MergeParams,
        merge_amplicons,
        merge_overlaps,
    )

    params = MergeParams(args.min_overlap, args.max_subs_pcnt)
    if args.mode >= 2:
        n, w, counts = merge_amplicons(args.in1, args.in2, args.out, params,
                                       no_merge=args.mode == 3,
                                       device=device)
        print(f"amplicon demux: {w}/{n} pairs assigned to "
              f"{len(counts)} wells")
        return 0
    n, m = merge_overlaps(args.in1, args.in2, args.out, params,
                          args.unmerged1, args.unmerged2, device=device)
    print(f"merged {m}/{n} pairs")
    return 0


def _query_batches(path: str):
    """Query records of a FASTA in batches of BLITZ_BATCH_BASES bases or
    BLITZ_BATCH_QUERIES queries."""
    from .seq.fasta import read_seqs

    batch, bases = [], 0
    for rec in read_seqs(path):
        batch.append((rec.name, rec.codes))
        bases += len(rec.codes)
        if bases >= BLITZ_BATCH_BASES or len(batch) >= BLITZ_BATCH_QUERIES:
            yield batch
            batch, bases = [], 0
    if batch:
        yield batch


def cmd_blitz(argv: list[str]) -> int:
    """`biokanga blitz` parity (CBlitz, biokanga/Blitz.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch blitz")
    p.add_argument("-i", "--inquery", required=True, help="query FASTA")
    p.add_argument("-I", "--sfx", required=True, help="index file")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-M", "--format", default="psl",
                   choices=("psl", "pslx", "bed", "maf"))
    p.add_argument("-C", "--corelen", type=int, default=20)
    p.add_argument("-c", "--coredelta", type=int, default=0)
    p.add_argument("-m", "--sensitivity", default="default",
                   choices=("default", "more", "ultra", "less"))
    p.add_argument("-s", "--minpathscore", type=int, default=75)
    p.add_argument("-a", "--minalignedpct", type=int, default=25)
    p.add_argument("-R", "--maxpaths", type=int, default=10)
    p.add_argument("-F", "--log", default=None)
    add_device(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    log = open_diagnostics(args.log)
    sw = StopWatch()
    from .index.build import load_index
    from .index.device import to_device
    from .tools.blitz import (
        PSL_HEADER,
        BlitzParams,
        bed_row,
        blitz_queries,
        maf_block,
        psl_row,
        pslx_row,
    )

    idx = load_index(args.sfx)
    didx = to_device(idx, device, pack=False)
    bp = BlitzParams(
        core_len=args.corelen, core_delta=args.coredelta,
        sensitivity=args.sensitivity, min_path_score=args.minpathscore,
        min_aligned_pct=args.minalignedpct, max_paths=args.maxpaths,
    )
    n_q = n_paths = 0
    with open(args.out, "w") as f:
        if args.format in ("psl", "pslx"):
            f.write(PSL_HEADER)
        for batch in _query_batches(args.inquery):
            for (_, q), paths in zip(batch, blitz_queries(didx, batch, bp)):
                n_q += 1
                n_paths += len(paths)
                for path in paths:
                    if args.format == "psl":
                        f.write(psl_row(path) + "\n")
                    elif args.format == "pslx":
                        f.write(pslx_row(path, idx, q) + "\n")
                    elif args.format == "bed":
                        f.write(bed_row(path) + "\n")
                    else:
                        f.write(maf_block(path, idx, q))
    log.info("blitz: %d queries -> %d paths in %.1fs", n_q, n_paths,
             sw.elapsed())
    return 0


def cmd_uhamming(argv: list[str]) -> int:
    """`uhamming` tool parity (uhamming/uhamming.cpp): genome min-Hamming
    sweep with node partitioning (-n/-N, mode 2) and merge (mode 3).  As
    in the JAX CLI, mode 2 runs no reverse-complement sweep."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch uhamming")
    p.add_argument("-m", "--mode", type=int, default=0,
                   choices=(0, 2, 3), help="0 full, 2 node partial, 3 merge")
    p.add_argument("-i", "--infasta", default=None)
    p.add_argument("-I", "--inhmg", action="append", default=None,
                   help="mode 3: partial .hmg.npz files to merge")
    p.add_argument("-o", "--out", required=True, help=".hmg.npz output")
    p.add_argument("-O", "--outcsv", default=None)
    p.add_argument("-K", "--seqlen", type=int, default=100)
    p.add_argument("-n", "--numnodes", type=int, default=1)
    p.add_argument("-N", "--node", type=int, default=1)
    p.add_argument("--no-rc", action="store_true")
    add_device(p)
    args = p.parse_args(argv)
    from .tools.uhamming import (
        hamming_sweep,
        load_hmg,
        merge_partials,
        save_hmg,
        write_hamming_csv,
    )

    if args.mode == 3:
        parts = []
        names = starts = K = None
        for f in args.inhmg or []:
            h, names, starts, K = load_hmg(f)
            parts.append(h)
        merged = merge_partials(parts)
        save_hmg(args.out, merged, names, starts, K)
        if args.outcsv:
            write_hamming_csv(args.outcsv, merged, names, starts)
        print(f"merged {len(parts)} partials")
        return 0

    device = resolve_device(args.device)
    from .seq.fasta import read_seqs

    seqs = [(r.name, r.codes) for r in read_seqs(args.infasta)]
    starts = np.zeros(len(seqs) + 1, dtype=np.int64)
    for i, (_, s) in enumerate(seqs):
        starts[i + 1] = starts[i] + len(s)
    codes = np.concatenate([s for _, s in seqs])
    n = len(codes)
    top = n - args.seqlen + 1
    if args.mode == 2:
        lo = 1 + (top - 1) * (args.node - 1) // args.numnodes
        hi = 1 + (top - 1) * args.node // args.numnodes
    else:
        lo, hi = 1, top
    h = hamming_sweep(codes, starts, K=args.seqlen, shift_lo=lo, shift_hi=hi,
                      include_rc=(not args.no_rc) and args.mode == 0,
                      device=device)
    save_hmg(args.out, h, [x for x, _ in seqs], starts, args.seqlen)
    if args.outcsv:
        write_hamming_csv(args.outcsv, h, [x for x, _ in seqs], starts)
    print(f"uhamming: {n} loci, shifts [{lo},{hi})")
    return 0


def cmd_kmarkers(argv: list[str], fasta_out: bool = False) -> int:
    """`biokanga kmarkers` / `prekmarkers` parity (CMarkerKMers/CLocKMers)."""
    prog = "prekmarkers" if fasta_out else "kmarkers"
    p = argparse.ArgumentParser(prog=f"biokanga-tpu-torch {prog}")
    p.add_argument("-I", "--sfx", required=True,
                   help="index over the multi-cultivar concatenation")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-k", "--kmerlen", type=int, default=50)
    p.add_argument("-c", "--cultivar", action="append", default=None,
                   help="entryname=cultivar mapping (repeatable); default: "
                        "each entry is its own cultivar")
    p.add_argument("--min-count", type=int, default=1)
    p.add_argument("--max-other", type=int, default=0)
    args = p.parse_args(argv)
    from .index.build import load_index
    from .tools.markers import kmer_markers, write_kmer_markers

    idx = load_index(args.sfx)
    mapping = dict(spec.split("=", 1) for spec in args.cultivar or [])
    e2c = [mapping.get(n, n) for n in idx.entry_names]
    ms = kmer_markers(idx, e2c, K=args.kmerlen, min_count=args.min_count,
                      max_other_count=args.max_other)
    write_kmer_markers(args.out, ms, fasta=fasta_out)
    print(f"{len(ms)} K-mer markers")
    return 0


def cmd_snpmarkers(argv: list[str]) -> int:
    """`biokanga snpmarkers` parity (CMarkers, biokanga/Markers.cpp)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch snpmarkers")
    p.add_argument("-i", "--snpcsv", action="append", required=True,
                   help="cultivar=snps.csv (repeatable)")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--min-cov", type=int, default=5)
    args = p.parse_args(argv)
    from .tools.markers import snp_markers, write_snp_markers

    csvs = dict(spec.split("=", 1) for spec in args.snpcsv)
    ms = snp_markers(csvs, min_cov=args.min_cov)
    write_snp_markers(args.out, ms, sorted(csvs))
    print(f"{len(ms)} SNP markers")
    return 0


def cmd_markerseqs(argv: list[str]) -> int:
    """`biokanga markerseqs` parity (CMarkerSeq)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch markerseqs")
    p.add_argument("-I", "--sfx", required=True)
    p.add_argument("-i", "--snpcsv", action="append", required=True,
                   help="cultivar=snps.csv")
    p.add_argument("-o", "--out", required=True, help="marker FASTA")
    p.add_argument("--flank5", type=int, default=100)
    p.add_argument("--flank3", type=int, default=100)
    args = p.parse_args(argv)
    from .index.build import load_index
    from .seq.fasta import write_fasta
    from .tools.markers import marker_seqs, snp_markers

    idx = load_index(args.sfx)
    csvs = dict(s.split("=", 1) for s in args.snpcsv)
    ms = snp_markers(csvs, min_cov=1)
    seqs = marker_seqs(idx, ms, args.flank5, args.flank3)
    write_fasta(args.out, seqs)
    print(f"{len(seqs)} marker sequences")
    return 0


def cmd_rnafragsim(argv: list[str]) -> int:
    """`RNAFragSim` tool parity: simulate RNA-seq fragments/reads from
    transcript BED features over a genome."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch rnafragsim")
    p.add_argument("-i", "--genome", required=True)
    p.add_argument("-b", "--bed", required=True, help="transcript BED")
    p.add_argument("-o", "--out", required=True, help="output FASTQ")
    p.add_argument("-O", "--truthcsv", default=None,
                   help="write per-transcript true counts CSV")
    p.add_argument("-n", "--nfrags", type=int, default=10000)
    p.add_argument("-l", "--readlen", type=int, default=100)
    p.add_argument("--frag-min", type=int, default=150)
    p.add_argument("--frag-max", type=int, default=400)
    p.add_argument("--expr-alpha", type=float, default=1.0)
    p.add_argument("-S", "--seed", type=int, default=1)
    args = p.parse_args(argv)
    from .seq.fasta import read_seqs, write_fastq
    from .sim.extra import rna_frag_sim

    seqs = [(r.name, r.codes) for r in read_seqs(args.genome)]
    names, reads, counts = rna_frag_sim(
        seqs, args.bed, args.nfrags, frag_min=args.frag_min,
        frag_max=args.frag_max, read_len=args.readlen, seed=args.seed,
        expr_alpha=args.expr_alpha,
    )
    write_fastq(args.out, ((n, r, None) for n, r in zip(names, reads)))
    if args.truthcsv:
        with open(args.truthcsv, "w") as f:
            f.write('"Transcript","TrueCount"\n')
            for name, c in counts:
                f.write(f'"{name}",{c}\n')
    print(f"rnafragsim: {len(reads)} fragments over {len(counts)} "
          "transcripts")
    return 0


def cmd_usimdiffexpr(argv: list[str]) -> int:
    """`usimdiffexpr` tool parity: simulate a differential-expression
    count table with controlled fold changes."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch usimdiffexpr")
    p.add_argument("-o", "--out", required=True, help="counts CSV")
    p.add_argument("-O", "--truthcsv", default=None)
    p.add_argument("-n", "--nfeatures", type=int, default=1000)
    p.add_argument("--nctrl", type=int, default=3)
    p.add_argument("--nexpt", type=int, default=3)
    p.add_argument("--de-frac", type=float, default=0.1)
    p.add_argument("--fold-change", type=float, default=4.0)
    p.add_argument("--dispersion", type=float, default=0.2)
    p.add_argument("-S", "--seed", type=int, default=1)
    args = p.parse_args(argv)
    from .sim.extra import sim_diff_expr

    names, ctrl, expt, truth = sim_diff_expr(
        args.nfeatures, n_ctrl=args.nctrl, n_expt=args.nexpt,
        de_frac=args.de_frac, fold_change=args.fold_change,
        dispersion=args.dispersion, seed=args.seed,
    )
    with open(args.out, "w") as f:
        hdr = (['"Feature"']
               + [f'"Ctrl{i+1}"' for i in range(args.nctrl)]
               + [f'"Expt{i+1}"' for i in range(args.nexpt)])
        f.write(",".join(hdr) + "\n")
        for i, name in enumerate(names):
            row = [f'"{name}"'] + [str(int(x)) for x in ctrl[i]]
            row += [str(int(x)) for x in expt[i]]
            f.write(",".join(row) + "\n")
    if args.truthcsv:
        with open(args.truthcsv, "w") as f:
            f.write('"Feature","TrueFoldChange"\n')
            for name, t in zip(names, truth):
                f.write(f'"{name}",{t:.4f}\n')
    n_de = int((truth != 1.0).sum())
    print(f"usimdiffexpr: {args.nfeatures} features, {n_de} DE")
    return 0


def cmd_kangarg(argv: list[str]) -> int:
    """`kangarg` tool parity: genome K-mer randomiser — shuffle each
    sequence preserving exact k-mer composition (CShuffle role)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch kangarg")
    p.add_argument("-i", "--inpath", required=True)
    p.add_argument("-o", "--outpath", required=True)
    p.add_argument("-k", "--kmerlen", type=int, default=2,
                   help="conserved k-mer order (1=plain shuffle)")
    p.add_argument("-S", "--seed", type=int, default=1)
    args = p.parse_args(argv)
    from .seq.fasta import read_seqs, write_fasta
    from .sim.extra import klet_shuffle

    out = [(rec.name, klet_shuffle(rec.codes, k=args.kmerlen,
                                   seed=args.seed + i))
           for i, rec in enumerate(read_seqs(args.inpath))]
    write_fasta(args.outpath, out)
    print(f"kangarg: {len(out)} sequences shuffled (k={args.kmerlen})")
    return 0


def cmd_findapproxmatches(argv: list[str]) -> int:
    """`FindShortApproxMatches` tool parity: every locus where each short
    query matches within a mismatch budget (one-hot convolution scan)."""
    p = argparse.ArgumentParser(prog="biokanga-tpu-torch findapproxmatches")
    p.add_argument("-i", "--queries", required=True, help="query FASTA")
    p.add_argument("-I", "--genome", required=True,
                   help="genome FASTA or index .npz")
    p.add_argument("-o", "--out", required=True, help="hits CSV")
    p.add_argument("-s", "--max-mm", type=int, default=2)
    p.add_argument("-Q", "--strand", default="both",
                   choices=("both", "sense"))
    add_device(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    from .ops.shortmatch import find_short_matches
    from .seq.fasta import read_seqs

    if args.genome.endswith(".npz"):
        from .index.build import load_index

        idx = load_index(args.genome)
        genome = np.asarray(idx.codes)
        entry_names = idx.entry_names
        entry_starts = np.asarray(idx.entry_starts)
    else:
        recs = [(r.name, r.codes) for r in read_seqs(args.genome)]
        genome = np.concatenate([c for _, c in recs])
        entry_names = [n for n, _ in recs]
        entry_starts = np.zeros(len(recs) + 1, np.int64)
        np.cumsum([len(c) for _, c in recs], out=entry_starts[1:])
    qrecs = [(r.name, r.codes) for r in read_seqs(args.queries)]
    # group queries by width (the convolution takes one W a call)
    by_w: dict[int, list[int]] = {}
    for i, (_, c) in enumerate(qrecs):
        by_w.setdefault(len(c), []).append(i)
    n = 0
    with open(args.out, "w") as f:
        f.write('"Query","Chrom","Loci","Strand","Mismatches"\n')
        for _, ids in sorted(by_w.items()):
            hits = find_short_matches(
                genome, [qrecs[i][1] for i in ids], max_mm=args.max_mm,
                both_strands=args.strand == "both", device=device,
            )
            for qi, locus, strand, mm in hits:
                e = int(np.searchsorted(entry_starts, locus,
                                        side="right")) - 1
                f.write(f'"{qrecs[ids[qi]][0]}","{entry_names[e]}",'
                        f"{locus - int(entry_starts[e])},"
                        f'"{strand}",{mm}\n')
                n += 1
    print(f"findapproxmatches: {n} hits for {len(qrecs)} queries")
    return 0


TOOL_SUBCOMMANDS = {
    "simreads": cmd_simreads,
    "mergeoverlaps": cmd_mergeoverlaps,
    "blitz": cmd_blitz,
    "uhamming": cmd_uhamming,
    "kmarkers": cmd_kmarkers,
    "prekmarkers": lambda argv: cmd_kmarkers(argv, fasta_out=True),
    "locmarkers": lambda argv: cmd_kmarkers(argv, fasta_out=True),
    "snpmarkers": cmd_snpmarkers,
    "genmarkers": cmd_snpmarkers,
    "markerseqs": cmd_markerseqs,
    "rnafragsim": cmd_rnafragsim,
    "usimdiffexpr": cmd_usimdiffexpr,
    "kangarg": cmd_kangarg,
    "findapproxmatches": cmd_findapproxmatches,
}
