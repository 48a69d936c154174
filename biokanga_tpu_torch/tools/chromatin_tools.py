"""Port of biokanga_tpu/tools/chromatin_tools.py: the chromatin /
DNA-structure tool family.

Parity surface (SURVEY.md §2.6 "Chromatin/structure"):
- dnasitepotential / rnasitepotential: read-start octamer site
  potentials (DNAseqSitePotential.cpp:565-860, RNAseqSitePotential.cpp)
- simulatemnase: MNase-digestion read simulation
  (SimulateMNase/SimulateMNase.cpp:96-110 CLI)
- prednucleosomes: dyad/nucleosome prediction from aligned reads with
  optional MNase bias (prednucleosomes.cpp:73,217)
- predconfnucs: conformation-driven nucleosome prediction from the
  octamer minor-groove signal (predconfnucs.cpp:180-198)
- genstructprofile / genstructstats: structural profiles and the raw
  parameter-table dump (genstructprofile.cpp:17-44,
  genstructstats.cpp:41-49)
- gennucstats: sample-vs-background dyad overlap stats
  (gennucstats.cpp:109-117)
- gencomposition: genome oligo-composition distributions
  (gencomposition.cpp:933-945 GenSeqIdx counting)
- gencentroidmetrics / proccentroids: oligo-centred fixation counts
  over .algn multialignments and their reduction to centroid
  probabilities (gencentroidmetrics.cpp:243-266, proccentroids.cpp:117-124,
  libbiokanga/Centroid.h:8-35)

All counting is vectorised over oligo-index arrays (one bincount per
sequence), host numpy as in the JAX module.  `pred_conf_nucs` and
`gen_struct_profile` take a `device`: their conformation profiles are
gathers over the parameter column kept there (chromatin/conformation.py),
one a chromosome, or one for each ~2^18 steps of profile records.
"""
from __future__ import annotations

import numpy as np

import torch

from ..chromatin.conformation import (
    N_OCT, OCT_PARAM_NAMES, gather_steps, idx_to_oligo, load_octamer_params,
    octamer_indices_t, oligo_indices, pad_steps, param_column,
    step_octamer_indices)
from ..chromatin.nucleosomes import (NUC_CORE, baseline_normalise, call_dyads,
                                     load_mnase_prefs, mnase_window_scores,
                                     moving_average, site_cut_probs,
                                     write_dyad_tracks)
from ..device import resolve_device
from ..seq.fasta import read_seqs


def _load_genome(path: str) -> dict[str, np.ndarray]:
    return {r.name: r.codes for r in read_seqs(path)}


def _read_loci(path: str):
    """Aligned loci from SAM or CSV/BED: (chrom, start, end, strand)."""
    if path.endswith((".sam", ".bam")):
        from .expression import read_sam_loci

        return read_sam_loci(path)
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("track", "#", "browser")):
                continue
            sep = "\t" if "\t" in line else ","
            fl = [p.strip().strip('"') for p in line.split(sep)]
            # BED: chrom,start,end[,name,score,strand]
            # aligner CSV rows carry chrom at 3, start 4, end 5 like the
            # reference's alignreads CSV; accept both by sniffing ints
            try:
                start, end = int(fl[1]), int(fl[2])
                chrom = fl[0]
                strand = fl[5] if len(fl) > 5 and fl[5] in "+-" else "+"
            except (ValueError, IndexError):
                try:
                    chrom, start, end = fl[3], int(fl[4]), int(fl[5])
                    strand = fl[6] if len(fl) > 6 and fl[6] in "+-" else "+"
                except (ValueError, IndexError):
                    continue
            out.append((chrom, start, end, strand))
    return out


# ------------------------------------------------------- site potentials ---

def dna_site_potential(reads_path: str, genome_path: str, outpath: str,
                       strand: str | None = None) -> int:
    """Read-start octamer site potentials.

    For each aligned read the octamer bracketing its 5' start (start-4
    .. start+3; for '-' strand the read end) is counted, the genome-wide
    octamer background is counted, and every octamer row is emitted as
    "octamer",genome_cnt,site_cnt,ratio
    (DNAseqSitePotential.cpp:617-766). The ratio column is the MNase
    site-preference input consumed by prednucleosomes/SimulateMNase.
    """
    genome = _load_genome(genome_path)
    site = np.zeros(N_OCT, dtype=np.int64)
    gen = np.zeros(N_OCT, dtype=np.int64)

    starts_by_chrom: dict[str, list[int]] = {}
    for chrom, start, end, rstrand in _read_loci(reads_path):
        if strand and rstrand != strand:
            continue
        ofs = (end - 4) if rstrand == "-" else (start - 4)
        starts_by_chrom.setdefault(chrom, []).append(ofs)

    for chrom, codes in genome.items():
        idx = oligo_indices(codes, 8)
        gen += np.bincount(idx[idx >= 0], minlength=N_OCT)
        ofs = np.asarray(starts_by_chrom.get(chrom, []), dtype=np.int64)
        ofs = ofs[(ofs >= 0) & (ofs < idx.size)]
        if ofs.size:
            sidx = idx[ofs]
            site += np.bincount(sidx[sidx >= 0], minlength=N_OCT)

    with open(outpath, "w") as f:
        for i in range(N_OCT):
            ratio = site[i] / gen[i] if gen[i] else 0.0
            f.write(f'"{idx_to_oligo(i, 8)}",{gen[i]},{site[i]},'
                    f"{ratio:.8f}\n")
    return N_OCT


def rna_site_potential(reads_path: str, genome_path: str, outpath: str,
                       strand: str | None = None) -> int:
    """RNA flavour of the site-potential scan (RNAseqSitePotential.cpp):
    identical octamer counting keyed on RNA read 5' starts."""
    return dna_site_potential(reads_path, genome_path, outpath, strand)


# --------------------------------------------------------- simulatemnase ---

def simulate_mnase(genome_path: str, outpath: str,
                   prefs_path: str | None = None, mode: int = 0,
                   numreads: int = 10000, readlen: int = 36,
                   cutmin: int = 122, cutmax: int = 172,
                   strand: str | None = None, seed: int = 1) -> int:
    """Simulate MNase-digested reads (SimulateMNase.cpp:96-110).

    mode 0: MNase-preferred start, random end; mode 1: MNase-preferred
    start and end; mode 2: random start and end. Cut-site starts are
    sampled with probability proportional to the octamer site
    preference; fragment length is uniform in [cutmin, cutmax]; the
    first `readlen` bases of each fragment are emitted (revcomp for
    '-' strand picks).
    """
    from ..seq.encode import codes_to_ascii, revcomp

    genome = {n: c for n, c in _load_genome(genome_path).items()
              if c.size > cutmax + 8}
    if not genome:
        raise ValueError("no genome sequence longer than cutmax")
    prefs = load_mnase_prefs(prefs_path) if prefs_path else None
    rng = np.random.default_rng(seed)
    names = list(genome)
    lens = np.array([genome[n].size for n in names], dtype=np.float64)
    chrom_p = lens / lens.sum()

    n_out = 0
    with open(outpath, "w") as f:
        per_chrom = rng.multinomial(numreads, chrom_p)
        for name, n_reads in zip(names, per_chrom):
            if n_reads == 0:
                continue
            codes = genome[name]
            if prefs is not None and mode in (0, 1):
                p = site_cut_probs(codes, prefs)
                tot = p.sum()
                p = (p / tot) if tot > 0 else None
            else:
                p = None
            max_start = codes.size - cutmax - 1
            if p is not None:
                p = p[:max_start]
                p = p / p.sum()
                starts = rng.choice(max_start, size=n_reads, p=p)
            else:
                starts = rng.integers(0, max_start, size=n_reads)
            cutlens = rng.integers(cutmin, cutmax + 1, size=n_reads)
            if mode == 1 and prefs is not None:
                # snap fragment end to the best MNase site in the
                # [cutmin, cutmax] end window
                pall = site_cut_probs(codes, prefs)
                for i in range(n_reads):
                    w = pall[starts[i] + cutmin: starts[i] + cutmax]
                    if w.size and w.max() > 0:
                        cutlens[i] = cutmin + int(w.argmax())
            strands = (rng.integers(0, 2, size=n_reads)
                       if strand is None
                       else np.full(n_reads, 0 if strand == "+" else 1))
            for i in range(n_reads):
                s, ln = int(starts[i]), int(cutlens[i])
                frag = codes[s: s + ln]
                st = "+-"[int(strands[i])]
                read = frag[:readlen] if st == "+" else revcomp(frag)[:readlen]
                n_out += 1
                f.write(f">lcl|simmnase|{n_out}|{name}|{s}|{s + ln}|"
                        f"{ln}|{st}\n")
                f.write(codes_to_ascii(read).decode() + "\n")
    return n_out


# ------------------------------------------------------- prednucleosomes ---

def pred_nucleosomes(reads_path: str, outpath: str,
                     genome_path: str | None = None,
                     prefs_path: str | None = None, fmt: int = 0,
                     movavg: int = 10, basewin: int = 250,
                     title: str = "prednucs", min_score: float = 1.0) -> int:
    """Predict dyads/nucleosomes from aligned read loci
    (prednucleosomes.cpp Process :73).

    Dyad signal = per-locus count of fragment midpoints, lowpassed with
    a moving average (-a), baseline-normalised (-A), then greedy local
    maxima at >= NUC_CORE separation become dyads. fmt 6 emits the MNase
    score distribution instead (needs genome+prefs, MNaseSeqScore
    histogram of 1000 bins, prednucleosomes.cpp:135).
    """
    if fmt == 6:
        if not (genome_path and prefs_path):
            raise ValueError("fmt 6 needs genome and MNase prefs")
        prefs = load_mnase_prefs(prefs_path)
        hist = np.zeros(1000, dtype=np.int64)
        for _, codes in _load_genome(genome_path).items():
            sc = mnase_window_scores(codes, prefs, NUC_CORE)
            hist += np.bincount(
                np.minimum((sc * 1000).astype(np.int64), 999),
                minlength=1000)
        return write_dyad_tracks(outpath, 6, title, [], score_hist=hist)

    mids: dict[str, list[int]] = {}
    for chrom, start, end, _ in _read_loci(reads_path):
        mids.setdefault(chrom, []).append((start + end) // 2)
    per_chrom = []
    for chrom in sorted(mids):
        m = np.asarray(mids[chrom], dtype=np.int64)
        signal = np.bincount(m, minlength=int(m.max()) + 1).astype(np.float64)
        signal = moving_average(signal, movavg)
        signal = baseline_normalise(signal, basewin)
        if fmt == 7:
            loci = np.arange(signal.size)
            per_chrom.append((chrom, loci, signal))
            continue
        dyads = call_dyads(signal, NUC_CORE, min_score=min_score)
        per_chrom.append((chrom, dyads, signal[dyads]))
    return write_dyad_tracks(outpath, fmt, title, per_chrom)


def pred_conf_nucs(genome_path: str, conf_path: str, outpath: str,
                   fmt: int = 0, movavg: int = 10, basewin: int = 250,
                   title: str = "confnucs",
                   device: str | torch.device = "cuda") -> int:
    """Conformation-driven nucleosome prediction (predconfnucs.cpp mode
    0 "predict from minor groove"): the per-step minor-groove signal is
    lowpassed, inverted around its mean (narrow minor groove at the
    dyad favours the histone octamer), baseline-normalised and peak
    -called exactly like the read-driven path.  The minor-groove column
    stays on `device`; each chromosome's profile is one gather there."""
    dev = resolve_device(device)
    column = param_column(load_octamer_params(conf_path), "minorgroove", dev)
    per_chrom = []
    for chrom, codes in _load_genome(genome_path).items():
        groove = gather_steps(column, step_octamer_indices(codes, dev))
        sm = moving_average(groove, max(movavg, 1))
        sig = baseline_normalise(sm.mean() * 2 - sm, basewin)
        if fmt == 7:
            per_chrom.append((chrom, np.arange(sig.size), sig))
            continue
        dyads = call_dyads(sig, NUC_CORE, min_score=float(sig.mean()))
        per_chrom.append((chrom, dyads, sig[dyads]))
    return write_dyad_tracks(outpath, fmt, title, per_chrom)


# ------------------------------------------------ profiles / stats dumps ---

# steps a gen_struct_profile gather collects before it runs
PROFILE_BATCH_STEPS = 1 << 18


def _write_profiles(f, batch, column: torch.Tensor) -> None:
    """One gather for the (name, codes) records of `batch`: their
    A-padded sequences laid end to end, the octamer index of every
    window of that, one gather, and each record's rows sliced from it
    (a record's windows never reach past its own padding).  The float32
    values are formatted through Python floats, which print as the
    float32 scalars do, at half the cost."""
    if not batch:
        return
    padded = [pad_steps(codes) for _, codes in batch]
    starts = np.cumsum([0] + [p.size for p in padded[:-1]])
    codes_t = torch.from_numpy(np.concatenate(padded)).to(column.device)
    prof = gather_steps(column, octamer_indices_t(codes_t)).tolist()
    for (name, codes), s in zip(batch, starts.tolist()):
        f.write(f'"{name}",' + ",".join(
            [f"{v:.4f}" for v in prof[s: s + codes.size - 1]]) + "\n")


def gen_struct_profile(fasta_path: str, params_path: str, outpath: str,
                       param: str = "minorgroove", trunclength: int = 147,
                       ofsstart: int = 0, nsamples: int = 0,
                       device: str | torch.device = "cuda") -> int:
    """Per-sequence structural profile CSV (genstructprofile.cpp):
    one row per sequence — name, then the per-step `param` values over
    the (offset, truncated) sequence.  The records' profiles are gathered
    on `device` a batch of ~PROFILE_BATCH_STEPS steps at a time."""
    column = param_column(load_octamer_params(params_path), param,
                          resolve_device(device))
    n = steps = 0
    batch = []
    with open(outpath, "w") as f:
        f.write(f'"Seq","{param}Profile..."\n')
        for rec in read_seqs(fasta_path):
            if nsamples and n >= nsamples:
                break
            codes = rec.codes[ofsstart: ofsstart + trunclength]
            if codes.size < 8:
                continue
            batch.append((rec.name, codes))
            steps += codes.size - 1
            n += 1
            if steps >= PROFILE_BATCH_STEPS:
                _write_profiles(f, batch, column)
                batch, steps = [], 0
        _write_profiles(f, batch, column)
    return n


def gen_struct_stats(params_path: str, outpath: str,
                     sort_flanking: bool = False) -> int:
    """Dump the octamer parameter table as CSV (genstructstats.cpp
    CreateStructValues): octamer then all 22 characteristics, sorted by
    octamer (default) or by flanking-inwards base order (-s)."""
    table = load_octamer_params(params_path)
    order = np.arange(N_OCT)
    if sort_flanking:
        # flanking-inwards: sort key reads bases outside-in
        # (0,7,1,6,2,5,3,4)
        def key(i):
            b = [(i >> s) & 3 for s in range(14, -2, -2)]
            return tuple(b[j] for j in (0, 7, 1, 6, 2, 5, 3, 4))

        order = np.asarray(sorted(order.tolist(), key=key))
    with open(outpath, "w") as f:
        f.write('"Octamer",' +
                ",".join(f'"{n}"' for n in OCT_PARAM_NAMES) + "\n")
        for i in order.tolist():
            f.write(f'"{idx_to_oligo(i, 8)}",' +
                    ",".join(f"{v:.4f}" for v in table[i]) + "\n")
    return N_OCT


def gen_nuc_stats(bkg_path: str, outpath: str,
                  sample_path: str | None = None, bkgdyadofs: int = 73,
                  smpldyadofs: int = 73, winddyad: int = 5) -> int:
    """Sample-vs-background dyad overlap stats (gennucstats.cpp:109-117):
    mode 0 emits the background dyad per-chrom distribution; with a
    sample file, counts sample dyads matching a background dyad within
    +/- winddyad."""
    bkg: dict[str, np.ndarray] = {}
    for chrom, start, _e, strand in _read_loci(bkg_path):
        d = start + (bkgdyadofs if strand == "+" else -bkgdyadofs)
        bkg.setdefault(chrom, []).append(d)
    bkg = {c: np.unique(np.asarray(v)) for c, v in bkg.items()}

    with open(outpath, "w") as f:
        if sample_path is None:
            f.write('"Chrom","NumDyads","MeanSpacing"\n')
            for chrom in sorted(bkg):
                d = bkg[chrom]
                spacing = float(np.diff(d).mean()) if d.size > 1 else 0.0
                f.write(f'"{chrom}",{d.size},{spacing:.2f}\n')
            return sum(v.size for v in bkg.values())
        matched = total = 0
        for chrom, start, _e, strand in _read_loci(sample_path):
            d = start + (smpldyadofs if strand == "+" else -smpldyadofs)
            total += 1
            b = bkg.get(chrom)
            if b is not None and b.size:
                j = np.searchsorted(b, d)
                near = [b[k] for k in (j - 1, j) if 0 <= k < b.size]
                if near and min(abs(d - x) for x in near) <= winddyad:
                    matched += 1
        f.write('"TotalSample","Matched","PropMatched"\n')
        f.write(f"{total},{matched},"
                f"{matched / total if total else 0.0:.6f}\n")
    return total


def gen_composition(genome_path: str, outpath: str, nmer: int = 2,
                    per_chrom: bool = True) -> int:
    """Oligo-composition distributions over a genome
    (gencomposition.cpp): counts every N-mer per chromosome (and the
    genome total), CSV rows "chrom","oligo",count,freq."""
    counts: list[tuple[str, np.ndarray]] = []
    tot = np.zeros(4 ** nmer, dtype=np.int64)
    for chrom, codes in _load_genome(genome_path).items():
        idx = oligo_indices(codes, nmer)
        c = np.bincount(idx[idx >= 0], minlength=4 ** nmer)
        tot += c
        if per_chrom:
            counts.append((chrom, c))
    counts.append(("genome", tot))
    n = 0
    with open(outpath, "w") as f:
        f.write('"Chrom","Oligo","Count","Freq"\n')
        for chrom, c in counts:
            denom = max(int(c.sum()), 1)
            for i in range(4 ** nmer):
                f.write(f'"{chrom}","{idx_to_oligo(i, nmer)}",{c[i]},'
                        f"{c[i] / denom:.8f}\n")
                n += 1
    return n


# ------------------------------------------------------------- centroids ---


def gen_centroid_metrics(algn_path: str, outpath: str, nmer: int = 5,
                         ref_species: str | None = None) -> int:
    """Oligo-centred fixation counts over an .algn multialignment
    (gencentroidmetrics.cpp mode 0): for every ref-species position
    with a full N-mer context, count whether the centre base is fixed
    (identical in all aligned rows) vs substituted. CSV rows
    "oligo",total,fixed per oligo (the centroid-parameter intermediate
    consumed by proccentroids; libbiokanga/Centroid.h tsCentroidParam)."""
    from .converters3 import load_biomultialign

    assert nmer % 2 == 1 and nmer <= 13, "nmer must be odd, <= 13"
    _, blocks = load_biomultialign(algn_path)
    lut = np.full(256, 4, dtype=np.int8)
    for i, ch in enumerate("ACGT"):
        lut[ord(ch)] = i
        lut[ord(ch.lower())] = i
    total = np.zeros(4 ** nmer, dtype=np.int64)
    fixed = np.zeros(4 ** nmer, dtype=np.int64)
    half = nmer // 2
    for rows in blocks:
        if len(rows) < 2:
            continue
        ref = rows[0]
        if ref_species and not ref[0].startswith(ref_species):
            ref = next((r for r in rows if r[0].startswith(ref_species)),
                       None)
            if ref is None:
                continue
        ref_codes = lut[np.frombuffer(ref[5].encode(), dtype=np.uint8)]
        others = [lut[np.frombuffer(r[5].encode(), dtype=np.uint8)]
                  for r in rows if r is not ref]
        idx = oligo_indices(ref_codes, nmer)
        centre = np.arange(idx.size) + half
        same = np.ones(idx.size, dtype=bool)
        for o in others:
            same &= (o[centre] == ref_codes[centre]) & (o[centre] < 4)
        ok = idx >= 0
        total += np.bincount(idx[ok], minlength=4 ** nmer)
        fx = ok & same
        fixed += np.bincount(idx[fx], minlength=4 ** nmer)
    n = 0
    with open(outpath, "w") as f:
        f.write('"Oligo","Total","Fixed"\n')
        for i in range(4 ** nmer):
            if total[i]:
                f.write(f'"{idx_to_oligo(i, nmer)}",{total[i]},'
                        f"{fixed[i]}\n")
                n += 1
    return n


def proc_centroids(inpath: str, outpath: str, mode: int = 0) -> int:
    """Reduce gencentroidmetrics counts into centroid fixation
    probabilities (proccentroids.cpp modes; Centroid.h cMaxProb100Int
    scaling): per-oligo P(fixed) scaled to 0..10000."""
    rows = []
    with open(inpath) as f:
        for line in f:
            parts = [p.strip().strip('"') for p in line.strip().split(",")]
            if len(parts) < 3:
                continue
            try:
                rows.append((parts[0], int(parts[1]), int(parts[2])))
            except ValueError:
                continue
    n = 0
    with open(outpath, "w") as f:
        f.write('"Oligo","Total","Fixed","FixProb10k"\n')
        for oligo, tot, fx in rows:
            prob = int(round(10000 * fx / tot)) if tot else 0
            f.write(f'"{oligo}",{tot},{fx},{prob}\n')
            n += 1
    return n
