"""Smoke test of the PyTorch port (biokanga_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. print the card (nvidia-smi name and power limit) and the versions;
  2. build the CUDA kernels from biokanga_tpu_torch/csrc;
  3. hold the align kernels against their plain torch versions on the
     card, at the shapes the align path gives them (the sorts also at
     every width of their dispatch: one warp a row up to 1,024 values or
     512 pairs, one block a row up to 32,768, a scratch row past that, the
     rescue ladder's dedup rows of reads up to 4,096 bp; the pair sort
     past 16,384 pairs, the sharded multi-hit union's rows, at 16,385,
     16,500 and 65,536 pairs), and time both;
     the sorts beside torch.sort and their bounds at the SE and fused PE
     shapes and at the wide rows; the extension also on every case of
     tests/extend_edge_cases.py and on a 100,000-contig genome;
  4. index the 4.6 Mbp genome with `python -m biokanga_tpu_torch index`
     (called in process) from a FASTA it writes and require the arrays
     of build_index; align 262,144 simulated 100 bp reads against it with
     `python -m biokanga_tpu_torch align --device cuda`, check that every
     align kernel was launched and that >= 99% of the reads map uniquely
     to their simulated origin;
  5. align the first 4,096 reads with --device cpu and --device cuda and
     require byte-identical SAM, also against the big run's records, and
     the same on a repeat genome that drives every engine stage, and on
     500 bp reads from a 2 kb repeat whose rescue rows pass 32,768 values;
  6. time the align engine alone on the 262,144 reads;
  7. hold the Smith-Waterman kernels (banded_sw_moves, banded_sw_score)
     and the traceback decode (sw_trace) against their plain versions at
     error-correction shapes (64 pairs of 10,240 bases, W = 96) and on
     the tests' edge cases (decode planes with long LEFT runs and climbs
     out of the band; scores near and past 2**15), time each at one SW
     chunk (1,024 pairs) and at the EC cell's chunk size, with the
     decode's dependent-chain floor; the same at W = 256 and 320 (one
     block a pair), checked on 16 pairs and timed at their EC chunks,
     and at W = 4,096 and 15,000 (the band in segments, its state row in
     shared and in device memory), checked and timed on 4 pairs of
     256 bases;
     then score one 100 kb noisy pair with banded_sw_score, as the JAX
     package's only caller of that kernel (scripts/bench_longread.py)
     does;
  8. correct 24 noisy 1.5 kb reads with `python -m biokanga_tpu_torch
     ecreads --rounds 2` with --device cpu and --device cuda and require
     byte-identical FASTA, at the default band and with --sw-band 256
     (the --device cpu runs are child processes that go on beside phases
     9-13 and are compared after phase 13);
  9. correct the error-correction head-to-head read set (500 x 10 kb CLR
     reads of a 200 kb genome, scripts/bench_ec_headtohead.py) with the
     CLI defaults on the card and require 32-mer recovery >= 0.99;
 10. hold the gather checksum kernel (stream_gather_consume) against
     its plain version at three table sizes (2.3 MB, one region; 128 MB,
     five regions of half the L2; 2,048 MB, one region past n = R;
     random and sorted indices), time it beside its bound and the floor
     of a gather in index order, then run the gather probe
     (scripts/probe_stream_gather_torch.py) over its seven sizes;
 11. align 262,144 simulated pairs of 2 x 100 bp (inserts 200-500) against
     the same genome with `align -i r1.fq -u r2.fq -d 100 -D 600 --device
     cuda`, check that every align kernel was launched and that >= 99% of
     the proper pairs have both mates at their simulated origin;
 12. align the first 4,096 pairs, and 2,048 pairs of 2 x 150 bp from the
     repeat genome (with --peinsertdist), with --device cpu and --device
     cuda and require byte-identical SAM and CSV; the repeat pairs must
     reach the orphan rescue and rescue at least one mate on the card;
 13. time the paired-end engine alone on the 262,144 pairs, with its
     decomposition: full path, pipelined as the CLI drives it,
     launch-only, and the host's pairing after the device has drained.
 14. the SE options cell, a bacterial resequencing run with variant
     calling: 1,048,576 reads of 100 bp (22.8x) from a sample of the
     4.6 Mbp genome with a SNP planted every 5 kb, 5% of them carrying a
     micro-indel, 5% a splice junction (three reads an event), 2% a junk
     tail; `align -C 50 -a 10 -A 50000 -O --snpvcf --disnp --trisnp
     --snpcentroid --stats --device cuda`, with kernels #1-#3 launched,
     >= 90% of the planted SNPs at depth >= 10 called with their base,
     <= 10% of the calls off a planted locus (a call in the 80 bases
     past an indel or junction site, where the ungapped pileup shifts
     bases, is counted apart), >= 80% of the junk-tailed reads and of
     the indel and junction reads whose true diagonals are among the 24
     lowest seed diagonals of their strand (the scans' candidates, found
     apart from the port in numpy from the genome's 9-mers) placed at
     their origin with their CIGAR operation (the share over all such
     reads is printed, with no bar: on this genome the JAX package's
     candidate cap drops most of them, ROADMAP.md queue 3);
     its wall and the engine, fall-through, scan, chimeric, pileup,
     call_snps and SAM parts of it;
 15. on a 50 kb genome with 40 planted SNPs and 10,000 reads: phase 14's
     gates over all reads on the card's run, the SAM
     and the six side files of those options, then BAM, BAI and the -q
     rows of a run with -x -y -k --min-accept-len --minflankexacts
     --pcrprimersubs --lociconstraints -Y --checkpoint-dir (once on the
     CPU, twice on the card, the second resuming), and a PE BAM, each
     byte for byte between --device cpu and --device cuda;
 16. the chunked CLI: `index --chunks 4 --chunk-overlap 2048` of the 4.6
     Mbp genome, then 65,536 reads of phase 14's kind from the SNP sample
     (seed 16) with `align -a 10 -A 50000 -O`, and 65,536 pairs from it
     with `align -u -d 100 -D 600 --peinsertdist`, with --device cpu
     (child processes) and twice with --device cuda, kernels #1-#3
     counted in each: the chunks resident (uploaded once, one engine a
     chunk; the PE run's blocks through select_chunk and merge_chunks,
     counted), and cycling through one engine (the aligner told the
     index does not fit; neither kernel runs there, nor on the SE run,
     which streams blocks chunk by chunk); each card run's SAM and SNP
     CSV byte for byte against the CPU's, and no insert CSV from any, as
     from the JAX CLI's chunked branch;
 17. long reads: 1,024 reads of 10,000 bp (past the packed extension's
     4,096) through `align` on the 4.6 Mbp index, the dense extension
     path, each of its calls timed with its peak memory, the SAM byte for
     byte with a --device cpu child's and every read at its origin; then
     LongReadAligner on 64 reads of 100 kb (30 substitutions each, every
     other one reverse-complemented) on the card and on the CPU, dicts
     equal and every read at its origin;
 18. the big genome: 3.0 Gbp of random sequence in 24 entries made on the
     card from a seed (scripts/bench_3gbp.py's layout), 262,144 pairs of
     2 x 100 bp (1% substitutions, inserts 200-500; every 97th pair with
     a seed-dead second mate), DeviceBuildChunkedAligner(max_chunk=
     256,000,000, overlap=2,048, lut_bases=13): 12 chunks each built on
     the card twice, two_level_chunk_sweep over blocks of 32,768, then
     classification and the orphan rescue grouped by the anchor's chunk;
     the set-up, each chunk build, the fast and classic cycles, the
     rescue, pairs/s and the peak device memory, with kernels #1-#3
     counted; >= 99% of pairs proper, >= 99% of those with both mates at
     their origin, and mates placed past 2^31;
 19. several ranks, four processes on this card joined over gloo
     (parallel/dist.py): the SE cell of phase 4 through
     ShardedAligner.align at (dp, sp) = (2, 2) and (1, 4), every field
     equal to AlignEngine.align_with_rescue (loci int64), with reads/s
     and each rank's peak device memory from that pass (after a warm
     batch), the gather's ms a batch from a second pass that times it,
     and a third uninstrumented pass; phase
     16's 65,536 options reads through align_extended (-a 10 -A 50000)
     and the sharded pileup at (1, 2), equal to ChunkedExtendedAligner
     on the same two chunks and PileupAccumulator; the EC cell through
     ec_reads with two ranks, every rank's FASTA equal to phase 9's byte
     for byte; then `swservice -n 2` on tie-rich pairs (gloo on this
     card) whose CSV equals a --device cpu run's, its ranks' kernel
     launches read from their stderr, and, in this process, a world of
     one over NCCL giving the SE cell equal to AlignEngine.
 20. hold the windowed extension (hamming_extend_packed_win, #3w, the
     assembler's overlap verify) against its plain version on every case
     of tests/win_edge_cases.py (windows across an entry cut, win = 0,
     windows past the genome's end, Ns in reads and genome) and at the
     sweep's (4,096, 192) for W = 10, 64 and 256, each timed beside its
     plain version and its bound;
 21. the bisulfite cell: `index -m 1` of the 4.6 Mbp genome, 262,144 x
     100 bp bisulfite reads (tests/bs_reads.py: half top, half bottom
     strand, C->T at 0.98) through `align --device cuda`: >= 0.9375 of
     the reads placed uniquely are at origin on the right strand, and
     the share of all reads so placed is printed (no bar: the JAX
     package's core length leaves most reads without a hit at this size,
     ROADMAP.md queue 3); the same on a 0.5 Mbp genome with 65,536 reads,
     where >= 0.9375 of all reads must be so placed; the CLI wall and
     BisulfiteAligner's reads/s; the first 4,096 reads' SAM byte for byte
     from a --device cpu child;
 22. the colorspace cell: `index -C`, 262,144 x 75 bp reads at 1%
     substitutions as .csfasta colours (primer T), >= 0.9667 unique at
     origin; the same timings and CPU-against-card SAM check;
 23. PacBio: phase 9's EC cell through `ecreads --checkpoint-dir`, once
     unbroken and once resumed after half its group files were deleted,
     both FASTAs equal to an unbroken `--rounds 1` run; `contigs` on
     phase 9's corrected reads, --device cuda against a --device cpu
     child, with its wall and N50;
 24. the assembly cell (BENCH_ASM.json's 0.5mbp_30x_r4: 50,000 error-free
     pairs of 2 x 150 bp from a 0.5 Mbp genome) through `assemb` on the
     card: wall, passes, contigs, N50, launches of #1-#3 and #3w, peak
     device memory, and every contig an exact genome substring; then
     `assemb` on the 20 kb, 2,400-read case of
     tests/test_assembly_scaled.py, `scaffold` and `pescaffold` on two
     contigs, each card against a --device cpu child byte for byte.
 25. uhamming: kernel #7 (uhamming_sweep) against its plain version,
     exact, on a 6 kb genome of three entries (one of 80 bp, short of K
     100) with N runs, exact, near and reverse-complement repeats and a
     300 bp palindrome (its centred window reads 0 at every K), K 24, 32,
     100 and 300, both sweeps and a mode-2 range, and at 65,536 bp, timed
     with its bound; `uhamming -m 0` on a 20 kb genome, card against a
     --device cpu child (.hmg arrays and CSV); `-m 3` of two `-m 2`
     partials equal to one `-m 2` run over their union; `-m 0 -K 100` on
     a 1 Mbp genome with planted repeats (each reads at most its
     substitutions), timed through the CLI (its sweep between CUDA
     events) against its bound; `-m 2 -n 64 -N 1` on the 4.6 Mbp genome;
 26. blitz: 2,000 transcripts of 1-4 kb at 3% substitutions from both
     strands (a third spliced, 1-20 kb introns) and the bar queries of
     tests/test_blitz.py against phase 4's index through the CLI on the
     card: the bars (exact and reverse queries at their origin on their
     strand, spliced ones in one path across the intron, unrelated ones
     without a path), queries/s, the share whose best path is at its
     origin; kernel #8 (blitz_chain) exact against its plain version on
     every chain batch of the CLI run and of the 1 Mbp query and on 4
     wide chains of 16,384 blocks (past the shared memory), timed with
     its bound and its dependent-chain floor (one step's latency measured
     by a one-warp probe kernel) on the CLI's first batch and on the wide
     set; PSL of 256 queries and PSLX, BED and MAF of 16
     against --device cpu children; the 1 Mbp rearranged query of
     tests/test_blitz_scale.py with its bars;
 27. `mergeoverlaps -m 0` and `-m 2` on 1,048,576 amplicon pairs of 2 x
     150 bp (plate barcodes, inserts 180-280, 1% substitutions): pairs/s,
     merged and welled shares, the first 65,536 pairs against --device
     cpu children; `findapproxmatches` of 256 guides of 23 bp (-s 2) on
     the 4.6 Mbp genome, every origin found, and on its first 256 kb
     against a --device cpu child; nw_score_batch of 4,096 pairs of 150 x
     150, card against CPU;
 28. the flagship flow in the port alone: `simreads -H <phase 25's .hmg>
     -N 1000 -X 0.05 -g dyn --pe` (65,536 pairs) on the 1 Mbp genome,
     `index`, `align -u` on the card: proper-pair and at-origin shares,
     split by the source window's min-Hamming (0 against > 0);
 29. read preparation: 262,144 pairs of 2 x 100 bp from the 4.6 Mbp
     genome (tests/readprep_reads.py: 3% adapter read-through, 1% pairs
     from a 6 kb cloning vector, 5% exact and 1% near duplicates) through
     `filter -c --near-dedupe` and `ngsqc -c` on the card, whose vector
     screen aligns every block against the vectors (#1-#3): the walls,
     the screen's share, the card's idle share of the filter wall,
     launches, >= 0.99 of the vector pairs rejected and >= 0.95 of the
     adapter reads trimmed; the screen's engine result on one block
     equal on the card and the CPU; the first 16,384 pairs (two full
     blocks) and 8,292 pairs (a partial block) byte for byte against
     --device cpu children;
 30. chromatin structure: a seeded genome of S. cerevisiae R64's 16
     chromosome lengths (12.07 Mbp) and a full seeded octamer table
     through `predconfnucs -M 0`, and 100,000 cores of 147 bp from it
     through `genstructprofile --param minorgroove` and `--param twist`,
     on the card: the walls, the gathers' and call_dyads' seconds, the
     gathers each run launched; conformation_profile on chromosome IV
     on the card equal to the CPU's exactly, its gather timed beside its
     bound; the three outputs byte for byte against --device cpu
     children;
 31. the seed stage's kernels (seed_rows, dedup_pack) against their
     plain versions on both strands at GRCh38's chunk (237,561,344
     bases, LUT 13: the fast and the classic pass) and at E. coli's fast
     pass, 131,072 reads of 100 bp, each timed beside its plain op chain
     and its bytes bound;
 32. the chunked index's select and merge kernels (select_chunk,
     merge_chunks) against their plain versions at GRCh38's block, 13
     chunks of 131,072 rows: seeded fast and classic passes whose loci
     are strided columns, with and without a fast pass, rows for the
     rescue ladder in every chunk, loci past 2^31, keys tied across
     chunks, and the flag of a locus past 2^42; each timed beside its
     plain version (the select's on the host, as the chunked path ran
     it, the merge's on the card) and its bytes bound.
Phases 16 and 17 run on the card right after phase 6, and 21-22 after
them; their --device cpu child processes go on beside the phases that
follow and are compared after phase 18 (16-17) and at the end (21-29).
Phase 20 runs right after phase 3, 31 and 32 after 20, 23 after phase 13, 24
after 18, 25-29 after 24, and 30 last, after the CPU runs of 21-29 are
compared.  Phase 3 also holds the extension kernel at the orphan
rescue's shape (2,048 windows of 500 consecutive loci, some off the
genome's ends).  The kernels line gives #1-#3 and the seed kernels
their launches on every path above, select_chunk and merge_chunks
theirs on phase 16's resident PE run, #3w its launches on the assembly
cell, #7 on phase 25's 1 Mbp and node sweeps, #8 on phase 26's CLI run,
every kernel its launches on phase
19's sharded, EC-mesh and swservice paths (summed over the ranks), and
on the paths of phases 21-24, 28 and 29 where it ran.
The last two lines are a JSON object per kernel and the result line.
Exits non-zero without CUDA or outside the repository.  Needs one card.

    python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
I32_MAX = 2**31 - 1

GENOME_BP = 4_600_000
N_READS = 262_144
READ_LEN = 100
BATCH = 65_536
N_PARITY = 4_096
MIN_TRUE_FRACTION = 0.99

# paired ends: the bench.py PE configuration
N_PAIRS = 262_144
PE_INSERT = (200, 500)
PE_FLAGS = ["-d", "100", "-D", "600"]
N_REPEAT_PAIRS = 2_048
RESCUE_SHAPE = (2_048, 500)            # orphans x consecutive loci
# dedup rows past the block sort: (1, 32,769), the ladder's step 2 at
# 500 bp (40 cores x 1,024) and at 4,096 bp with -m ultra (369 x 1,024),
# the widest row whose merges take one pass a level, and two past it
WIDE_SORT_SHAPES = ((1, 32_769), (512, 40_960), (512, 377_856),
                    (2, 1 << 21), (1, (1 << 21) + 1), (1, 1 << 22))
LONG_READ_LEN = 500                    # phase 5's repeat reads
CONTIGS, CONTIG_LEN = 100_000, 1_000   # a draft assembly's entries

# the gather probe: table sizes held against the plain version here
GATHER_N = 6_291_456
# regions swept: 1 (the table inside one), 5 of half the L2, 1 (n < R)
GATHER_CHECK_MB = (2.3, 128.0, 2048.0)
GATHER_LINE_MB = 128.0                 # the size of the kernels line
# int32 operations a word of the checksum: an XOR and a byte sum (one
# IDP.4A against 0x01010101)
GATHER_OPS_PER_WORD = 2

# error correction: SW at EC shapes, and the head-to-head read set
SW_LA = 10_240
SW_W = 96
SW_CHECK_PAIRS = 64
SW_CHUNK_PAIRS = 1_024
WIDE_SW_BANDS = (256, 320)             # one block a pair
WIDE_SW_CHECK_PAIRS = 16
# past the band in registers: segments with the state row in shared
# memory (4,096) and in device memory (15,000), on short pairs
SEGMENT_SW_BANDS = (4_096, 15_000)
SEGMENT_SW_LA, SEGMENT_SW_PAIRS = 256, 4
LONG_PAIR_W = 255                      # bench_longread's band
EC_WIDE_BAND = 256
EC_PARITY_READS = 24                   # phase 8: noisy 1.5 kb reads
EC_READS, EC_READ_LEN, EC_GENOME_KB, EC_ERR, EC_SEED = 500, 10_000, 200, 0.07, 3
MIN_KMER_RECOVERY = 0.99

# single-end options (phases 14-15): a bacterial resequencing run with
# variant calling on the phase 4 genome (22.8x), and a small all-options
# case; the depth gate counts only the SNPs covered 10 times or more
OPT_READS = 1_048_576
OPT_SNP_EVERY = 5_000                  # one planted SNP per 5 kb (~920)
OPT_INDEL_SHARE, OPT_SPLICE_SHARE, OPT_JUNK_SHARE = 0.05, 0.05, 0.02
OPT_READS_PER_EVENT = 3                # see tests/options_reads.py
OPT_FLAGS = ["-C", "50", "-a", "10", "-A", "50000"]
OPT_MIN_DEPTH = 10                     # the gates' bars: tests/test_snp.py
OPT_MIN_RECALL = 0.90                  # :54 (18 of 20) and :66 (2 of ~20
OPT_MAX_OFF = 0.10                     # off a planted locus);
OPT_MIN_RECOVERY = 0.80                # tests/test_splice_indel.py:60,76,
#                                        107 and tests/test_multihit.py:100
# bases past an event's site where the ungapped pileup shifts the event
# reads' bases (a read's second segment is at most read length - 20)
OPT_EVENT_SHADOW = READ_LEN - 20
PARITY_GENOME = [("chr1", 30_000), ("chr2", 20_000)]
PARITY_READS = 10_000                  # 20x
PARITY_SNP_EVERY = 1_200               # 40 planted SNPs
PARITY_PAIRS = 2_000

# chunked CLI (phase 16): the SE options cell's sample through an index of
# four chunks, card against CPU
CHUNKED_CHUNKS = 4
CHUNKED_SE_READS = 65_536
CHUNKED_PE_PAIRS = 65_536
CHUNKED_SE_FLAGS = ["-a", "10", "-A", "50000"]
CHUNK_PATHS = ("resident", "cycling")     # the chunked aligner's two paths
# long reads (phase 17): the dense extension, then segments and stitching
LONG_READS, LONG_LEN, LONG_SUB_RATE = 1_024, 10_000, 0.002
LR_READS, LR_LEN, LR_SUBS = 64, 100_000, 30
# the big genome (phase 18): scripts/bench_3gbp.py's layout and chunks
BIG_GENOME_BP = 3_000_000_000
BIG_ENTRIES = 24
BIG_MAX_CHUNK = 256_000_000
BIG_OVERLAP = 2_048
BIG_LUT_BASES = 13
BIG_CHUNKS = 12
BIG_PAIRS = 262_144
BIG_BLOCK = 32_768
BIG_ORPHAN_EVERY = 97

# several ranks (phase 19): processes on cuda:0 over gloo; the SE cell at
# two layouts, the options sample of phase 16 at (1, 2), the EC cell with
# two ranks, swservice -n 2 on tie-rich pairs, and a world of one over NCCL
RANKS = 4
RANK_LAYOUTS = ((2, 2), (1, 4))
RANK_OPTIONS_LAYOUT = (1, 2)
# the chunked index of each sp width: phase 16's `index --chunks 4`, and
# two chunks built in phase 19
RANK_INDEX = {2: "ck2.npz", 4: "ck.npz"}
EC_RANKS = 2
SWS_PROBES, SWS_LEN, SWS_BAND = 24, 400, 32   # 24 x 24 cross pairs

# the pair sort past its block path (phase 3): the sharded multi-hit
# union's rows at 3,277 sp ranks (-R 5), 33 (-R 500), and four times that
WIDE_SORT2_SHAPES = ((512, 16_385), (512, 16_500), (64, 65_536))
# the windowed extension (phase 20): the assembler's sweep batch of 4,096
# queries, its candidate cap and the word counts of 150 bp reads and of
# contigs past 1 kb and at the 4,096-base verify cap; integer operations
# a covered word (funnel shift, XOR, OR, fold, mask, popcount, add, lane
# mask; two more with an N plane) and a candidate (loads, flags, range)
WIN_B, WIN_C, WIN_WORDS = 4_096, 192, (10, 64, 256)
WIN_OPS_PER_WORD, WIN_OPS_PER_CAND = 12, 20
# bisulfite and colorspace cells (phases 21-22) on the phase 4 genome:
# the bars are the JAX tests' 60/64 (tests/test_bisulfite.py:62) and
# 290/300 (tests/test_colorspace.py:67); 75 bp is SOLiD 5500's fragment
BS_READS, MIN_BS_SHARE = 262_144, 0.9375
BS_SMALL_BP, BS_SMALL_READS = 500_000, 65_536
CS_READS, CS_READ_LEN, MIN_CS_SHARE = 262_144, 75, 0.9667
# the assembly cell (phase 24): BENCH_ASM.json's row 0.5mbp_30x_r4
ASM_GENOME_BP, ASM_PAIRS = 500_000, 50_000
# uhamming (phase 25): the window lengths checked (a multiple of the word,
# and past 255 where the counts saturate), the check genome's entries (two
# of 3 kb and one of 80 bp, short of K 100) and its palindrome (a window of
# every even K up to 300 that is its own reverse complement: the cross
# sweep's self-pair), the kernels line's genome, the CLI parity genome,
# the timed 1 Mbp genome with its planted repeats (source, copy,
# substitutions), the node partition of the SE genome; integer operations
# a pair of windows: the mismatch test of 2-bit packed words (3 a 32
# bases), the window's slide (2), the pair's mask (1) and the two minima
# (both windows' loci; the cross sweep's distances are symmetric,
# Ham(g_i, rc g_k) = Ham(g_k, rc g_i), so it needs each unordered pair once)
UH_KS, UH_K = (24, 32, 100, 300), 100
UH_CHECK = [("e1", 3_000), ("e2", 80), ("e3", 3_000)]
UH_PALINDROME = (2_400, 300)
UH_LINE_BP, UH_CLI_BP, UH_BP, UH_NODES = 65_536, 20_000, 1_000_000, 64
UH_REPEAT_LEN = 600
UH_REPEATS = ((100_000, 700_000, 0), (200_000, 800_000, 1),
              (300_000, 900_000, 3))
UH_OPS_PAIR = 3 / 32 + 2 + 1 + 2
# blitz (phase 26): transcripts and ESTs mapped to a bacterial genome; the
# bars of tests/test_blitz.py and the 1 Mbp query of
# tests/test_blitz_scale.py; integer operations of the chain DP: a valid
# block's ends (2), once; an (i, j < i) pair's overlap and gap tests (4),
# gap (2), gap cost (5), candidate (1) and argmax (2); a wide set of long
# collinear chains (a long or repetitive query's) past the shared memory
BZ_QUERIES, BZ_LEN, BZ_SUB, BZ_INTRON = 2_000, (1_000, 4_000), 0.03, (
    1_000, 20_000)
BZ_BARS, BZ_PARITY_Q, BZ_FMT_Q = 16, 256, 16
BZ_BIG = ((100_000, 600_000), (1_200_000, 1_700_000))
BZ_OPS_PER_BLOCK, BZ_OPS_PER_PAIR = 2, 14
BZ_WIDE = (4, 16_384)
# the other device tools (phase 27): amplicon pairs, guides, NW pairs
MO_PAIRS, MO_LEN, MO_INSERT, MO_SUB = 1_048_576, 150, (180, 280), 0.01
MO_PARITY = 65_536
FA_QUERIES, FA_LEN, FA_MM, FA_PARITY_BP = 256, 23, 2, 262_144
NW_PAIRS, NW_LEN = 4_096, 150
# the flagship flow in the port alone (phase 28)
FL_PAIRS = 65_536
# read preparation (phase 29): tests/readprep_reads.py's TruSeq-style PE
# library from the 4.6 Mbp genome; the first two blocks of `filter`, and
# a block and 100 pairs, against --device cpu children
RP_PAIRS, RP_SEED = N_READS, 29
RP_PARITY = (16_384, 8_292)
# chromatin structure (phase 30): a seeded genome of S. cerevisiae R64's
# 16 chromosome lengths (12.07 Mbp, tests/chromatin_inputs.py), a full
# seeded octamer table, and nucleosome cores of 147 bp from the genome
CR_SEED, CR_CORES, CR_CHECK_CHROM = 30, 100_000, "IV"

# least-time bounds (NVIDIA H100 SXM data sheet and Hopper white paper)
HBM_BYTES_PER_S = 3.35e12
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per band cell of the SW recurrence: E (2 adds, 1 max),
# match test and select (2), Hd (1), H0 (4 max), lazy F (3), H (2 max),
# band masks (2), row max (1) = 18; the move code adds 3 compares, 3
# selects and a shift-or (8)
SW_OPS_PER_CELL = 18
SW_MOVES_OPS_PER_CELL = 26
# the decode's dependent chain: one row's step is a shuffle (~24 cycles)
# and some 6 dependent integer operations (subtract, select, mask, add,
# compare, select) of ~4 cycles
TRACE_STEP_CYCLES = 48
SM_CLOCK_HZ = 1.98e9
# #8's dependent chain: step i waits for f[i-1], so a step is at least
# one 32-lane max and the register update around it; the kernel
# blitz_chain_step_probe runs that many dependent steps in one warp, and
# its time at the two counts gives one step's latency on this card
BZ_PROBE_STEPS = (1 << 16, 1 << 20)


def _timed_ms(fn, iters: int = 10) -> float:
    """Mean device time of fn() over `iters` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _once_ms(fn):
    """(fn(), its device time in ms) of one call."""
    import torch

    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def _max_abs_err(got, want) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} "
                             f"!= {tuple(want.shape)} {want.dtype}")
    if not got.numel():
        return 0
    return int((got.long() - want.long()).abs().max().item())


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations") on one H100."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def _sort_values(rng, B, C):
    """int32 values: bit 31 set in about half, heavy ties, INT32_MAX pad."""
    x = rng.integers(-2**31, 2**31, size=(B, C), dtype=np.int64)
    x = x.astype(np.int32)
    r = rng.random((B, C))
    x[r < 0.2] = rng.integers(0, 64, size=int((r < 0.2).sum()))
    x[r > 0.7] = I32_MAX
    return x


def _network_cx(B: int, C: int) -> int:
    """Compare-exchanges of the bitonic network csrc/sort_rows.cu runs on
    (B, C): P/2 a stage, log2 P (log2 P + 1) / 2 stages, P = 2^ceil(log2 C)
    (at least 32, a warp's width)."""
    k = max(5, math.ceil(math.log2(C)))
    return B * (2**k // 2) * k * (k + 1) // 2


def _sort_timing(inputs) -> dict:
    """Kernel, plain and torch.sort times of sort_rows (one input) or
    sort2_rows (key, val) on card tensors, with the bound at their shape."""
    import torch

    from biokanga_tpu_torch.ops import sort

    B, C = inputs[0].shape
    if len(inputs) == 1:
        kernel, plain = sort.sort_rows, sort.sort_rows_plain
        keys = inputs[0]
    else:
        key, val = inputs
        kernel, plain = sort.sort2_rows, sort.sort2_rows_plain
        # the one torch call at the heart of the two-key sort: int64 keys
        # packed beforehand as (key, val) in high and low words
        keys = key.to(torch.int64) * 2**32 + (val.to(torch.int64) + 2**31)
    return dict(ms=_timed_ms(lambda: kernel(*inputs)),
                plain_ms=_timed_ms(lambda: plain(*inputs)),
                library_ms=_timed_ms(lambda: torch.sort(keys, dim=1)),
                bound=_bound(2 * _nbytes(*inputs),
                             B * C * math.ceil(math.log2(C))),
                network_cx=_network_cx(B, C))


def check_sorts(dev, rng):
    """sort_rows / sort2_rows against their plain versions on the card, at
    widths that take every path of the kernels' dispatch (one warp a row
    up to 1,024 values or 512 pairs, one block a row past that), then
    timed at the fast pass's shapes, SE and fused PE."""
    import torch

    from biokanga_tpu_torch.ops import sort

    err = {"sort_rows": 0, "sort2_rows": 0}
    for B, C in ((65_536, 480), (2 * BATCH, 480), (65_536, 384),
                 (65_536, 512), (2_048, 2_048), (512, 8_192), (512, 24_576),
                 (7, 1_000), (1, 1), (7, 31), (25, 32), (33, 33), (7, 64),
                 (25, 65), (33, 128), (4_097, 129), (65, 256), (4_097, 257),
                 (65, 513), (65_536, 720), (4_097, 1_024), (4_097, 1_025),
                 (16_385, 1_440)):
        x = torch.from_numpy(_sort_values(rng, B, C)).to(dev)
        err["sort_rows"] = max(err["sort_rows"], _max_abs_err(
            sort.sort_rows(x), sort.sort_rows_plain(x)))
    for B, C in ((65_536, 192), (2 * BATCH, 192), (65_536, 512),
                 (16_384, 384), (2_048, 2_048), (512, 3_072), (512, 4_096),
                 (7, 1_000), (1, 1), (7, 32), (25, 33), (33, 64),
                 (4_097, 65), (65, 128), (7, 129), (25, 256), (33, 257),
                 (4_097, 513)):
        key = _sort_values(rng, B, C)
        key = np.where(key == I32_MAX, key,
                       rng.integers(0, 512, size=(B, C))).astype(np.int32)
        key, val = (torch.from_numpy(key).to(dev),
                    torch.from_numpy(_sort_values(rng, B, C)).to(dev))
        (gk, gv), (wk, wv) = (sort.sort2_rows(key, val),
                              sort.sort2_rows_plain(key, val))
        err["sort2_rows"] = max(err["sort2_rows"], _max_abs_err(gk, wk),
                                _max_abs_err(gv, wv))
    if any(err.values()):
        raise AssertionError(f"sort kernels disagree with torch.sort: {err}")
    wide = _check_wide_sort(dev)
    err["sort_rows"] = max(err["sort_rows"], wide.pop("err"))
    wide2 = _check_wide_sort2(dev)
    err["sort2_rows"] = max(err["sort2_rows"], wide2.pop("err"))

    # time at the fast pass's shapes: B = 65,536 reads of 100 bp, and the
    # paired-end path's fused batches of both mates, twice the rows
    timing = {}
    for B in (BATCH, 2 * BATCH):
        x = torch.from_numpy(_sort_values(rng, B, 480)).to(dev)
        key = torch.from_numpy(
            rng.integers(0, 512, size=(B, 192), dtype=np.int32)).to(dev)
        val = torch.from_numpy(_sort_values(rng, B, 192)).to(dev)
        for name, inputs, what in (("sort_rows", (x,), "480"),
                                   ("sort2_rows", (key, val), "192 pairs")):
            t = _sort_timing(inputs)
            print(f"{name} at ({B}, {what}): kernel {t['ms']:.4f} ms, plain "
                  f"torch {t['plain_ms']:.4f} ms, torch.sort "
                  f"{t['library_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms "
                  f"({t['bound'][1]}); network {t['network_cx']} "
                  f"compare-exchanges")
            if B == BATCH:
                timing[name] = t
            else:
                timing[name]["ms_fused_pe"] = t["ms"]
        del x, key, val
    timing["sort_rows"]["wide"] = wide
    timing["sort2_rows"]["wide"] = wide2
    return err, timing


def _wide_rows(dev, B, C, kind, seed):
    """(B, C) int32 rows on the card: random (bit 31 set in about half,
    30% INT32_MAX), all INT32_MAX, or a handful of values repeated."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "all_max":
        return torch.full((B, C), I32_MAX, dtype=torch.int32, device=dev)
    if kind == "dups":
        return torch.randint(-3, 4, (B, C), dtype=torch.int32, device=dev,
                             generator=gen)
    x = torch.randint(-2**31, 2**31 - 1, (B, C), dtype=torch.int32,
                      device=dev, generator=gen)
    pad = torch.rand((B, C), device=dev, generator=gen) < 0.3
    return x.masked_fill_(pad, I32_MAX)


def _check_wide_sort(dev) -> dict:
    """sort_rows past the block path (scratch rows in device memory) at
    WIDE_SORT_SHAPES, exactly, also off 16-byte alignment; timed at the
    rescue ladder's shapes.  Returns {"err": e, "BxC": timing, ...}."""
    import torch

    from biokanga_tpu_torch.ops import sort

    out = {"err": 0}
    for B, C in WIDE_SORT_SHAPES:
        for k, kind in enumerate(("random", "all_max", "dups")):
            x = _wide_rows(dev, B, C, kind, C + k)
            out["err"] = max(out["err"], _max_abs_err(
                sort.sort_rows(x), sort.sort_rows_plain(x)))
            if B > 1:
                y = x.reshape(-1)[1:1 + (B - 1) * C].view(B - 1, C)
                out["err"] = max(out["err"], _max_abs_err(
                    sort.sort_rows(y), sort.sort_rows_plain(y)))
            del x
    if out["err"]:
        raise AssertionError(f"wide sort_rows disagrees: {out['err']}")
    print(f"sort_rows past 32,768 values exact at {WIDE_SORT_SHAPES} on "
          f"random, all-INT32_MAX and duplicate rows")
    for B, C in WIDE_SORT_SHAPES[1:3]:
        x = _wide_rows(dev, B, C, "random", 7)
        t = _sort_timing((x,))
        out[f"{B}x{C}"] = dict(ms=t["ms"], plain_ms=t["plain_ms"],
                               library_ms=t["library_ms"],
                               bound_ms=t["bound"][0], bound_by=t["bound"][1])
        print(f"sort_rows at ({B}, {C}): kernel {t['ms']:.4f} ms, plain "
              f"torch {t['plain_ms']:.4f} ms, torch.sort "
              f"{t['library_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms "
              f"({t['bound'][1]})")
        del x
    torch.cuda.empty_cache()
    return out


def _extend_args(dev, rng, pg, genome, starts, L, B, C):
    """Reads of length <= L drawn from the genome with subs and Ns, and
    (B, C) loci: true origins, near misses, entry boundaries, invalid."""
    import torch

    from biokanga_tpu_torch.ops.extend_packed import pack_reads

    n = len(genome)
    lens = np.where(rng.random(B) < 0.3, L - rng.integers(1, 20, B), L)
    lens = lens.astype(np.int32)
    origin = rng.integers(0, n - L, size=B)
    reads = genome[origin[:, None] + np.arange(L)]
    sub = rng.random(reads.shape) < 0.03
    reads[sub] = (reads[sub] + 1) % 4
    reads[rng.random(reads.shape) < 0.01] = 4
    reads[np.arange(L)[None, :] >= lens[:, None]] = 4
    loci = origin[:, None] + rng.integers(-3, 4, size=(B, C))
    edge = rng.choice(starts[1:-1], size=(B, C)) + rng.integers(-L, L, (B, C))
    pick = rng.random((B, C))
    loci = np.where(pick < 0.3, edge, loci)
    loci = np.where(pick > 0.97, I32_MAX, loci)
    loci = np.where((pick > 0.94) & (pick <= 0.97), -5, loci)
    loci = np.where((pick > 0.91) & (pick <= 0.94), n - L // 2, loci)
    r = torch.from_numpy(reads).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    rc, rn = pack_reads(r, ln)
    return (pg, torch.from_numpy(starts.astype(np.int32)).to(dev),
            torch.from_numpy(loci.astype(np.int32)).to(dev),
            torch.from_numpy(rng.random((B, C)) < 0.9).to(dev), rc, rn, ln)


def contig_genome(rng):
    """A draft assembly: CONTIGS entries of CONTIG_LEN random bases."""
    n = CONTIGS * CONTIG_LEN
    genome = rng.integers(0, 4, size=n, dtype=np.int8)
    starts = np.arange(0, n + 1, CONTIG_LEN, dtype=np.int64)
    return genome, starts


def extend_runner(lib, a, out, stream):
    """A call of `lib`'s extension on hamming_extend_packed's arguments `a`
    (contiguous card tensors) into `out`; returns the CUDA error code."""
    pg, es, loci, valid, rc, rn, ln = a
    B, C = loci.shape
    ptrs = (pg.rows.data_ptr(),
            None if pg.n_rows is None else pg.n_rows.data_ptr(),
            pg.rows.shape[0], pg.length, es.data_ptr(), es.shape[0],
            loci.data_ptr(), valid.data_ptr(), rc.data_ptr(), rn.data_ptr(),
            ln.data_ptr(), out.data_ptr(), B, C, rc.shape[1], stream)
    return lambda: lib.hamming_extend_packed(*ptrs)


def _extend_kernel_ms(a) -> float:
    """Device time of the extension kernel on hamming_extend_packed's
    arguments `a`, called through its C entry point, so that the wrapper's
    host time (its checks, ~0.02-0.05 ms) cannot hide a shorter kernel."""
    import torch

    from biokanga_tpu_torch import kernels

    a = tuple(t.contiguous() if torch.is_tensor(t) else t for t in a)
    out = torch.empty(a[2].shape, dtype=torch.uint8, device=a[2].device)
    stream = torch.cuda.current_stream(a[2].device).cuda_stream
    return _timed_ms(extend_runner(kernels.library(), a, out, stream))


def _extend_ops(pg, es, loci, valid, ln, out) -> int:
    """Integer operations hamming_extend_packed needs on these inputs.
    Every candidate tests its flag (1).  A flagged one tests its range
    (2); one inside the genome searches the entry starts (2 a step, and
    the last compare).  One that passes all three counts the words of its
    read, ceil(len / 16) of them: a funnel shift, one LOP3 for the XOR
    and the OR of the read's N lanes, a shift and one LOP3 for the fold
    and the mask, __popc and an add (6); with the genome's N plane, its
    funnel shift and OR (2 more); then the clamp and the store (2)."""
    B, C = loci.shape
    last = loci.long() + ln.long()[:, None] - 1
    ranged = valid & (loci >= 0) & (last < pg.length)
    hit = out != 255
    words = ((ln.long() + 15) // 16)[:, None].expand(B, C)
    per_word = 8 if pg.has_n else 6
    steps = int(es.numel()).bit_length()
    return int(loci.numel() + 2 * int(valid.sum())
               + (2 * steps + 1) * int(ranged.sum())
               + per_word * int(words[hit].sum()) + 2 * int(hit.sum()))


def _check_extend_edges(dev) -> int:
    """hamming_extend_packed on every case of tests/extend_edge_cases.py
    (read lengths 1 to 4,096, N plane or none, 1 to 100,000 entries, loci
    off the genome, B = 1, odd C), also off 16-byte alignment."""
    import torch

    from biokanga_tpu_torch.ops import extend_packed as ep

    sys.path.insert(0, str(ROOT / "tests"))
    import extend_edge_cases as edges

    def off(t):                                # same values, 1 element on
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    err = 0
    for case in edges.cases():
        genome, starts, reads, lens, loci, valid = edges.extend_case(*case)
        pg = ep.pack_genome(genome, dev)
        ln = torch.from_numpy(lens).to(dev)
        rc, rn = ep.pack_reads(torch.from_numpy(reads).to(dev), ln)
        args = (pg, torch.from_numpy(starts.astype(np.int32)).to(dev),
                torch.from_numpy(loci).to(dev),
                torch.from_numpy(valid).to(dev), rc, rn, ln)
        want = ep.hamming_extend_packed_plain(*args)
        moved = ep.PackedGenome(off(pg.rows), None if pg.n_rows is None
                                else off(pg.n_rows), pg.length)
        err = max(err, _max_abs_err(ep.hamming_extend_packed(*args), want),
                  _max_abs_err(ep.hamming_extend_packed(
                      moved, *(off(t) for t in args[1:])), want))
    if err:
        raise AssertionError(f"hamming_extend_packed disagrees on the edge "
                             f"cases: {err}")
    print(f"hamming_extend_packed exact on the {len(edges.cases())} edge "
          f"cases, aligned and off 16-byte alignment")
    return err


def check_extend(dev, rng):
    """hamming_extend_packed against its plain version on the card."""
    import torch

    from biokanga_tpu_torch.ops import extend_packed as ep

    n = 1_000_000
    genome = rng.integers(0, 4, size=n, dtype=np.int8)
    genome[200_000:200_500] = 4                   # N run: the N plane is on
    genome[rng.random(n) < 0.001] = 4
    starts = np.array([0, 300_000, 700_000, 700_150, n], np.int64)
    pg = ep.pack_genome(genome, dev)
    if not pg.has_n:
        raise AssertionError("test genome lost its N plane")
    err = 0
    for L, B, C in ((100, 4_096, 384), (150, 4_096, 384), (300, 2_048, 384),
                    (100, 512, 1_536)):
        args = _extend_args(dev, rng, pg, genome, starts, L, B, C)
        err = max(err, _max_abs_err(ep.hamming_extend_packed(*args),
                                    ep.hamming_extend_packed_plain(*args)))
    if err:
        raise AssertionError(f"hamming_extend_packed disagrees: {err}")
    _check_extend_rescue_shape(dev, rng, pg, genome, starts)
    err = max(err, _check_extend_edges(dev))
    # time at the fast pass's shape: one strand, 65,536 reads x 96 loci
    genome = rng.integers(0, 4, size=GENOME_BP, dtype=np.int8)
    starts = np.array([0, GENOME_BP // 2, GENOME_BP], np.int64)
    args = _extend_args(dev, rng, ep.pack_genome(genome, dev), genome,
                        starts, READ_LEN, BATCH, 96)
    args2 = _extend_args(dev, rng, args[0], genome, starts, READ_LEN,
                         2 * BATCH, 96)
    if _max_abs_err(ep.hamming_extend_packed(*args2),
                    ep.hamming_extend_packed_plain(*args2)):
        raise AssertionError("hamming_extend_packed disagrees at the fused "
                             "PE batch")
    ms_pe = _extend_kernel_ms(args2)
    print(f"fused PE batch ({2 * BATCH} rows x 96 loci): "
          f"hamming_extend_packed exact, {ms_pe:.4f} ms")
    g3, s3 = contig_genome(rng)
    args3 = _extend_args(dev, rng, ep.pack_genome(g3, dev), g3, s3,
                         READ_LEN, BATCH, 96)
    if _max_abs_err(ep.hamming_extend_packed(*args3),
                    ep.hamming_extend_packed_plain(*args3)):
        raise AssertionError("hamming_extend_packed disagrees on "
                             f"{CONTIGS} contigs")
    ms_contigs = _extend_kernel_ms(args3)
    print(f"{CONTIGS} contigs of {CONTIG_LEN} bases ({BATCH} "
          f"rows x 96 loci): hamming_extend_packed exact, "
          f"{ms_contigs:.4f} ms")
    pg, es, loci, valid, rc, rn, ln = args
    out = ep.hamming_extend_packed(*args)
    n_ops = _extend_ops(pg, es, loci, valid, ln, out)
    timing = dict(
        ms=_extend_kernel_ms(args),
        wrapper_ms=_timed_ms(lambda: ep.hamming_extend_packed(*args)),
        plain_ms=_timed_ms(lambda: ep.hamming_extend_packed_plain(*args)),
        library_ms=None, ms_fused_pe=ms_pe, ms_contigs=ms_contigs,
        bound=_bound(_nbytes(pg.rows, pg.n_rows, es, loci, valid, rc, rn, ln,
                             out), n_ops))
    del args2, args3
    return err, timing


def _check_extend_rescue_shape(dev, rng, pg, genome, starts):
    """The extension at the orphan rescue's shape: every locus of a
    window, the windows running from below 0 to past the genome's end."""
    import torch

    from biokanga_tpu_torch.ops import extend_packed as ep

    B, Wlen = RESCUE_SHAPE
    n, L = len(genome), READ_LEN
    win = np.linspace(-Wlen + 50, n - 60, B).astype(np.int64)
    src = np.clip(win + rng.integers(0, Wlen - L, B), 0, n - L)
    reads = genome[src[:, None] + np.arange(L)]
    sub = rng.random(reads.shape) < 0.03
    reads[sub] = (reads[sub] + 1) % 4
    loci = torch.from_numpy(
        (win[:, None] + np.arange(Wlen)).astype(np.int32)).to(dev)
    ln = torch.full((B,), L, dtype=torch.int32, device=dev)
    rc, rn = ep.pack_reads(torch.from_numpy(reads).to(dev), ln)
    es = torch.from_numpy(starts.astype(np.int32)).to(dev)
    args = (pg, es, loci, torch.ones_like(loci, dtype=torch.bool), rc, rn, ln)
    got = ep.hamming_extend_packed(*args)
    want = ep.hamming_extend_packed_plain(*args)
    err = _max_abs_err(got, want)
    found = int((want.min(dim=1).values <= 10).sum())
    off = int((want[0] == 255).sum()), int((want[-1] == 255).sum())
    if err or found < B // 2 or min(off) < 40:
        raise AssertionError(f"extension at the rescue shape: err {err}, "
                             f"{found} windows hold their read, invalid "
                             f"loci in the end windows {off}")
    out_bytes = _nbytes(pg.rows, pg.n_rows, es, loci, args[3], rc, rn, ln,
                        got)
    bound_ms, by = _bound(out_bytes,
                          _extend_ops(pg, es, loci, args[3], ln, got))
    print(f"hamming_extend_packed at the rescue shape ({B} windows x {Wlen} "
          f"consecutive loci, {L} bp, a 1 Mbp genome with Ns): exact; kernel "
          f"{_extend_kernel_ms(args):.4f} ms, "
          f"plain torch "
          f"{_timed_ms(lambda: ep.hamming_extend_packed_plain(*args), 3):.4f}"
          f" ms, bound {bound_ms:.4f} ms ({by}); {found} windows hold their "
          f"read, {off} invalid loci in the first and last window")


def _records(path: Path) -> list[str]:
    with open(path) as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith("@")]


def _true_unique_fraction(path: Path, n_reads: int) -> float:
    """Share of reads with a unique (MAPQ 60) record at their origin."""
    from biokanga_tpu_torch.sim.simreads import SimReadTruth

    ok = 0
    for rec in _records(path):
        f = rec.split("\t")
        flag = int(f[1])
        if flag & 4 or f[4] != "60":
            continue
        t = SimReadTruth.parse(f[0])
        ok += (f[2] == t.chrom and int(f[3]) == t.start
               and bool(flag & 16) == (t.strand == "-"))
    return ok / n_reads


def _repeat_genome():
    """A genome with an N run, a 3 kb tandem repeat, a 120 bp block in 80
    copies and a 400 bp block in five."""
    from biokanga_tpu_torch.sim.simreads import random_genome

    seqs = random_genome([("chrA", 200_000), ("chrB", 100_000)], seed=3)
    g = seqs[0][1]
    g[30_000:33_000] = np.tile(np.array([0, 1, 2, 3, 3, 1], np.int8), 500)
    rep = g[50_000:50_120].copy()
    for c in range(80):
        g[60_000 + 130 * c: 60_120 + 130 * c] = rep
    block = g[1_000:1_400].copy()
    for dst in (7_000, 21_000, 150_000):
        g[dst:dst + 400] = block
    seqs[1][1][5_000:5_400] = block
    seqs[1][1][20_000:20_050] = 4
    return seqs


def _repeat_case(n_reads: int = 8_192, read_len: int = 150):
    """Reads drawn from the repeat genome and from its repeats: they drive
    the classic rerun, both rescue-ladder steps, the genome N plane and
    multi-hit assignment."""
    from biokanga_tpu_torch.sim.simreads import simulate_reads

    rng = np.random.default_rng(31)
    seqs = _repeat_genome()
    g = seqs[0][1]
    names, reads, _ = simulate_reads(seqs, n_reads, read_len=read_len,
                                     sub_rate=0.02, seed=23)
    for i in range(0, 256):
        s = (29_900, 60_000, 1_000)[i % 3] + int(rng.integers(0, 250))
        reads[i] = g[s:s + read_len]
    for i in range(256, n_reads, 7):
        p = int(rng.integers(0, read_len - 5))
        reads[i, p:p + int(rng.integers(1, 5))] = 4
    return seqs, names, reads


def long_read_parity():
    """Phase 5c: 500 bp reads, half from a 2 kb block in 150 copies of a
    400 kbp genome, at 3% substitutions: the rescue ladder's step 2 sorts
    dedup rows of 40 cores x 1,024 positions.  --device cpu == cuda."""
    from biokanga_tpu_torch import cli
    from biokanga_tpu_torch.align import pipeline
    from biokanga_tpu_torch.index.build import build_index, save_index
    from biokanga_tpu_torch.sim.simreads import random_genome

    rng = np.random.default_rng(41)
    L, n_reads = LONG_READ_LEN, 256
    seqs = random_genome([("chr1", 400_000)], seed=11)
    g = seqs[0][1]
    block = g[1_000:3_000].copy()
    for c in range(150):
        g[5_000 + 2_100 * c: 7_000 + 2_100 * c] = block
    save_index(build_index(seqs, lut_bases=9), str(WORK / "long.npz"))
    reads = []
    for i in range(n_reads):
        s = (1_000 + int(rng.integers(0, 2_000 - L)) if i % 2 == 0
             else int(rng.integers(0, len(g) - L)))
        r = g[s:s + L].copy()
        sub = rng.random(L) < 0.03
        r[sub] = (r[sub] + 1 + rng.integers(0, 3, int(sub.sum()))) % 4
        reads.append(r)
    _write_fastq(WORK / "long.fq", [f"r{i}" for i in range(n_reads)], reads)
    widths = {}
    sort_rows = pipeline.sort_rows
    try:
        for d in ("cpu", "cuda"):
            widths[d] = []
            pipeline.sort_rows = lambda x, w=widths[d]: (
                w.append(x.shape[1]), sort_rows(x))[1]
            _reset_kernel_launches()
            rc = cli.main(["align", "-i", str(WORK / "long.fq"),
                           "-I", str(WORK / "long.npz"),
                           "-o", str(WORK / f"long_{d}.sam"), "--device", d])
            if rc != 0:
                raise AssertionError(f"align 500 bp --device {d} rc={rc}")
    finally:
        pipeline.sort_rows = sort_rows
    launches = _align_launches()
    sam = (WORK / "long_cpu.sam").read_bytes()
    wide = sum(w > 32_768 for w in widths["cuda"])
    if sam != (WORK / "long_cuda.sam").read_bytes() or not wide or \
            min(launches.values()) < 1:
        raise AssertionError(f"500 bp SAM differs between cpu and cuda, or "
                             f"no dedup row past 32,768 ({widths['cuda']}), "
                             f"or launches {launches}")
    print(f"{n_reads} reads of {L} bp from a 2 kb block in 150 copies: "
          f"--device cpu == cuda byte for byte ({len(sam)} bytes); {wide} "
          f"dedup sorts of rows up to {max(widths['cuda'])} values on the "
          f"card; launches {launches}")


# ---------------------------------------------------------------- EC ----

def _clr_copy(rng, w, err):
    """Vectorised CLR-like noisy copy: of the error events, 10% are
    substitutions, 60% insertions (after the base), 30% deletions."""
    x = rng.random(len(w))
    sub = x < err * 0.1
    ins = (x >= err * 0.1) & (x < err * 0.7)
    dele = (x >= err * 0.7) & (x < err)
    out = w.copy()
    out[sub] = (out[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    reps = np.where(dele, 0, np.where(ins, 2, 1))
    r = np.repeat(out, reps)
    r[np.cumsum(reps)[ins] - 1] = rng.integers(0, 4, int(ins.sum()))
    return r.astype(np.int8)


def _sw_pairs(rng, B, La, W):
    """B overlap-like pairs of CLR reads of <= La bases: ragged lengths,
    diagonals of both signs, Ns in queries and targets.  Returns
    (a, b, alen, blen, diag) numpy arrays."""
    genome = rng.integers(0, 4, 400_000, dtype=np.int8)
    a = np.full((B, La), 4, np.int8)
    b = np.full((B, La), 4, np.int8)
    alen = np.zeros(B, np.int32)
    blen = np.zeros(B, np.int32)
    diag = np.zeros(B, np.int32)
    trim = min(600, La // 4)                      # ragged ends, <= La
    for p in range(B):
        d = int(rng.integers(-W, W + 1))          # target j ~ query i + d
        st = int(rng.integers(W, len(genome) - La - 2 * W))
        q = _clr_copy(rng, genome[st + max(d, 0): st + max(d, 0) + La],
                      EC_ERR)[:La - int(rng.integers(0, trim))]
        t = _clr_copy(rng, genome[st + max(-d, 0): st + max(-d, 0) + La],
                      EC_ERR)[:La - int(rng.integers(0, trim))]
        a[p, :len(q)], alen[p] = q, len(q)
        b[p, :len(t)], blen[p] = t, len(t)
        diag[p] = d + int(rng.integers(-8, 9))
    for arr, lens in ((a, alen), (b, blen)):
        rows = rng.integers(0, B, B // 4)
        cols = (rng.random(B // 4) * lens[rows]).astype(np.int64)
        arr[rows, cols] = 4
        arr[rows[: B // 8], cols[: B // 8] // 2] = 4
    return a, b, alen, blen, diag


def _sw_inputs(dev, a, b, alen, blen, diag, La, W):
    import torch

    from biokanga_tpu_torch.ops.banded_sw import normalize_band

    bwin, jlo, jhi = normalize_band(
        torch.from_numpy(b).to(dev), torch.from_numpy(blen).to(dev),
        torch.from_numpy(diag).to(dev), La, W)
    return (torch.from_numpy(a).to(dev), bwin,
            torch.from_numpy(alen).to(dev), jlo, jhi)


def _edge_cases():
    """tests/sw_edge_cases.py: the inputs the SW and decode tests use."""
    sys.path.insert(0, str(ROOT / "tests"))
    import sw_edge_cases

    return sw_edge_cases


def _check_sw_edges(dev):
    """The kernels on the tests' edge cases: decode planes with long LEFT
    runs, runs to column 0 and climbs out of the band; pairs whose scores
    come near 2**15 and pass it.  Returns the largest error of each
    kernel."""
    import torch

    from biokanga_tpu_torch.ops import banded_sw as bsw
    from biokanga_tpu_torch.ops import sw_trace

    edges = _edge_cases()
    err = {"sw_trace": 0, "banded_sw_moves": 0, "banded_sw_score": 0}
    for La, W, B in ((SW_LA, SW_W, 24), (77, 40, 13), (100, 24, 7)):
        planes = [torch.from_numpy(x).to(dev)
                  for x in edges.decode_planes(La + W, B, La, W)]
        got = sw_trace.traceback_cols_packed(*planes, W, La)
        want = sw_trace.traceback_cols_packed_plain(*planes, W, La)
        err["sw_trace"] = max(err["sw_trace"], *(_max_abs_err(g, w)
                                                 for g, w in zip(got, want)))
    for scoring, past in ((edges.SCORING_BELOW_2_15, False),
                          (edges.SCORING_PAST_2_15, True)):
        La, W = (320, 24) if past else (256, 24)
        args = _sw_inputs(dev, *edges.near_identical_pairs(La, 9, La, W),
                          La, W)
        kw = dict(zip(("match", "mismatch", "gap_open", "gap_ext"), scoring))
        want = bsw.banded_sw_moves_plain(*args, W, **kw)
        err["banded_sw_moves"] = max(err["banded_sw_moves"], *(
            _max_abs_err(g, w) for g, w in
            zip(bsw.banded_sw_moves(*args, W, **kw), want)))
        err["banded_sw_score"] = max(err["banded_sw_score"], *(
            _max_abs_err(g, w) for g, w in
            zip(bsw.banded_sw_score(*args, W, **kw), want[:3])))
        top = int(want[0].max())
        if (top > 32_767) != past:
            raise AssertionError(f"edge pairs scored {top} at {scoring}")
    return err


def check_sw(dev, rng):
    """banded_sw_moves / banded_sw_score / sw_trace against their plain
    versions at EC shapes and on the edge cases, exactly; then each timed
    at one SW chunk of 1,024 pairs and at the EC cell's chunk size."""
    import torch

    from biokanga_tpu_torch.ops import banded_sw as bsw
    from biokanga_tpu_torch.ops import sw_trace
    from biokanga_tpu_torch.pacbio.ecreads import ECParams, _pair_bytes

    La, W = SW_LA, SW_W
    args = _sw_inputs(dev, *_sw_pairs(rng, SW_CHECK_PAIRS, La, W), La, W)
    got = bsw.banded_sw_moves(*args, W)
    want = bsw.banded_sw_moves_plain(*args, W)
    err = {"banded_sw_moves": max(_max_abs_err(g, w)
                                  for g, w in zip(got, want))}
    err["banded_sw_score"] = max(
        _max_abs_err(g, w) for g, w in zip(bsw.banded_sw_score(*args, W),
                                           want[:3]))
    best, bi, bk, mv = got
    dec = sw_trace.traceback_cols_packed(mv, bi, bk, args[1], W, La)
    dec_plain = sw_trace.traceback_cols_packed_plain(mv, bi, bk, args[1], W,
                                                     La)
    err["sw_trace"] = max(_max_abs_err(g, w) for g, w in zip(dec, dec_plain))
    if any(err.values()):
        raise AssertionError(f"SW kernels disagree with plain torch: {err}")
    if int((best > 1000).sum()) < SW_CHECK_PAIRS // 2 or \
            not bool((dec[0] == 5).any()) or not bool((dec[1] > 0).any()):
        raise AssertionError("SW check pairs do not look like overlaps")
    print(f"SW kernels exact against plain torch on {SW_CHECK_PAIRS} pairs "
          f"of <= {La} bases, W {W}: best scores "
          f"{int(best.min())}..{int(best.max())}")
    edge_err = _check_sw_edges(dev)
    if any(edge_err.values()):
        raise AssertionError(f"SW kernels disagree on edge cases: {edge_err}")
    print("SW kernels exact on the edge cases: decode planes with LEFT runs "
          "past 32 columns, runs to column 0 and climbs out of the band; "
          "scores near and past 2**15")

    # one SW chunk of the phase's pairs, and the EC cell's chunk size
    n_ec = ECParams().sw_chunk_bytes // _pair_bytes(La, W)
    pairs = _sw_pairs(rng, max(SW_CHUNK_PAIRS, n_ec), La, W)
    args = _sw_inputs(dev, *(x[:SW_CHUNK_PAIRS] for x in pairs), La, W)
    a, bwin, alen, jlo, jhi = args
    best, bi, bk, mv = bsw.banded_sw_moves(*args, W)
    out = sw_trace.traceback_cols_packed(mv, bi, bk, bwin, W, La)
    K = 2 * W + 1
    cells = float(alen.clamp(max=La).sum()) * K
    t0 = time.monotonic()
    bsw.banded_sw_moves_plain(*args, W)
    torch.cuda.synchronize()
    moves_plain = (time.monotonic() - t0) * 1e3
    t0 = time.monotonic()
    bsw.banded_sw_score_plain(*args, W)
    torch.cuda.synchronize()
    score_plain = (time.monotonic() - t0) * 1e3
    t0 = time.monotonic()
    sw_trace.traceback_cols_packed_plain(mv, bi, bk, bwin, W, La)
    torch.cuda.synchronize()
    trace_plain = (time.monotonic() - t0) * 1e3
    in_bytes = _nbytes(a, bwin, alen, jlo, jhi)
    # the decode reads the codes and target bases along each path only
    path_rows = int((out[0] != 6).sum()) + int(out[1].sum())
    longest = int((out[0] != 6).sum(1).max())
    timing = {
        "banded_sw_moves": dict(
            ms=_timed_ms(lambda: bsw.banded_sw_moves(*args, W), 5),
            plain_ms=moves_plain, library_ms=None,
            bound=_bound(in_bytes + _nbytes(best, bi, bk, mv),
                         cells * SW_MOVES_OPS_PER_CELL)),
        "banded_sw_score": dict(
            ms=_timed_ms(lambda: bsw.banded_sw_score(*args, W), 5),
            plain_ms=score_plain, library_ms=None,
            bound=_bound(in_bytes + _nbytes(best, bi, bk),
                         cells * SW_OPS_PER_CELL)),
        "sw_trace": dict(
            ms=_timed_ms(lambda: sw_trace.traceback_cols_packed(
                mv, bi, bk, bwin, W, La), 5),
            plain_ms=trace_plain, library_ms=None,
            bound=_bound(_nbytes(bi, bk, *out) + 5 * path_rows,
                         12 * path_rows),
            chain_ms=longest * TRACE_STEP_CYCLES / SM_CLOCK_HZ * 1e3),
    }
    tm, tt = timing["banded_sw_moves"], timing["sw_trace"]
    for name in ("banded_sw_moves", "banded_sw_score"):
        t = timing[name]
        print(f"{name}: {SW_CHUNK_PAIRS} pairs x {La} x K {K}: "
              f"{t['ms']:.4f} ms, {cells / t['ms'] / 1e6:.2f} GCUPS "
              f"(plain torch {t['plain_ms']:.1f} ms, once)")
    print(f"sw_trace: {SW_CHUNK_PAIRS} pairs: {tt['ms']:.4f} ms (plain torch "
          f"{trace_plain:.1f} ms, once); byte bound {tt['bound'][0]:.4f} ms; "
          f"dependent-chain floor {tt['chain_ms']:.4f} ms ({longest} rows on "
          f"the longest path x {TRACE_STEP_CYCLES} cycles a step / "
          f"{SM_CLOCK_HZ / 1e9:.2f} GHz)")
    args = _sw_inputs(dev, *(x[:n_ec] for x in pairs), La, W)
    best, bi, bk, mv = bsw.banded_sw_moves(*args, W)
    tm["ms_ec_chunk"] = _timed_ms(lambda: bsw.banded_sw_moves(*args, W), 5)
    tt["ms_ec_chunk"] = _timed_ms(lambda: sw_trace.traceback_cols_packed(
        mv, bi, bk, args[1], W, La), 5)
    tm["ec_chunk_pairs"] = tt["ec_chunk_pairs"] = n_ec
    print(f"the EC cell's chunk, {n_ec} pairs x {La}: banded_sw_moves "
          f"{tm['ms_ec_chunk']:.4f} ms, sw_trace "
          f"{tt['ms_ec_chunk']:.4f} ms")
    for W, timed_on, La, n in (
            *((W, pairs, SW_LA, WIDE_SW_CHECK_PAIRS) for W in WIDE_SW_BANDS),
            *((W, None, SEGMENT_SW_LA, SEGMENT_SW_PAIRS)
              for W in SEGMENT_SW_BANDS)):
        wide = _check_wide_sw(dev, rng, timed_on, W, La, n)
        for name in ("banded_sw_moves", "banded_sw_score", "sw_trace"):
            err[name] = max(err[name], wide[name].pop("err"))
            timing[name].setdefault("wide", {})[f"W{W}"] = wide[name]
    return err, timing


def _check_wide_sw(dev, rng, pairs, W, La, n_check):
    """The SW kernels and the decode at a band past the one-warp path (one
    block a pair): exact on `n_check` new pairs of `La` bases, then timed
    at the EC cell's chunk size for this band on the first of `pairs`, or
    on the checked pairs where `pairs` is None."""
    import torch

    from biokanga_tpu_torch.ops import banded_sw as bsw
    from biokanga_tpu_torch.ops import sw_trace
    from biokanga_tpu_torch.pacbio.ecreads import ECParams, _pair_bytes

    K = 2 * W + 1
    # diagonals within a quarter of the pairs' length, so that they overlap
    args = _sw_inputs(dev, *_sw_pairs(rng, n_check, La, min(W, La // 4)),
                      La, W)
    out = {}
    t0 = time.monotonic()
    want = bsw.banded_sw_moves_plain(*args, W)
    torch.cuda.synchronize()
    moves_plain = (time.monotonic() - t0) * 1e3
    t0 = time.monotonic()
    bsw.banded_sw_score_plain(*args, W)
    torch.cuda.synchronize()
    score_plain = (time.monotonic() - t0) * 1e3
    _, bi, bk, mv = want
    t0 = time.monotonic()
    dec_want = sw_trace.traceback_cols_packed_plain(mv, bi, bk, args[1], W,
                                                    La)
    torch.cuda.synchronize()
    trace_plain = (time.monotonic() - t0) * 1e3
    errs = {
        "banded_sw_moves": max(_max_abs_err(g, w) for g, w in
                               zip(bsw.banded_sw_moves(*args, W), want)),
        "banded_sw_score": max(_max_abs_err(g, w) for g, w in
                               zip(bsw.banded_sw_score(*args, W), want[:3])),
        "sw_trace": max(_max_abs_err(g, w) for g, w in zip(
            sw_trace.traceback_cols_packed(mv, bi, bk, args[1], W, La),
            dec_want))}
    if any(errs.values()) or int(want[0].max()) < La // 10:
        raise AssertionError(f"SW kernels at W {W}: {errs}, best "
                             f"{int(want[0].max())}")
    if pairs is None:
        n = n_check
    else:
        n = ECParams().sw_chunk_bytes // _pair_bytes(La, W)
        args = _sw_inputs(dev, *(x[:n] for x in pairs), La, W)
    a, bwin, alen, jlo, jhi = args
    best, bi, bk, mv = bsw.banded_sw_moves(*args, W)
    dec = sw_trace.traceback_cols_packed(mv, bi, bk, bwin, W, La)
    cells = float(alen.clamp(max=La).sum()) * K
    in_bytes = _nbytes(a, bwin, alen, jlo, jhi)
    path_rows = int((dec[0] != 6).sum()) + int(dec[1].sum())
    for name, fn, plain_ms, bound in (
            ("banded_sw_moves", lambda: bsw.banded_sw_moves(*args, W),
             moves_plain, _bound(in_bytes + _nbytes(best, bi, bk, mv),
                                 cells * SW_MOVES_OPS_PER_CELL)),
            ("banded_sw_score", lambda: bsw.banded_sw_score(*args, W),
             score_plain, _bound(in_bytes + _nbytes(best, bi, bk),
                                 cells * SW_OPS_PER_CELL)),
            ("sw_trace", lambda: sw_trace.traceback_cols_packed(
                mv, bi, bk, bwin, W, La), trace_plain,
             _bound(_nbytes(bi, bk, *dec) + 5 * path_rows, 12 * path_rows))):
        ms = _timed_ms(fn, 3)
        out[name] = dict(err=errs[name], ms=ms, pairs=n,
                         plain_ms_check_pairs=plain_ms, bound_ms=bound[0],
                         bound_by=bound[1])
        print(f"{name} at W {W} (one block a pair): exact on "
              f"{n_check} pairs (plain torch {plain_ms:.1f} ms, "
              f"once); {n} pairs x {La} x K {K}: {ms:.4f} ms"
              + (f", {cells / ms / 1e6:.2f} GCUPS" if name != "sw_trace"
                 else "") + f", bound {bound[0]:.4f} ms ({bound[1]})")
    del mv, args
    torch.cuda.empty_cache()
    return out


def long_pair_score(dev, rng):
    """#6's only consumer in the JAX package scores single long pairs
    (scripts/bench_longread.py); here one 100 kb pair with 5% error, at
    the kernel's widest band.  Returns the launches of that run."""
    from biokanga_tpu_torch.ops import banded_sw as bsw

    L, W = 100_000, LONG_PAIR_W
    w = rng.integers(0, 4, L, dtype=np.int8)
    x = rng.random(L)                            # bench_longread's noise mix
    keep = ~((x >= 0.035) & (x < 0.05))
    q = w.copy()
    q[x < 0.02] = (q[x < 0.02] + rng.integers(1, 4, int((x < 0.02).sum()))
                   ) % 4
    reps = np.where(keep, np.where((x >= 0.02) & (x < 0.035), 2, 1), 0)
    q = np.repeat(q, reps)[:L]
    a = np.full((1, L), 4, np.int8)
    a[0, :len(q)] = q
    args = _sw_inputs(dev, a, w[None, :], np.array([len(q)], np.int32),
                      np.array([L], np.int32), np.zeros(1, np.int32), L, W)
    bsw.banded_sw_score.launches = 0
    t0 = time.monotonic()
    best, bi, _ = bsw.banded_sw_score(*args, W)
    score = int(best[0])
    dt = time.monotonic() - t0
    launches = bsw.banded_sw_score.launches
    if launches < 1 or score < 0.75 * len(q):
        raise AssertionError(f"long pair: score {score}, launches {launches}")
    print(f"long pair {len(q)} x {L}, W {W}: score {score} at row "
          f"{int(bi[0])}, {dt * 1e3:.1f} ms wall (one pair, one warp)")
    return launches


def gen_reads(n_reads, L, genome_kb, err, seed=3):
    """Copy of scripts/bench_ec_headtohead.py gen_reads (burst=False):
    PacBio CLR-like errors, of all error events 10% substitutions, 60%
    insertions, 30% deletions."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_kb * 1000, dtype=np.int8)
    reads, truths = [], []
    for _ in range(n_reads):
        st = int(rng.integers(0, len(genome) - L))
        w = genome[st : st + L].copy()
        truths.append(w.copy())
        rate = np.full(L, err)
        r = []
        for bi, b in enumerate(w):
            err_i = rate[bi]
            x = rng.random()
            if x < err_i * 0.1:
                r.append((b + rng.integers(1, 4)) % 4)
            elif x < err_i * 0.7:
                r.append(b)
                r.append(rng.integers(0, 4))
            elif x < err_i:
                continue
            else:
                r.append(b)
        reads.append(np.array(r, np.int8))
    return reads, truths


def kmer_set(s: np.ndarray, k: int = 32):
    """Copy of scripts/bench_ecreads.py kmer_set."""
    packs = set()
    v = 0
    mask = (1 << (2 * k)) - 1
    run = 0
    for b in s:
        if b >= 4:
            run = 0
            v = 0
            continue
        v = ((v << 2) | int(b)) & mask
        run += 1
        if run >= k:
            packs.add(v)
    return packs


def kmer_recovery(read: np.ndarray, truth_kmers: set, k: int = 32) -> float:
    """Copy of scripts/bench_ecreads.py kmer_recovery."""
    n = tot = 0
    v = 0
    mask = (1 << (2 * k)) - 1
    run = 0
    for b in read:
        if b >= 4:
            run = 0
            v = 0
            continue
        v = ((v << 2) | int(b)) & mask
        run += 1
        if run >= k:
            tot += 1
            n += v in truth_kmers
    return n / max(tot, 1)


def _ecreads(fasta: Path, out: Path, device: str, extra=()) -> dict:
    """`python -m biokanga_tpu_torch ecreads` in process; the numbers of
    its log line."""
    from biokanga_tpu_torch import cli

    log = out.with_suffix(".log")
    log.unlink(missing_ok=True)         # the log handler appends
    rc = cli.main(["ecreads", "-i", str(fasta), "-o", str(out), "-F",
                   str(log), "--device", device, *extra])
    if rc != 0:
        raise AssertionError(f"ecreads --device {device} rc={rc}")
    return _ecreads_log(log)


def _ecreads_log(log: Path) -> dict:
    """The numbers of an `ecreads -F` log's summary line."""
    m = re.search(r"ecreads: (\d+) reads, (\d+) pairs aligned, (\d+) "
                  r"overlaps used, \S+s(?:; device time: SW (\S+) ms, "
                  r"traceback (\S+) ms)?", log.read_text())
    if m is None:
        raise AssertionError("ecreads wrote no summary line")
    return {"reads": int(m[1]), "pairs": int(m[2]), "overlaps": int(m[3]),
            "sw_ms": m[4] and float(m[4]), "trace_ms": m[5] and float(m[5])}


def ec_parity_start(rng) -> list:
    """Phase 8, first half: EC_PARITY_READS noisy 1.5 kb reads, --rounds
    2, at the default band and at --sw-band 256 (one block a pair).  The
    --device cpu runs (host row loops, some 20 s each) start as child
    processes that go on beside the phases after this one; the --device
    cuda runs follow here, in process, with their launches counted.
    Returns what ec_parity_finish compares."""
    import atexit
    import os

    from biokanga_tpu_torch.ops import banded_sw, sw_trace
    from biokanga_tpu_torch.seq.encode import revcomp
    from biokanga_tpu_torch.seq.fasta import write_fasta

    genome = rng.integers(0, 4, 3_000, dtype=np.int8)
    reads = []
    for i in range(EC_PARITY_READS):
        st = int(rng.integers(0, 1_500))
        r = _clr_copy(rng, genome[st: st + 1_500], EC_ERR)
        r[rng.random(len(r)) < 0.002] = 4
        reads.append(revcomp(r) if i % 3 == 2 else r)
    fasta = WORK / "ec_small.fa"
    write_fasta(str(fasta), ((f"read{i}", r) for i, r in enumerate(reads)))
    # the child processes see no card and share the host's cores
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="3")
    runs = []
    for extra in ((), ("--sw-band", str(EC_WIDE_BAND))):
        tag = "_".join(("ec_small",) + extra[1:])
        out = WORK / f"{tag}_cpu.fa"
        out.with_suffix(".log").unlink(missing_ok=True)
        err = open(WORK / f"{tag}_cpu.err", "wb")
        proc = subprocess.Popen(
            [sys.executable, "-m", "biokanga_tpu_torch", "ecreads", "-i",
             str(fasta), "-o", str(out), "-F", str(out.with_suffix(".log")),
             "--device", "cpu", *extra],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err)
        err.close()
        atexit.register(lambda p=proc: p.poll() is None and (p.kill(),
                                                             p.wait()))
        runs.append({"extra": extra, "tag": tag, "proc": proc})
    for run in runs:
        banded_sw.banded_sw_moves.launches = 0
        sw_trace.traceback_cols_packed.launches = 0
        _ecreads(fasta, WORK / f"{run['tag']}_cuda.fa", "cuda", run["extra"])
        run["launches"] = (banded_sw.banded_sw_moves.launches,
                           sw_trace.traceback_cols_packed.launches)
    return runs


def ec_parity_finish(runs) -> None:
    """Phase 8, second half: wait for the --device cpu runs and require
    their FASTA byte for byte from the --device cuda runs."""
    for run in runs:
        extra, tag, launches = run["extra"], run["tag"], run["launches"]
        if run["proc"].wait() != 0:
            raise AssertionError(
                f"ecreads --device cpu {extra} rc={run['proc'].returncode}: "
                f"{(WORK / f'{tag}_cpu.err').read_text()[-2000:]}")
        st = _ecreads_log(WORK / f"{tag}_cpu.log")
        want = (WORK / f"{tag}_cpu.fa").read_bytes()
        if (WORK / f"{tag}_cuda.fa").read_bytes() != want or \
                min(launches) < 1 or st["overlaps"] < EC_PARITY_READS:
            raise AssertionError(f"EC parity {extra}: FASTA differs or "
                                 f"launches {launches}, overlaps "
                                 f"{st['overlaps']}")
        print(f"ecreads --rounds 2 {' '.join(extra)} on {EC_PARITY_READS} "
              f"reads of ~1.5 kb: "
              f"--device cpu == --device cuda byte for byte ({len(want)} "
              f"bytes, {st['overlaps']} overlaps; SW/decode launches "
              f"{launches})")


def ec_full_width(smi):
    """The head-to-head EC cell on the card through the CLI defaults."""
    import torch

    from biokanga_tpu_torch.ops import banded_sw, sw_trace
    from biokanga_tpu_torch.seq.fasta import read_seqs, write_fasta

    t0 = time.monotonic()
    reads, truths = gen_reads(EC_READS, EC_READ_LEN, EC_GENOME_KB, EC_ERR,
                              seed=EC_SEED)
    fasta = WORK / "ec_h2h.fa"
    write_fasta(str(fasta), ((f"read{i:06d}", r)
                             for i, r in enumerate(reads)))
    print(f"EC read set: {len(reads)} reads, mean "
          f"{np.mean([len(r) for r in reads]):.1f} bases "
          f"({time.monotonic() - t0:.1f} s to simulate)")
    torch.cuda.reset_peak_memory_stats()
    banded_sw.banded_sw_moves.launches = 0
    sw_trace.traceback_cols_packed.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    st = _ecreads(fasta, WORK / "ec_h2h_out.fa", "cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"banded_sw_moves": banded_sw.banded_sw_moves.launches,
                "sw_trace": sw_trace.traceback_cols_packed.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"EC ran no SW kernel: {launches}")
    corrected = {int(r.name[4:]): r.codes
                 for r in read_seqs(str(WORK / "ec_h2h_out.fa"))}
    post = 0.0
    for i, (r, t) in enumerate(zip(reads, truths)):
        c = corrected.get(i)
        post += kmer_recovery(c if c is not None and len(c) else r,
                              kmer_set(t))
    post /= len(reads)
    print(f"ecreads (CLI defaults) on {len(reads)} x {EC_READ_LEN} CLR reads "
          f"of a {EC_GENOME_KB} kb genome: wall {wall:.2f} s; SW kernel "
          f"{st['sw_ms']:.1f} ms, traceback kernel {st['trace_ms']:.1f} ms; "
          f"{st['pairs']} pairs aligned, {st['overlaps']} overlaps used; "
          f"launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; 32-mer "
          f"recovery {post:.4f} ({smi})")
    if post < MIN_KMER_RECOVERY:
        raise AssertionError(f"32-mer recovery {post:.4f} < "
                             f"{MIN_KMER_RECOVERY}")
    return launches


# ------------------------------------------------------ gather probe ----

def _probe_module():
    """scripts/probe_stream_gather_torch.py, the gather kernel's entry
    point."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import probe_stream_gather_torch

    return probe_stream_gather_torch


def check_stream_gather(dev, smi):
    """stream_gather_consume against its plain version at GATHER_CHECK_MB
    (the region sizes the wrapper takes: the whole table as one region,
    and regions of half the L2), random and sorted, exactly; each timed
    beside its bound and the floor of a gather in index order."""
    import torch

    from biokanga_tpu_torch.ops import stream_gather as sg

    probe = _probe_module()
    err, timing, swept = 0, None, set()
    for mb in GATHER_CHECK_MB:
        table, idx = probe.make_inputs(mb, GATHER_N, dev)
        sidx = torch.sort(idx).values
        want = int(sg.stream_gather_consume_plain(table, idx))
        got = {"random": sg.stream_gather_consume(table, idx)}
        regions = sg.stream_gather_consume.last_regions
        got["sorted"] = sg.stream_gather_consume(table, sidx)
        got["sort_rows"] = sg.stream_gather_consume(table, idx,
                                                    sort_rows=True)
        for name, g in got.items():
            err = max(err, abs(int(g) - want))
            if int(g) != want:
                raise AssertionError(f"stream_gather_consume, {mb} MB, "
                                     f"{name}: {int(g)} != {want}")
        swept.add(regions)
        path = f"{regions} region{'s' if regions > 1 else ''}"
        n = idx.numel()
        # what this run's indices need: each distinct row and each index
        # read once, one word written; beside it, the floor of a gather in
        # index order (the rows L2 does not hold come from device memory)
        distinct = int(torch.unique(idx).numel())
        b = probe.bounds(n, distinct, table.numel() * 4,
                         sg.l2_bytes(table.device))
        t = dict(
            ms=_timed_ms(lambda: sg.stream_gather_consume(table, idx)),
            sorted_ms=_timed_ms(lambda: sg.stream_gather_consume(table,
                                                                 sidx)),
            plain_ms=_timed_ms(
                lambda: sg.stream_gather_consume_plain(table, idx), 3),
            library_ms=None, bound=(b["bound_ms"], b["bound_by"]),
            path=path, direct_floor_ms=b["direct_floor_ms"])
        print(f"stream_gather_consume, table {table.numel() * 4 / 1e6:.1f} MB"
              f" ({table.shape[0]} rows), {n} gathers of {distinct} distinct "
              f"rows: exact (random, sorted, sort_rows); {path}: kernel "
              f"{t['ms']:.4f} ms random, {t['sorted_ms']:.4f} ms sorted, "
              f"plain torch {t['plain_ms']:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}), share "
              f"{b['bound_ms'] / t['ms']:.3f}; in index order "
              f"{b['direct_floor_ms']:.4f} ms at best ({smi})")
        if mb == GATHER_LINE_MB:
            timing = t
        del table, idx, sidx
        torch.cuda.empty_cache()
    if 1 not in swept or max(swept) < 2:
        raise AssertionError(f"the checked sizes swept {swept} regions")
    # the kernel's path through the system: the probe, over its own sizes
    sg.stream_gather_consume.launches = 0
    if probe.main(["--iters", "3"]) != 0:
        raise AssertionError("the gather probe failed")
    launches = sg.stream_gather_consume.launches
    if launches < len(probe.DEFAULT_MB):
        raise AssertionError(f"the gather probe launched {launches} kernels")
    torch.cuda.empty_cache()
    return err, timing, launches


# ------------------------------------------------------ paired ends ----

def _pe_repeat_case(n_pairs: int = N_REPEAT_PAIRS, read_len: int = 150):
    """Pairs of 2 x 150 bp from the repeat genome of `_repeat_case`.  In
    every fifth pair one mate lies in the 400 bp block that occurs five
    times (not unique) while its partner is unique beside it: an orphan
    that only the windowed rescue can place.  Every ninth pair has a mate
    with a substitution in each seed core, and some mates carry Ns."""
    from biokanga_tpu_torch.seq.encode import revcomp
    from biokanga_tpu_torch.sim.simreads import simulate_reads

    rng = np.random.default_rng(37)
    seqs = _repeat_genome()
    g = seqs[0][1]
    names, reads, _ = simulate_reads(seqs, n_pairs, read_len=read_len,
                                     sub_rate=0.02, seed=29, pe=True,
                                     insert_min=300, insert_max=550)

    for i in range(0, n_pairs, 5):
        s = (1_000, 7_000, 21_000, 150_000)[i // 5 % 4] + \
            int(rng.integers(10, 240))
        a, b = g[s:s + read_len], revcomp(g[s + 330:s + 330 + read_len])
        reads[2 * i], reads[2 * i + 1] = (a, b) if i % 2 else (b, a)
    for i in range(3, n_pairs, 9):
        r = reads[2 * i + i % 2]
        r[5:140:10] = (r[5:140:10] + 1) % 4
    for i in range(7, n_pairs, 23):
        p = int(rng.integers(0, read_len - 5))
        reads[2 * i, p:p + int(rng.integers(1, 4))] = 4
    return seqs, names, reads


def _write_pairs(stem: str, names, reads, n_pairs: int):
    for m in (0, 1):
        _write_fastq(WORK / f"{stem}{m + 1}.fq", names[m:2 * n_pairs:2],
                     reads[m:2 * n_pairs:2])


def _align_pe(stem: str, ref: str, out: str, device: str, extra=()) -> dict:
    """`align -i <stem>1.fq -u <stem>2.fq` in process; the numbers of its
    log line."""
    from biokanga_tpu_torch import cli

    log = WORK / f"{out}.log"
    log.unlink(missing_ok=True)         # the log handler appends
    rc = cli.main(["align", "-i", str(WORK / f"{stem}1.fq"),
                   "-u", str(WORK / f"{stem}2.fq"), "-I", str(WORK / ref),
                   "-o", str(WORK / f"{out}.sam"), "-F", str(log),
                   "--device", device, "--batch-size", str(BATCH),
                   *PE_FLAGS, *extra])
    if rc != 0:
        raise AssertionError(f"align -u --device {device} rc={rc}")
    m = re.search(r"paired (\d+) pairs: (\d+) proper \(\S+\), (\d+) mates "
                  r"rescued in (\d+) window scans", log.read_text())
    if m is None:
        raise AssertionError("align -u wrote no summary line")
    return {"pairs": int(m[1]), "proper": int(m[2]), "rescued": int(m[3]),
            "scans": int(m[4])}


def _pe_origin_fractions(path: Path, n_pairs: int) -> tuple[float, float]:
    """(share of pairs flagged proper, share of the proper pairs with both
    mates at their simulated origin), from the read names."""
    from biokanga_tpu_torch.sim.simreads import SimReadTruth

    recs = _records(path)
    if len(recs) != 2 * n_pairs:
        raise AssertionError(f"{len(recs)} records for {n_pairs} pairs")
    proper = at_origin = 0
    for i in range(0, len(recs), 2):
        mates = [r.split("\t") for r in recs[i:i + 2]]
        if not all(int(f[1]) & 2 for f in mates):
            continue
        proper += 1
        ok = True
        for f in mates:
            t = SimReadTruth.parse(f[0])
            ok &= (f[2] == t.chrom and int(f[3]) == t.start
                   and bool(int(f[1]) & 16) == (t.strand == "-"))
        at_origin += ok
    return proper / n_pairs, at_origin / max(proper, 1)


ALIGN_KERNELS = ("seed_rows", "sort_rows", "dedup_pack", "sort2_rows",
                 "hamming_extend_packed")
# the resident chunked path's own kernels (phase 16, the resident PE run)
CHUNK_MERGE_KERNELS = ("select_chunk", "merge_chunks")


def _align_launches() -> dict:
    """Launch counts of the align path's kernels, #1-#3."""
    counts = _kernel_launches()
    return {k: counts[k] for k in ALIGN_KERNELS}


def pe_full_width(seqs, smi):
    """Phase 11: the PE cell through the CLI.  Returns (launches of the
    run, r1, r2) with the mates as (N_PAIRS, READ_LEN) arrays."""
    import torch

    from biokanga_tpu_torch.sim.simreads import simulate_reads

    t0 = time.monotonic()
    names, reads, _ = simulate_reads(
        seqs, N_PAIRS, read_len=READ_LEN, sub_rate=0.01, seed=17, pe=True,
        insert_min=PE_INSERT[0], insert_max=PE_INSERT[1])
    _write_pairs("pe", names, reads, N_PAIRS)
    _write_pairs("pehead", names, reads, N_PARITY)
    print(f"PE read set: {N_PAIRS} pairs of 2 x {READ_LEN} bp, inserts "
          f"{PE_INSERT} ({time.monotonic() - t0:.1f} s to simulate and write)")
    _reset_kernel_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    st = _align_pe("pe", "ref.npz", "pe_out", "cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _align_launches()
    if min(launches.values()) < 1 or st["pairs"] != N_PAIRS:
        raise AssertionError(f"align -u: launches {launches}, {st}")
    proper, at_origin = _pe_origin_fractions(WORK / "pe_out.sam", N_PAIRS)
    print(f"align -u --device cuda: {N_PAIRS} pairs in {wall:.2f} s (CLI "
          f"wall, index load and I/O included); launches {launches}; proper "
          f"pairs {proper:.6f}, of them both mates at origin "
          f"{at_origin:.6f}; {st['rescued']} mates rescued in {st['scans']} "
          f"window scans ({smi})")
    if at_origin < MIN_TRUE_FRACTION or proper < MIN_TRUE_FRACTION:
        raise AssertionError(f"proper {proper:.4%}, at origin "
                             f"{at_origin:.4%}")
    return (launches, np.ascontiguousarray(reads[0::2]),
            np.ascontiguousarray(reads[1::2]))


def pe_parity():
    """Phase 12: --device cpu against --device cuda, SAM (and CSV) byte
    for byte, on the first pairs of the cell and on the repeat pairs."""
    from biokanga_tpu_torch.index.build import build_index, save_index

    for d in ("cpu", "cuda"):
        _align_pe("pehead", "ref.npz", f"pehead_{d}", d)
    cpu_sam = (WORK / "pehead_cpu.sam").read_bytes()
    if cpu_sam != (WORK / "pehead_cuda.sam").read_bytes():
        raise AssertionError("PE SAM differs between --device cpu and cuda")
    if _records(WORK / "pe_out.sam")[:2 * N_PARITY] != \
            _records(WORK / "pehead_cpu.sam"):
        raise AssertionError("first PE records differ from the full run")
    print(f"PE SAM of the first {N_PARITY} pairs: --device cpu == --device "
          f"cuda byte for byte ({len(cpu_sam)} bytes)")

    rseqs, rnames, rreads = _pe_repeat_case()
    save_index(build_index(rseqs, lut_bases=9), str(WORK / "perep.npz"))
    _write_pairs("perep", rnames, rreads, N_REPEAT_PAIRS)
    st = {}
    for d in ("cpu", "cuda"):
        _reset_kernel_launches()
        st[d] = _align_pe("perep", "perep.npz", f"perep_{d}", d,
                          ["--peinsertdist", str(WORK / f"perep_{d}.csv")])
    launches = _align_launches()
    rep_sam = (WORK / "perep_cpu.sam").read_bytes()
    csv = (WORK / "perep_cpu.csv").read_bytes()
    if rep_sam != (WORK / "perep_cuda.sam").read_bytes() or \
            csv != (WORK / "perep_cuda.csv").read_bytes() or \
            b"InsertBin" not in csv:
        raise AssertionError("PE repeat SAM or insert CSV differs between "
                             "cpu and cuda")
    # the first pair's block mate can only be placed by the rescue
    first = [r.split("\t") for r in _records(WORK / "perep_cuda.sam")[:2]]
    # the CPU path scans its orphans in chunks, so only the card's count
    # of scans is the count of kernel launches
    same = all(st["cuda"][k] == st["cpu"][k]
               for k in ("pairs", "proper", "rescued"))
    if not same or st["cuda"]["rescued"] < 1 or \
            st["cuda"]["scans"] < 1 or min(launches.values()) < 1 or \
            not all(int(f[1]) & 2 for f in first):
        raise AssertionError(f"PE repeat case: {st}, launches {launches}")
    print(f"repeat genome, {N_REPEAT_PAIRS} pairs of 2 x 150 bp, "
          f"--peinsertdist: --device cpu == cuda byte for byte (SAM "
          f"{len(rep_sam)} bytes, CSV {len(csv)} bytes); "
          f"{st['cuda']['proper']} proper pairs, {st['cuda']['rescued']} "
          f"mates rescued in {st['cuda']['scans']} window scans on the card; "
          f"launches {launches}")


def pe_engine(idx, r1, r2, dev, smi):
    """Phase 13: the PE engine alone, reads in host memory, and its
    decomposition.  reads/s = 2 x pairs / s."""
    import torch

    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.align.pe import PEAligner, PEParams
    from biokanga_tpu_torch.align.pipeline import AlignEngine
    from biokanga_tpu_torch.index.device import to_device

    pea = PEAligner(AlignEngine(to_device(idx, dev),
                                AlignParams(batch_size=BATCH)),
                    PEParams(pair_min_len=100, pair_max_len=600))
    ln = np.full(BATCH, READ_LEN, np.int32)
    batches = [(r1[s:s + BATCH], ln, r2[s:s + BATCH], ln)
               for s in range(0, N_PAIRS, BATCH)]
    pea.align_pairs(*batches[0])                               # warm-up

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        return time.monotonic() - t0, out

    def full():
        return sum(int(pea.align_pairs(*b)["proper"].sum()) for b in batches)

    def pipelined():
        n, inflight = 0, None
        for b in batches:
            nxt = pea.launch_pairs(*b)
            if inflight is not None:
                n += int(pea.finish_pairs(inflight)["proper"].sum())
            inflight = nxt
        return n + int(pea.finish_pairs(inflight)["proper"].sum())

    def launch_only():
        return [pea.launch_pairs(*b) for b in batches]

    t_full, t_pipe, t_launch, t_finish = [], [], [], []
    n_proper = 0
    for _ in range(5):
        t, n_proper = timed(full)
        t_full.append(t)
        t, n_pipe = timed(pipelined)
        t_pipe.append(t)
        if n_pipe != n_proper:
            raise AssertionError("launch/finish differs from align_pairs")
        t, pending = timed(launch_only)
        t_launch.append(t)
        # the device has drained: what is left is copies and host pairing
        t, _ = timed(lambda: [pea.finish_pairs(p) for p in pending])
        t_finish.append(t)
    rate = lambda ts: 2 * N_PAIRS / min(ts)
    print(f"PE engine: {rate(t_full):.1f} reads/s best of 5 epochs "
          f"(align_pairs; {', '.join(f'{2 * N_PAIRS / t:.1f}' for t in t_full)}"
          f"; {N_PAIRS} pairs of 2 x {READ_LEN} bp, batch {BATCH} pairs, "
          f"{n_proper} proper, {pea.rescued} mates rescued in "
          f"{pea.rescue_calls} window scans over all epochs) on {smi}")
    print(f"PE decomposition, best of 5, seconds for {N_PAIRS} pairs: full "
          f"path {min(t_full):.4f}; pipelined (launch k+1 before finish k) "
          f"{min(t_pipe):.4f}, {rate(t_pipe):.1f} reads/s; launch-only "
          f"(launch_pairs of all batches, then synchronize) "
          f"{min(t_launch):.4f}; host pairing (finish_pairs after the "
          f"device has drained: copies, classify, rescue) "
          f"{min(t_finish):.4f} ({smi})")


# ------------------------------------------------- single-end options ----

def _options_data(seqs, n_reads, snp_every, seed, block):
    """A sample of `seqs` with planted SNPs, simulated reads from it, and
    shares of them replaced by indel and junction reads (three a sample
    event, in one block of `block` rows) or given junk tails
    (tests/options_reads.py).  Returns (names, reads, snps, events,
    truth, depth): depth is each genome position's coverage by the plain
    simulated reads."""
    from biokanga_tpu_torch.sim.simreads import simulate_reads

    sys.path.insert(0, str(ROOT / "tests"))
    import options_reads as opt

    rng = np.random.default_rng(seed)
    sample, snps = opt.plant_snps(seqs, snp_every, rng)
    n_ind = round(OPT_INDEL_SHARE * n_reads / OPT_READS_PER_EVENT)
    n_spl = round(OPT_SPLICE_SHARE * n_reads / OPT_READS_PER_EVENT)
    events = opt.plan_events(seqs, n_ind, n_spl, snps, rng, spacing=100)
    names, reads, truths = simulate_reads(sample, n_reads, read_len=READ_LEN,
                                          sub_rate=0.002, seed=seed)
    offsets = np.cumsum([0] + [len(g) for _, g in seqs])
    entry = {nm: offsets[e] for e, (nm, _) in enumerate(seqs)}
    first = np.array([entry[t.chrom] + t.start - 1 for t in truths])
    truth = opt.alter_reads(names, reads, sample, events, rng,
                            OPT_INDEL_SHARE, OPT_SPLICE_SHARE, OPT_JUNK_SHARE,
                            block=block)
    plain = np.ones(n_reads, bool)
    for kind in "DIN":
        plain[[row for row, *_ in truth[kind]]] = False
    cov = np.zeros(offsets[-1] + 1, np.int64)
    np.add.at(cov, first[plain], 1)
    np.add.at(cov, first[plain] + READ_LEN, -1)
    truth["first"] = first
    return names, reads, snps, events, truth, np.cumsum(cov)[:-1], offsets


def _write_fastq(path: Path, names, reads) -> None:
    """The FASTQ of reads of one length with "I" qualities, the bytes of
    the package's write_fastq, built a block of records at a time: the
    script's only FASTQ writer (a record at a time takes seconds per
    100,000 reads)."""
    reads = np.asarray(reads)
    n, L = reads.shape
    mat = np.empty((n, 2 * L + 4), np.uint8)
    mat[:, :L] = np.frombuffer(b"ACGTN", np.uint8)[reads]
    mat[:, L:L + 3] = np.frombuffer(b"\n+\n", np.uint8)
    mat[:, L + 3:2 * L + 3] = ord("I")
    mat[:, -1] = ord("\n")
    w = mat.shape[1]
    with open(path, "wb") as f:
        for a in range(0, n, 65_536):
            blob = mat[a:a + 65_536].tobytes()
            f.write(b"".join(b"@" + names[a + i].encode() + b"\n"
                             + blob[i * w:(i + 1) * w]
                             for i in range(len(blob) // w)))


def _reachable(reads, truth, genome: np.ndarray, rows_a_pass=16_384) -> dict:
    """For each indel and junction read, whether its true diagonals are
    among the candidates the indel and splice scans see: the lowest
    SPLICE_CAND_CAP of its strand's seed diagonals, counted with
    multiplicity, from the cores of at most `cand_per_core` hits
    (biokanga_tpu/align/pipeline.py:797-818, `_strand_candidates` with
    `occ_skip`).  Computed here in numpy from the genome's k-mers, apart
    from the port's seeding, so that a port that lost true diagonals
    would miss the gate instead of shrinking its denominator.  On a
    genome whose cores have more hits than the cap holds, a read whose
    origin lies past the lowest ones cannot be placed by the JAX
    package's ExtendedAligner, nor by the port (ROADMAP.md, queue 3).
    The genome is one entry (`want` is its locus)."""
    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.align.pipeline import SPLICE_CAND_CAP
    from biokanga_tpu_torch.seq.encode import revcomp

    params = AlignParams()
    dp = params.derive(reads.shape[1], len(genome))
    H, k = params.cand_per_core, dp.core_len
    n = len(genome) - k + 1
    key = np.zeros(n, np.uint64)
    clean = np.ones(n, bool)
    for j in range(k):
        w = genome[j:j + n]
        key = (key << np.uint64(2)) | (w & 3).astype(np.uint64)
        clean &= w < 4
    pos = np.nonzero(clean)[0]
    order = np.argsort(key[pos], kind="stable")
    skey, spos = key[pos][order], pos[order]
    offs = np.asarray(dp.offsets)
    out = {}
    for kind in "DIN":
        t = truth[kind]
        rows = np.array([x[0] for x in t])
        want = np.array([x[2] for x in t], np.int64)
        second = want + np.array([x[4] for x in t])
        rc = np.array([x[3] == "-" for x in t])
        ok = np.zeros(len(rows), bool)
        for a in range(0, len(rows), rows_a_pass):
            sl = slice(a, a + rows_a_pass)
            seq = reads[rows[sl]]
            seq = np.where(rc[sl, None], revcomp(seq), seq)
            q = np.zeros((len(seq), len(offs)), np.uint64)
            has_n = np.zeros(q.shape, bool)
            for j in range(k):
                w = seq[:, offs + j]
                q = (q << np.uint64(2)) | (w & 3).astype(np.uint64)
                has_n |= w >= 4
            lo = np.searchsorted(skey, q, "left")
            size = np.searchsorted(skey, q, "right") - lo
            size[has_n | (size > H)] = 0
            j = np.arange(H)
            diag = spos[np.minimum(lo[..., None] + j, len(spos) - 1)] \
                - offs[None, :, None]
            flat = np.where((j < size[..., None]) & (diag >= 0), diag,
                            np.iinfo(np.int64).max).reshape(len(seq), -1)
            low = np.partition(flat, SPLICE_CAND_CAP - 1, axis=1)[
                :, :SPLICE_CAND_CAP]
            hit = (low == want[sl, None]).any(1)
            if kind == "N":
                hit &= (low == second[sl, None]).any(1)
            ok[sl] = hit
        out[kind] = ok
    return out


def _options_gates(sam: Path, snp_csv: Path, n_reads, snps, events, truth,
                   depth, offsets, names, reachable=None):
    """The gates of phases 14 and 15 from the SAM and the SNP CSV.
    Returns the numbers; raises if one misses its bar.  With `reachable`,
    the indel and junction bars hold over the reads the candidate cap
    leaves reachable (see _reachable); the share over all is reported."""
    import csv

    recs = _records(sam)[:n_reads]
    if len(recs) != n_reads:
        raise AssertionError(f"{len(recs)} records for {n_reads} reads")
    entry = {nm: e for e, nm in enumerate(names)}
    calls = {(r["Chrom"], int(r["StartLoci"])): r
             for r in csv.DictReader(open(snp_csv))}
    deep = [(c, p) for (c, p) in snps
            if depth[offsets[entry[c]] + p] >= OPT_MIN_DEPTH]
    hit = 0
    for c, p in deep:
        r = calls.get((c, p))
        if r is not None:
            mm = [int(r[f"MMBase{b}"]) for b in "ACGT"]
            hit += int(np.argmax(mm)) == snps[(c, p)][1]
    # a call at no planted SNP counts as off a planted locus, unless it
    # lies in an event's shadow, where the JAX package's ungapped pileup
    # shifts the event reads' bases (ROADMAP.md, queue 3)
    shadow = np.zeros(offsets[-1], bool)
    for kind, e, site, size, _ in events:
        shadow[offsets[e] + site: offsets[e] + site + OPT_EVENT_SHADOW] = True
    off = [k for k in calls if k not in snps]
    off_clean = [k for k in off if not shadow[offsets[entry[k[0]]] + k[1]]]
    out = {"planted": len(snps), "deep": len(deep),
           "recall": hit / max(len(deep), 1), "calls": len(calls),
           "off_planted": len(off),
           "off_in_event_shadow": len(off) - len(off_clean),
           "off_share": len(off_clean) / max(len(calls), 1)}
    bars = {"recall": out["recall"] >= OPT_MIN_RECALL,
            "off_share": out["off_share"] <= OPT_MAX_OFF}
    for kind in "DIN":
        good = np.array([
            f[4] == "60" and kind in f[5] and f[2] == chrom
            and int(f[3]) - 1 == p
            for f, (_, chrom, p, _, _) in (
                (recs[t[0]].split("\t"), t) for t in truth[kind])])
        out[f"recovered_{kind}"] = float(good.mean())
        if reachable is None:
            bars[kind] = good.mean() >= OPT_MIN_RECOVERY
        else:
            reach = reachable[kind]
            out[f"reachable_{kind}"] = float(reach.mean())
            out[f"recovered_reachable_{kind}"] = float(good[reach].mean())
            bars[kind] = good[reach].mean() >= OPT_MIN_RECOVERY
    good = 0
    for row in truth["junk"]:
        f = recs[row].split("\t")
        m = re.match(r"(\d+)S", f[5])
        clip5 = int(m[1]) if m else 0
        at = offsets[entry[f[2]]] + int(f[3]) - 1 - clip5 if f[4] == "60" \
            else -1
        good += "S" in f[5] and at == truth["first"][row]
    out["recovered_junk"] = good / len(truth["junk"])
    bars["junk"] = out["recovered_junk"] >= OPT_MIN_RECOVERY
    if not all(bars.values()):
        raise AssertionError(f"SE options gates missed "
                             f"{[k for k, v in bars.items() if not v]}: {out}")
    return out


def _timed_parts():
    """Wrap the engine, the indel/splice fall-through, the chimeric pass,
    the pileup, the two scans, call_snps and the SAM writer so that each
    call is timed between two device synchronisations; returns (totals
    in ms by part, undo).  The engine's time holds the fall-through's
    first pass; the fall-through's holds the scans'."""
    import torch

    from biokanga_tpu_torch.align import (
        multihit,
        pipeline,
        sam,
        snp,
        splice_indel,
    )

    ms = {}
    saved = []

    def wrap(owner, attr, part):
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))
        ms[part] = 0.0

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            ms[part] += (time.perf_counter() - t0) * 1e3
            return out
        setattr(owner, attr, timed)

    wrap(pipeline.AlignEngine, "align_with_rescue", "engine")
    wrap(pipeline.ExtendedAligner, "scan_rows", "fall_through_scans")
    wrap(splice_indel, "indel_scan", "indel_scan")
    wrap(splice_indel, "splice_scan", "splice_scan")
    wrap(multihit, "chimeric_pass", "chimeric_pass")
    wrap(snp, "pileup_batch", "pileup")
    wrap(snp, "call_snps", "call_snps")
    wrap(sam, "write_alignments_sam", "sam")

    def undo():
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)
    return ms, undo


def se_options_cell(seqs, dev, smi):
    """Phase 14: the SE options cell through the CLI on the card.  Returns
    the launches of kernels #1-#3 in the run."""
    from biokanga_tpu_torch import cli

    t0 = time.monotonic()
    names, reads, snps, events, truth, depth, offsets = _options_data(
        seqs, OPT_READS, OPT_SNP_EVERY, 14, BATCH)
    _write_fastq(WORK / "opt.fq", names, reads)
    setup_s = time.monotonic() - t0
    side = {"-O": "opt_snps.csv", "--snpvcf": "opt_snps.vcf",
            "--disnp": "opt_di.csv", "--trisnp": "opt_tri.csv",
            "--snpcentroid": "opt_cent.csv", "--stats": "opt_stats.csv"}
    argv = ["align", "-i", str(WORK / "opt.fq"), "-I", str(WORK / "ref.npz"),
            "-o", str(WORK / "opt.sam"), *OPT_FLAGS, "--device", "cuda",
            "--batch-size", str(BATCH)]
    for flag, name in side.items():
        argv += [flag, str(WORK / name)]
    ms, undo = _timed_parts()
    _reset_kernel_launches()
    try:
        import torch

        torch.cuda.synchronize()
        t0 = time.monotonic()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        undo()
    launches = _align_launches()
    if rc != 0 or min(launches.values()) < 1:
        raise AssertionError(f"SE options run rc={rc}, launches={launches}")
    gates = _options_gates(WORK / "opt.sam", WORK / side["-O"], OPT_READS,
                           snps, events, truth, depth, offsets,
                           [nm for nm, _ in seqs],
                           _reachable(reads, truth, seqs[0][1]))
    stats = dict(line.strip().replace('"', '').split(",") for line in
                 (WORK / side["--stats"]).read_text().splitlines()[1:9])
    parts = {k: round(v, 3) for k, v in ms.items()}
    gates = {k: round(v, 6) if isinstance(v, float) else v
             for k, v in gates.items()}
    print(f"SE options cell: {OPT_READS} x {READ_LEN} bp, {len(snps)} "
          f"planted SNPs, {len(events)} indel and junction events; `align "
          f"{' '.join(OPT_FLAGS)} -O --snpvcf --disnp --trisnp --snpcentroid "
          f"--stats --device cuda` wall {wall:.3f} s (data set-up "
          f"{setup_s:.1f} s); parts in ms: {json.dumps(parts)}; launches "
          f"{launches}; stats {json.dumps(stats)}; gates "
          f"{json.dumps(gates)} ({smi})")
    return launches


def _parity_run(argv, device, outs):
    from biokanga_tpu_torch import cli

    rc = cli.main(["align", *argv, "--device", device])
    if rc != 0:
        raise AssertionError(f"align --device {device} rc={rc}")
    return {o: (WORK / o).read_bytes() for o in outs}


def options_parity():
    """Phase 15: every SE option, and PE BAM output, with --device cpu and
    --device cuda on a 50 kb genome; the outputs byte for byte."""
    import shutil

    from biokanga_tpu_torch import cli
    from biokanga_tpu_torch.align import pipeline
    from biokanga_tpu_torch.seq.fasta import write_fasta
    from biokanga_tpu_torch.sim.simreads import random_genome, simulate_reads

    sys.path.insert(0, str(ROOT / "tests"))
    import options_reads as opt

    seqs = random_genome(PARITY_GENOME, seed=15)
    write_fasta(str(WORK / "par.fa"), seqs)
    if cli.main(["index", "-i", str(WORK / "par.fa"), "-o",
                 str(WORK / "par.npz"), "--lut-bases", "8"]) != 0:
        raise AssertionError("index of the parity genome failed")
    names, reads, snps, events, truth, depth, offsets = _options_data(
        seqs, PARITY_READS, PARITY_SNP_EVERY, 15, 4_096)
    _write_fastq(WORK / "par.fq", names, reads)
    rng = np.random.default_rng(16)
    opt.loci_constraints_csv(str(WORK / "par_constraints.csv"), seqs, rng)
    opt.priority_bed(str(WORK / "par_priority.bed"), seqs, rng)
    base = ["-i", str(WORK / "par.fq"), "-I", str(WORK / "par.npz")]

    # every output of the SNP, indel, splice and chimeric options
    side = ["snps.csv", "snps.vcf", "di.csv", "tri.csv", "cent.csv",
            "stats.csv"]
    got = {}
    for d in ("cpu", "cuda"):
        files = [f"par_{d}.sam"] + [f"par_{d}_{x}" for x in side]
        argv = base + ["-o", str(WORK / files[0]), *OPT_FLAGS]
        for flag, f in zip(("-O", "--snpvcf", "--disnp", "--trisnp",
                            "--snpcentroid", "--stats"), files[1:]):
            argv += [flag, str(WORK / f)]
        got[d] = list(_parity_run(argv, d, files).values())
    for name, a, b in zip(["sam"] + side, got["cpu"], got["cuda"]):
        if a != b:
            raise AssertionError(f"phase 15: {name} differs cpu vs cuda")
    n_calls = got["cpu"][1].count(b"\n") - 1
    cig = "".join(r.split("\t")[5] for r in
                  got["cpu"][0].decode().splitlines()
                  if not r.startswith("@"))
    if n_calls < 20 or not all(op in cig for op in "DINS"):
        raise AssertionError(f"phase 15: {n_calls} SNP calls, CIGAR ops "
                             f"{sorted(set(cig) - set('0123456789'))}")
    # the gates of phase 14 on this genome, where every core's hits fit
    # the candidate cap: over all indel and junction reads
    gates = _options_gates(WORK / "par_cuda.sam", WORK / "par_cuda_snps.csv",
                           PARITY_READS, snps, events, truth, depth, offsets,
                           [nm for nm, _ in seqs])

    # the post-passes, BAM, checkpoints and -q: cpu once, cuda twice (the
    # second run resumes from its checkpoints)
    more = ["-x", "3", "-y", "2", "-k", "2", "--min-accept-len", "90",
            "--minflankexacts", "5", "--pcrprimersubs", "2",
            "--lociconstraints", str(WORK / "par_constraints.csv"),
            "-Y", str(WORK / "par_priority.bed")]
    bams, rows, engine_calls = [], [], []
    real = pipeline.AlignEngine.align_with_rescue
    for run, d in enumerate(("cpu", "cuda", "cuda")):
        ck = WORK / f"par_ck_{d}"
        if run < 2:
            shutil.rmtree(ck, ignore_errors=True)
        db = WORK / f"par_{run}.db"
        db.unlink(missing_ok=True)
        calls = [0]

        def counted(self, *a, **k):
            calls[0] += 1
            return real(self, *a, **k)
        pipeline.AlignEngine.align_with_rescue = counted
        try:
            out = f"par_{run}.bam"
            res = _parity_run(base + more + [
                "-o", str(WORK / out), "--checkpoint-dir", str(ck),
                "-q", str(db)], d, [out, out + ".bai"])
        finally:
            pipeline.AlignEngine.align_with_rescue = real
        bams.append(tuple(res.values()))
        rows.append(opt.sumrslts_rows(db))
        engine_calls.append(calls[0])
    if not bams[0] == bams[1] == bams[2]:
        raise AssertionError("phase 15: BAM or BAI differs cpu/cuda/resume")
    if not rows[0] == rows[1] == rows[2]:
        raise AssertionError("phase 15: -q rows differ")
    if engine_calls[2] != 0 or engine_calls[1] < 3:
        raise AssertionError(f"phase 15: engine calls {engine_calls}; the "
                             f"second card run did not resume")

    # paired ends into BAM
    pn, pr, _ = simulate_reads(seqs, PARITY_PAIRS, read_len=READ_LEN,
                               sub_rate=0.01, seed=17, pe=True,
                               insert_min=200, insert_max=500)
    _write_pairs("par_p", pn, pr, PARITY_PAIRS)
    pe = {}
    for d in ("cpu", "cuda"):
        out = f"par_pe_{d}.bam"
        pe[d] = list(_parity_run([
            "-i", str(WORK / "par_p1.fq"), "-u", str(WORK / "par_p2.fq"),
            "-I", str(WORK / "par.npz"), "-o", str(WORK / out), *PE_FLAGS],
            d, [out, out + ".bai"]).values())
    if pe["cpu"] != pe["cuda"]:
        raise AssertionError("phase 15: PE BAM differs cpu vs cuda")
    gates = {k: round(v, 6) if isinstance(v, float) else v
             for k, v in gates.items()}
    print(f"SE options parity on {sum(n for _, n in PARITY_GENOME)} bp, "
          f"{PARITY_READS} reads: --device cpu == cuda byte for byte for "
          f"the SAM and {len(side)} side files ({n_calls} SNP calls; gates "
          f"on the card's run {json.dumps(gates)}); BAM, "
          f"BAI and -q rows of the post-pass run equal on cpu, cuda and "
          f"the resumed cuda run ({len(bams[0][0])} bytes; engine calls "
          f"{engine_calls}); PE BAM of {PARITY_PAIRS} pairs equal "
          f"({len(pe['cpu'][0])} bytes)")


def _cpu_child(argv, tag: str):
    """`python -m biokanga_tpu_torch <argv> --device cpu` as a child
    process that sees no card, beside the phases that follow."""
    import atexit
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    err = open(WORK / f"{tag}.err", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "biokanga_tpu_torch", *argv, "--device",
         "cpu"], cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err)
    err.close()
    atexit.register(lambda: proc.poll() is None and (proc.kill(),
                                                     proc.wait()))
    return proc


def _wait_child(proc, tag: str) -> None:
    if proc.wait() != 0:
        raise AssertionError(f"{tag} --device cpu rc={proc.returncode}: "
                             f"{(WORK / f'{tag}.err').read_text()[-2000:]}")


def _timed_cli(argv) -> float:
    """Wall seconds of `python -m biokanga_tpu_torch <argv>` in process,
    between two device synchronisations; raises on a non-zero exit."""
    import torch

    from biokanga_tpu_torch import cli

    torch.cuda.synchronize()
    t0 = time.monotonic()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"{' '.join(argv[:3])} rc={rc}")
    return time.monotonic() - t0


def chunked_cli_start(seqs) -> dict:
    """Phase 16, first half: `index --chunks 4` of the 4.6 Mbp genome, the
    SE options cell's sample (seed 16) read as 65,536 single reads with
    indel, junction and junk-tailed reads, and as 65,536 pairs; `align
    -a 10 -A 50000 -O` and `align -u -d 100 -D 600` on the chunked index.
    The --device cpu runs start as child processes; the --device cuda
    runs follow in process, on each chunked path (`_chunk_path`), with
    kernels #1-#3 counted."""
    from biokanga_tpu_torch import cli
    from biokanga_tpu_torch.sim.simreads import simulate_reads

    sys.path.insert(0, str(ROOT / "tests"))
    import options_reads as opt

    t0 = time.monotonic()
    if cli.main(["index", "-i", str(WORK / "ref.fa"), "-o",
                 str(WORK / "ck.npz"), "--chunks", str(CHUNKED_CHUNKS),
                 "--chunk-overlap", "2048", "--lut-bases", "10"]) != 0:
        raise AssertionError("index --chunks failed")
    index_s = time.monotonic() - t0
    names, reads, *_ = _options_data(seqs, CHUNKED_SE_READS, OPT_SNP_EVERY,
                                     16, BATCH)
    _write_fastq(WORK / "ck_se.fq", names, reads)
    sample, _ = opt.plant_snps(seqs, OPT_SNP_EVERY,
                               np.random.default_rng(16))
    pn, pr, _ = simulate_reads(sample, CHUNKED_PE_PAIRS, read_len=READ_LEN,
                               sub_rate=0.01, seed=17, pe=True,
                               insert_min=PE_INSERT[0],
                               insert_max=PE_INSERT[1])
    _write_pairs("ck_pe", pn, pr, CHUNKED_PE_PAIRS)
    setup_s = time.monotonic() - t0
    runs = {}
    for kind, inputs, flags in (
            ("se", ["-i", str(WORK / "ck_se.fq")],
             [*CHUNKED_SE_FLAGS, "-O", "SNPS"]),
            ("pe", ["-i", str(WORK / "ck_pe1.fq"), "-u",
                    str(WORK / "ck_pe2.fq")],
             [*PE_FLAGS, "--peinsertdist", "INS"])):
        argv = {}
        for d in ("cpu", *CHUNK_PATHS):
            side = {"SNPS": WORK / f"ck_{kind}_{d}_snps.csv",
                    "INS": WORK / f"ck_{kind}_{d}_ins.csv"}
            for f in side.values():
                f.unlink(missing_ok=True)
            argv[d] = ["align", *inputs, "-I", str(WORK / "ck.npz"), "-o",
                       str(WORK / f"ck_{kind}_{d}.sam"), "--batch-size",
                       str(BATCH), *[str(side.get(a, a)) for a in flags]]
        runs[kind] = {"proc": _cpu_child(argv["cpu"], f"ck_{kind}_cpu"),
                      "argv": argv}
    for kind, run in runs.items():
        for path in CHUNK_PATHS:
            _reset_kernel_launches()
            with _chunk_path(path) as seen:
                wall = _timed_cli(run["argv"][path] + ["--device", "cuda"])
            counts = _kernel_launches()
            merge = {k: counts[k] for k in CHUNK_MERGE_KERNELS}
            run[path] = {"wall": wall, "launches": _align_launches(),
                         "merge_launches": merge, **seen}
            if min(run[path]["launches"].values()) < 1:
                raise AssertionError(f"chunked {kind} {path}: launches "
                                     f"{run[path]['launches']}")
            # the select and the merge run on the resident path of the PE
            # run alone: the SE run streams blocks chunk by chunk
            # (`align_blocks`) and merges on the host
            on = kind == "pe" and path == "resident"
            if any((n > 0) != on for n in merge.values()):
                raise AssertionError(f"chunked {kind} {path}: select and "
                                     f"merge launches {merge}")
            want = ((1, 0) if path == "resident" else (0, CHUNKED_CHUNKS))
            got = (seen["resident_sets"], seen["chunk_uploads"])
            if got[0] != want[0] or got[1] < want[1]:
                raise AssertionError(f"chunked {kind} {path}: resident sets, "
                                     f"chunk uploads {got}")
    print(f"chunked CLI: `index --chunks {CHUNKED_CHUNKS}` of the 4.6 Mbp "
          f"genome in {index_s:.2f} s (data set-up {setup_s:.1f} s)")
    for kind, what in (("se", f"{CHUNKED_SE_READS} SE reads `align "
                               f"{' '.join(CHUNKED_SE_FLAGS)} -O"),
                       ("pe", f"{CHUNKED_PE_PAIRS} pairs `align -u "
                               f"{' '.join(PE_FLAGS)}")):
        for path in CHUNK_PATHS:
            r = runs[kind][path]
            print(f"chunked CLI {path}: {what} --device cuda` wall "
                  f"{r['wall']:.2f} s, launches {r['launches']} "
                  f"{r['merge_launches']}, chunk uploads "
                  f"{r['chunk_uploads']}")
    return runs


@contextlib.contextmanager
def _chunk_path(path: str):
    """Count, in the block, the chunked aligner's uploads of a whole
    resident set and of single chunks; "cycling" tells it that no index
    fits the card, so that it cycles the chunks through one engine."""
    from biokanga_tpu_torch.parallel import chunked as par

    seen = {"resident_sets": 0, "chunk_uploads": 0}
    saved = (par.upload_chunked_index, par.chunk_to_device,
             par.fits_on_device)

    def upload(*a, **k):
        seen["resident_sets"] += 1
        return saved[0](*a, **k)

    def one(*a, **k):
        seen["chunk_uploads"] += 1
        return saved[1](*a, **k)

    par.upload_chunked_index, par.chunk_to_device = upload, one
    if path == "cycling":
        par.fits_on_device = lambda *a: False
    try:
        yield seen
    finally:
        (par.upload_chunked_index, par.chunk_to_device,
         par.fits_on_device) = saved


def chunked_cli_finish(runs) -> None:
    """Phase 16, second half: the --device cpu runs' SAM and SNP CSV byte
    for byte against the card's.  The chunked branch, like the JAX
    CLI's, writes no insert CSV."""
    for kind, run in runs.items():
        _wait_child(run["proc"], f"ck_{kind}_cpu")
    for name in ("ck_se_{}.sam", "ck_se_{}_snps.csv", "ck_pe_{}.sam"):
        a = (WORK / name.format("cpu")).read_bytes()
        for path in CHUNK_PATHS:
            if a != (WORK / name.format(path)).read_bytes():
                raise AssertionError(f"chunked CLI: {name.format('*')} "
                                     f"differs between --device cpu and "
                                     f"cuda, {path}")
    if any((WORK / f"ck_pe_{d}_ins.csv").exists()
           for d in ("cpu", *CHUNK_PATHS)):
        raise AssertionError("the chunked PE branch wrote an insert CSV")
    se = [r.split("\t") for r in _records(WORK / "ck_se_resident.sam")]
    n_calls = (WORK / "ck_se_resident_snps.csv").read_text().count("\n") - 1
    ops = sum(any(c in r[5] for c in "DIN") for r in se)
    proper, at_origin = _pe_origin_fractions(WORK / "ck_pe_resident.sam",
                                             CHUNKED_PE_PAIRS)
    print(f"chunked CLI: --device cpu == --device cuda, resident and "
          f"cycling, byte for byte: SE "
          f"SAM ({sum(r[4] == '60' for r in se)} of {len(se)} reads unique, "
          f"{ops} with an indel or junction CIGAR), SNP CSV ({n_calls} "
          f"calls), PE SAM (proper {proper:.6f}, both mates at origin "
          f"{at_origin:.6f}); no insert CSV from either, as from the JAX "
          f"CLI's chunked branch")
    if n_calls < 1 or ops < 100 or proper < MIN_TRUE_FRACTION:
        raise AssertionError(f"chunked CLI: {n_calls} SNP calls, {ops} "
                             f"CIGAR ops, proper {proper:.4%}")


def _long_read_set(g: np.ndarray):
    """LR_READS reads of LR_LEN bases from `g`, LR_SUBS substitutions
    each, every other one reverse-complemented."""
    from biokanga_tpu_torch.seq.encode import revcomp

    rng = np.random.default_rng(19)
    starts = rng.integers(0, len(g) - LR_LEN, LR_READS)
    reads = np.stack([g[s:s + LR_LEN] for s in starts]).copy()
    for i, r in enumerate(reads):
        mut = rng.choice(LR_LEN, LR_SUBS, replace=False)
        r[mut] = (r[mut] + rng.integers(1, 4, LR_SUBS)) % 4
        if i % 2:
            reads[i] = revcomp(r)
    return reads, starts


def long_reads_start(seqs):
    """Phase 17, first half: LONG_READS reads of LONG_LEN bases (past the
    packed extension's 4,096) against the SE cell's index with `align`,
    the dense extension path; the --device cpu run is a child process.
    On the card, each dense extension call is timed between two
    synchronisations with its own peak memory."""
    import torch

    from biokanga_tpu_torch.align import pipeline
    from biokanga_tpu_torch.sim.simreads import simulate_reads

    names, reads, _ = simulate_reads(seqs, LONG_READS, read_len=LONG_LEN,
                                     sub_rate=LONG_SUB_RATE, seed=18)
    _write_fastq(WORK / "dense.fq", names, reads)
    argv = {d: ["align", "-i", str(WORK / "dense.fq"), "-I",
                str(WORK / "ref.npz"), "-o", str(WORK / f"dense_{d}.sam"),
                "--batch-size", str(LONG_READS)] for d in ("cpu", "cuda")}
    proc = _cpu_child(argv["cpu"], "dense_cpu")
    calls = []
    dense = pipeline.hamming_extend

    def timed(*args):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        out = dense(*args)
        torch.cuda.synchronize()
        calls.append((time.monotonic() - t0,
                      torch.cuda.max_memory_allocated() - base,
                      int(args[3].sum())))
        return out

    pipeline.hamming_extend = timed
    _reset_kernel_launches()
    try:
        wall = _timed_cli(argv["cuda"] + ["--device", "cuda"])
    finally:
        pipeline.hamming_extend = dense
    return {"proc": proc, "wall": wall, "calls": calls,
            "launches": _align_launches()}


def long_reads_finish(run, seqs, dev, smi) -> dict:
    """Phase 17, second half: the --device cpu SAM byte for byte, every
    read unique at its origin; then LongReadAligner on LR_READS reads of
    LR_LEN bases on the card and on the CPU, dicts equal, every read at
    its origin.  Returns the launches of #1-#3 in the phase's card runs."""
    import torch

    from biokanga_tpu_torch.align.longread import LongReadAligner
    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.align.pipeline import AlignEngine
    from biokanga_tpu_torch.index.build import load_index
    from biokanga_tpu_torch.index.device import to_device

    _wait_child(run["proc"], "dense_cpu")
    sam = (WORK / "dense_cuda.sam").read_bytes()
    if (WORK / "dense_cpu.sam").read_bytes() != sam:
        raise AssertionError("long reads: SAM differs cpu vs cuda")
    frac = _true_unique_fraction(WORK / "dense_cuda.sam", LONG_READS)
    secs, peaks, cands = zip(*run["calls"])
    print(f"long reads: {LONG_READS} x {LONG_LEN} bp `align --device cuda` "
          f"wall {run['wall']:.2f} s, SAM == --device cpu byte for byte, "
          f"unique at origin {frac:.6f}; dense extension: {len(secs)} "
          f"calls (a strand a batch of {LONG_READS}), "
          f"{', '.join(f'{1e3 * t:.3f}' for t in secs)} ms, valid "
          f"candidates {list(cands)}, peak memory "
          f"{max(peaks) / 2**20:.1f} MiB ({smi})")
    if frac < 1.0:
        raise AssertionError(f"long reads: {frac:.4%} at their origin")

    idx = load_index(str(WORK / "ref.npz"))
    reads, starts = _long_read_set(seqs[0][1])
    lens = np.full(LR_READS, LR_LEN, np.int32)
    out = {}
    for d in ("cuda", "cpu"):
        lr = LongReadAligner(AlignEngine(to_device(idx, torch.device(d)),
                                         AlignParams()))
        _reset_kernel_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out[d] = lr.align(reads, lens)
        torch.cuda.synchronize()
        out[d + "_s"] = time.monotonic() - t0
        if d == "cuda":
            launches = {k: v + run["launches"][k]
                        for k, v in _align_launches().items()}
    for k in ("unique", "locus", "is_rc", "best_mm"):
        if not np.array_equal(out["cuda"][k], out["cpu"][k]):
            raise AssertionError(f"LongReadAligner: {k} differs cpu/cuda")
    r = out["cuda"]
    ok = (r["unique"] & (r["locus"] == starts)
          & (r["is_rc"] == (np.arange(LR_READS) % 2 == 1))
          & (r["best_mm"] == LR_SUBS))
    print(f"LongReadAligner: {LR_READS} x {LR_LEN} bp, {LR_SUBS} subs each: "
          f"cuda {out['cuda_s']:.2f} s, cpu {out['cpu_s']:.2f} s, dicts "
          f"equal, {int(ok.sum())} at their origin with their strand and "
          f"substitutions; #1-#3 launches in phase 17's card runs "
          f"{launches} ({smi})")
    if not ok.all() or min(launches.values()) < 1:
        raise AssertionError(f"LongReadAligner: {int(ok.sum())} placed, "
                             f"launches {launches}")
    return launches


def _seed_stabs(params, genome_len: int) -> list[int]:
    """Fewest read positions that hit every seed core of a READ_LEN-base
    read, in the classic pass and in the fast pass (greedy interval
    stabbing at each core's last base)."""
    dp = params.derive(READ_LEN, genome_len)
    cores = [(o, o + dp.core_len) for o in dp.offsets]
    fp = params.derive_fast(READ_LEN, genome_len, BIG_LUT_BASES)
    if fp is not None:
        cores += [(o, o + fp.dp.core_len) for o in fp.dp.offsets]
    stabs = []
    for a, b in sorted(cores, key=lambda c: c[1]):
        if not stabs or stabs[-1] < a:
            stabs.append(b - 1)
    return stabs


def _big_genome(dev, n_bp: int, seed: int = 30):
    """The big genome, made on the device from a seed and brought to the
    host once: n_bp random bases in BIG_ENTRIES entries of equal length
    (the last takes the rest), scripts/bench_3gbp.py's layout."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randint(0, 4, (n_bp,), generator=gen, device=dev,
                      dtype=torch.int8).cpu().numpy()
    per = n_bp // BIG_ENTRIES
    bounds = [per * i for i in range(BIG_ENTRIES)] + [n_bp]
    return [(f"chr{i + 1}", g[bounds[i]:bounds[i + 1]])
            for i in range(BIG_ENTRIES)]


def _rescue_by_chunk(ca, blocks, res1, res2, pe, dev) -> int:
    """PE classification and orphan rescue grouped by the anchor's chunk
    (scripts/bench_3gbp.py:121-196): each chunk that holds anchors gets
    its packed rows alone (no suffix sort) and one windowed rescue of its
    orphans' mates.  Updates res1/res2 in place; returns mates rescued."""
    from types import SimpleNamespace

    import torch

    from biokanga_tpu_torch.align.pe import PEAligner, classify_pairs
    from biokanga_tpu_torch.parallel.chunked import chunk_of
    from biokanga_tpu_torch.seq.encode import revcomp

    nb = len(res1)
    orphans = {}                       # chunk -> [(pair block, row, which)]
    for pb in range(nb):
        c = classify_pairs(res1[pb], res2[pb], blocks[pb][1],
                           blocks[nb + pb][1], ca.entry_starts, pe)
        for which, anch in ((1, res1[pb]), (2, res2[pb])):
            rows = np.nonzero(c[f"orphan{which}"])[0]
            ak = chunk_of(ca.bases, anch["locus"][rows])
            for k in np.unique(ak):
                orphans.setdefault(int(k), []).extend(
                    (pb, int(r), which) for r in rows[ak == k])
    n_rescued = 0
    pea = PEAligner(ca, pe)
    for k, items in sorted(orphans.items()):
        _, pg, es_k = ca.packed_chunk(k)
        didx = SimpleNamespace(packed=pg, device=dev,
                               entry_starts=torch.from_numpy(
                                   es_k.astype(np.int32)).to(dev))
        engine = SimpleNamespace(didx=didx, params=ca.params)
        L = blocks[0][0].shape[1]
        a_loc = np.empty(len(items), np.int64)
        a_rc = np.empty(len(items), bool)
        a_len = np.empty(len(items), np.int32)
        m_reads = np.full((len(items), L), 4, np.int8)
        m_len = np.empty(len(items), np.int32)
        for j, (pb, r, which) in enumerate(items):
            anch = res1[pb] if which == 1 else res2[pb]
            a_blk, m_blk = ((blocks[pb], blocks[nb + pb]) if which == 1
                            else (blocks[nb + pb], blocks[pb]))
            a_loc[j] = anch["locus"][r] - int(ca.bases[k])
            a_rc[j] = anch["is_rc"][r]
            a_len[j] = a_blk[1][r]
            m_len[j] = ml = m_blk[1][r]
            row = m_blk[0][r, :ml]
            # FR: the mate of a forward anchor is scanned as its revcomp
            m_reads[j, :ml] = row if a_rc[j] else revcomp(row)
        out = pea.rescue(engine, a_loc.astype(np.int32), a_rc, a_len,
                         m_reads, m_len)
        for j in np.nonzero(out["ok"])[0]:
            pb, r, which = items[j]
            mres = res2[pb] if which == 1 else res1[pb]
            mres["unique"][r] = True
            mres["locus"][r] = int(out["locus"][j]) + int(ca.bases[k])
            mres["is_rc"][r] = not a_rc[j]
            mres["best_mm"][r] = out["mm"][j]
            n_rescued += 1
    return n_rescued


def big_genome_cell(dev, smi, n_bp=BIG_GENOME_BP, n_pairs=BIG_PAIRS,
                    max_chunk=BIG_MAX_CHUNK, block=BIG_BLOCK,
                    n_chunks=BIG_CHUNKS) -> dict:
    """Phase 18: PE reads against a genome past 2^31 bases on one card
    (scripts/bench_3gbp.py's flow): DeviceBuildChunkedAligner builds each
    chunk's index on the card, two_level_chunk_sweep runs the fast pass
    per (chunk, block) and a classic cycle for the reads the merge leaves
    unresolved, then classification and the orphan rescue by the anchor's
    chunk.  Gates: PERF.md's PE bars, and mates placed past 2^31.
    Returns the launches of #1-#3 in the run."""
    import torch

    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.align.pe import PEParams, classify_pairs
    from biokanga_tpu_torch.align.pipeline import pad_rows
    from biokanga_tpu_torch.index.device_build import (
        DeviceBuildChunkedAligner,
    )
    from biokanga_tpu_torch.parallel.chunked import two_level_chunk_sweep
    from biokanga_tpu_torch.sim.simreads import simulate_reads

    t0 = time.monotonic()
    seqs = _big_genome(dev, n_bp)
    names, reads, truths = simulate_reads(
        seqs, n_pairs, read_len=READ_LEN, sub_rate=0.01, seed=31, pe=True,
        insert_min=PE_INSERT[0], insert_max=PE_INSERT[1])
    del names
    offs = dict(zip([nm for nm, _ in seqs],
                    np.cumsum([0] + [len(s) for _, s in seqs])[:-1]))
    origin = np.array([offs[t.chrom] + t.start - 1 for t in truths],
                      np.int64).reshape(n_pairs, 2)
    del truths
    params = AlignParams(batch_size=block)
    pe = PEParams(pair_min_len=100, pair_max_len=600)
    ca = DeviceBuildChunkedAligner(seqs, params, max_chunk=max_chunk,
                                   overlap=BIG_OVERLAP,
                                   lut_bases=BIG_LUT_BASES, device=dev)
    ca.time_builds = True
    del seqs
    # every BIG_ORPHAN_EVERY-th pair: a second mate with a substitution in
    # each seed core of both passes (no seed hit; 7 substitutions at this
    # genome's 14-base cores, within the budget of 10), an orphan that only
    # the rescue places
    kill = _seed_stabs(params, ca.pad_n)
    mates = reads[1::2 * BIG_ORPHAN_EVERY]
    mates[:, kill] = (mates[:, kill] + 1) % 4
    reads[1::2 * BIG_ORPHAN_EVERY] = mates
    lens = np.full(n_pairs, READ_LEN, np.int32)
    blocks = [pad_rows(reads[m::2][i:i + block], lens[i:i + block])
              for m in (0, 1) for i in range(0, n_pairs, block)]
    del reads
    setup_s = time.monotonic() - t0
    if ca.num_chunks != n_chunks or ca.entry_starts[-1] != n_bp:
        raise AssertionError(f"{ca.num_chunks} chunks of {n_bp} bases")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_launches()
    marks = {}

    def progress(phase, k):
        marks[phase] = time.monotonic()

    t0 = time.monotonic()
    merged = two_level_chunk_sweep(ca, blocks, progress=progress)
    t1 = time.monotonic()
    nb = len(blocks) // 2
    res1, res2 = merged[:nb], merged[nb:]
    n_rescued = _rescue_by_chunk(ca, blocks, res1, res2, pe, dev)
    torch.cuda.synchronize()
    t2 = time.monotonic()
    launches = _align_launches()
    peak = torch.cuda.max_memory_allocated()
    builds = list(ca.build_s)
    unresolved = len(builds) > n_chunks
    starts = ca.entry_starts
    ca._engine = None
    del ca
    torch.cuda.empty_cache()

    proper = both = past = 0
    for pb in range(nb):
        c = classify_pairs(res1[pb], res2[pb], blocks[pb][1],
                           blocks[nb + pb][1], starts, pe)
        o = origin[pb * block:(pb + 1) * block]
        n = len(o)
        hit = [r["unique"][:n] & (r["locus"][:n] == o[:, m])
               for m, r in enumerate((res1[pb], res2[pb]))]
        pr = c["proper"][:n]
        proper += int(pr.sum())
        both += int((pr & hit[0] & hit[1]).sum())
        past += sum(int((h & (o[:, m] >= 2**31)).sum())
                    for m, h in enumerate(hit))
    fast_s = marks["fast"] - t0
    classic_s = t1 - marks["fast"]
    gates = {"proper": proper / n_pairs, "both_at_origin":
             both / max(proper, 1), "mates_at_origin_past_2^31": past}
    print(f"big genome: {n_bp} bp in {BIG_ENTRIES} entries, "
          f"{n_chunks} chunks of at most {max_chunk} bases (overlap "
          f"{BIG_OVERLAP}, LUT {BIG_LUT_BASES} bases), {n_pairs} pairs of "
          f"2 x {READ_LEN} bp in blocks of {block}; genome and reads set-up "
          f"{setup_s:.1f} s; chunk device builds (s, fast cycle then "
          f"classic cycle) {[round(b, 3) for b in builds]}; fast cycle "
          f"{fast_s:.2f} s, classic cycle {classic_s:.2f} s "
          f"({'ran' if unresolved else 'none unresolved'}); rescue "
          f"{t2 - t1:.2f} s ({n_rescued} mates); {n_pairs / (t2 - t0):.1f} "
          f"pairs/s ({2 * n_pairs / (t2 - t0):.1f} reads/s); peak device "
          f"memory {peak / 2**30:.2f} GiB; launches {launches}; gates "
          f"{json.dumps(gates)} ({smi})")
    if (gates["proper"] < MIN_TRUE_FRACTION
            or gates["both_at_origin"] < MIN_TRUE_FRACTION
            or (n_bp > 2**31 and past < 1) or min(launches.values()) < 1
            or n_rescued < n_pairs // BIG_ORPHAN_EVERY // 2):
        raise AssertionError(f"big genome: gates {gates}, launches "
                             f"{launches}")
    return launches


# -------------------------------------------------------- several ranks ----

def _save(name: str, obj) -> None:
    import pickle

    tmp = WORK / f"{name}.tmp"
    tmp.write_bytes(pickle.dumps(obj))
    tmp.replace(WORK / f"{name}.pkl")


def _load(name: str):
    import pickle

    return pickle.loads((WORK / f"{name}.pkl").read_bytes())


def _rank_main(rank: int, world: int, init_method: str) -> None:
    """One rank of phase 19, on cuda:0 (four ranks share the card; gloo
    between them).  Writes its own report and, on rank 0, the gathered
    results to build/chip_smoke/."""
    import torch
    import torch.distributed as dist

    import biokanga_tpu_torch.parallel.sharded as sharded
    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.align.pipeline import _rc_reads
    from biokanga_tpu_torch.index.chunked import load_chunked_index
    from biokanga_tpu_torch.pacbio.ecreads import ECParams, ec_reads
    from biokanga_tpu_torch.parallel.chunked import chunk_of
    from biokanga_tpu_torch.parallel.dist import (
        all_gather_sp,
        init_ranks,
        make_mesh,
    )
    from biokanga_tpu_torch.parallel.swservice import make_sw_mesh
    from biokanga_tpu_torch.seq.fasta import (
        read_blocks,
        read_seqs,
        write_fasta,
    )

    torch.set_num_threads(1)
    init_ranks("gloo", init_method, world, rank)
    report = {"rank": rank}
    # the collective's time, taken in a second pass of its own so that
    # reads/s comes from the path as it ships: the gather of each merge,
    # from a barrier of the sp group (the wait for its slowest rank, kept
    # apart) to the device's synchronisation (under gloo it includes the
    # copies to and from the host)
    coll = {"s": 0.0, "wait_s": 0.0, "n": 0}
    gather = sharded.all_gather_sp

    def timed_gather(mesh, t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.barrier(group=mesh.sp_group)
        t1 = time.perf_counter()
        out = gather(mesh, t)
        torch.cuda.synchronize()
        coll["wait_s"] += t1 - t0
        coll["s"] += time.perf_counter() - t1
        coll["n"] += 1
        return out

    def one_pass(sa, mesh, reads, lengths):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocks = []
        for s in range(0, len(reads), BATCH):
            rows = mesh.rows(BATCH)
            blocks.append(sa.align(reads[s:s + BATCH][rows],
                                   lengths[s:s + BATCH][rows]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dist.barrier()
        return blocks, wall

    try:
        # the SE cell at each layout
        reads = np.load(WORK / "se_reads.npy")
        lengths = np.full(len(reads), READ_LEN, np.int32)
        for n_dp, n_sp in RANK_LAYOUTS:
            mesh = make_mesh(n_dp, n_sp)
            sa = sharded.ShardedAligner(
                mesh, load_chunked_index(str(WORK / RANK_INDEX[n_sp])),
                AlignParams(batch_size=BATCH))
            # warm at the batch's own shape (allocations, gloo buffers)
            warm = mesh.rows(BATCH)
            sa.align(reads[:BATCH][warm], lengths[:BATCH][warm])
            torch.cuda.reset_peak_memory_stats()
            _reset_kernel_launches()
            blocks, wall = one_pass(sa, mesh, reads, lengths)
            peak, launches = torch.cuda.max_memory_allocated(), \
                _kernel_launches()
            coll.update(s=0.0, wait_s=0.0, n=0)
            sharded.all_gather_sp = timed_gather
            try:
                _, timed_wall = one_pass(sa, mesh, reads, lengths)
            finally:
                sharded.all_gather_sp = gather
            _, wall2 = one_pass(sa, mesh, reads, lengths)
            report[f"{n_dp}x{n_sp}"] = {
                "wall_s": wall, "wall2_s": wall2, "timed_wall_s": timed_wall,
                "gather_s": coll["s"], "wait_s": coll["wait_s"],
                "gathers": coll["n"], "peak_bytes": peak,
                "launches": launches}
            full = [sharded.gather_results(mesh, b) for b in blocks]
            if rank == 0:
                _save(f"ranks_se_{n_dp}x{n_sp}", full)
            del sa, blocks, full
            torch.cuda.empty_cache()

        # the options sample: align_extended and the sharded pileup
        mesh = make_mesh(*RANK_OPTIONS_LAYOUT)
        if mesh is not None:
            _reset_kernel_launches()
            blk = next(read_blocks(str(WORK / "ck_se.fq"), block_size=BATCH))
            sa = sharded.ShardedAligner(
                mesh, load_chunked_index(str(WORK / RANK_INDEX[2])),
                AlignParams(batch_size=BATCH))
            t0 = time.perf_counter()
            res = sa.align_extended(blk.codes, blk.lengths, 10, 50_000)
            r = torch.from_numpy(blk.codes).to(mesh.device)
            ln = torch.from_numpy(blk.lengths).to(mesh.device)
            flip = torch.from_numpy(res["unique"] & res["is_rc"]).to(
                mesh.device)
            aligned = torch.where(flip[:, None], _rc_reads(r, ln), r)
            chunk = chunk_of(sa.sidx.bases, res["locus"])
            planes = sharded.build_sharded_pileup_fn(mesh, sa.sidx)(
                chunk, res["locus"] - sa.sidx.bases[chunk],
                aligned.cpu().numpy(), blk.lengths, res["unique"])
            planes = [all_gather_sp(mesh, p).cpu().numpy() for p in planes]
            torch.cuda.synchronize()
            report["options"] = {"wall_s": time.perf_counter() - t0,
                                 "launches": _kernel_launches()}
            if rank == 0:
                _save("ranks_options", {
                    "res": res, "planes": [sharded.combine_pileup_planes(
                        p, sa.sidx) for p in planes]})
            del sa

        # the EC cell with EC_RANKS ranks: the CLI defaults, two rounds
        mesh = make_sw_mesh(EC_RANKS)
        if mesh is not None:
            _reset_kernel_launches()
            recs = list(read_seqs(str(WORK / "ec_h2h.fa")))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            corrected, st = ec_reads(
                [x.codes for x in recs],
                ECParams(seed_len=12, min_seed_votes=8, sw_band=96,
                         min_overlap_score=60, max_targets=48),
                rounds=2, mesh=mesh)
            torch.cuda.synchronize()
            report["ec"] = {"wall_s": time.perf_counter() - t0,
                            "overlaps": st["overlaps_used"],
                            "launches": _kernel_launches()}
            write_fasta(str(WORK / f"ec_h2h_rank{rank}.fa"),
                        zip([x.name for x in recs], corrected))
        _save(f"ranks_report{rank}", report)
    finally:
        dist.destroy_process_group()


def _sws_inputs():
    """Phase 19's swservice inputs: tie-rich probe and target FASTAs
    (tests/sw_edge_cases.tie_rich_pairs)."""
    from biokanga_tpu_torch.seq.fasta import write_fasta

    sys.path.insert(0, str(ROOT / "tests"))
    from sw_edge_cases import tie_rich_pairs

    a, b, alen, blen, _ = tie_rich_pairs(19, SWS_PROBES, SWS_LEN)
    write_fasta(str(WORK / "sws_p.fa"),
                ((f"probe{i}", a[i, :alen[i]]) for i in range(SWS_PROBES)))
    write_fasta(str(WORK / "sws_t.fa"),
                ((f"targ{i}", b[i, :blen[i]]) for i in range(SWS_PROBES)))


def _sws_launches(stderr: str) -> dict:
    """The SW kernels' launches summed over the ranks of one `swservice`
    run, from the line each rank prints on stderr."""
    total = {}
    for line in stderr.splitlines():
        if ": kernel launches " not in line:
            continue
        for field in line.split(": kernel launches ")[1].split():
            name, n = field.split("=")
            total[name] = total.get(name, 0) + int(n)
    return total


def several_ranks(seqs, dev, smi, engine_rate) -> dict:
    """Phase 19: RANKS processes on this card over gloo (and, in this
    process, a world of one over NCCL).  Every sharded, EC and SW result
    must equal its single-rank counterpart.  Returns the kernels' launches
    on the sharded, EC-mesh and swservice paths."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.align.pipeline import RESULT_KEYS, AlignEngine
    from biokanga_tpu_torch.align.snp import PileupAccumulator
    from biokanga_tpu_torch.index.build import load_index
    from biokanga_tpu_torch.index.chunked import (
        ChunkedIndex,
        build_chunked_index,
        load_chunked_index,
        save_chunked_index,
    )
    from biokanga_tpu_torch.index.device import to_device
    from biokanga_tpu_torch.parallel.chunked import (
        ChunkedAligner,
        ChunkedExtendedAligner,
    )
    from biokanga_tpu_torch.parallel.dist import init_ranks, make_mesh
    from biokanga_tpu_torch.parallel.sharded import (
        ShardedAligner,
        gather_results,
    )
    from biokanga_tpu_torch.seq.fasta import read_blocks

    t0 = time.monotonic()
    save_chunked_index(build_chunked_index(seqs, num_chunks=2,
                                           lut_bases=10),
                       str(WORK / RANK_INDEX[2]))
    _sws_inputs()
    for f in WORK.glob("ranks_*.pkl"):
        f.unlink()
    setup_s = time.monotonic() - t0
    rdv = tempfile.mkdtemp(dir=WORK)
    ctx = mp.start_processes(_rank_main, nprocs=RANKS, join=False,
                             start_method="spawn",
                             args=(RANKS, f"file://{rdv}/gloo"))

    # meanwhile the single-rank results: the engine on the SE cell, the
    # chunked extended aligner and the pileup on the options sample
    reads = np.load(WORK / "se_reads.npy")
    lengths = np.full(len(reads), READ_LEN, np.int32)
    idx = load_index(str(WORK / "ref.npz"))
    didx = to_device(idx, dev)
    engine = AlignEngine(didx, AlignParams(batch_size=BATCH))
    se_ref = [engine.align_with_rescue(reads[s:s + BATCH],
                                       lengths[s:s + BATCH])
              for s in range(0, len(reads), BATCH)]
    blk = next(read_blocks(str(WORK / "ck_se.fq"), block_size=BATCH))
    ca = ChunkedAligner(load_chunked_index(str(WORK / RANK_INDEX[2])),
                        AlignParams(batch_size=BATCH), dev)
    opt_ref = ChunkedExtendedAligner(ca, 10, 50_000).align(blk.codes,
                                                           blk.lengths)
    acc = PileupAccumulator(didx)
    acc.add_alignments(blk.codes, blk.lengths, opt_ref)
    pile_ref = acc.finalize()
    del ca, engine
    while not ctx.join():
        pass
    ranks_s = time.monotonic() - t0 - setup_s

    # swservice -n 2 through the CLI, on the card and on the CPU, beside
    # the NCCL world of one below
    sws = ["swservice", "-a", str(WORK / "sws_p.fa"), "-b",
           str(WORK / "sws_t.fa"), "--pairs", "cross", "--sw-band",
           str(SWS_BAND), "-n", "2"]
    sws_cpu = _cpu_child(sws + ["-o", str(WORK / "sws_cpu.csv")], "sws_cpu")
    sws_err = open(WORK / "sws_cuda.err", "wb")
    sws_cuda = subprocess.Popen(
        [sys.executable, "-m", "biokanga_tpu_torch", *sws, "-o",
         str(WORK / "sws_cuda.csv")], cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=sws_err, env=dict(os.environ, OMP_NUM_THREADS="2"))
    sws_err.close()

    # a world of one over NCCL, in this process: the SE cell at (1, 1)
    t1 = time.monotonic()
    init_ranks("nccl", f"file://{rdv}/nccl", 1, 0)
    try:
        mesh = make_mesh(1, 1)
        one = ChunkedIndex(chunks=[idx], bases=np.zeros(1, np.int64),
                           owned=np.asarray([idx.total_len], np.int64),
                           entry_names=list(idx.entry_names),
                           entry_starts=idx.entry_starts.astype(np.int64),
                           overlap=0)
        sa = ShardedAligner(mesh, one, AlignParams(batch_size=BATCH))
        nccl = [gather_results(mesh, sa.align(reads[s:s + BATCH],
                                               lengths[s:s + BATCH]))
                for s in range(0, len(reads), BATCH)]
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    nccl_s = time.monotonic() - t1
    del sa, didx
    torch.cuda.empty_cache()

    def same(got: dict, want: dict, keys, what: str) -> None:
        for k in keys:
            if not np.array_equal(np.asarray(got[k]), np.asarray(want[k])):
                raise AssertionError(f"phase 19: {what}: {k} differs from "
                                     f"the single rank")

    reports = [_load(f"ranks_report{r}") for r in range(RANKS)]
    for (n_dp, n_sp) in RANK_LAYOUTS:
        for got, want in zip(_load(f"ranks_se_{n_dp}x{n_sp}"), se_ref):
            same(got, want, RESULT_KEYS, f"SE cell at ({n_dp}, {n_sp})")
            if got["locus"].dtype != np.int64:
                raise AssertionError("phase 19: loci are not int64")
    for got, want in zip(nccl, se_ref):
        same(got, want, RESULT_KEYS, "SE cell over NCCL")
    opt = _load("ranks_options")
    same(opt["res"], opt_ref, RESULT_KEYS + ("cigar_op", "op_len", "split"),
         "options sample, align_extended")
    for g, w, name in zip(opt["planes"], pile_ref,
                          ("counts", "match", "mismatch")):
        if not np.array_equal(g, w):
            raise AssertionError(f"phase 19: sharded pileup {name} differs")
    want_fa = (WORK / "ec_h2h_out.fa").read_bytes()
    for r in range(EC_RANKS):
        if (WORK / f"ec_h2h_rank{r}.fa").read_bytes() != want_fa:
            raise AssertionError(f"phase 19: EC FASTA of rank {r} differs "
                                 "from phase 9's")
    _wait_child(sws_cpu, "sws_cpu")
    if sws_cuda.wait() != 0:
        raise AssertionError("swservice -n 2 --device cuda rc="
                             f"{sws_cuda.returncode}: "
                             f"{(WORK / 'sws_cuda.err').read_text()[-2000:]}")
    chosen = (WORK / "sws_cuda.err").read_text()
    csv = (WORK / "sws_cuda.csv").read_bytes()
    if csv != (WORK / "sws_cpu.csv").read_bytes() or "over gloo" not in chosen:
        raise AssertionError(f"phase 19: swservice -n 2 CSV differs cpu vs "
                             f"cuda, or not over gloo: {chosen.strip()}")

    sws_launches = _sws_launches(chosen)
    if chosen.count(": kernel launches ") != 2:
        raise AssertionError(f"phase 19: swservice -n 2 did not report the "
                             f"launches of 2 ranks: {chosen.strip()}")

    def total(part: str, name: str) -> int:
        return sum(rep[part]["launches"][name] for rep in reports
                   if part in rep)

    launches = {}
    for name in ALIGN_KERNELS + ("banded_sw_moves", "banded_sw_score",
                                 "sw_trace", "stream_gather_consume"):
        launches[name] = {
            "launches_sharded": sum(total(f"{d}x{s}", name)
                                    for d, s in RANK_LAYOUTS)
            if name in reports[0]["2x2"]["launches"] else 0,
            "launches_ec_mesh": total("ec", name)
            if name in reports[0]["ec"]["launches"] else 0,
            "launches_swservice": sws_launches.get(name, 0)}
    for name, want in (*((k, "launches_sharded") for k in ALIGN_KERNELS),
                       ("banded_sw_moves", "launches_ec_mesh"),
                       ("sw_trace", "launches_ec_mesh"),
                       ("banded_sw_score", "launches_swservice")):
        if launches[name][want] < 1:
            raise AssertionError(f"phase 19: {name} never launched on "
                                 f"{want[9:]}")
    for n_dp, n_sp in RANK_LAYOUTS:
        rep = [r[f"{n_dp}x{n_sp}"] for r in reports]
        wall = max(r["wall_s"] for r in rep)
        wall2 = max(r["wall2_s"] for r in rep)
        timed = max(r["timed_wall_s"] for r in rep)
        per_batch = lambda key: ", ".join(
            f"{1e3 * r[key] / (N_READS // BATCH):.2f}" for r in rep)
        peak = ", ".join(f"{r['peak_bytes'] / 2**20:.1f}" for r in rep)
        print(f"sharded SE cell at ({n_dp}, {n_sp}), {RANKS} ranks on one "
              f"card over gloo: {N_READS} reads in {wall:.3f} s, "
              f"{N_READS / wall:.1f} reads/s, uninstrumented (single-rank "
              f"engine {engine_rate:.1f} reads/s, phase 6); peak device "
              f"memory a rank {peak} MiB; every field equal to AlignEngine. "
              f"Second pass with the gather timed (a barrier and two "
              f"synchronisations around each): {timed:.3f} s, "
              f"{N_READS / timed:.1f} reads/s; third pass, uninstrumented: "
              f"{wall2:.3f} s, {N_READS / wall2:.1f} reads/s; the gather "
              f"{per_batch('gather_s')} ms a batch a rank (copies to the "
              f"host included; {rep[0]['gathers']} gathers), the wait for "
              f"the sp group's slowest rank before it {per_batch('wait_s')} "
              f"ms ({smi})")
    opt_s = max(r["options"]["wall_s"] for r in reports if "options" in r)
    ec_s = max(r["ec"]["wall_s"] for r in reports if "ec" in r)
    print(f"sharded options sample at {RANK_OPTIONS_LAYOUT}: {len(blk.codes)} "
          f"reads, align_extended -a 10 -A 50000 and the pileup in "
          f"{opt_s:.2f} s, equal to ChunkedExtendedAligner and "
          f"PileupAccumulator; {int(opt['res']['unique'].sum())} accepted, "
          f"{int((opt['res']['cigar_op'] != 0).sum())} by the fall-through")
    print(f"EC cell with {EC_RANKS} ranks: wall {ec_s:.2f} s, "
          f"{reports[0]['ec']['overlaps']} overlaps; FASTA of every rank "
          f"equal to phase 9's byte for byte ({len(want_fa)} bytes)")
    print(f"swservice -n 2 on {SWS_PROBES} x {SWS_PROBES} tie-rich pairs: "
          f"--device cuda == --device cpu byte for byte ({len(csv)} bytes; "
          f"{chosen.splitlines()[0].strip()}; launches {sws_launches}); "
          f"NCCL world of one ({backend}): SE cell equal "
          f"in {nccl_s:.2f} s; phase 19 set-up {setup_s:.1f} s, ranks "
          f"{ranks_s:.1f} s")
    return launches


# ------------------------------------------- #2 wide and #3w (3, 20) ----

def _check_wide_sort2(dev) -> dict:
    """sort2_rows past the block path's 16,384 pairs (the sharded
    multi-hit union's K x n_sp rows) against its plain version, exactly,
    on random, all-INT32_MAX and duplicate rows, also off 16-byte
    alignment; each shape timed beside torch.sort of the packed int64
    keys and its bound.  Returns {"err": e, "BxC": timing, ...}."""
    import torch

    from biokanga_tpu_torch.ops import sort

    out = {"err": 0}
    for B, C in WIDE_SORT2_SHAPES:
        for k, kind in enumerate(("random", "all_max", "dups")):
            key = _wide_rows(dev, B, C, kind, C + 11 * k)
            if kind == "random":               # union keys: < 511 x n_sp
                key = torch.where(key == I32_MAX, key, key & 0xFFFFF)
            val = _wide_rows(dev, B, C, "random" if k else "dups", C + k)
            for kk, vv in ((key, val),
                           (key.reshape(-1)[1:1 + (B - 1) * C].view(B - 1, C),
                            val.reshape(-1)[1:1 + (B - 1) * C].view(B - 1,
                                                                    C))):
                if not kk.numel():
                    continue
                (gk, gv), (wk, wv) = (sort.sort2_rows(kk, vv),
                                      sort.sort2_rows_plain(kk, vv))
                out["err"] = max(out["err"], _max_abs_err(gk, wk),
                                 _max_abs_err(gv, wv))
            del key, val
    if out["err"]:
        raise AssertionError(f"wide sort2_rows disagrees: {out['err']}")
    print(f"sort2_rows past 16,384 pairs exact at {WIDE_SORT2_SHAPES} on "
          f"random, all-INT32_MAX and duplicate rows")
    for B, C in WIDE_SORT2_SHAPES:
        key = _wide_rows(dev, B, C, "random", 5) & 0xFFFFF
        val = _wide_rows(dev, B, C, "random", 6)
        t = _sort_timing((key, val))
        out[f"{B}x{C}"] = dict(ms=t["ms"], plain_ms=t["plain_ms"],
                               library_ms=t["library_ms"],
                               bound_ms=t["bound"][0], bound_by=t["bound"][1])
        print(f"sort2_rows at ({B}, {C} pairs): kernel {t['ms']:.4f} ms, "
              f"plain torch {t['plain_ms']:.4f} ms, torch.sort of packed "
              f"int64 {t['library_ms']:.4f} ms, bound {t['bound'][0]:.4f} "
              f"ms ({t['bound'][1]})")
        del key, val
    torch.cuda.empty_cache()
    return out


def _win_args(dev, case):
    """The windowed extension's arguments on the card for one
    tests/win_edge_cases.py case."""
    import torch

    from biokanga_tpu_torch.ops import extend_packed as ep

    sys.path.insert(0, str(ROOT / "tests"))
    import win_edge_cases

    g, starts, reads, lens, loci, valid, win = win_edge_cases.win_case(*case)
    pg = ep.pack_genome(g, dev)
    rc, rn = ep.pack_reads(torch.from_numpy(reads).to(dev),
                           torch.from_numpy(lens).to(dev))
    return (pg, torch.from_numpy(starts.astype(np.int32)).to(dev),
            torch.from_numpy(loci).to(dev), torch.from_numpy(valid).to(dev),
            rc, rn, torch.from_numpy(win).to(dev))


def _win_bound(args, out) -> tuple[float, str]:
    """The windowed extension's least time on these inputs: every input
    read once and the output written once, against the integer
    operations of the candidates that pass the flag, range and one-entry
    tests (those whose output is a count), each over the words its
    window covers."""
    from biokanga_tpu_torch.ops import extend_packed as ep

    pg, starts, loci, valid, rc, rn, win = args
    ok = out != ep.MM_WIN_INVALID
    W = rc.shape[1]
    words = ((win.clamp(0, 16 * W) + 15) // 16)[ok].sum().item()
    per_word = WIN_OPS_PER_WORD + (2 if pg.has_n else 0)
    search = 3 * max(1, math.ceil(math.log2(starts.numel() + 1)))
    n_ops = (words * per_word + int(ok.sum()) * search
             + loci.numel() * WIN_OPS_PER_CAND)
    n_bytes = _nbytes(pg.rows, pg.n_rows, starts, loci, valid, rc, rn, win,
                      out)
    return _bound(n_bytes, n_ops)


def check_extend_win(dev):
    """Phase 20: hamming_extend_packed_win (#3w) against its plain
    version on every case of tests/win_edge_cases.py (windows across an
    entry cut, win <= 0 and past 16 W, windows past the genome's end, Ns
    in the reads and the genome, W on both sides of the unrolled 16) and
    at the assembler's sweep shapes (4,096, 192) for W = 10, 64 and 256;
    each of those timed with its plain version and its bound.  Returns
    (max_abs_err, timing)."""
    import torch

    from biokanga_tpu_torch.ops import extend_packed as ep

    sys.path.insert(0, str(ROOT / "tests"))
    import win_edge_cases

    err = 0
    for case in win_edge_cases.cases():
        a = _win_args(dev, case)
        err = max(err, _max_abs_err(ep.hamming_extend_packed_win(*a),
                                    ep.hamming_extend_packed_win_plain(*a)))
    timing = {}
    for W in WIN_WORDS:
        a = _win_args(dev, (20 + W, WIN_B, WIN_C, W, W != 64))
        got = ep.hamming_extend_packed_win(*a)
        want = ep.hamming_extend_packed_win_plain(*a)
        err = max(err, _max_abs_err(got, want))
        bound_ms, by = _win_bound(a, want)
        n_ok = int((want != ep.MM_WIN_INVALID).sum())
        t = dict(ms=_timed_ms(lambda: ep.hamming_extend_packed_win(*a)),
                 plain_ms=_timed_ms(
                     lambda: ep.hamming_extend_packed_win_plain(*a), 3),
                 library_ms=None, bound=(bound_ms, by), valid=n_ok)
        timing[W] = t
        print(f"hamming_extend_packed_win at ({WIN_B}, {WIN_C}), W {W} "
              f"({'with' if a[0].has_n else 'no'} N plane; {n_ok} counted "
              f"windows): kernel {t['ms']:.4f} ms, plain torch "
              f"{t['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({by})")
        del a, got, want
    if err:
        raise AssertionError(f"hamming_extend_packed_win disagrees: {err}")
    print(f"hamming_extend_packed_win exact on {len(win_edge_cases.cases())} "
          f"edge cases and at W = {WIN_WORDS}")
    torch.cuda.empty_cache()
    head = dict(timing[WIN_WORDS[0]])
    head["by_words"] = {str(W): {"ms": t["ms"], "plain_ms": t["plain_ms"],
                                 "bound_ms": t["bound"][0],
                                 "bound_by": t["bound"][1]}
                        for W, t in timing.items()}
    return err, head


# ------------------------------------------------- the seed stage (31) ----

# (name, genome bases, LUT bases, pass): GRCh38's chunk of the benchmark
# (237,561,344 padded bases, LUT 13) at its fast and classic passes, and
# E. coli's genome (4,641,652 bases, LUT 10) at its fast pass; 100 bp
# reads in the fused PE batch of 131,072 rows
SEED_SHAPES = (("grch38_fast", 237_561_344, 13, "fast"),
               ("grch38_classic", 237_561_344, 13, "classic"),
               ("ecoli_fast", 4_641_652, 10, "fast"))
SEED_ROWS = 2 * BATCH


def _seed_batch(dev, genome, n_rows, L, seed):
    """n_rows reads of L bases from a device genome, every other one
    reverse complemented, 1% substitutions, lengths all L."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    n = genome.shape[0]
    at = torch.randint(0, n - L, (n_rows,), device=dev, generator=gen)
    r = genome[at[:, None] + torch.arange(L, device=dev)]
    flip = torch.arange(n_rows, device=dev) % 2 == 1
    r = torch.where(flip[:, None], (3 - r).flip(1), r)
    sub = torch.rand(r.shape, device=dev, generator=gen) < 0.01
    r = torch.where(sub, (r + 1) % 4, r).to(torch.int8)
    return r.contiguous(), torch.full((n_rows,), L, dtype=torch.int32,
                                      device=dev)


def _seed_bytes(didx, reads, S, core_len, flat, overflow, got):
    """Bytes the two kernels need on these inputs: seed_rows reads the
    reads, two LUT entries and one key pair a bound a core, the live
    positions, and writes the rows and flags; dedup_pack reads the filled
    slots, the flags and the reads, and writes the loci, valid flags,
    counts and read words.  Each input once, each output once."""
    B, L = reads.shape
    filled = int((flat != I32_MAX).sum())
    search = 2 * 8 * B * S if core_len > didx.lut_bases else 0
    seed = (B * L + 4 * B + 8 * B * S + search + 4 * filled
            + _nbytes(flat, overflow))
    dedup = B * L + 4 * B + 4 * filled + _nbytes(overflow, *got)
    return seed, dedup, filled


def check_seed_kernels(dev, smi):
    """Phase 31: seed_rows and dedup_pack against their plain versions at
    GRCh38's and E. coli's pass shapes, both strands, and timed beside
    the plain op chains and their bytes bounds."""
    import torch

    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.index.device_build import device_build_index
    from biokanga_tpu_torch.ops import seed_rows as sr
    from biokanga_tpu_torch.ops import sort

    ap = AlignParams()
    err = {"seed_rows": 0, "dedup_pack": 0}
    by_shape = {}
    built = {}
    for name, n, lut_bases, kind in SEED_SHAPES:
        if (n, lut_bases) not in built:
            built.clear()
            gen = torch.Generator(device=dev).manual_seed(n)
            g = torch.randint(0, 4, (n,), dtype=torch.int8, device=dev,
                              generator=gen)
            didx = device_build_index(g.cpu().numpy(), np.array([0, n]),
                                      lut_bases, device=dev)
            built[(n, lut_bases)] = (g, didx)
            torch.cuda.empty_cache()
        g, didx = built[(n, lut_bases)]
        if kind == "fast":
            fp = ap.derive_fast(READ_LEN, n, lut_bases)
            dp, H, cap = fp.dp, fp.H, fp.cand_cap
        else:
            dp = ap.derive(READ_LEN, n)
            H, cap = ap.cand_per_core, ap.max_cand_per_strand
        reads, lengths = _seed_batch(dev, g, SEED_ROWS, READ_LEN, n % 9973)
        offs = torch.tensor(dp.offsets, dtype=torch.int32, device=dev)
        S = len(dp.offsets)
        for rc in (False, True):
            args = (didx, reads, lengths, rc, offs, dp.core_len, H, None,
                    True)
            flat, overflow = sr.seed_rows(*args)
            want = sr.seed_rows_plain(*args)
            err["seed_rows"] = max(err["seed_rows"],
                                   _max_abs_err(flat, want[0]),
                                   _max_abs_err(overflow, want[1]))
            del want
            srt = sort.sort_rows(flat)
            got = sr.dedup_pack(srt, overflow, reads, lengths, rc, cap, True)
            for a, b in zip(got, sr.dedup_pack_plain(
                    srt, overflow, reads, lengths, rc, cap, True)):
                err["dedup_pack"] = max(err["dedup_pack"], _max_abs_err(a, b))
        if any(err.values()):
            raise AssertionError(f"phase 31: the seed kernels disagree with "
                                 f"their plain versions at {name}: {err}")
        seed_out = (flat, overflow)
        got = tuple(t.contiguous() for t in got)
        t = dict(
            seed_ms=_timed_ms(lambda: sr.seed_rows(*args, out=seed_out)),
            seed_plain_ms=_timed_ms(lambda: sr.seed_rows_plain(*args), 3),
            dedup_ms=_timed_ms(lambda: sr.dedup_pack(
                srt, overflow, reads, lengths, True, cap, True, out=got)),
            dedup_plain_ms=_timed_ms(lambda: sr.dedup_pack_plain(
                srt, overflow, reads, lengths, True, cap, True), 3))
        seed_b, dedup_b, filled = _seed_bytes(didx, reads, S, dp.core_len,
                                              flat, overflow, got)
        t["seed_bound"] = _bound(seed_b, 0)
        t["dedup_bound"] = _bound(dedup_b, 0)
        t["filled_share"] = filled / flat.numel()
        by_shape[name] = t
        print(f"seed stage at {name} ({SEED_ROWS} x {READ_LEN} bp, {S} "
              f"cores of {dp.core_len}, H {H}, cap {cap}; "
              f"{100 * t['filled_share']:.2f}% of slots filled): seed_rows "
              f"{t['seed_ms']:.4f} ms (plain {t['seed_plain_ms']:.4f}, bound "
              f"{t['seed_bound'][0]:.4f}), dedup_pack {t['dedup_ms']:.4f} ms "
              f"(plain {t['dedup_plain_ms']:.4f}, bound "
              f"{t['dedup_bound'][0]:.4f}) ({smi})")
        del flat, overflow, srt, got, seed_out, reads
    del built
    torch.cuda.empty_cache()
    head = by_shape["grch38_classic"]
    timing = {
        kernel: dict(ms=head[f"{part}_ms"], plain_ms=head[f"{part}_plain_ms"],
                     bound=head[f"{part}_bound"], library_ms=None,
                     by_shape={k: {"ms": v[f"{part}_ms"],
                                   "plain_ms": v[f"{part}_plain_ms"],
                                   "bound_ms": v[f"{part}_bound"][0],
                                   "filled_share": v["filled_share"]}
                               for k, v in by_shape.items()})
        for kernel, part in (("seed_rows", "seed"), ("dedup_pack", "dedup"))}
    return err, timing


# ------------------------------------ the chunked select and merge (32) ----

def _chunk_merge_bytes(stage, n_unresolved, merged):
    """Bytes the two kernels need at a staging set's shape, each input and
    output once: select_chunk with a fast pass reads the lengths, the fast
    pass's resolve keys (best_mm, n_over, cap_trunc), a row's result
    fields from the pass it takes and, on an unresolved row, the classic
    pass's ladder keys, and writes the chunk's slot; merge_chunks reads
    every slot, the lengths and the bases, and writes `merged`."""
    from biokanga_tpu_torch.ops import chunk_merge as cm

    K, B = stage["best_mm"].shape
    slot = _nbytes(*(stage[f][0] for f in cm.FIELDS))
    res = _nbytes(*(stage[f][0] for f in cm.FIELDS[:10])) // B
    lad = slot // B - res
    keys = _nbytes(*(stage[f][0] for f in ("best_mm", "n_over",
                                           "cap_trunc")))
    read = (keys + (B - n_unresolved) * (res - 1)
            + n_unresolved * (res + lad))
    select = 4 * B + read + slot
    merge = K * slot + 4 * B + 8 * K + _nbytes(*merged.values())
    return select, merge


def check_chunk_merge(dev, smi):
    """Phase 32: select_chunk and merge_chunks against their plain versions
    at GRCh38's block (13 chunks of 131,072 rows), timed beside the plain
    versions and their bytes bounds."""
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    import chunk_merge_cases as cases

    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.ops import chunk_merge as cm

    ap = AlignParams()
    fp = ap.derive_fast(READ_LEN, cases.CHUNK_LEN, 13)
    dp = ap.derive(READ_LEN, cases.CHUNK_LEN)
    med, subs = ap.min_edit_dist, ap.max_subs_per100
    K, B, Kml = cases.GRCH38_K, cases.GRCH38_B, 5
    cpu = torch.device("cpu")
    rng = np.random.default_rng(32)
    lengths = rng.integers(0, READ_LEN + 1, B).astype(np.int32)
    ln = {d: torch.from_numpy(lengths).to(d) for d in (dev, cpu)}
    # the bases of GRCh38's chunks: global loci past 2^31
    base = np.arange(K, dtype=np.int64) * (cases.CHUNK_LEN - 2048)
    bases = {d: torch.from_numpy(base).to(d) for d in (dev, cpu)}
    passes = cases.grch38_passes(rng, dev)
    err = {"select_chunk": 0, "merge_chunks": 0}

    def cmp(name, got, want, keys):
        for f in keys:
            err[name] = max(err[name], _max_abs_err(got[f].cpu(), want[f]))

    staged = {}
    for fast_pass in (True, False):
        st = {d: cm.staging(K, B, Kml, d) for d in (dev, cpu)}
        for k, (fast, classic) in enumerate(passes):
            for d, stage in st.items():
                def on(p):
                    return {f: v.to(d) for f, v in p.items()}
                cm.select_chunk(stage, k, ln[d], on(classic), dp, med,
                                on(fast) if fast_pass else None,
                                fp if fast_pass else None)
        cmp("select_chunk", st[dev], st[cpu], cm.FIELDS + ("counts",))
        if int(st[cpu]["counts"][0].min()) < 1:
            raise AssertionError("phase 32: a chunk without rows for the "
                                 "rescue ladder")
        staged[fast_pass] = st
    st = staged[True]
    for s, m in ((subs, med), (0, 2)):
        cmp("merge_chunks", cm.merge_chunks(st[dev], bases[dev], ln[dev], s,
                                            m),
            cm.merge_chunks(st[cpu], bases[cpu], ln[cpu], s, m), cm.FIELDS)
    parts, tie_base = cases.partials(rng, K, B, "overlap")
    tie_base = torch.from_numpy(tie_base)
    cmp("merge_chunks", cm.merge_chunks(cases.stage_of(parts, dev),
                                        tie_base.to(dev), ln[dev], subs, med),
        cm.merge_chunks(cases.stage_of(parts), tie_base, ln[cpu], subs, med),
        cm.FIELDS)
    flagged = cases.stage_of(parts, dev)
    far = torch.tensor([0] + [(1 << 42) - 10] * (K - 1), dtype=torch.int64,
                       device=dev)
    cm.merge_chunks(flagged, far, ln[dev], subs, med)
    flags = (int(st[dev]["counts"][2, 0]), int(flagged["counts"][2, 0]))
    if any(err.values()) or flags != (0, 1):
        raise AssertionError(f"phase 32: the chunk merge kernels disagree "
                             f"with their plain versions: {err}, 2^42 "
                             f"flags {flags}")
    # timed on the main path's layout: contiguous pass outputs, one
    # chunk's select and the merge of the block
    fast, classic = ({f: v.contiguous() for f, v in p.items()}
                     for p in passes[0])
    host = [{f: v.cpu() for f, v in p.items()} for p in (fast, classic)]
    stage = st[dev]
    merged = cm.merge_chunks(stage, bases[dev], ln[dev], subs, med)
    mtm = torch.from_numpy(cm.max_tot_mm(lengths, subs)).to(dev)
    n_unres = int(st[cpu]["counts"][1, 0])
    sel_b, merge_b = _chunk_merge_bytes(stage, n_unres, merged)
    t0 = time.perf_counter()
    for _ in range(3):
        cm.select_chunk(st[cpu], 0, ln[cpu], host[1], dp, med, host[0], fp)
    sel_host_ms = (time.perf_counter() - t0) / 3 * 1e3
    timing = {
        "select_chunk": dict(
            ms=_timed_ms(lambda: cm.select_chunk(
                stage, 0, ln[dev], classic, dp, med, fast, fp)),
            plain_ms=sel_host_ms, plain_on="host", bound=_bound(sel_b, 0),
            library_ms=None, unresolved_share=n_unres / B),
        "merge_chunks": dict(
            ms=_timed_ms(lambda: cm.merge_chunks(stage, bases[dev], ln[dev],
                                                 subs, med)),
            plain_ms=_timed_ms(lambda: cm.merge_chunks_plain(
                {f: stage[f] for f in cm.FIELDS}, bases[dev], mtm, med), 3),
            plain_on="card", bound=_bound(merge_b, 0), library_ms=None)}
    sel, mrg = timing["select_chunk"], timing["merge_chunks"]
    print(f"chunked select and merge at GRCh38's block ({K} chunks x {B} "
          f"rows, -R {Kml}; {100 * n_unres / B:.2f}% of a chunk's rows "
          f"unresolved): select_chunk {sel['ms']:.4f} ms a chunk (host "
          f"plain {sel['plain_ms']:.4f}, bound {sel['bound'][0]:.4f}), "
          f"merge_chunks {mrg['ms']:.4f} ms (plain on the card "
          f"{mrg['plain_ms']:.4f}, bound {mrg['bound'][0]:.4f}) ({smi})")
    del staged, st, stage, passes, flagged, merged
    torch.cuda.empty_cache()
    return err, timing


# -------------------------------------- bisulfite, colorspace (21, 22) ----

def _kernel_launches() -> dict:
    """Launch counts of every kernel wrapper in this process."""
    from biokanga_tpu_torch.ops import (
        banded_sw,
        blitz_chain,
        chunk_merge,
        extend_packed,
        seed_rows,
        sort,
        sw_trace,
        uhamming_sweep,
    )

    return {"uhamming_sweep": uhamming_sweep.uhamming_sweep.launches,
            "select_chunk": chunk_merge.select_chunk.launches,
            "merge_chunks": chunk_merge.merge_chunks.launches,
            "blitz_chain": blitz_chain.chain_scan.launches,
            "seed_rows": seed_rows.seed_rows.launches,
            "dedup_pack": seed_rows.dedup_pack.launches,
            "sort_rows": sort.sort_rows.launches,
            "sort2_rows": sort.sort2_rows.launches,
            "hamming_extend_packed":
                extend_packed.hamming_extend_packed.launches,
            "hamming_extend_packed_win":
                extend_packed.hamming_extend_packed_win.launches,
            "banded_sw_moves": banded_sw.banded_sw_moves.launches,
            "banded_sw_score": banded_sw.banded_sw_score.launches,
            "sw_trace": sw_trace.traceback_cols_packed.launches}


def _reset_kernel_launches() -> None:
    from biokanga_tpu_torch.ops import (
        banded_sw,
        blitz_chain,
        chunk_merge,
        extend_packed,
        seed_rows,
        sort,
        sw_trace,
        uhamming_sweep,
    )

    for fn in (uhamming_sweep.uhamming_sweep, blitz_chain.chain_scan,
               chunk_merge.select_chunk, chunk_merge.merge_chunks,
               seed_rows.seed_rows, seed_rows.dedup_pack,
               sort.sort_rows, sort.sort2_rows,
               extend_packed.hamming_extend_packed,
               extend_packed.hamming_extend_packed_win,
               banded_sw.banded_sw_moves, banded_sw.banded_sw_score,
               sw_trace.traceback_cols_packed):
        fn.launches = 0


def _two_pass_rate(aligner, reads, lengths) -> float:
    """Reads/s of a two-pass aligner's align_batch over `reads` in
    batches of BATCH, after one warm batch, between synchronisations."""
    import torch

    aligner.align_batch(reads[:BATCH], lengths[:BATCH])
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for s in range(0, len(reads), BATCH):
        aligner.align_batch(reads[s:s + BATCH], lengths[s:s + BATCH])
    torch.cuda.synchronize()
    return len(reads) / (time.monotonic() - t0)


def _bs_align(tag: str, genome: np.ndarray, n_reads: int, seed: int):
    """`index -m 1` of WORK/<tag>.fa, then n_reads bisulfite reads of
    100 bp (tests/bs_reads.py) through `align --device cuda`.  Returns
    (reads, index seconds, CLI seconds, launches, recall: the share of
    all reads placed uniquely at origin on the right strand, precision:
    that share among the reads placed uniquely)."""
    from biokanga_tpu_torch import cli

    sys.path.insert(0, str(ROOT / "tests"))
    from bs_reads import bs_reads

    t0 = time.monotonic()
    if cli.main(["index", "-m", "1", "-i", str(WORK / f"{tag}.fa"), "-o",
                 str(WORK / f"{tag}_bs.npz"), "--lut-bases", "10"]) != 0:
        raise AssertionError(f"index -m 1 of {tag} failed")
    index_s = time.monotonic() - t0
    names, reads, starts, bottom = bs_reads(genome, n_reads, READ_LEN,
                                            np.random.default_rng(seed))
    _write_fastq(WORK / f"{tag}_bs.fq", names, reads)
    _reset_kernel_launches()
    cli_s = _timed_cli(["align", "-i", str(WORK / f"{tag}_bs.fq"), "-I",
                        str(WORK / f"{tag}_bs.npz"), "-o",
                        str(WORK / f"{tag}_bs.sam"), "--device", "cuda",
                        "--batch-size", str(BATCH)])
    launches = _kernel_launches()
    if min(launches[k] for k in ALIGN_KERNELS) < 1:
        raise AssertionError(f"phase 21: kernels not launched: {launches}")
    placed = ok = 0
    for rec in _records(WORK / f"{tag}_bs.sam"):
        f = rec.split("\t")
        flag, i = int(f[1]), int(f[0][2:])
        if flag & 4 or f[4] != "60":
            continue
        placed += 1
        ok += (int(f[3]) == starts[i] + 1
               and bool(flag & 16) == bool(bottom[i]))
    return (names, reads, index_s, cli_s, launches, ok / n_reads,
            ok / max(placed, 1))


def bisulfite_cell(seqs, dev, smi) -> dict:
    """Phase 21: whole-genome bisulfite resequencing of the 4.6 Mbp
    genome: `index -m 1`, then BS_READS reads of 100 bp (half top, half
    bottom strand, C->T at 0.98; tests/bs_reads.py) through `align
    --device cuda`; the recall (share placed uniquely at origin on the
    right strand), the precision (that share among the reads placed),
    the CLI wall and BisulfiteAligner's reads/s.  The JAX package's
    bisulfite path keeps the core length it derives for a 4-letter
    genome, so in the 3-letter collapsed genome every core of a read
    over-occurs at this size, is skipped, and most reads get no hit
    (ROADMAP.md queue 3; the port gives the JAX result dicts here,
    tests/test_torch_bisulfite.py): the recall at 4.6 Mbp is printed
    with no bar, and the JAX test's bar (60/64, tests/test_bisulfite.py:
    62) holds on a BS_SMALL_BP genome with BS_SMALL_READS reads, where
    that core length still resolves.  The precision bar holds on both.
    The first N_PARITY reads of the big cell go through a --device cpu
    child.  Returns the run's launches and what two_pass_finish
    compares."""
    from biokanga_tpu_torch import cli
    from biokanga_tpu_torch.align.bisulfite import BisulfiteAligner
    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.align.pipeline import AlignEngine
    from biokanga_tpu_torch.index.build import load_bisulfite_index
    from biokanga_tpu_torch.index.device import to_device
    from biokanga_tpu_torch.seq.fasta import write_fasta
    from biokanga_tpu_torch.sim.simreads import random_genome

    (names, reads, index_s, cli_s, launches, recall,
     precision) = _bs_align("ref", seqs[0][1], BS_READS, 21)
    _write_fastq(WORK / "bs_head.fq", names[:N_PARITY], reads[:N_PARITY])
    child = _cpu_child(["align", "-i", str(WORK / "bs_head.fq"), "-I",
                        str(WORK / "ref_bs.npz"), "-o",
                        str(WORK / "bs_head_cpu.sam")], "bs_head_cpu")
    if cli.main(["align", "-i", str(WORK / "bs_head.fq"), "-I",
                 str(WORK / "ref_bs.npz"), "-o",
                 str(WORK / "bs_head_cuda.sam"), "--device", "cuda",
                 "--batch-size", str(BATCH)]) != 0:
        raise AssertionError("phase 21: head align failed")
    ct, ga = load_bisulfite_index(str(WORK / "ref_bs.npz"))
    bs = BisulfiteAligner(
        AlignEngine(to_device(ct, dev), AlignParams(strand="sense",
                                                    batch_size=BATCH)),
        AlignEngine(to_device(ga, dev), AlignParams(strand="antisense",
                                                    batch_size=BATCH)))
    rate = _two_pass_rate(bs, reads, np.full(BS_READS, READ_LEN, np.int32))
    del bs, ct, ga
    small = random_genome([("chr", BS_SMALL_BP)], seed=43)
    write_fasta(str(WORK / "bs_small.fa"), small)
    (_, _, _, small_s, small_launches, small_recall,
     small_precision) = _bs_align("bs_small", small[0][1], BS_SMALL_READS, 23)
    print(f"bisulfite cell: index -m 1 of {GENOME_BP} bp in {index_s:.2f} "
          f"s; align --device cuda of {BS_READS} x {READ_LEN} bp reads in "
          f"{cli_s:.2f} s (CLI wall); recall {recall:.6f} (no bar: the JAX "
          f"package's core length, ROADMAP.md queue 3), precision "
          f"{precision:.6f}; BisulfiteAligner.align_batch {rate:.1f} "
          f"reads/s; launches {launches}. On {BS_SMALL_BP} bp: "
          f"{BS_SMALL_READS} reads in {small_s:.2f} s, recall "
          f"{small_recall:.6f}, precision {small_precision:.6f}, launches "
          f"{small_launches} ({smi})")
    if min(precision, small_precision, small_recall) < MIN_BS_SHARE:
        raise AssertionError(f"phase 21: precision {precision:.4f} / "
                             f"{small_precision:.4f} or recall on "
                             f"{BS_SMALL_BP} bp {small_recall:.4f} < "
                             f"{MIN_BS_SHARE}")
    return {"launches": launches, "child": child, "tag": "bs_head"}


def _write_csfasta(path: Path, names, reads, primer: int = 3) -> None:
    """The .csfasta of base reads of one length (primer T), the bytes of
    the package's write_csfasta, built a block of records at a time."""
    reads = np.asarray(reads)
    n, L = reads.shape
    full = np.concatenate([np.full((n, 1), primer, np.int8), reads], axis=1)
    a, b = full[:, :-1], full[:, 1:]
    colors = np.where((a < 4) & (b < 4), a ^ b, 4)
    mat = np.empty((n, L + 2), np.uint8)
    mat[:, 0] = ord("ACGT"[primer])
    mat[:, 1:L + 1] = np.frombuffer(b"0123.", np.uint8)[colors]
    mat[:, -1] = ord("\n")
    w = mat.shape[1]
    with open(path, "wb") as f:
        for s in range(0, n, 65_536):
            blob = mat[s:s + 65_536].tobytes()
            f.write(b"".join(b">" + names[s + i].encode() + b"\n"
                             + blob[i * w:(i + 1) * w]
                             for i in range(len(blob) // w)))


def colorspace_cell(seqs, dev, smi) -> dict:
    """Phase 22: a SOLiD resequencing run on the 4.6 Mbp genome.  `index
    -C`, then CS_READS reads of 75 bp at 1% substitutions as .csfasta
    colours (primer T, as `simreads -C` writes them) through `align
    --device cuda`; the share placed uniquely at origin, the CLI wall and
    ColorspaceAligner's reads/s.  The first N_PARITY reads go through a
    --device cpu child."""
    from biokanga_tpu_torch import cli
    from biokanga_tpu_torch.align.colorspace import ColorspaceAligner
    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.align.pipeline import AlignEngine, pad_rows
    from biokanga_tpu_torch.index.build import load_index
    from biokanga_tpu_torch.index.device import to_device
    from biokanga_tpu_torch.seq.fasta import read_csfasta_blocks, write_csfasta
    from biokanga_tpu_torch.sim.simreads import simulate_reads

    t0 = time.monotonic()
    if cli.main(["index", "-C", "-i", str(WORK / "ref.fa"), "-o",
                 str(WORK / "cs.npz"), "--lut-bases", "10"]) != 0:
        raise AssertionError("index -C failed")
    index_s = time.monotonic() - t0
    names, reads, _ = simulate_reads(seqs, CS_READS, read_len=CS_READ_LEN,
                                     sub_rate=0.01, seed=22)
    _write_csfasta(WORK / "cs.csfasta", names, reads)
    write_csfasta(str(WORK / "cs_check.csfasta"),
                  zip(names[:1_000], reads[:1_000]))
    head = (WORK / "cs.csfasta").read_bytes().split(b"\n")
    if b"\n".join(head[:2_000]) + b"\n" != \
            (WORK / "cs_check.csfasta").read_bytes():
        raise AssertionError("phase 22: the block writer's .csfasta differs "
                             "from write_csfasta")
    (WORK / "cs_head.csfasta").write_bytes(b"\n".join(
        head[:2 * N_PARITY]) + b"\n")
    child = _cpu_child(["align", "-i", str(WORK / "cs_head.csfasta"), "-I",
                        str(WORK / "cs.npz"), "-o",
                        str(WORK / "cs_head_cpu.sam")], "cs_head_cpu")
    _reset_kernel_launches()
    cli_s = _timed_cli(["align", "-i", str(WORK / "cs.csfasta"), "-I",
                        str(WORK / "cs.npz"), "-o", str(WORK / "cs.sam"),
                        "--device", "cuda", "--batch-size", str(BATCH)])
    launches = _kernel_launches()
    if min(launches[k] for k in ALIGN_KERNELS) < 1:
        raise AssertionError(f"phase 22: kernels not launched: {launches}")
    share = _true_unique_fraction(WORK / "cs.sam", CS_READS)
    if cli.main(["align", "-i", str(WORK / "cs_head.csfasta"), "-I",
                 str(WORK / "cs.npz"), "-o", str(WORK / "cs_head_cuda.sam"),
                 "--device", "cuda", "--batch-size", str(BATCH)]) != 0:
        raise AssertionError("phase 22: head align failed")
    idx = load_index(str(WORK / "cs.npz"))
    cs = ColorspaceAligner(AlignEngine(to_device(idx, dev), AlignParams(
        strand="sense", batch_size=BATCH)))
    blk = next(read_csfasta_blocks(str(WORK / "cs.csfasta"), CS_READS))
    colours, lens = pad_rows(blk.codes, blk.lengths)
    rate = _two_pass_rate(cs, colours, lens)
    print(f"colorspace cell: index -C of {GENOME_BP} bp in {index_s:.2f} s; "
          f"align --device cuda of {CS_READS} x {CS_READ_LEN} bp reads "
          f"({CS_READ_LEN - 1} colours) in {cli_s:.2f} s (CLI wall); unique "
          f"at origin {share:.6f}; ColorspaceAligner.align_batch "
          f"{rate:.1f} reads/s; launches {launches} ({smi})")
    if share < MIN_CS_SHARE:
        raise AssertionError(f"phase 22: {share:.4f} < {MIN_CS_SHARE}")
    del cs
    return {"launches": launches, "child": child, "tag": "cs_head"}


def two_pass_finish(run, what: str) -> None:
    """Phases 21-22, end: the --device cpu child's SAM of the first
    N_PARITY reads against the card's, byte for byte."""
    tag = run["tag"]
    _wait_child(run["child"], f"{tag}_cpu")
    want = (WORK / f"{tag}_cpu.sam").read_bytes()
    if (WORK / f"{tag}_cuda.sam").read_bytes() != want:
        raise AssertionError(f"{what}: SAM differs between --device cpu "
                             f"and cuda")
    print(f"{what}, first {N_PARITY} reads: --device cpu == --device cuda "
          f"byte for byte ({len(want)} bytes)")


# ------------------------------------------ PacBio, assembly (23, 24) ----

def _n50(lengths) -> int:
    ls = sorted(lengths, reverse=True)
    acc, half = 0, sum(ls) / 2
    for x in ls:
        acc += x
        if acc >= half:
            return x
    return 0


def _fasta_lengths(path: Path) -> list[int]:
    from biokanga_tpu_torch.seq.fasta import read_seqs

    return [len(r.codes) for r in read_seqs(str(path))]


def pacbio_cell(smi) -> dict:
    """Phase 23: phase 9's EC read set through `ecreads --checkpoint-dir`
    on the card, once unbroken and once after half its group files were
    deleted (the resumed run recomputes them), both FASTAs byte for byte
    equal to each other and to an unbroken `--rounds 1` run (the
    checkpointed EC is one round); then `contigs` on phase 9's corrected
    reads with --device cuda against a --device cpu child."""
    import shutil

    from biokanga_tpu_torch import cli

    fasta, ck = WORK / "ec_h2h.fa", WORK / "ec_ck"
    child = _cpu_child(["contigs", "-i", str(WORK / "ec_h2h_out.fa"), "-o",
                        str(WORK / "ctg_cpu.fa")], "ctg_cpu")
    shutil.rmtree(ck, ignore_errors=True)
    _reset_kernel_launches()
    t0 = time.monotonic()
    st = _ecreads(fasta, WORK / "ec_ck1.fa", "cuda",
                  ("--checkpoint-dir", str(ck)))
    ck_s = time.monotonic() - t0
    ec_launches = _kernel_launches()
    groups = sorted(ck.glob("c*.npz"))
    for g in groups[::2]:
        g.unlink()
    t0 = time.monotonic()
    _ecreads(fasta, WORK / "ec_ck2.fa", "cuda", ("--checkpoint-dir", str(ck)))
    resume_s = time.monotonic() - t0
    _ecreads(fasta, WORK / "ec_r1.fa", "cuda", ("--rounds", "1"))
    want = (WORK / "ec_r1.fa").read_bytes()
    if (WORK / "ec_ck1.fa").read_bytes() != want or \
            (WORK / "ec_ck2.fa").read_bytes() != want:
        raise AssertionError("phase 23: checkpointed EC FASTA differs")
    if min(ec_launches["banded_sw_moves"], ec_launches["sw_trace"]) < 1:
        raise AssertionError(f"phase 23: EC launches {ec_launches}")
    print(f"ecreads --checkpoint-dir on the EC cell: {len(groups)} groups, "
          f"{ck_s:.2f} s unbroken, {resume_s:.2f} s resumed after deleting "
          f"{len(groups[::2])}; both FASTAs equal the unbroken --rounds 1 "
          f"run byte for byte ({len(want)} bytes, {st['overlaps']} overlaps; "
          f"SW/decode launches {ec_launches['banded_sw_moves']}/"
          f"{ec_launches['sw_trace']})")
    _reset_kernel_launches()
    ctg_s = _timed_cli(["contigs", "-i", str(WORK / "ec_h2h_out.fa"), "-o",
                        str(WORK / "ctg_cuda.fa"), "--device", "cuda"])
    ctg_launches = _kernel_launches()
    lens = _fasta_lengths(WORK / "ctg_cuda.fa")
    print(f"contigs --device cuda on phase 9's {EC_READS} corrected reads: "
          f"{ctg_s:.2f} s, {len(lens)} contigs, N50 {_n50(lens)}, max "
          f"{max(lens)}, {sum(lens)} bp; launches {ctg_launches} ({smi})")
    return {"child": child, "ec_launches": ec_launches,
            "ctg_launches": ctg_launches}


def pacbio_finish(run) -> None:
    _wait_child(run["child"], "ctg_cpu")
    want = (WORK / "ctg_cpu.fa").read_bytes()
    if (WORK / "ctg_cuda.fa").read_bytes() != want:
        raise AssertionError("phase 23: contigs FASTA differs cpu vs cuda")
    print(f"contigs on the corrected EC cell: --device cpu == --device cuda "
          f"byte for byte ({len(want)} bytes)")


def _assembly_parity_start() -> dict:
    """Phase 24's card-against-CPU cases: `assemb` on the 20 kb, 2,400-read
    case of tests/test_assembly_scaled.py, and `scaffold` and
    `pescaffold` on two contigs of a 6 kb genome with PE reads across
    their gap (the second contig reverse-complemented); the --device cpu
    runs are child processes, the card's run here."""
    from biokanga_tpu_torch import cli
    from biokanga_tpu_torch.seq.encode import revcomp
    from biokanga_tpu_torch.seq.fasta import write_fasta
    from biokanga_tpu_torch.sim.simreads import random_genome, simulate_reads

    g = random_genome([("chr1", 20_000)], seed=21)
    _, reads, _ = simulate_reads(g, 2_400, read_len=100, sub_rate=0.0,
                                 seed=9)
    write_fasta(str(WORK / "asm20k.fa"), ((f"r{i}", r)
                                          for i, r in enumerate(reads)))
    g6 = random_genome([("s", 6_000)], seed=33)[0][1]
    write_fasta(str(WORK / "ctg2.fa"), [("ctg1", g6[:2_500]),
                                        ("ctg2", revcomp(g6[2_700:5_500]))])
    rng = np.random.default_rng(6)
    r1, r2 = [], []
    for p in list(rng.integers(2_050, 2_350, 24)) + list(
            rng.integers(0, 5_400, 40)):
        frag = g6[p:p + 500]
        if len(frag) == 500:
            r1.append(frag[:100].copy())
            r2.append(revcomp(frag[-100:]))
    for m, rs in ((1, r1), (2, r2)):
        write_fasta(str(WORK / f"sc{m}.fa"), ((f"p{i}/{m}", r)
                                              for i, r in enumerate(rs)))
    if cli.main(["index", "-i", str(WORK / "ctg2.fa"), "-o",
                 str(WORK / "ctg2.npz"), "--lut-bases", "8"]) != 0:
        raise AssertionError("phase 24: index of the two contigs failed")
    runs = {}
    for d in ("cpu", "cuda"):
        argv = {
            "asm20k": ["assemb", "-i", str(WORK / "asm20k.fa"), "-o",
                       str(WORK / f"asm20k_{d}.fa")],
            "scaffold": ["scaffold", "-c", str(WORK / "ctg2.fa"), "-i",
                         str(WORK / "sc1.fa"), "-u", str(WORK / "sc2.fa"),
                         "-o", str(WORK / f"scaffold_{d}.fa"),
                         "--insert-size", "500"],
            "sam1": ["align", "-i", str(WORK / "sc1.fa"), "-I",
                     str(WORK / "ctg2.npz"), "-o", str(WORK / f"pe1_{d}.sam")],
            "sam2": ["align", "-i", str(WORK / "sc2.fa"), "-I",
                     str(WORK / "ctg2.npz"), "-o", str(WORK / f"pe2_{d}.sam")],
        }
        for name, a in argv.items():
            if d == "cpu":
                runs[name] = _cpu_child(a, f"{name}_cpu")
            elif cli.main(a + ["--device", "cuda"]) != 0:
                raise AssertionError(f"phase 24: {name} --device cuda failed")
    return runs


def _assembly_parity_finish(runs) -> None:
    from biokanga_tpu_torch import cli

    for name, proc in runs.items():
        _wait_child(proc, f"{name}_cpu")
    for d in ("cpu", "cuda"):
        if cli.main(["pescaffold", "-i", str(WORK / f"pe1_{d}.sam"), "-u",
                     str(WORK / f"pe2_{d}.sam"), "-o",
                     str(WORK / f"pesc_{d}.csv")]) != 0:
            raise AssertionError("phase 24: pescaffold failed")
    for stem, ext in (("asm20k", "fa"), ("scaffold", "fa"), ("pe1", "sam"),
                      ("pe2", "sam"), ("pesc", "csv")):
        want = (WORK / f"{stem}_cpu.{ext}").read_bytes()
        if (WORK / f"{stem}_cuda.{ext}").read_bytes() != want:
            raise AssertionError(f"phase 24: {stem}.{ext} differs cpu vs "
                                 f"cuda")
    lens = _fasta_lengths(WORK / "asm20k_cuda.fa")
    sc = _fasta_lengths(WORK / "scaffold_cuda.fa")
    print(f"assemb on the 20 kb, 2,400-read case ({len(lens)} contigs, max "
          f"{max(lens)}), scaffold of two contigs ({len(sc)} scaffold(s), "
          f"{sc}) and pescaffold's CSV: --device cpu == --device cuda byte "
          f"for byte")


def assembly_cell(dev, smi) -> dict:
    """Phase 24: de novo assembly of a bacterial Illumina PE readset,
    BENCH_ASM.json's row 0.5mbp_30x_r4 (scripts/bench_assembly.py's
    genome and reads: seed 33, 2 x 150 bp error-free pairs, inserts
    250-500, both mate files as -i), through `assemb` with its defaults
    on the card: wall, passes, contigs, N50, max contig, total bp, the
    launches of #1-#3 and #3w and the peak device memory; every contig
    must be an exact substring of the genome on one strand or the
    other.  Then the card-against-CPU cases of _assembly_parity_start."""
    import torch

    from biokanga_tpu_torch.seq.encode import revcomp
    from biokanga_tpu_torch.seq.fasta import read_seqs, write_fasta
    from biokanga_tpu_torch.sim.simreads import random_genome, simulate_reads

    parity = _assembly_parity_start()
    seqs = random_genome([("chr1", ASM_GENOME_BP)], seed=33)
    names, reads, _ = simulate_reads(
        seqs, ASM_PAIRS, read_len=150, sub_rate=0.0, seed=44, pe=True,
        insert_min=250, insert_max=500)
    for m in (0, 1):
        write_fasta(str(WORK / f"asm_pe{m + 1}.fa"),
                    ((names[i], reads[i]) for i in range(m, 2 * ASM_PAIRS, 2)))
    log = WORK / "asm.log"
    log.unlink(missing_ok=True)
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_launches()
    wall = _timed_cli(["assemb", "-i", str(WORK / "asm_pe1.fa"), "-i",
                       str(WORK / "asm_pe2.fa"), "-o", str(WORK / "asm.fa"),
                       "-F", str(log), "--device", "cuda"])
    launches = _kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    m = re.search(r"assembled (\d+) seqs -> (\d+) contigs \((\d+) bp, max "
                  r"(\d+)\) in (\d+) passes", log.read_text())
    if m is None:
        raise AssertionError("phase 24: assemb wrote no summary line")
    contigs = [r.codes for r in read_seqs(str(WORK / "asm.fa"))]
    g = seqs[0][1].tobytes()
    bad = sum(c.tobytes() not in g and revcomp(c).tobytes() not in g
              for c in contigs)
    lens = [len(c) for c in contigs]
    print(f"assembly cell ({ASM_GENOME_BP} bp, {ASM_PAIRS} pairs of 2 x 150 "
          f"bp): assemb --device cuda wall {wall:.2f} s, {m[5]} passes, "
          f"{len(contigs)} contigs, N50 {_n50(lens)}, max {max(lens)}, total "
          f"{sum(lens)} bp ({sum(lens) / ASM_GENOME_BP:.4f} of the genome), "
          f"{bad} not exact genome substrings; launches {launches}; peak "
          f"device memory {peak / 2**30:.2f} GiB ({smi})")
    if bad or not contigs:
        raise AssertionError(f"phase 24: {bad} of {len(contigs)} contigs are "
                             f"not exact substrings of the genome")
    if min(launches[k] for k in ALIGN_KERNELS
           + ("hamming_extend_packed_win",)) < 1:
        raise AssertionError(f"phase 24: kernels not launched: {launches}")
    return {"launches": launches, "parity": parity}


# ---------------------------------------------- the device tools (25-28) ----

def _uh_pairs(starts, n: int, K: int, lo: int, hi: int,
              rc: bool) -> tuple[int, int]:
    """(watson, cross) pairs of windows a sweep must evaluate: both
    windows inside an entry, watson shifts in [lo, hi), and with rc each
    unordered pair of a window and a reverse-complement window once (its
    own reverse complement included)."""
    ivs = [(int(a), int(b) - K + 1) for a, b in zip(starts[:-1], starts[1:])
           if b - a >= K]
    watson = 0
    for x0, x1 in ivs:
        x = np.arange(x0, x1, dtype=np.int64)
        for y0, y1 in ivs:
            watson += int(np.clip(np.minimum(y1, x + hi)
                                  - np.maximum(y0, x + lo), 0, None).sum())
    n_valid = sum(b - a for a, b in ivs)
    return watson, n_valid * (n_valid + 1) // 2 if rc else 0


def _uh_bound(starts, n: int, K: int, lo: int, hi: int, rc: bool):
    """The sweep's least time: its integer operations over the pairs it
    needs, against n codes, n flags and n results in and out."""
    watson, cross = _uh_pairs(starts, n, K, lo, hi, rc)
    return _bound(4 * n, UH_OPS_PAIR * (watson + cross))


def _uh_check_genome():
    """Phase 25's check genome: two 3 kb entries and an 80 bp one (past
    K 24 and 32, short of K 100), N runs (one in the short entry), an
    exact, a near (3 substitutions) and a reverse-complement repeat, and a
    300 bp palindrome (its own reverse complement)."""
    from biokanga_tpu_torch.seq.encode import revcomp
    from biokanga_tpu_torch.sim.simreads import random_genome

    seqs = random_genome(UH_CHECK, seed=25)
    g = np.concatenate([s for _, s in seqs])
    starts = np.concatenate([[0], np.cumsum([len(s) for _, s in seqs])])
    g[500:540] = 4
    g[3_010:3_013] = 4
    g[4_000:4_300] = g[200:500]
    near = g[1_000:1_300].copy()
    near[[50, 150, 250]] = (near[[50, 150, 250]] + 1) % 4
    g[5_000:5_300] = near
    g[5_500:5_700] = revcomp(g[2_000:2_200])
    at, ln = UH_PALINDROME
    g[at + ln // 2:at + ln] = revcomp(g[at:at + ln // 2])
    return g, starts


def _uh_big_genome():
    """The 1 Mbp genome of phases 25 and 28, with its planted repeats."""
    from biokanga_tpu_torch.sim.simreads import random_genome

    seqs = random_genome([("chr", UH_BP)], seed=251)
    g = seqs[0][1]
    for src, dst, subs in UH_REPEATS:
        c = g[src:src + UH_REPEAT_LEN].copy()
        at = np.linspace(50, UH_REPEAT_LEN - 50, subs).astype(int)
        c[at] = (c[at] + 1) % 4
        g[dst:dst + UH_REPEAT_LEN] = c
    return seqs


def check_uhamming(dev):
    """Phase 25.1: #7 against its plain version on the check genome, K 24,
    32, 100 and 300, both sweeps over every shift and the watson sweep
    over a mode-2 range; the planted repeats must read 0 and <= 3 at K
    100, and the palindrome's centred window 0 at every K.  Then both at
    UH_LINE_BP, timed with the bound.  Returns (max_abs_err, timing)."""
    import torch

    from biokanga_tpu_torch.ops import uhamming_sweep as us
    from biokanga_tpu_torch.sim.simreads import random_genome
    from biokanga_tpu_torch.tools.uhamming import window_validity

    def args(g, starts, K):
        return (torch.from_numpy(g).to(dev),
                torch.from_numpy(window_validity(starts, len(g), K)).to(dev),
                torch.full((len(g),), us.H_INVALID, dtype=torch.uint8,
                           device=dev))

    g, starts = _uh_check_genome()
    err = 0
    for K in UH_KS:
        a = args(g, starts, K)
        top = len(g) - K + 1
        for lo, hi, rc in ((1, top, True), (1 + (top - 1) // 3,
                                             1 + 2 * (top - 1) // 3, False)):
            got = us.uhamming_sweep(*a, K, lo, hi, rc)
            want = us.uhamming_sweep_plain(*a, K, lo, hi, rc)
            err = max(err, _max_abs_err(got, want))
            if lo == 1 and K == 100:
                h = want.cpu().numpy()
                if h[200:401].max() or h[2_000:2_101].max() or \
                        h[1_000:1_201].max() > 3:
                    raise AssertionError("phase 25: planted repeats missed")
            at, ln = UH_PALINDROME
            if rc and int(want[at + (ln - K) // 2]):
                raise AssertionError(f"phase 25: the palindrome's window "
                                     f"reads {int(want[at + (ln - K) // 2])} "
                                     f"at K {K}")
    line = random_genome([("chr", UH_LINE_BP)], seed=252)[0][1]
    ls = np.array([0, UH_LINE_BP])
    a = args(line, ls, UH_K)
    top = UH_LINE_BP - UH_K + 1
    got = us.uhamming_sweep(*a, UH_K, 1, top, True)
    want = us.uhamming_sweep_plain(*a, UH_K, 1, top, True)
    err = max(err, _max_abs_err(got, want))
    if err:
        raise AssertionError(f"uhamming_sweep disagrees: {err}")
    bound_ms, by = _uh_bound(ls, UH_LINE_BP, UH_K, 1, top, True)
    t = dict(ms=_timed_ms(lambda: us.uhamming_sweep(*a, UH_K, 1, top, True),
                          3),
             plain_ms=_timed_ms(
                 lambda: us.uhamming_sweep_plain(*a, UH_K, 1, top, True), 1),
             library_ms=None, bound=(bound_ms, by))
    print(f"uhamming_sweep exact against its plain version (K {UH_KS}, both "
          f"sweeps and a mode-2 range on {len(g)} bases in "
          f"{len(starts) - 1} entries with Ns, repeats and a palindrome; "
          f"-m 0 at "
          f"{UH_LINE_BP} bases); at {UH_LINE_BP}: kernel {t['ms']:.4f} ms, "
          f"plain torch {t['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
          f"({by})")
    torch.cuda.empty_cache()
    return err, t


def _uh_cli(argv, device="cuda") -> float:
    return _timed_cli(["uhamming", *map(str, argv), "--device", device])


def uhamming_cell(dev, smi):
    """Phase 25: #7 checked (check_uhamming); `uhamming -m 0` on a 20 kb
    genome on the card against a --device cpu child (.hmg arrays and CSV
    compared at the end); the 1 Mbp -m 0 sweep with the reverse
    complement, K 100, timed through the CLI (its wall, and its sweep
    between CUDA events), its planted
    repeats read back; `-m 2 -n 64 -N 1` on the 4.6 Mbp SE genome; a
    `-m 3` merge of two partials against one -m 2 run over their union.
    Returns the phase's record."""
    import torch

    from biokanga_tpu_torch.ops import uhamming_sweep as us
    from biokanga_tpu_torch.seq.fasta import write_fasta
    from biokanga_tpu_torch.sim.simreads import random_genome
    from biokanga_tpu_torch.tools import uhamming as uh

    err, timing = check_uhamming(dev)
    write_fasta(str(WORK / "uh20k.fa"),
                random_genome([("u1", UH_CLI_BP // 2), ("u2", UH_CLI_BP // 2)],
                              seed=253))
    child = _cpu_child(["uhamming", "-i", str(WORK / "uh20k.fa"), "-o",
                        str(WORK / "uh20k_cpu.hmg.npz"), "-O",
                        str(WORK / "uh20k_cpu.csv")], "uh20k_cpu")
    _uh_cli(["-i", WORK / "uh20k.fa", "-o", WORK / "uh20k_cuda.hmg.npz",
             "-O", WORK / "uh20k_cuda.csv"])
    # -m 3 of two node partials against one -m 2 run over their union
    for node, nodes in ((1, 2), (2, 2), (1, 1)):
        _uh_cli(["-m", 2, "-n", nodes, "-N", node, "-i", WORK / "uh20k.fa",
                 "-o", WORK / f"uh20k_m2_{node}of{nodes}.hmg.npz"])
    _uh_cli(["-m", 3, "-I", WORK / "uh20k_m2_1of2.hmg.npz", "-I",
             WORK / "uh20k_m2_2of2.hmg.npz", "-o", WORK / "uh20k_m3.hmg.npz"])
    merged = uh.load_hmg(str(WORK / "uh20k_m3.hmg.npz"))[0]
    if not np.array_equal(merged, uh.load_hmg(str(WORK /
                                                  "uh20k_m2_1of1.hmg.npz"))[0]):
        raise AssertionError("phase 25: -m 3 merge != one -m 2 run")

    seqs = _uh_big_genome()
    write_fasta(str(WORK / "uh1m.fa"), seqs)
    us.uhamming_sweep.launches = 0
    sweep_ms = []
    real = uh.uhamming_sweep

    def timed(*a):
        """The CLI's sweep between two CUDA events."""
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        out = real(*a)
        t1.record()
        torch.cuda.synchronize()
        sweep_ms.append(t0.elapsed_time(t1))
        return out

    uh.uhamming_sweep = timed
    try:
        wall = _uh_cli(["-i", WORK / "uh1m.fa", "-o",
                        WORK / "uh1m.hmg.npz", "-K", UH_K])
    finally:
        uh.uhamming_sweep = real
    launches = us.uhamming_sweep.launches
    h = uh.load_hmg(str(WORK / "uh1m.hmg.npz"))[0]
    for src, dst, subs in UH_REPEATS:
        for at in (src, dst):
            got = int(h[at:at + UH_REPEAT_LEN - UH_K + 1].max())
            if got > subs:
                raise AssertionError(f"phase 25: repeat at {at} ({subs} "
                                     f"substitutions) reads {got}")
    alone_s = sweep_ms[0] / 1e3
    big_bound, big_by = _uh_bound(np.array([0, UH_BP]), UH_BP, UH_K, 1,
                                  UH_BP - UH_K + 1, True)
    # the node partition on the SE genome
    us.uhamming_sweep.launches = 0
    m2_wall = _uh_cli(["-m", 2, "-n", UH_NODES, "-N", 1, "-i",
                       WORK / "ref.fa", "-o", WORK / "se_m2.hmg.npz", "-K",
                       UH_K])
    launches += us.uhamming_sweep.launches
    if launches != 3:
        raise AssertionError(f"phase 25: #7 launched {launches} times, not "
                             f"3 (two sweeps of -m 0, one of -m 2)")
    top = GENOME_BP - UH_K + 1
    m2_bound, m2_by = _uh_bound(np.array([0, GENOME_BP]), GENOME_BP, UH_K, 1,
                                1 + (top - 1) // UH_NODES, False)
    share = (h < us.H_INVALID).mean()
    print(f"uhamming -m 0 -K {UH_K} on {UH_BP} bp: CLI wall {wall:.2f} s, "
          f"its sweep {alone_s:.2f} s (bound {big_bound / 1e3:.4f} s "
          f"({big_by}), {big_bound / 1e3 / alone_s:.4f} of it); planted "
          f"repeats read <= their substitutions; {share:.4f} of loci "
          f"counted, {int((h == 0).sum())} at 0; -m 2 -n {UH_NODES} -N 1 on "
          f"{GENOME_BP} bp: wall {m2_wall:.2f} s (bound {m2_bound:.4f} ms, "
          f"{m2_by}); #7 launches {launches} ({smi})")
    timing.update(ms_1mbp=alone_s * 1e3, bound_ms_1mbp=big_bound,
                  wall_s_1mbp=wall, wall_s_m2_se=m2_wall,
                  bound_ms_m2_se=m2_bound)
    return {"err": err, "timing": timing, "launches": launches,
            "child": child}


def _uh_finish(run) -> None:
    from biokanga_tpu_torch.tools.uhamming import load_hmg

    _wait_child(run["child"], "uh20k_cpu")
    a = load_hmg(str(WORK / "uh20k_cpu.hmg.npz"))
    b = load_hmg(str(WORK / "uh20k_cuda.hmg.npz"))
    if not (np.array_equal(a[0], b[0]) and a[1] == b[1]
            and np.array_equal(a[2], b[2]) and a[3] == b[3]):
        raise AssertionError("phase 25: .hmg differs cpu vs cuda")
    if (WORK / "uh20k_cpu.csv").read_bytes() != \
            (WORK / "uh20k_cuda.csv").read_bytes():
        raise AssertionError("phase 25: CSV differs cpu vs cuda")
    print(f"uhamming -m 0 on {UH_CLI_BP} bp: --device cpu == --device cuda "
          f"(.hmg arrays and CSV byte for byte)")


def _bz_queries(g: np.ndarray):
    """Phase 26's queries: BZ_QUERIES transcripts of 1-4 kb at 3%
    substitutions from both strands, a third spliced (two segments 1-20
    kb apart), then the JAX tests' bars, BZ_BARS each: exact 600 bp
    queries on each strand, exact spliced ones (two 300 bp exons 10 kb
    apart) and unrelated 500 bp ones.  Returns (records, truths) with a
    truth (kind, start, end, strand) in genome coordinates."""
    from biokanga_tpu_torch.seq.encode import revcomp

    rng = np.random.default_rng(26)
    n = len(g)
    recs, truth = [], []
    for i in range(BZ_QUERIES):
        L = int(rng.integers(BZ_LEN[0], BZ_LEN[1] + 1))
        if i % 3 == 0:
            a = int(rng.integers(L // 4, 3 * L // 4))
            intron = int(rng.integers(BZ_INTRON[0], BZ_INTRON[1] + 1))
            s = int(rng.integers(0, n - L - intron))
            q = np.concatenate([g[s:s + a], g[s + a + intron:s + L + intron]])
            t = ("spliced", s, s + L + intron)
        else:
            s = int(rng.integers(0, n - L))
            q, t = g[s:s + L].copy(), ("mutated", s, s + L)
        m = rng.random(len(q)) < BZ_SUB
        q[m] = (q[m] + rng.integers(1, 4, int(m.sum()))) % 4
        minus = bool(rng.random() < 0.5)
        recs.append((f"q{i}", revcomp(q) if minus else q))
        truth.append((*t, "-" if minus else "+"))
    for i in range(BZ_BARS):
        s = int(rng.integers(0, n - 20_000))
        recs.append((f"exact{i}", g[s:s + 600].copy()))
        truth.append(("exact", s, s + 600, "+"))
        recs.append((f"reverse{i}", revcomp(g[s + 5_000:s + 5_500])))
        truth.append(("exact", s + 5_000, s + 5_500, "-"))
        recs.append((f"splice{i}", np.concatenate(
            [g[s + 8_000:s + 8_300], g[s + 18_300:s + 18_600]])))
        truth.append(("splice", s + 8_000, s + 18_600, "+"))
        recs.append((f"junk{i}", rng.integers(0, 4, 500).astype(np.int8)))
        truth.append(("junk", 0, 0, "+"))
    return recs, truth


def _psl_best(path: Path) -> dict:
    """Query name -> the fields of its first (best) PSL row."""
    best = {}
    for ln in path.read_text().splitlines()[5:]:
        f = ln.split("\t")
        best.setdefault(f[9], f)
    return best


def _bz_gates(best: dict, recs, truth) -> float:
    """The JAX tests' bars (tests/test_blitz.py:22-67) on the bar
    queries; returns the share of the transcripts whose best path lies
    at their origin on their strand."""
    at_origin = n_tx = 0
    for (name, q), (kind, s, e, strand) in zip(recs, truth):
        f = best.get(name)
        if kind == "junk":
            if f is not None:
                raise AssertionError(f"phase 26: unrelated {name} has a path")
            continue
        if kind in ("mutated", "spliced"):
            n_tx += 1
            at_origin += (f is not None and f[8] == strand
                          and int(f[15]) >= s - 100 and int(f[16]) <= e + 100)
            continue
        if f is None or f[8] != strand or int(f[15]) > s + 5 or \
                int(f[16]) < e - 10:
            raise AssertionError(f"phase 26: {name} not found at its origin: "
                                 f"{f}")
        if kind == "exact" and int(f[0]) < 0.9 * len(q):
            raise AssertionError(f"phase 26: {name} matches {f[0]}")
        if kind == "splice" and (int(f[6]) < 1 or int(f[7]) < 9_000):
            raise AssertionError(f"phase 26: {name} did not chain across "
                                 f"its intron: {f}")
    return at_origin / n_tx


def _chain_bound(q0, valid) -> tuple[float, str, int]:
    """The chain DP's least time on these inputs: its integer operations
    over the valid blocks and their (i, j < i) pairs of every chain,
    against five int32 inputs read and two outputs written."""
    m = valid.to(dtype=q0.dtype).sum(dim=1).double()
    pairs = int((m * (m - 1) / 2).sum().item())
    ms, by = _bound(7 * q0.numel() * 4, BZ_OPS_PER_BLOCK * int(m.sum().item())
                    + BZ_OPS_PER_PAIR * pairs)
    return ms, by, pairs


def _chain_step_ms(dev) -> float:
    """One step of #8's dependent chain on this card, in ms: the
    blitz_chain_step_probe warp's time at BZ_PROBE_STEPS[1] steps less
    its time at BZ_PROBE_STEPS[0], over the difference (CUDA events, the
    mean of 5 launches each)."""
    import torch

    from biokanga_tpu_torch import kernels

    lib = kernels.library()
    out = torch.empty(32, dtype=torch.int32, device=dev)
    stream = kernels.stream_ptr(dev)

    def run(steps):
        kernels.check(lib.blitz_chain_step_probe(steps, out.data_ptr(),
                                                 stream),
                      "blitz_chain_step_probe")

    lo, hi = BZ_PROBE_STEPS
    with torch.cuda.device(dev):
        t_lo, t_hi = (_timed_ms(lambda: run(s), 5) for s in (lo, hi))
    return (t_hi - t_lo) / (hi - lo)


def _chain_floor(valid, step_ms: float) -> float:
    """#8's dependent-chain floor in ms on these chains: the valid steps
    of the longest chain of each wave, times one step's measured latency
    (_chain_step_ms).  A wave is the most chains the card can walk at
    once: a warp a chain, 64 warps an SM."""
    import torch

    wave = 132 * 64
    steps = valid.to(dtype=torch.int64).sum(dim=1).cpu().numpy()
    return sum(int(steps[k:k + wave].max())
               for k in range(0, len(steps), wave)) * step_ms


def _bz_wide_chains(rng, C: int, M: int, dev):
    """chain_scan's arguments for C chains of M blocks, long collinear
    chains sorted by t: steps of 0-60 bp with small indels, 10% of the
    blocks off the diagonal, blocks of 16-40 bp, the last chain a quarter
    padding; gap_open 5."""
    import torch

    t0 = np.cumsum(rng.integers(0, 61, (C, M)), axis=1)
    q0 = t0 + rng.integers(-5, 6, (C, M)).cumsum(axis=1) // 4
    off = rng.random((C, M)) < 0.1
    q0[off] = rng.integers(0, int(t0.max()) + 1, int(off.sum()))
    ln = rng.integers(16, 41, (C, M))
    valid = np.ones((C, M), bool)
    valid[-1, 3 * M // 4:] = False
    t = [torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(dev)
         for v in (q0, t0, ln, ln)]
    return (*t, torch.from_numpy(valid).to(dev), 5)


def blitz_cell(dev, smi):
    """Phase 26: `blitz` of transcripts and ESTs against the 4.6 Mbp SE
    genome (phase 4's index): the queries of _bz_queries through the CLI
    on the card, their PSL gated on the JAX tests' bars, queries/s and
    the share at origin; the PSL of the first BZ_PARITY_Q queries, and
    PSLX, BED and MAF of the first BZ_FMT_Q, against --device cpu
    children; the 1 Mbp rearranged query of tests/test_blitz_scale.py on
    the card with its bars; #8 against its plain version on every chain
    batch of the CLI run and of the 1 Mbp query, timed with its bound and
    its dependent-chain floor on the CLI's first batch; #8 on a wide set
    of BZ_WIDE chains past the shared memory against its plain version,
    timed with its bound and floor."""
    from biokanga_tpu_torch.index.build import load_index
    from biokanga_tpu_torch.index.device import to_device
    from biokanga_tpu_torch.ops import blitz_chain as bc
    from biokanga_tpu_torch.seq.fasta import write_fasta
    from biokanga_tpu_torch.tools import blitz

    idx = load_index(str(WORK / "ref.npz"))
    recs, truth = _bz_queries(idx.codes)
    write_fasta(str(WORK / "bz_q.fa"), recs)
    write_fasta(str(WORK / "bz_head.fa"), recs[:BZ_PARITY_Q])
    write_fasta(str(WORK / "bz_fmt.fa"), recs[:BZ_FMT_Q])
    children = {"psl": _cpu_child(
        ["blitz", "-i", str(WORK / "bz_head.fa"), "-I", str(WORK / "ref.npz"),
         "-o", str(WORK / "bz_head_cpu.psl")], "bz_head_cpu")}
    for fmt in ("pslx", "bed", "maf"):
        children[fmt] = _cpu_child(
            ["blitz", "-i", str(WORK / "bz_fmt.fa"), "-I",
             str(WORK / "ref.npz"), "-o", str(WORK / f"bz_fmt_cpu.{fmt}"),
             "-M", fmt], f"bz_{fmt}_cpu")
    captured = []
    real = blitz.chain_scan

    def record(*a):
        captured.append(a)
        return real(*a)

    blitz.chain_scan = record
    bc.chain_scan.launches = 0
    try:
        wall = _timed_cli(["blitz", "-i", str(WORK / "bz_q.fa"), "-I",
                           str(WORK / "ref.npz"), "-o",
                           str(WORK / "bz_cuda.psl"), "--device", "cuda"])
    finally:
        blitz.chain_scan = real
    launches, n_cli = bc.chain_scan.launches, len(captured)
    if launches < 1 or not captured:
        raise AssertionError(f"phase 26: #8 launched {launches} times")
    best = _psl_best(WORK / "bz_cuda.psl")
    share = _bz_gates(best, recs, truth)
    _timed_cli(["blitz", "-i", str(WORK / "bz_head.fa"), "-I",
                str(WORK / "ref.npz"), "-o", str(WORK / "bz_head_cuda.psl"),
                "--device", "cuda"])
    for fmt in ("pslx", "bed", "maf"):
        _timed_cli(["blitz", "-i", str(WORK / "bz_fmt.fa"), "-I",
                    str(WORK / "ref.npz"), "-o",
                    str(WORK / f"bz_fmt_cuda.{fmt}"), "-M", fmt, "--device",
                    "cuda"])

    # the 1 Mbp query of tests/test_blitz_scale.py, on this genome
    (a0, a1), (b0, b1) = BZ_BIG
    q = np.concatenate([idx.codes[a0:a1], idx.codes[b0:b1]])
    didx = to_device(idx, dev, pack=False)
    blitz.chain_scan = record
    try:
        t0 = time.monotonic()
        paths = blitz.blitz_query(didx, "big", q, blitz.BlitzParams(
            max_nodes=2048, max_paths=4))
        big_s = time.monotonic() - t0
    finally:
        blitz.chain_scan = real
    if len(captured) == n_cli:
        raise AssertionError("phase 26: the 1 Mbp query ran no chain DP")
    spans = sorted((p.tstart, p.tend) for p in paths[:2])
    seg = a1 - a0                       # the bars: 400,000 and 490,000
    if len(spans) < 2 or spans[0][0] > a0 + 2_000 or \
            abs(spans[0][1] - a1) >= 2_000 or spans[1][0] > b0 + 2_000 or \
            abs(spans[1][1] - b1) >= 2_000 or \
            not all(p.score > 0.8 * seg and p.matches > 0.98 * seg
                    for p in paths[:2]):
        raise AssertionError(f"phase 26: the 1 Mbp query's paths {spans}")

    err = 0
    for a in captured:
        got = bc.chain_scan(*a)
        want = bc.chain_scan_plain(*a)
        err = max(err, _max_abs_err(got[0], want[0]),
                  _max_abs_err(got[1], want[1]))
    wide = _bz_wide_chains(np.random.default_rng(26), *BZ_WIDE, dev)
    want, wide_plain_ms = _once_ms(lambda: bc.chain_scan_plain(*wide))
    got = bc.chain_scan(*wide)
    err = max(err, _max_abs_err(got[0], want[0]),
              _max_abs_err(got[1], want[1]))
    if err:
        raise AssertionError(f"blitz_chain disagrees: {err}")
    a = captured[0]
    bound_ms, by, pairs = _chain_bound(a[0], a[4])
    wide_bound, wide_by, _ = _chain_bound(wide[0], wide[4])
    step_ms = _chain_step_ms(dev)
    t = dict(ms=_timed_ms(lambda: bc.chain_scan(*a)),
             plain_ms=_timed_ms(lambda: bc.chain_scan_plain(*a), 1),
             library_ms=None, bound=(bound_ms, by),
             step_ms=step_ms, floor_ms=_chain_floor(a[4], step_ms),
             chains=int(a[0].shape[0]), width=int(a[0].shape[1]),
             pairs=pairs, wide_ms=_timed_ms(lambda: bc.chain_scan(*wide), 3),
             wide_plain_ms=wide_plain_ms, wide_bound_ms=wide_bound,
             wide_floor_ms=_chain_floor(wide[4], step_ms),
             wide_shape=list(BZ_WIDE))
    n_q = len(recs)
    print(f"blitz of {n_q} queries ({BZ_QUERIES} transcripts of "
          f"{BZ_LEN[0]}-{BZ_LEN[1]} bp at {BZ_SUB} substitutions, a third "
          f"spliced, and {4 * BZ_BARS} bar queries) on {GENOME_BP} bp: CLI "
          f"wall {wall:.2f} s, {n_q / wall:.1f} queries/s; the JAX tests' bars "
          f"hold; best path at origin for {share:.4f} of the transcripts; "
          f"#8 launches {launches}; blitz_chain exact on all {n_cli} "
          f"batches of the CLI run and the 1 Mbp query's "
          f"{len(captured) - n_cli} ("
          + ", ".join(f"{x[0].shape[0]} x {x[0].shape[1]}" for x in captured)
          + f" chains x width) and on {BZ_WIDE[0]} wide chains of "
          f"{BZ_WIDE[1]}; on the first batch's {t['chains']} chains "
          f"of width {t['width']} ({pairs} pairs): kernel {t['ms']:.4f} ms, "
          f"plain torch {t['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
          f"({by}), dependent-chain floor {t['floor_ms']:.4f} ms "
          f"(a step {step_ms * 1e6:.2f} ns, measured); on the "
          f"wide set: kernel {t['wide_ms']:.4f} ms, plain torch "
          f"{t['wide_plain_ms']:.1f} ms, bound {wide_bound:.4f} ms "
          f"({wide_by}), floor {t['wide_floor_ms']:.4f} ms ({smi})")
    print(f"blitz of a 1 Mbp query (two 500 kb segments, rearranged): "
          f"{big_s:.2f} s, both segments recovered, scores "
          f"{[p.score for p in paths[:2]]}")
    t.update(queries_per_s=n_q / wall, at_origin=share, big_query_s=big_s)
    return {"err": err, "timing": t, "launches": launches,
            "children": children}


def _bz_finish(run) -> None:
    for fmt, proc in run["children"].items():
        _wait_child(proc, "bz_head_cpu" if fmt == "psl" else f"bz_{fmt}_cpu")
    pairs = [("bz_head_cpu.psl", "bz_head_cuda.psl")] + [
        (f"bz_fmt_cpu.{f}", f"bz_fmt_cuda.{f}") for f in ("pslx", "bed",
                                                          "maf")]
    for a, b in pairs:
        if (WORK / a).read_bytes() != (WORK / b).read_bytes():
            raise AssertionError(f"phase 26: {b} differs from {a}")
    n_rows = len((WORK / "bz_head_cuda.psl").read_text().splitlines()) - 5
    print(f"blitz PSL of the first {BZ_PARITY_Q} queries ({n_rows} rows), "
          f"and PSLX, BED and MAF of the first {BZ_FMT_Q}: --device cpu == "
          f"--device cuda byte for byte")


def _mo_pairs(g: np.ndarray, n: int, seed: int):
    """n amplicon pairs of 2 x MO_LEN bp: a plate column barcode, an
    insert of the genome and a reverse-complemented row barcode, 180-280
    bp in all, read from both ends at MO_SUB substitutions."""
    from biokanga_tpu_torch.seq.encode import revcomp
    from biokanga_tpu_torch.tools import mergeoverlaps as mo

    rng = np.random.default_rng(seed)
    ins = rng.integers(MO_INSERT[0], MO_INSERT[1] + 1, n)
    s = rng.integers(0, len(g) - MO_INSERT[1], n)
    body = MO_LEN - 6
    cols = np.stack([mo._codes(x) for x in mo._COL_BARCODES])
    rows = np.stack([mo._codes(x) for x in mo._ROW_BARCODES])
    r1 = np.concatenate([cols[rng.integers(0, 12, n)],
                         g[s[:, None] + np.arange(body)]], axis=1)
    tail = g[(s + ins - 12 - body)[:, None] + np.arange(body)]
    r2 = np.concatenate([rows[rng.integers(0, 8, n)], revcomp(tail)], axis=1)
    for r in (r1, r2):
        m = rng.random(r.shape) < MO_SUB
        r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
    names = [f"p{i}" for i in range(n)]
    return names, r1.astype(np.int8), r2.astype(np.int8)


def _fastq_count(path: Path) -> int:
    with open(path, "rb") as f:
        return sum(1 for _ in f) // 4


def other_tools_cell(dev, smi):
    """Phase 27: `mergeoverlaps` modes 0 and 2 on MO_PAIRS amplicon pairs
    (pairs/s, merged and welled shares), the first MO_PARITY against
    --device cpu children; `findapproxmatches` of FA_QUERIES guides of 23
    bp, -s 2, on the 4.6 Mbp genome (every origin found) and its CSV on a
    256 kb genome against a --device cpu child; nw_score_batch on
    NW_PAIRS pairs of 150 x 150, card against CPU."""
    import torch

    from biokanga_tpu_torch.index.build import load_index
    from biokanga_tpu_torch.ops.nw import nw_score_batch
    from biokanga_tpu_torch.seq.encode import revcomp
    from biokanga_tpu_torch.seq.fasta import write_fasta

    g = load_index(str(WORK / "ref.npz")).codes
    names, r1, r2 = _mo_pairs(g, MO_PAIRS, seed=27)
    _write_fastq(WORK / "mo1.fq", names, r1)
    _write_fastq(WORK / "mo2.fq", names, r2)
    _write_fastq(WORK / "mo_head1.fq", names[:MO_PARITY], r1[:MO_PARITY])
    _write_fastq(WORK / "mo_head2.fq", names[:MO_PARITY], r2[:MO_PARITY])
    del r1, r2
    head = ["-i", str(WORK / "mo_head1.fq"), "-u", str(WORK / "mo_head2.fq")]
    children = {
        "mo0": _cpu_child(["mergeoverlaps", *head, "-o",
                           str(WORK / "mo_head_cpu.fq"), "--unmerged1",
                           str(WORK / "mo_head_cpu_u1.fq"), "--unmerged2",
                           str(WORK / "mo_head_cpu_u2.fq")], "mo0_cpu"),
        "mo2": _cpu_child(["mergeoverlaps", *head, "-m", "2", "-o",
                           str(WORK / "mo_head_cpu_amp")], "mo2_cpu")}
    walls = {}
    for mode, out in ((0, "mo_merged.fq"), (2, "mo_amp")):
        walls[mode] = _timed_cli(["mergeoverlaps", "-i", str(WORK / "mo1.fq"),
                                  "-u", str(WORK / "mo2.fq"), "-m", str(mode),
                                  "-o", str(WORK / out), "--device", "cuda"])
    merged = _fastq_count(WORK / "mo_merged.fq")
    welled = sum(_fastq_count(p) for p in WORK.glob("mo_amp.Well*.SE.fastq"))
    _timed_cli(["mergeoverlaps", *head, "-o", str(WORK / "mo_head_cuda.fq"),
                "--unmerged1", str(WORK / "mo_head_cuda_u1.fq"),
                "--unmerged2", str(WORK / "mo_head_cuda_u2.fq"), "--device",
                "cuda"])
    _timed_cli(["mergeoverlaps", *head, "-m", "2", "-o",
                str(WORK / "mo_head_cuda_amp"), "--device", "cuda"])
    print(f"mergeoverlaps on {MO_PAIRS} pairs of 2 x {MO_LEN} bp (inserts "
          f"{MO_INSERT[0]}-{MO_INSERT[1]}, {MO_SUB} substitutions): -m 0 "
          f"{MO_PAIRS / walls[0]:.1f} pairs/s, merged {merged / MO_PAIRS:.4f}; "
          f"-m 2 {MO_PAIRS / walls[2]:.1f} pairs/s, merged into a well "
          f"{welled / MO_PAIRS:.4f} ({smi})")
    if merged < 0.9 * MO_PAIRS or welled < 0.5 * MO_PAIRS:
        raise AssertionError(f"phase 27: merged {merged}, welled {welled}")

    # findapproxmatches: guides from the first FA_PARITY_BP bases
    rng = np.random.default_rng(271)
    fa_q, fa_truth = [], []
    for i in range(FA_QUERIES):
        s = int(rng.integers(0, FA_PARITY_BP - FA_LEN))
        q = g[s:s + FA_LEN].copy()
        subs = rng.choice(FA_LEN, int(rng.integers(0, FA_MM + 1)),
                          replace=False)
        q[subs] = (q[subs] + 1) % 4
        minus = i % 2 == 1
        fa_q.append((f"guide{i}", revcomp(q) if minus else q))
        fa_truth.append((f"guide{i}", s, "-" if minus else "+"))
    write_fasta(str(WORK / "fa_q.fa"), fa_q)
    write_fasta(str(WORK / "fa_256k.fa"), [("chr", g[:FA_PARITY_BP])])
    fa_args = ["-i", str(WORK / "fa_q.fa"), "-s", str(FA_MM)]
    children["fa"] = _cpu_child(["findapproxmatches", *fa_args, "-I",
                                 str(WORK / "fa_256k.fa"), "-o",
                                 str(WORK / "fa_256k_cpu.csv")], "fa_cpu")
    fa_wall = _timed_cli(["findapproxmatches", *fa_args, "-I",
                          str(WORK / "ref.fa"), "-o", str(WORK / "fa.csv"),
                          "--device", "cuda"])
    _timed_cli(["findapproxmatches", *fa_args, "-I",
                str(WORK / "fa_256k.fa"), "-o",
                str(WORK / "fa_256k_cuda.csv"), "--device", "cuda"])
    hits = set()
    rows = (WORK / "fa.csv").read_text().splitlines()[1:]
    for ln in rows:
        f = ln.split(",")
        hits.add((f[0].strip('"'), int(f[2]), f[3].strip('"')))
    missed = [t for t in fa_truth if t not in hits]
    print(f"findapproxmatches of {FA_QUERIES} guides of {FA_LEN} bp, -s "
          f"{FA_MM}, on {GENOME_BP} bp: {fa_wall:.2f} s, {len(rows)} hits, "
          f"{FA_QUERIES - len(missed)} of {FA_QUERIES} origins found")
    if missed:
        raise AssertionError(f"phase 27: origins missed: {missed[:5]}")

    # NW scores, card against CPU
    a = rng.integers(0, 4, (NW_PAIRS, NW_LEN)).astype(np.int8)
    b = a.copy()
    m = rng.random(b.shape) < 0.05
    b[m] = (b[m] + 1) % 4
    b = np.roll(b, rng.integers(-3, 4), axis=1)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    on_card = nw_score_batch(a, b, device=dev)
    nw_s = time.monotonic() - t0
    if not np.array_equal(on_card, nw_score_batch(a, b, device="cpu")):
        raise AssertionError("phase 27: NW scores differ cpu vs cuda")
    print(f"nw_score_batch of {NW_PAIRS} pairs of {NW_LEN} x {NW_LEN}: "
          f"{nw_s * 1e3:.1f} ms on the card, equal to the CPU's")
    return {"children": children}


def _other_tools_finish(run) -> None:
    import filecmp

    tags = {"mo0": "mo0_cpu", "mo2": "mo2_cpu", "fa": "fa_cpu"}
    for name, proc in run["children"].items():
        _wait_child(proc, tags[name])
    pairs = [(f"mo_head_cpu{s}.fq", f"mo_head_cuda{s}.fq")
             for s in ("", "_u1", "_u2")]
    pairs += [(p.name, p.name.replace("_cpu_", "_cuda_"))
              for p in WORK.glob("mo_head_cpu_amp.Well*")]
    pairs.append(("fa_256k_cpu.csv", "fa_256k_cuda.csv"))
    if len(list(WORK.glob("mo_head_cuda_amp.Well*"))) != \
            len(list(WORK.glob("mo_head_cpu_amp.Well*"))):
        raise AssertionError("phase 27: amplicon wells differ cpu vs cuda")
    for a, b in pairs:
        if not filecmp.cmp(WORK / a, WORK / b, shallow=False):
            raise AssertionError(f"phase 27: {b} differs from {a}")
    print(f"mergeoverlaps -m 0 (with unmerged mates) and -m 2 on "
          f"{MO_PARITY} pairs, and findapproxmatches on {FA_PARITY_BP} bp: "
          f"--device cpu == --device cuda byte for byte ({len(pairs)} files)")


def flagship_cell(dev, smi):
    """Phase 28: simreads -> index -> align in the port alone, on phase
    25's 1 Mbp genome: `simreads -H <its .hmg> -N 1000 -X 0.05 -g dyn
    --pe`, `index`, then `align` of the pairs on the card; the shares of
    proper pairs and of proper pairs at origin, split by the min-Hamming
    of each pair's first-mate source window (0 against > 0; the JAX
    simulator writes the .hmg's value into single-end names only, so it
    is read from the .hmg here)."""
    from biokanga_tpu_torch.sim.simreads import SimReadTruth
    from biokanga_tpu_torch.tools.uhamming import load_hmg

    fa = str(WORK / "uh1m.fa")
    wall = {"simreads": _timed_cli(
        ["simreads", "-i", fa, "-o", str(WORK / "fl1.fq"), "-O",
         str(WORK / "fl2.fq"), "-n", str(FL_PAIRS), "--pe", "-H",
         str(WORK / "uh1m.hmg.npz"), "-N", "1000", "-X", "0.05", "-g",
         "dyn"])}
    wall["index"] = _timed_cli(["index", "-i", fa, "-o",
                                str(WORK / "uh1m.npz"), "--lut-bases", "10"])
    _reset_kernel_launches()
    wall["align"] = _timed_cli(
        ["align", "-i", str(WORK / "fl1.fq"), "-u", str(WORK / "fl2.fq"),
         "-I", str(WORK / "uh1m.npz"), "-o", str(WORK / "fl.sam"),
         *PE_FLAGS, "--device", "cuda", "--batch-size", str(BATCH)])
    launches = _align_launches()
    if min(launches.values()) < 1:
        raise AssertionError(f"phase 28: kernels not launched: {launches}")
    h = load_hmg(str(WORK / "uh1m.hmg.npz"))[0]
    recs = _records(WORK / "fl.sam")
    counts = {k: [0, 0, 0] for k in ("0", ">0")}     # pairs, proper, origin
    for i in range(0, len(recs), 2):
        mates = [r.split("\t") for r in recs[i:i + 2]]
        truths = [SimReadTruth.parse(f[0]) for f in mates]
        key = "0" if h[truths[0].start - 1] == 0 else ">0"
        c = counts[key]
        c[0] += 1
        if all(int(f[1]) & 2 for f in mates):
            c[1] += 1
            c[2] += all(f[2] == t.chrom and abs(int(f[3]) - t.start) <= 10
                        and bool(int(f[1]) & 16) == (t.strand == "-")
                        for f, t in zip(mates, truths))
    shares = {k: {"pairs": c[0], "proper": c[1] / max(c[0], 1),
                  "at_origin": c[2] / max(c[1], 1)}
              for k, c in counts.items()}
    total = sum(c[0] for c in counts.values())
    if total != FL_PAIRS:
        raise AssertionError(f"phase 28: {total} pairs in the SAM")
    print(f"flagship in the port: simreads -H -N 1000 -X 0.05 -g dyn --pe "
          f"({FL_PAIRS} pairs, {wall['simreads']:.2f} s) -> index "
          f"({wall['index']:.2f} s) -> align PE ({wall['align']:.2f} s, "
          f"launches {launches}) on {UH_BP} bp; by the source window's "
          f"min-Hamming: {json.dumps(shares)} ({smi})")
    at_origin = (sum(c[2] for c in counts.values())
                 / max(sum(c[1] for c in counts.values()), 1))
    if at_origin < 0.95:
        raise AssertionError(f"phase 28: {at_origin:.4f} of the proper pairs "
                             f"at their origin")
    return {"launches": launches, "shares": shares}


def _rp_argv(stem: str, tag: str) -> dict:
    """Phase 29's `filter` and `ngsqc` argv on WORK/<stem>_{1,2}.fq, their
    outputs named <stem>_<tag>."""
    w = str(WORK)
    contam = f"{w}/rp_contam.fa"
    return {"filter": ["filter", "-i", f"{w}/{stem}_1.fq", "-u",
                       f"{w}/{stem}_2.fq", "-o", f"{w}/{stem}_{tag}_1.fq",
                       "-U", f"{w}/{stem}_{tag}_2.fq", "-c", contam,
                       "--near-dedupe"],
            "ngsqc": ["ngsqc", "-i", f"{w}/{stem}_1.fq", "-o",
                      f"{w}/{stem}_{tag}.html", "-c", contam]}


def readprep_cell(seqs, dev, smi):
    """Phase 29: read preparation on the card.  RP_PAIRS pairs of 2 x 100
    bp of tests/readprep_reads.py (3% adapter read-through of 20-60 bases,
    1% cloning-vector pairs, 5% exact and 1% near duplicates, 1%
    substitutions) from the 4.6 Mbp genome through `filter -c
    --near-dedupe` and `ngsqc -c` with --device cuda: their walls, the
    vector screen's time (Contaminants.match_vectors between
    synchronisations), the card's idle share of the filter wall (device
    time under torch.profiler), the launches of #1-#3 in each run, and
    the planted vector pairs rejected and adapter reads trimmed against
    the bars the JAX package reaches (tests/test_torch_readprep.py); the
    vector screen's engine result on one block equal on the card and the
    CPU; the first RP_PARITY pairs against --device cpu children."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from biokanga_tpu_torch.align.pipeline import pad_rows
    from biokanga_tpu_torch.seq import contaminants
    from biokanga_tpu_torch.seq.fasta import write_fasta

    sys.path.insert(0, str(ROOT / "tests"))
    import readprep_reads as rp

    t0 = time.monotonic()
    names, r1, r2, lengths = rp.library(seqs[0][1], RP_PAIRS, seed=RP_SEED)
    for m, r in ((1, r1), (2, r2)):
        _write_fastq(WORK / f"rp_{m}.fq", names, r)
        for n in RP_PARITY:
            _write_fastq(WORK / f"rp{n}_{m}.fq", names[:n], r[:n])
    write_fasta(str(WORK / "rp_contam.fa"), rp.contaminant_entries(RP_SEED))
    make_s = time.monotonic() - t0
    children = {}
    for n in RP_PARITY:
        for cmd, argv in _rp_argv(f"rp{n}", "cpu").items():
            children[f"rp{n}_{cmd}_cpu"] = _cpu_child(argv,
                                                      f"rp{n}_{cmd}_cpu")

    screen = {"s": 0.0, "calls": 0}
    plain_match = contaminants.Contaminants.match_vectors

    def timed_match(self, *a, **k):
        torch.cuda.synchronize()
        t = time.monotonic()
        out = plain_match(self, *a, **k)
        torch.cuda.synchronize()
        screen["s"] += time.monotonic() - t
        screen["calls"] += 1
        return out

    cuda = ["--device", "cuda"]
    contaminants.Contaminants.match_vectors = timed_match
    try:
        _reset_kernel_launches()
        t0 = time.monotonic()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall_f = _timed_cli(_rp_argv("rp", "cuda")["filter"] + cuda)
        launches_f = _align_launches()
        busy_ms = sum(e.device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA) / 1e3
        prof_s = time.monotonic() - t0 - wall_f
        screen_f = dict(screen)
        screen.update(s=0.0, calls=0)
        _reset_kernel_launches()
        wall_q = _timed_cli(_rp_argv("rp", "cuda")["ngsqc"] + cuda)
        launches_q = _align_launches()
        screen_q = dict(screen)
        t0 = time.monotonic()
        for n in RP_PARITY:
            for argv in _rp_argv(f"rp{n}", "cuda").values():
                _timed_cli(argv + cuda)
        heads_s = time.monotonic() - t0
    finally:
        contaminants.Contaminants.match_vectors = plain_match
    if min(launches_f.values()) < 1 or min(launches_q.values()) < 1:
        raise AssertionError(f"phase 29: kernels not launched: {launches_f}"
                             f", {launches_q}")
    idle = 1.0 - busy_ms / 1e3 / wall_f if busy_ms > 0 else None
    shares = rp.planted_shares(names,
                               rp.fastq_name_lengths(WORK / "rp_cuda_1.fq"))
    print(f"read preparation, {RP_PAIRS} pairs of 2 x {rp.READ_LEN} bp "
          f"(library made and written in {make_s:.2f} s): filter -c "
          f"--near-dedupe --device cuda {wall_f:.2f} s (under the profiler, "
          f"whose own {prof_s:.2f} s follow), "
          f"vector screen {screen_f['s']:.3f} s in {screen_f['calls']} calls, "
          f"the rest {wall_f - screen_f['s']:.2f} s; device busy "
          f"{busy_ms:.1f} ms, idle share "
          f"{'not measured' if idle is None else f'{idle:.4f}'}; launches "
          f"{launches_f}; ngsqc -c {wall_q:.2f} s, vector screen "
          f"{screen_q['s']:.3f} s in {screen_q['calls']} calls, launches "
          f"{launches_q}; the parity heads on the card {heads_s:.2f} s; "
          f"vector pairs rejected "
          f"{shares['vector_rejected']:.4f} of {shares['n_vector']} (bar "
          f"{rp.MIN_VECTOR_REJECTED}), adapter reads trimmed "
          f"{shares['adapter_trimmed']:.4f} of {shares['n_adapter']} (bar "
          f"{rp.MIN_ADAPTER_TRIMMED}) ({smi})")
    if (shares["vector_rejected"] < rp.MIN_VECTOR_REJECTED
            or shares["adapter_trimmed"] < rp.MIN_ADAPTER_TRIMMED):
        raise AssertionError(f"phase 29: planted shares {shares}")

    # the screen's engine on the first block of read 1, card against CPU
    r, ln = pad_rows(r1[:8_192], lengths[:8_192])
    res = {}
    for d in (torch.device("cpu"), dev):
        db = contaminants.Contaminants.load(str(WORK / "rp_contam.fa"), d)
        res[d.type] = db._vector_engine()[0].align_with_rescue(r, ln)
    keys = [k for k, v in res["cpu"].items() if isinstance(v, np.ndarray)]
    bad = [k for k in keys if not np.array_equal(res["cpu"][k],
                                                 res["cuda"][k])]
    if bad or not res["cuda"]["any_hit"].any():
        raise AssertionError(f"phase 29: vector screen engine differs: {bad}")
    print(f"vector screen engine on 8,192 reads: {len(keys)} fields equal "
          f"on the card and the CPU, {int(res['cuda']['any_hit'].sum())} "
          f"reads in a vector")
    return {"children": children, "launches": launches_f,
            "launches_ngsqc": launches_q}


def _readprep_finish(run) -> None:
    for tag, proc in run["children"].items():
        _wait_child(proc, tag)
    n_files = 0
    for n in RP_PARITY:
        for out in ("_1.fq", "_2.fq", ".html"):
            a = (WORK / f"rp{n}_cpu{out}").read_bytes()
            if a != (WORK / f"rp{n}_cuda{out}").read_bytes():
                raise AssertionError(f"phase 29: rp{n}{out} differs cpu vs "
                                     f"cuda")
            n_files += 1
    print(f"filter -c --near-dedupe and ngsqc -c on {RP_PARITY[0]} and "
          f"{RP_PARITY[1]} pairs: --device cpu == --device cuda byte for "
          f"byte ({n_files} files)")


def _cr_argv(tag: str) -> dict:
    """Phase 30's `predconfnucs` and `genstructprofile` argv on WORK's
    yeast genome, table and cores, their outputs named by `tag`."""
    w = str(WORK)
    prof = ["genstructprofile", "-i", f"{w}/cr_cores.fa", "-p",
            f"{w}/cr_oct.csv"]
    return {"predconfnucs": ["predconfnucs", "-i", f"{w}/cr_yeast.fa", "-I",
                             f"{w}/cr_oct.csv", "-M", "0", "-o",
                             f"{w}/cr_nucs_{tag}.bg"],
            "minorgroove": prof + ["--param", "minorgroove", "-o",
                                   f"{w}/cr_minorgroove_{tag}.csv"],
            "twist": prof + ["--param", "twist", "-o",
                             f"{w}/cr_twist_{tag}.csv"]}


def chromatin_cell(dev, smi):
    """Phase 30: the chromatin structure tools on the card.  A seeded
    genome of S. cerevisiae R64's 16 chromosome lengths, a full seeded
    octamer table (65,536 rows x 22 parameters) and CR_CORES cores of 147
    bp drawn from the genome: `predconfnucs -M 0` on the whole genome and
    `genstructprofile --param minorgroove` and `--param twist` on the
    cores with --device cuda, their walls with the host seconds of the
    gathers (ending in the copy to the host) and of call_dyads' greedy
    loop, and the gathers each run launched; conformation_profile on
    chromosome IV on the card equal to its plain version on the CPU,
    exactly, and the gather's CUDA-event ms there beside its bound and
    the plain version's ms; the three outputs against --device cpu
    children, compared by _chromatin_finish."""
    import torch

    from biokanga_tpu_torch.chromatin import conformation as conf
    from biokanga_tpu_torch.seq.fasta import write_fasta
    from biokanga_tpu_torch.tools import chromatin_tools

    sys.path.insert(0, str(ROOT / "tests"))
    import chromatin_inputs as ci

    t0 = time.monotonic()
    genome = ci.yeast_genome(CR_SEED)
    write_fasta(str(WORK / "cr_yeast.fa"), genome)
    ci.write_octamer_table(WORK / "cr_oct.csv", CR_SEED)
    write_fasta(str(WORK / "cr_cores.fa"),
                ci.cores(genome, CR_CORES, CR_SEED))
    make_s = time.monotonic() - t0
    children = {f"cr_{k}_cpu": _cpu_child(argv, f"cr_{k}_cpu")
                for k, argv in _cr_argv("cpu").items()}

    # chromosome IV: the card against the plain version, then timings
    table = conf.load_octamer_params(str(WORK / "cr_oct.csv"))
    codes = dict(genome)[CR_CHECK_CHROM]
    cpu = torch.device("cpu")
    want = conf.conformation_profile(codes, table, "minorgroove",
                                     device=cpu)
    got = conf.conformation_profile(codes, table, "minorgroove", device=dev)
    if got.dtype != np.float32 or not np.array_equal(got, want):
        raise AssertionError("phase 30: the chromosome IV profile differs "
                             "between the card and the CPU")
    column = conf.param_column(table, "minorgroove", dev)
    idx = conf.step_octamer_indices(codes, dev)
    gather_ms = _timed_ms(lambda: conf.gather_column(column, idx), iters=20)
    index_ms = _timed_ms(lambda: conf.step_octamer_indices(codes, dev),
                         iters=20)
    col_c, idx_c = column.cpu(), idx.cpu()
    t0 = time.monotonic()
    for _ in range(5):
        conf.gather_column(col_c, idx_c)
    plain_ms = (time.monotonic() - t0) / 5 * 1e3
    # the indices read and the values written once, the column read once;
    # a clamp, a compare and a select a step
    bound_ms, bound_by = _bound(idx.numel() * (8 + 4) + column.numel() * 4,
                                3 * idx.numel())

    parts = {}
    plain_gather = chromatin_tools.gather_steps
    plain_dyads = chromatin_tools.call_dyads

    def timed(fn, key):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t = time.monotonic()
            out = fn(*a, **k)
            parts[key] += time.monotonic() - t
            return out
        return wrapped

    chromatin_tools.gather_steps = timed(plain_gather, "gather_s")
    chromatin_tools.call_dyads = timed(plain_dyads, "dyads_s")
    walls, launches, split = {}, {}, {}
    try:
        for k, argv in _cr_argv("cuda").items():
            parts.update(gather_s=0.0, dyads_s=0.0)
            conf.gather_column.launches = 0
            walls[k] = _timed_cli(argv + ["--device", "cuda"])
            launches[k] = conf.gather_column.launches
            split[k] = dict(parts)
    finally:
        chromatin_tools.gather_steps = plain_gather
        chromatin_tools.call_dyads = plain_dyads
    per_batch = -(-chromatin_tools.PROFILE_BATCH_STEPS // 146)
    want_launches = {"predconfnucs": len(genome),
                     "minorgroove": -(-CR_CORES // per_batch),
                     "twist": -(-CR_CORES // per_batch)}
    if launches != want_launches:
        raise AssertionError(f"phase 30: gathers {launches}, expected "
                             f"{want_launches}")
    n_dyads = sum(1 for ln in open(WORK / "cr_nucs_cuda.bg")) - 1
    n_rows = [sum(1 for ln in open(WORK / f"cr_{p}_cuda.csv")) - 1
              for p in ("minorgroove", "twist")]
    if n_dyads < 1 or n_rows != [CR_CORES, CR_CORES]:
        raise AssertionError(f"phase 30: {n_dyads} dyads, {n_rows} profile "
                             f"rows")
    n_bp = sum(c.size for _, c in genome)
    print(f"chromatin structure, {len(genome)} chromosomes of R64's "
          f"lengths ({n_bp} bp), a full octamer table and {CR_CORES} cores "
          f"of 147 bp (made and written in {make_s:.2f} s): predconfnucs "
          f"-M 0 --device cuda {walls['predconfnucs']:.2f} s ({n_dyads} "
          f"dyads; gathers {split['predconfnucs']['gather_s']:.3f} s in "
          f"{launches['predconfnucs']} launches, call_dyads "
          f"{split['predconfnucs']['dyads_s']:.2f} s); genstructprofile "
          f"--param minorgroove {walls['minorgroove']:.2f} s and twist "
          f"{walls['twist']:.2f} s (gathers "
          f"{split['minorgroove']['gather_s']:.3f} and "
          f"{split['twist']['gather_s']:.3f} s in {launches['minorgroove']} "
          f"and {launches['twist']} launches); chromosome {CR_CHECK_CHROM} "
          f"({idx.numel()} steps) equal on the card and the CPU, its gather "
          f"{gather_ms:.4f} ms (bound {bound_ms:.4f} ms, {bound_by}; plain "
          f"on the CPU {plain_ms:.4f} ms), step indices with the upload "
          f"{index_ms:.4f} ms ({smi})")
    return {"children": children, "walls": walls, "launches": launches}


def _chromatin_finish(run) -> None:
    for tag, proc in run["children"].items():
        _wait_child(proc, tag)
    outs = ("cr_nucs_{}.bg", "cr_minorgroove_{}.csv", "cr_twist_{}.csv")
    for out in outs:
        a = (WORK / out.format("cpu")).read_bytes()
        if a != (WORK / out.format("cuda")).read_bytes():
            raise AssertionError(f"phase 30: {out.format('*')} differs cpu "
                                 f"vs cuda")
    print(f"predconfnucs and genstructprofile (minorgroove, twist): "
          f"--device cpu == --device cuda byte for byte ({len(outs)} files)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from biokanga_tpu_torch import cli, kernels
    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.align.pipeline import AlignEngine
    from biokanga_tpu_torch.index.build import (
        build_index,
        load_index,
        save_index,
    )
    from biokanga_tpu_torch.index.device import to_device
    from biokanga_tpu_torch.ops import sort
    from biokanga_tpu_torch.seq.fasta import write_fasta
    from biokanga_tpu_torch.sim.simreads import random_genome, simulate_reads

    dev = torch.device("cuda", 0)
    t_start = time.monotonic()
    laps, t_lap = {}, [t_start]

    def lap(phase: str) -> None:
        """Seconds since the previous phase ended, kept under `phase`."""
        now = time.monotonic()
        laps[phase] = round(now - t_lap[0], 1)
        t_lap[0] = now

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.monotonic()
    lib = kernels.build()
    kernels.library()
    print(f"kernels built in {time.monotonic() - t0:.2f} s: "
          f"{lib.relative_to(ROOT)}")
    lap("1-2")

    # 3. align kernels against their plain versions
    rng = np.random.default_rng(2024)
    sort_err, timing = check_sorts(dev, rng)
    ext_err, timing["hamming_extend_packed"] = check_extend(dev, rng)
    errs = {**sort_err, "hamming_extend_packed": ext_err}
    print("align kernel checks passed: exact equality at every shape")
    lap("3")

    # 20. the windowed extension (#3w) against its plain version
    (errs["hamming_extend_packed_win"],
     timing["hamming_extend_packed_win"]) = check_extend_win(dev)
    lap("20")

    # 31. the seed stage's kernels at GRCh38's and E. coli's shapes
    seed_err, seed_timing = check_seed_kernels(dev, smi)
    errs.update(seed_err)
    timing.update(seed_timing)
    lap("31")

    # 32. the chunked index's select and merge at GRCh38's block
    merge_err, merge_timing = check_chunk_merge(dev, smi)
    errs.update(merge_err)
    timing.update(merge_timing)
    lap("32")

    # 4. align end to end through the CLI
    WORK.mkdir(parents=True, exist_ok=True)
    seqs = random_genome([("chr", GENOME_BP)], seed=42)
    idx = build_index(seqs, lut_bases=10)
    write_fasta(str(WORK / "ref.fa"), seqs)
    if cli.main(["index", "-i", str(WORK / "ref.fa"), "-o",
                 str(WORK / "ref.npz"), "--lut-bases", "10"]) != 0:
        raise AssertionError("index failed")
    built = load_index(str(WORK / "ref.npz"))
    for f in ("codes", "entry_starts", "pos_sorted", "key_hi", "key_lo",
              "lut"):
        a, b = getattr(built, f), getattr(idx, f)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"index CLI: {f} differs from build_index")
    if (built.entry_names, built.lut_bases) != (idx.entry_names, 10):
        raise AssertionError("index CLI: meta differs from build_index")
    names, reads, _ = simulate_reads(seqs, N_READS, read_len=READ_LEN,
                                     sub_rate=0.01, seed=9)
    _write_fastq(WORK / "reads.fq", names, reads)
    _write_fastq(WORK / "head.fq", names[:N_PARITY], reads[:N_PARITY])
    _reset_kernel_launches()
    t0 = time.monotonic()
    rc = cli.main(["align", "-i", str(WORK / "reads.fq"),
                   "-I", str(WORK / "ref.npz"), "-o", str(WORK / "out.sam"),
                   "--device", "cuda", "--batch-size", str(BATCH)])
    torch.cuda.synchronize()
    cli_s = time.monotonic() - t0
    se_launches = _align_launches()
    if rc != 0 or min(se_launches.values()) < 1:
        raise AssertionError(f"align rc={rc}, launches={se_launches}")
    frac = _true_unique_fraction(WORK / "out.sam", N_READS)
    print(f"align --device cuda: {N_READS} reads in {cli_s:.2f} s (CLI wall, "
          f"index load and I/O included); launches {se_launches}; "
          f"unique at origin {frac:.6f}")
    if frac < MIN_TRUE_FRACTION:
        raise AssertionError(f"only {frac:.4%} of reads map to their origin")
    lap("4")

    # 5. CPU plain path against the card, byte for byte
    for d in ("cpu", "cuda"):
        rc = cli.main(["align", "-i", str(WORK / "head.fq"),
                       "-I", str(WORK / "ref.npz"),
                       "-o", str(WORK / f"head_{d}.sam"), "--device", d,
                       "--batch-size", str(BATCH)])
        if rc != 0:
            raise AssertionError(f"align --device {d} rc={rc}")
    cpu_sam = (WORK / "head_cpu.sam").read_bytes()
    if cpu_sam != (WORK / "head_cuda.sam").read_bytes():
        raise AssertionError("SAM differs between --device cpu and cuda")
    if _records(WORK / "out.sam")[:N_PARITY] != \
            _records(WORK / "head_cpu.sam")[:N_PARITY]:
        raise AssertionError("first records differ from the full CUDA run")
    print(f"SAM of the first {N_PARITY} reads: --device cpu == --device cuda "
          f"byte for byte ({len(cpu_sam)} bytes)")
    # 5b. repeats, Ns and 150 bp reads: every engine stage on the card
    rseqs, rnames, rreads = _repeat_case()
    save_index(build_index(rseqs, lut_bases=9), str(WORK / "rep.npz"))
    _write_fastq(WORK / "rep.fq", rnames, rreads)
    for d in ("cpu", "cuda"):
        sort.sort_rows.launches = sort.sort2_rows.launches = 0
        rc = cli.main(["align", "-i", str(WORK / "rep.fq"),
                       "-I", str(WORK / "rep.npz"),
                       "-o", str(WORK / f"rep_{d}.sam"), "--device", d,
                       "--batch-size", str(BATCH)])
        if rc != 0:
            raise AssertionError(f"align --device {d} rc={rc}")
    # one block: fast pass, classic rerun, ladder steps 1 and 2, 2 strands
    if sort.sort_rows.launches < 8 or sort.sort2_rows.launches < 4:
        raise AssertionError("the repeat run skipped an engine stage: "
                             f"{sort.sort_rows.launches} dedup sorts")
    rep_sam = (WORK / "rep_cpu.sam").read_bytes()
    if rep_sam != (WORK / "rep_cuda.sam").read_bytes():
        raise AssertionError("repeat SAM differs between cpu and cuda")
    recs = [r.split("\t") for r in _records(WORK / "rep_cpu.sam")]
    n_assigned = sum(r[4] == "3" for r in recs)
    if not n_assigned:
        raise AssertionError("multi-hit assignment never ran")
    print(f"repeat genome, {len(rreads)} x 150 bp: --device cpu == cuda byte "
          f"for byte; {sort.sort_rows.launches} dedup sorts on the card, "
          f"{n_assigned} multi-hit reads assigned")
    # 5c. reads past 400 bp: dedup rows past the block sort
    long_read_parity()
    lap("5")

    # 6. the align engine alone: index on the card, reads in host memory
    engine = AlignEngine(to_device(idx, dev), AlignParams(batch_size=BATCH))
    lengths = np.full(N_READS, READ_LEN, np.int32)
    engine.align_with_rescue(reads[:BATCH], lengths[:BATCH])    # warm-up
    rates = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        n_unique = 0
        for s in range(0, N_READS, BATCH):
            res = engine.align_with_rescue(reads[s:s + BATCH],
                                           lengths[s:s + BATCH])
            n_unique += int(res["unique"].sum())
        torch.cuda.synchronize()
        rates.append(N_READS / (time.monotonic() - t0))
    print(f"engine: {max(rates):.1f} reads/s best of 5 epochs "
          f"({', '.join(f'{r:.1f}' for r in rates)}; {N_READS} x {READ_LEN} "
          f"bp, batch {BATCH}, unique {n_unique}) on {smi}")
    np.save(WORK / "se_reads.npy", reads)              # phase 19's input
    del engine, reads
    torch.cuda.empty_cache()
    lap("6")

    # 16-17. the chunked CLI and long reads on the card; their --device cpu
    # runs are child processes beside phases 7-15 and 18
    ck_runs = chunked_cli_start(seqs)
    lap("16")
    long_run = long_reads_start(seqs)
    lap("17")

    # 21-22. bisulfite and colorspace cells; their --device cpu runs are
    # child processes compared at the end
    bs_run = bisulfite_cell(seqs, dev, smi)
    lap("21")
    cs_run = colorspace_cell(seqs, dev, smi)
    lap("22")

    # 7. SW kernels at EC shapes, and #6 on a long pair
    sw_err, sw_timing = check_sw(dev, rng)
    errs.update(sw_err)
    timing.update(sw_timing)
    launches = {"banded_sw_score": long_pair_score(dev, rng)}
    lap("7")

    # 8. EC through the CLI: the plain path against the card (the plain
    # runs go on in child processes beside phases 9-13)
    ec_runs = ec_parity_start(rng)
    lap("8")

    # 9. EC at full width
    launches.update(ec_full_width(smi))
    lap("9")

    # 10. the gather kernel against its plain version, then its probe
    (errs["stream_gather_consume"], timing["stream_gather_consume"],
     launches["stream_gather_consume"]) = check_stream_gather(dev, smi)
    lap("10")

    # 11. paired ends end to end through the CLI; kernels #1-#3 are
    # counted on this run, the newest path through them
    pe_launches, r1, r2 = pe_full_width(seqs, smi)
    launches.update(pe_launches)
    lap("11")

    # 12. PE: the plain path against the card
    pe_parity()
    lap("12")

    # 13. the PE engine alone and its decomposition
    pe_engine(idx, r1, r2, dev, smi)
    del idx, r1, r2
    torch.cuda.empty_cache()
    lap("13")

    # 8, end: the plain EC runs against the card's
    ec_parity_finish(ec_runs)
    lap("8, end")

    # 23. resumable EC on phase 9's cell, and contigs on its output
    pb_run = pacbio_cell(smi)
    lap("23")

    # 14. the SE options cell: SNP calling, indels, junctions, chimeric
    # trims; kernels #1-#3 are counted again on this path
    opt_launches = se_options_cell(seqs, dev, smi)
    lap("14")

    # 15. every SE option and PE BAM: the plain path against the card
    options_parity()
    lap("15")

    # 18. the big genome; kernels #1-#3 are counted on this path
    big_launches = big_genome_cell(dev, smi)
    lap("18")

    # 24. de novo assembly; #1-#3 and #3w are counted on this path
    asm_run = assembly_cell(dev, smi)
    lap("24")

    # 25-28. the device tools: #7 is counted on uhamming's sweeps, #8 on
    # blitz's CLI run, #1-#3 on the flagship's align; their --device cpu
    # runs are child processes compared at the end
    uh_run = uhamming_cell(dev, smi)
    (errs["uhamming_sweep"], timing["uhamming_sweep"],
     launches["uhamming_sweep"]) = (uh_run["err"], uh_run["timing"],
                                     uh_run["launches"])
    lap("25")
    bz_run = blitz_cell(dev, smi)
    (errs["blitz_chain"], timing["blitz_chain"],
     launches["blitz_chain"]) = (bz_run["err"], bz_run["timing"],
                                 bz_run["launches"])
    lap("26")
    tools_run = other_tools_cell(dev, smi)
    lap("27")
    flagship = flagship_cell(dev, smi)
    lap("28")
    # 29. read preparation: filter and ngsqc with the vector screen, #1-#3
    # counted on each; their --device cpu runs are child processes
    rp_run = readprep_cell(seqs, dev, smi)
    lap("29")

    # 16-17, end: the CPU runs against the card's; LongReadAligner
    chunked_cli_finish(ck_runs)
    lap("16, end")
    long_launches = long_reads_finish(long_run, seqs, dev, smi)
    lap("17, end")

    # 19. several ranks: the sharded aligner, the EC mesh, swservice
    rank_launches = several_ranks(seqs, dev, smi, max(rates))
    del seqs
    lap("19")

    # 21-24, end: the CPU runs against the card's
    two_pass_finish(bs_run, "bisulfite")
    two_pass_finish(cs_run, "colorspace")
    pacbio_finish(pb_run)
    _assembly_parity_finish(asm_run["parity"])
    _uh_finish(uh_run)
    _bz_finish(bz_run)
    _other_tools_finish(tools_run)
    _readprep_finish(rp_run)
    lap("21-29, end")

    # 30. chromatin structure on the yeast genome: the octamer gather on
    # the card; its --device cpu runs are child processes
    _chromatin_finish(chromatin_cell(dev, smi))
    lap("30")
    new_paths = {"launches_flagship": flagship["launches"],
                 "launches_filter": rp_run["launches"],
                 "launches_ngsqc": rp_run["launches_ngsqc"],
                 "launches_bisulfite": bs_run["launches"],
                 "launches_colorspace": cs_run["launches"],
                 "launches_contigs": pb_run["ctg_launches"],
                 "launches_assembly": asm_run["launches"],
                 "launches_ec_checkpoint": pb_run["ec_launches"]}
    launches["hamming_extend_packed_win"] = \
        asm_run["launches"]["hamming_extend_packed_win"]
    for name in CHUNK_MERGE_KERNELS:
        launches[name] = ck_runs["pe"]["resident"]["merge_launches"][name]

    src = "biokanga_tpu_torch/csrc/"
    rows = [
        ("sort_rows", "sort_rows.cu", "biokanga_tpu/ops/pallas_sort.py:90",
         "(65536, 480) int32"),
        ("sort2_rows", "sort_rows.cu", "biokanga_tpu/ops/pallas_sort.py:98",
         "(65536, 192) int32 pairs"),
        ("hamming_extend_packed", "hamming_extend.cu",
         "biokanga_tpu/ops/stream_gather.py:179",
         "(65536, 96) loci, 100 bp reads"),
        ("seed_rows", "seed_rows.cu", "none (XLA ops)",
         f"GRCh38 chunk, classic pass: {SEED_ROWS} x {READ_LEN} bp, 8 cores "
         f"of 13, H 48"),
        ("dedup_pack", "seed_rows.cu", "none (XLA ops)",
         f"GRCh38 chunk, classic pass: {SEED_ROWS} rows of 384, cap 192"),
        ("select_chunk", "chunk_merge.cu",
         "none (host numpy: biokanga_tpu/parallel/chunked.py)",
         f"GRCh38 block: one chunk's select of {SEED_ROWS} rows"),
        ("merge_chunks", "chunk_merge.cu",
         "biokanga_tpu/parallel/chunked.py:40 (host)",
         f"GRCh38 block: 13 chunks x {SEED_ROWS} rows, -R 5"),
        ("banded_sw_moves", "banded_sw.cu",
         "biokanga_tpu/ops/pallas_sw.py:191",
         f"{SW_CHUNK_PAIRS} pairs x {SW_LA}, W {SW_W}"),
        ("banded_sw_score", "banded_sw.cu", "biokanga_tpu/ops/pallas_sw.py:53",
         f"{SW_CHUNK_PAIRS} pairs x {SW_LA}, W {SW_W}"),
        ("sw_trace", "sw_trace.cu", "biokanga_tpu/ops/sw_trace.py:33",
         f"{SW_CHUNK_PAIRS} pairs x {SW_LA}, W {SW_W}"),
        ("stream_gather_consume", "stream_gather.cu",
         "biokanga_tpu/ops/stream_gather.py:58",
         f"{GATHER_N} random rows of a {GATHER_LINE_MB:.0f} MB table"),
        ("hamming_extend_packed_win", "hamming_extend.cu",
         "biokanga_tpu/ops/extend_packed.py:217",
         f"({WIN_B}, {WIN_C}) windows, W {WIN_WORDS[0]}"),
        ("uhamming_sweep", "uhamming_sweep.cu",
         "biokanga_tpu/tools/uhamming.py:33",
         f"-m 0 with the reverse complement, K {UH_K}, {UH_LINE_BP} bp"),
        ("blitz_chain", "blitz_chain.cu", "biokanga_tpu/tools/blitz.py:158",
         f"{timing['blitz_chain']['chains']} chains of width "
         f"{timing['blitz_chain']['width']}"),
    ]
    kernels_line = []
    for name, path, rep, shape in rows:
        t = timing[name]
        bound_ms, bound_by = t["bound"]
        lib_ms = t["library_ms"]
        print(f"{name} at {shape}: kernel {t['ms']:.4f} ms, plain torch "
              f"{t['plain_ms']:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
              f"{bound_ms:.4f} ms ({bound_by}) ({smi})")
        extra = {k: t[k] for k in ("ms_ec_chunk", "ec_chunk_pairs",
                                   "chain_ms", "ms_fused_pe", "ms_contigs",
                                   "wrapper_ms", "wide", "path",
                                   "direct_floor_ms", "by_words",
                                   "ms_1mbp", "bound_ms_1mbp", "wall_s_1mbp",
                                   "wall_s_m2_se", "bound_ms_m2_se",
                                   "chains", "width", "pairs", "step_ms",
                                   "floor_ms",
                                   "wide_ms", "wide_plain_ms",
                                   "wide_bound_ms", "wide_floor_ms",
                                   "wide_shape",
                                   "queries_per_s", "at_origin",
                                   "big_query_s", "by_shape", "plain_on",
                                   "unresolved_share")
                 if k in t}
        # launches on the paths this slice added, where the kernel ran
        extra.update({path: counts[name]
                      for path, counts in new_paths.items()
                      if counts.get(name)})
        kernels_line.append({
            "name": name, "route": "cuda", "source": src + path,
            "replaces": rep, "launches": launches[name],
            **({"launches_se_align": se_launches[name],
                "launches_se_options": opt_launches[name],
                **{f"launches_chunked_{kind}_{path}":
                   ck_runs[kind][path]["launches"][name]
                   for kind in ("se", "pe") for path in CHUNK_PATHS},
                "launches_long_reads": long_launches[name],
                "launches_big_genome": big_launches[name]}
               if name in se_launches else {}),
            **({f"launches_chunked_{kind}_{path}":
                ck_runs[kind][path]["merge_launches"][name]
                for kind in ("se", "pe") for path in CHUNK_PATHS}
               if name in CHUNK_MERGE_KERNELS else {}),
            **rank_launches.get(name, {}),
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, **extra})
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "biokanga_tpu"))
    if leaked:
        raise AssertionError(f"the JAX side was imported: {leaked[:5]}")
    print(f"phase seconds: {json.dumps(laps)}")
    print(f"chip_smoke: {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
