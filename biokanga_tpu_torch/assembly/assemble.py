"""Greedy overlap-extension de novo assembly.

Counterpart of biokanga_tpu/assembly/assemble.py, with the same contigs.
The passes' device work is the aligner's (AlignEngine for containment,
kernels #1-#3) and the scaled overlap sweep's (assembly/scale_overlap.py,
#1 and #3w); every entry point takes the device it runs on.  A pass and
a containment sweep are `utils.trace.span` ranges named `asm.pass` and
`asm.contain` (the scaled pass's index build and sweeps inside it are
`asm.index` and `asm.sweep`): `torch.profiler` ranges while a profiler
records, one check otherwise (profile_torch.py asm reads them).

Capability match for `biokanga assemb` (CdeNovoAssemb::AssembReads,
biokanga/deNovoAssemb.cpp:109): iterative passes with a decaying minimum
overlap (reference defaults 150 -> 25, Kangadna.h:89-90); each pass finds
suffix-prefix overlaps between current sequences (both orientations),
greedily merges unambiguous dovetails, and repeats until no merges.

The merge-selection graph is intentionally conservative (the reference's
semantics): a merge A->B happens only when A has exactly one best right
extension and B exactly one best left extension (mutual best), so
repeat-induced ambiguity breaks contigs rather than mis-joining them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import torch

from ..seq.encode import revcomp
from ..utils.trace import spanned
from .overlap import find_prefix_occurrences, verify_overlaps

C_DFLT_INIT_SE_OVLP = 150  # Kangadna.h:89
C_DFLT_FIN_SE_OVLP = 25    # Kangadna.h:90
C_MIN_ASSEMB_SEQ_LEN = 80  # cMinDfltSeqLenToAssemb, Kangadna.h:109


@dataclass
class AssemblyStats:
    passes: int = 0
    merges: int = 0
    n_contigs: int = 0
    total_bp: int = 0
    max_contig: int = 0


def _pad(seqs: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    L = max(len(s) for s in seqs)
    out = np.full((len(seqs), L), 4, dtype=np.int8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
        lens[i] = len(s)
    return out, lens


@spanned("asm.pass")
def one_pass(seqs: list[np.ndarray], min_overlap: int, k: int = 16,
             max_subs_per_100: float = 1.0,
             device: torch.device | str = "cuda"):
    """One merge pass. Returns (new_seqs, n_merges)."""
    n = len(seqs)
    if n < 2:
        return seqs, 0
    # queries = every sequence in both orientations; orientation 1 is the
    # revcomp (a right-extension by rc(B) means B's rc dovetails A)
    fwd, flens = _pad(seqs)
    rc_list = [revcomp(s) for s in seqs]
    rcp, _ = _pad(rc_list)
    queries = np.concatenate([fwd, rcp], axis=0)
    qlens = np.concatenate([flens, flens])

    # multiple anchor offsets so residual errors near the query start
    # cannot hide a true overlap (noisy long-read regime)
    anchors = (0, k // 2, k, 2 * k)
    cands, _idx = find_prefix_occurrences(
        seqs, queries, qlens, k=k, anchor_offsets=anchors, device=device
    )
    qid, tid, ovl, subs = verify_overlaps(
        seqs, queries, qlens, cands, min_overlap, max_subs_per_100
    )
    if len(qid) == 0:
        return seqs, 0

    # drop self-overlaps and rc-self
    orient = qid >= n
    base_q = np.where(orient, qid - n, qid)
    keep = base_q != tid
    qid, tid, ovl, orient, base_q = (
        qid[keep], tid[keep], ovl[keep], orient[keep], base_q[keep]
    )
    if len(qid) == 0:
        return seqs, 0

    # choose, for each target, its single BEST right extension (longest
    # overlap); ambiguity (two equally long) disqualifies the target
    best_ov = np.full(n, -1, np.int64)
    best_j = np.full(n, -1, np.int64)
    ambiguous = np.zeros(n, bool)
    for j in range(len(qid)):
        t = tid[j]
        if ovl[j] > best_ov[t]:
            best_ov[t] = ovl[j]
            best_j[t] = j
            ambiguous[t] = False
        elif ovl[j] == best_ov[t]:
            ambiguous[t] = True

    # each extension source (query base seq, with orientation) may extend
    # only one target (unique left attachment)
    src_count = {}
    for t in range(n):
        if best_j[t] < 0 or ambiguous[t]:
            continue
        j = best_j[t]
        key = (int(base_q[j]), bool(orient[j]))
        src_count[key] = src_count.get(key, 0) + 1

    merge_info = {}
    for t in range(n):
        if best_j[t] < 0 or ambiguous[t]:
            continue
        j = best_j[t]
        key = (int(base_q[j]), bool(orient[j]))
        if src_count.get(key, 0) != 1:
            continue
        merge_info[t] = (int(base_q[j]), bool(orient[j]), int(ovl[j]))
    return _merge_chains(seqs, merge_info)


def _merge_chains(seqs: list[np.ndarray], merge_info: dict):
    """Walk merge chains t -> q (q possibly rc), starting only from chain
    heads (sequences that are not themselves the extension of some other
    target); visited bookkeeping guards against cycles.  merge_info maps
    target -> (query base index, query-is-rc, overlap_len)."""
    n = len(seqs)
    out = []
    n_merges = 0
    extension_seqs = {q for (q, _, _) in merge_info.values()}
    visited = np.zeros(n, bool)

    def walk(t0):
        nonlocal n_merges
        visited[t0] = True
        cur = t0
        seq = seqs[t0].copy()
        while cur in merge_info:
            q, is_rc, o = merge_info[cur]
            if visited[q]:
                break  # cycle guard (also closes circular walks)
            ext = revcomp(seqs[q]) if is_rc else seqs[q]
            seq = np.concatenate([seq, ext[o:]])
            visited[q] = True
            n_merges += 1
            cur = q
        out.append(seq)

    for t0 in range(n):
        if not visited[t0] and t0 not in extension_seqs:
            walk(t0)
    # components with NO head are cycles (mutual dovetails — typical of
    # near-duplicate fragment pairs); start anywhere, the visited guard
    # stops the wrap-around.  Without this, cyclic components stall the
    # pass loop at a trickle of merges per pass.
    for t0 in range(n):
        if not visited[t0] and t0 in merge_info:
            walk(t0)
    for i in range(n):
        if not visited[i]:
            out.append(seqs[i])
    return out, n_merges


@spanned("asm.pass")
def one_pass_scaled(seqs: list[np.ndarray], min_overlap: int,
                    k: int = 16, max_subs_per_100: float = 1.0,
                    device: torch.device | str = "cuda"):
    """one_pass at readset scale over the BIDIRECTED overlap graph:
    device-batched winner discovery per ORIENTED target (2n targets —
    assembly/scale_overlap.best_right_extensions), host chain merge with
    orientation bookkeeping.  Greedy semantics per oriented target match
    one_pass: longest-overlap winner, overlap ties disqualify, oriented
    extension sources attach uniquely.  Selected edges are symmetrized
    with their mirrors (edge T->Q == edge M(Q)->M(T), M = orientation
    flip) so a middle piece with only outgoing winner edges still joins
    both of its flanks."""
    n = len(seqs)
    if n < 2:
        return seqs, 0
    from .scale_overlap import best_right_extensions

    e = best_right_extensions(seqs, min_overlap,
                              max_subs_per_100=max_subs_per_100, k=k,
                              device=device)
    ok = (e.win_q >= 0) & ~e.ambiguous
    src, cnt = np.unique(e.win_q[ok], return_counts=True)
    multi = set(src[cnt > 1].tolist())
    merge_info = {}      # oriented target -> (oriented query, overlap)
    sources = set()
    for t in np.nonzero(ok)[0]:
        q = int(e.win_q[t])
        if q in multi:
            continue
        merge_info[int(t)] = (q, int(e.win_ov[t]))
        sources.add(q)

    def M(x):
        return x - n if x >= n else x + n

    # symmetrize: add mirror edges where they don't conflict
    for t, (q, ov) in list(merge_info.items()):
        mt, mq = M(q), M(t)
        if mt not in merge_info and mq not in sources:
            merge_info[mt] = (mq, ov)
            sources.add(mq)

    def oseq(x):
        return seqs[x] if x < n else revcomp(seqs[x - n])

    phys = np.zeros(n, bool)
    out = []
    merges = 0

    def walk(t0):
        nonlocal merges
        seq = oseq(t0).copy()
        phys[t0 % n] = True
        cur = t0
        while cur in merge_info:
            q, ov = merge_info[cur]
            if phys[q % n]:
                break
            seq = np.concatenate([seq, oseq(q)[ov:]])
            phys[q % n] = True
            merges += 1
            cur = q
        out.append(seq)

    for t0 in range(2 * n):
        if not phys[t0 % n] and t0 not in sources:
            walk(t0)
    for t0 in range(2 * n):          # headless components (cycles)
        if not phys[t0 % n] and t0 in merge_info:
            walk(t0)
    for i in range(n):
        if not phys[i]:
            out.append(seqs[i])
    return out, merges


@spanned("asm.contain")
def remove_contained(seqs: list[np.ndarray],
                     max_subs_per_100: float = 1.0,
                     device: torch.device | str = "cuda"
                     ) -> list[np.ndarray]:
    """Drop sequences fully CONTAINED in a longer sequence (either
    orientation) — the overlap-graph containment-removal step the
    reference applies via its sparse index before extension
    (CKangadna duplicate/contained handling).  Containment is detected
    with the aligner machinery: short sequences align full-length
    against an index of the longer ones."""
    if len(seqs) < 2:
        return seqs
    order = np.argsort([-len(s) for s in seqs], kind="stable")
    # index the longer half (targets); probe everything shorter
    lens = np.array([len(seqs[i]) for i in order])
    # targets: all sequences; a sequence is dropped if contained in a
    # STRICTLY longer one (or an equal-length earlier one)
    from ..align.params import AlignParams
    from ..align.pipeline import AlignEngine, pad_rows

    total = int(lens.sum())
    starts = np.zeros(len(order) + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    if total > 32_000_000:
        # readset scale: suffix-sort on device (host qsort is ~3 min per
        # 100 Mbp; the device build is seconds — PERF.md)
        from ..index.device_build import device_build_index

        didx = device_build_index(
            np.concatenate([seqs[i] for i in order]).astype(np.int8),
            starts, lut_bases=12, device=device,
        )
    else:
        from ..index.build import build_index
        from ..index.device import to_device

        entries = [(f"s{i}", seqs[i]) for i in order]
        idx = build_index(entries, lut_bases=8)
        didx = to_device(idx, device)
        starts = idx.entry_starts
    max_mm = max(1, int(max_subs_per_100))
    eng = AlignEngine(didx, AlignParams(max_subs_per100=max(1, int(
        max_subs_per_100)), min_edit_dist=0))
    keep = np.ones(len(seqs), bool)
    B = len(order)
    # probe in LENGTH BUCKETS (pow2 padded width): padding every probe
    # to the global max length made the post-merge phase build
    # (n_seqs x longest_contig) matrices — the round-4 2 Mbp HBM OOM —
    # and the per-bucket chunk row count bounds the extension temp.
    # Probes are additionally capped at PW=4096 bases (the packed
    # path's envelope, ops/extend_packed.MAX_PACKED_READ_LEN): longer
    # sequences probe their first PW bases on device, then the full
    # window is VERIFIED on host at the implied target offset — probing
    # long contigs full-width through the aligner compiled (rows x C x
    # Lb) dense graphs that exceed HBM at Lb >= 512 kb (the 2 Mbp
    # post-merge crash).
    PW = 4096
    BUDGET = 1 << 31
    j = 0
    while j < B:
        Lb = 256
        while Lb < min(int(lens[j]), PW):
            Lb *= 2
        # lens is DESCENDING: this bucket ends where lengths drop into
        # the next pow2 (the floor bucket 256 takes everything shorter;
        # the PW bucket takes everything longer)
        j1 = j
        while j1 < B and (Lb == 256 or int(lens[j1]) > Lb // 2):
            j1 += 1
        CH = int(min(4096, max(64, BUDGET // (Lb * 512))))
        for s0 in range(j, j1, CH):
            nb = min(CH, j1 - s0)
            mat = np.full((nb, Lb), 4, np.int8)
            pl = np.zeros(nb, np.int32)
            for r, oi in enumerate(order[s0: s0 + nb]):
                pw = min(len(seqs[oi]), Lb)
                mat[r, :pw] = seqs[oi][:pw]
                pl[r] = pw
            sub, sl = pad_rows(mat, pl)
            res = eng.align_batch(sub, sl)
            mlm = res["ml_mm"][:nb].astype(np.int64)   # (nb, K) top hits
            mll = res["ml_loci"][:nb]
            mlr = res["ml_rc"][:nb]
            # the aligner's per-read budget caps at 63 mismatches
            # (C_MAX_TOT_ALLOWED_SUBS) and masks over-budget rows to
            # (ml_mm=255, ml_loci=-1); treating those SENTINEL rows as
            # hits was the round-4 over-drop (every >25.4 kb contig
            # "contained" via a 255 <= length-proportional budget) —
            # containment needs a VALID hit within min(budget, 63)
            valid_hit = (mll >= 0) & (mlm < 255)
            mtm = np.minimum(np.maximum(pl * max_mm // 100, 1), 63)
            ent = np.searchsorted(starts, mll, side="right") - 1
            ent = np.clip(ent, 0, B - 1)
            gsel = np.arange(s0, s0 + nb)[:, None]
            # contained in a longer target, or an equal-length EARLIER
            # one (order is length-descending, so ties keep the first)
            hit = (
                valid_hit & (mlm <= mtm[:, None]) & (ent != gsel)
                & ((lens[ent] > lens[gsel])
                   | ((lens[ent] == lens[gsel]) & (ent < gsel)))
            )
            contained = hit.any(axis=1)
            # rows probed TRUNCATED (true length > Lb): the device hit
            # covers only the prefix — verify the full window on host
            for r in np.nonzero(contained)[0]:
                oi = order[s0 + r]
                q = seqs[oi]
                if len(q) <= pl[r]:
                    continue  # full-length probe: device verdict final
                full_budget = max(1, len(q) * max_mm // 100)
                ok = False
                for c in np.nonzero(hit[r])[0]:
                    te = int(ent[r, c])
                    tgt = seqs[order[te]]
                    # fwd: prefix hit at target offset o covers q at o;
                    # rc: rc(prefix) is the TAIL of the rc(q) window, so
                    # the window starts at o = hitoff + pw - len(q)
                    hitoff = int(mll[r, c] - starts[te])
                    if mlr[r, c]:
                        o = hitoff + int(pl[r]) - len(q)
                        qq = revcomp(q)
                    else:
                        o = hitoff
                        qq = q
                    if o < 0 or o + len(q) > len(tgt):
                        continue
                    if int((tgt[o: o + len(q)] != qq).sum()) <= full_budget:
                        ok = True
                        break
                contained[r] = ok
            keep[order[s0: s0 + nb][contained]] = False
        j = j1
    return [s for s, k in zip(seqs, keep) if k]


def assemble(
    seqs: list[np.ndarray],
    init_overlap: int = C_DFLT_INIT_SE_OVLP,
    final_overlap: int = C_DFLT_FIN_SE_OVLP,
    min_seq_len: int = C_MIN_ASSEMB_SEQ_LEN,
    max_subs_per_100: float = 1.0,
    max_passes: int = 50,
    containment_removal: bool = True,
    scaled: bool | None = None,
    progress=None,
    device: torch.device | str = "cuda",
) -> tuple[list[np.ndarray], AssemblyStats]:
    """Full iterative assembly with the reference's decaying-overlap
    schedule (deNovoAssemb.cpp pass loop), preceded and followed by
    containment removal (redundant reads/contigs fully contained in a
    longer sequence are dropped).

    scaled=None auto-selects the device-batched pass
    (assembly/scale_overlap) above 5000 sequences — the readset-scale
    path; below that the host-verified pass is faster (no device index
    build per pass).  `device` is where every pass runs; `cuda` raises
    without CUDA."""
    from ..device import resolve_device

    device = resolve_device(device)
    cur = [s for s in seqs if len(s) >= min_seq_len]
    st = AssemblyStats()
    # exact-duplicate collapse (the reference marks duplicates in its
    # packed store before assembly, CKangadna duplicate flags)
    if cur:
        seen = set()
        ded = []
        for s in cur:
            key = s.tobytes()
            krc = revcomp(s).tobytes()
            if key in seen or krc in seen:
                continue
            seen.add(key)
            ded.append(s)
        cur = ded
    if containment_removal and cur:
        cur = remove_contained(cur, max_subs_per_100, device)
    ov = init_overlap
    removed_at = -1
    while st.passes < max_passes:
        ov_eff = min(ov, min(len(s) for s in cur) - 1) if cur else ov
        ov_eff = max(ov_eff, final_overlap)
        use_scaled = scaled if scaled is not None else len(cur) > 5000
        if use_scaled:
            cur, merges = one_pass_scaled(
                cur, ov_eff, max_subs_per_100=max_subs_per_100,
                device=device)
        else:
            cur, merges = one_pass(cur, ov_eff,
                                   max_subs_per_100=max_subs_per_100,
                                   device=device)
        if progress is not None:
            progress(st.passes, ov_eff, merges, len(cur))
        st.passes += 1
        st.merges += merges
        if merges == 0:
            # before decaying the threshold, clear contained fragments —
            # they are what blocks further dovetails (mirrors the
            # reference's per-pass duplicate/contained sequence culling,
            # deNovoAssemb.cpp pass loop)
            if containment_removal and ov != removed_at and cur:
                cur = remove_contained(cur, max_subs_per_100, device)
                removed_at = ov
                continue
            if ov <= final_overlap:
                break
            ov = max(final_overlap, int(ov * 2 / 3))
    if containment_removal and cur:
        cur = remove_contained(cur, max_subs_per_100, device)
    st.n_contigs = len(cur)
    st.total_bp = int(sum(len(s) for s in cur))
    st.max_contig = int(max((len(s) for s in cur), default=0))
    return cur, st


def kmer_containment_dedup(seqs: list[np.ndarray], k: int = 32,
                           min_frac: float = 0.98) -> list[np.ndarray]:
    """Indel-tolerant redundancy collapse for corrected-long-read
    contigs (the PBAssemb contained-sequence culling role,
    pacbiokanga/PBAssemb.cpp): residual post-EC INDELS defeat the
    Hamming containment pass (one indel mid-window shifts the frame and
    floods the substitution budget), leaving near-duplicate contigs in
    the output.  A sequence is dropped when >= min_frac of its
    canonical k-mers already occur in kept (longer) sequences —
    frame-shift-immune because k-mers re-anchor after every indel.

    k=32 packs exactly into uint64 at 2 bits/base (vectorised rolling
    pack); canonical = min(fwd, revcomp) handles orientation.  N-bearing
    k-mers are excluded on both sides."""
    if len(seqs) < 2:
        return seqs

    def canon_kmers(s: np.ndarray) -> np.ndarray:
        if len(s) < k:
            return np.zeros(0, np.uint64)
        v = s.astype(np.int64)
        ok = v < 4
        v = np.where(ok, v, 0)
        # rolling 2-bit pack, fwd and rc in one pass
        fwd = np.zeros(len(s) - k + 1, np.uint64)
        rc = np.zeros(len(s) - k + 1, np.uint64)
        valid = np.ones(len(s) - k + 1, bool)
        for j in range(k):
            col = v[j: j + len(fwd)]
            fwd |= col.astype(np.uint64) << np.uint64(2 * (k - 1 - j))
            rc |= (3 - col).astype(np.uint64) << np.uint64(2 * j)
            valid &= ok[j: j + len(fwd)]
        return np.minimum(fwd, rc)[valid]

    order = sorted(range(len(seqs)), key=lambda i: -len(seqs[i]))
    seen: set[int] = set()
    keep = np.zeros(len(seqs), bool)
    for i in order:
        km = canon_kmers(seqs[i])
        if len(km) == 0:
            keep[i] = True
            continue
        uniq = np.unique(km)
        hits = sum(1 for x in uniq.tolist() if x in seen)
        if hits / len(uniq) >= min_frac:
            continue  # redundant: contained (mod indels) in kept output
        keep[i] = True
        seen.update(uniq.tolist())
    return [s for s, kf in zip(seqs, keep) if kf]
