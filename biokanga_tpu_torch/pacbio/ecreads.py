"""PacBio long-read error correction (`pacbiokanga ecreads` parity).

Counterpart of biokanga_tpu/pacbio/ecreads.py, with the same results.
Every read is corrected against the others:

  1. the reads and their reverse complements go into one device-built
     index (index/device_build.py);
  2. one lookup seeds every probe's 12-base cores (`_seed_all`, the
     binary-search path of ops/lookup.seed_range_lookup), and host numpy
     clusters the hits into (probe, target, diagonal) overlap candidates,
     at most `max_targets` per probe by seed votes;
  3. every candidate pair is aligned by the banded Smith-Waterman kernel
     (ops/banded_sw.banded_sw_moves) and its path decoded per probe column
     by the traceback kernel (ops/sw_trace.traceback_cols_packed), in
     chunks of pairs;
  4. pairs scoring at least `min_overlap_score` add their columns to
     integer vote planes (index_add_: exact in any order, so the chunking
     cannot change the output), and a column-majority consensus rewrites
     each probe.

With `mesh` (a parallel/dist.py mesh of ranks, one process each) every
rank seeds and clusters the whole read set, aligns its dp share of each
chunk's pairs on its own device, and the integer vote planes are summed
over dp with one all-reduce before the consensus, so every rank ends with
the same corrected reads (the JAX package's `_make_sw_vote_fn` psum;
integer sums are exact in any order).  The TPU's one-hot bf16 vote matmul
(`_vote_deltas`) is a TPU workaround and is not ported.

Stages are marked with `utils.trace.span` ranges named `ec.index`,
`ec.seed`, `ec.cluster`, `ec.sw` and `ec.consensus`: `torch.profiler`
ranges while a profiler records, one check otherwise (profile_torch.py
reads them).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..index.device_build import device_build_index
from ..ops.banded_sw import band_window_len, banded_sw_moves, normalize_band
from ..ops.lookup import seed_range_lookup
from ..ops.sw_trace import traceback_cols_packed
from ..parallel.dist import sum_dp
from ..seq.encode import revcomp
from ..utils.trace import span, spanned


@dataclass(frozen=True)
class ECParams:
    seed_len: int = 12            # short cores for noisy reads
    seed_stride: int = 4
    min_seed_votes: int = 8       # seeds agreeing on a diagonal band
    diag_band: int = 64           # diagonal clustering granularity
    sw_band: int = 96             # SW band half-width
    min_overlap_score: int = 60
    min_cov_for_call: int = 2     # column votes needed to overrule probe
    max_targets: int = 24         # overlap candidates per probe
    sw_chunk_bytes: int = 1 << 30  # device bytes per SW pair chunk


# copied from biokanga_tpu/pacbio/ecreads.py:52-60
def _pad_reads(reads: list[np.ndarray], pad_to: int | None = None):
    L = pad_to or max(len(r) for r in reads)
    L = -(-L // 64) * 64
    arr = np.full((len(reads), L), 4, np.int8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        arr[i, : len(r)] = r
        lens[i] = len(r)
    return arr, lens


def _seed_all(didx, probes: torch.Tensor, k: int, H: int, stride: int,
              S: int):
    """(N, S, H) int32 candidate positions and their validity for the k-base
    cores at offsets 0, stride, ... of every probe (ecreads.py:63-98).

    Keys past a probe's padded end pack as base 0; a core holding an N
    (the probes' tail padding included) gets no candidates."""
    if not 1 <= k <= 16:
        raise ValueError(f"seed length {k} outside 1..16")
    N, L = probes.shape
    dev = probes.device
    is_n = probes >= 4
    b = torch.where(is_n, 0, probes).to(torch.int64)
    b = torch.cat([b, torch.zeros((N, k), dtype=torch.int64, device=dev)], 1)
    is_n = torch.cat([is_n, torch.zeros((N, k), dtype=torch.bool,
                                        device=dev)], 1)
    span = stride * (S - 1) + 1
    key = torch.zeros((N, S), dtype=torch.int64, device=dev)
    has_n = torch.zeros((N, S), dtype=torch.bool, device=dev)
    for j in range(k):
        key += b[:, j : j + span : stride] << (2 * (15 - j))
        has_n |= is_n[:, j : j + span : stride]
    pad_hi = (1 << (2 * (16 - k))) - 1
    start, end = seed_range_lookup(
        didx.key_hi, didx.key_lo, didx.lut, didx.lut_bases, key,
        torch.zeros_like(key), key | pad_hi, torch.full_like(key, 0xFFFFFFFF),
        core_len=k, max_steps=didx.max_bsearch_steps)
    size = torch.where(has_n, 0, (end - start).clamp(max=H))
    j = torch.arange(H, device=dev)
    pos_flat = didx.pos_sorted
    idx = (start[..., None] + j).clamp(0, pos_flat.shape[0] - 1)
    return pos_flat[idx], j < size[..., None]


def _build_ec_index(entries, device, lut_bases: int = 8):
    """Device-built index of the entries' codes (ecreads.py:101-111).
    Returns (didx, entry_starts)."""
    codes = (np.concatenate([np.asarray(e[1], np.int8) for e in entries])
             if entries else np.zeros(0, np.int8))
    starts = np.zeros(len(entries) + 1, np.int64)
    np.cumsum([len(e[1]) for e in entries], out=starts[1:])
    with span("ec.index"):
        didx = device_build_index(codes, starts.astype(np.int32),
                                  lut_bases=lut_bases, device=device)
    return didx, starts


def find_overlap_candidates_batch(didx, starts, probes, plens, p: ECParams,
                                  probe_gids=None, n_reads_total=None,
                                  ent_gids=None):
    """Vectorised candidate clustering for a batch of probes.

    Returns (pair_probe, pair_entry, pair_diag) host arrays — one row per
    accepted (probe, target entry) overlap candidate, at most
    p.max_targets per probe, ordered by descending seed votes.

    probe_gids/n_reads_total: when probes are a SUBSET of the indexed
    read set, the global read id of each probe and the total read count —
    needed to drop self-overlaps (entry g and its rc copy g +
    n_reads_total both belong to probe with global id g).  ent_gids: the
    global read id of each entry of a target-chunked index.

    The seeding runs on didx's device; the clustering is host numpy."""
    N, L = probes.shape
    k = p.seed_len
    offsets = tuple(range(0, L - k + 1, p.seed_stride))
    S = len(offsets)
    H = 16
    with span("ec.seed"):
        pos, valid = _seed_all(didx,
                               torch.from_numpy(probes).to(didx.device),
                               k, H, p.seed_stride, S)
        pos = pos.cpu().numpy().astype(np.int64)
        valid = valid.cpu().numpy()
    with span("ec.cluster"):
        return _cluster(pos, valid, starts, offsets, p, probe_gids,
                        n_reads_total, ent_gids)


def _cluster(pos, valid, starts, offsets, p: ECParams, probe_gids,
             n_reads_total, ent_gids):
    """Host numpy of find_overlap_candidates_batch, copied from
    biokanga_tpu/pacbio/ecreads.py:137-188."""
    N = pos.shape[0]
    starts = np.asarray(starts)
    offs = np.asarray(offsets, np.int64)[None, :, None]
    ent = np.searchsorted(starts, pos, side="right") - 1
    diag = (pos - starts[np.clip(ent, 0, len(starts) - 2)]) - offs
    pid = np.broadcast_to(np.arange(N, dtype=np.int64)[:, None, None],
                          pos.shape)

    v = valid.ravel()
    pidv = pid.ravel()[v]
    entv = ent.ravel()[v]
    diagv = diag.ravel()[v]
    band = (diagv + (1 << 22)) // p.diag_band
    E = len(starts)
    key = (pidv * E + entv) * (1 << 24) + band
    uk, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
    dsum = np.zeros(len(uk), np.int64)
    np.add.at(dsum, inv, diagv)
    keep = cnt >= p.min_seed_votes
    uk, cnt, dsum = uk[keep], cnt[keep], dsum[keep]
    c_probe = (uk >> 24) // E
    c_ent = (uk >> 24) % E
    c_diag = dsum // cnt

    # drop self-overlaps (entry g and its rc copy g+n map to the probe
    # whose GLOBAL read id is g); with a target-chunked index the
    # entry->global-read mapping goes through ent_gids
    n = N if n_reads_total is None else int(n_reads_total)
    gids = (np.arange(N, dtype=np.int64) if probe_gids is None
            else np.asarray(probe_gids, np.int64))
    if ent_gids is None:
        tgt_gid = c_ent % n
    else:
        eg = np.asarray(ent_gids, np.int64)
        tgt_gid = eg[np.clip(c_ent, 0, len(eg) - 1)]
    ok = tgt_gid != gids[c_probe]
    c_probe, c_ent, c_diag, cnt = (c_probe[ok], c_ent[ok], c_diag[ok],
                                   cnt[ok])
    # top max_targets per probe by votes
    order = np.lexsort((-cnt, c_probe))
    c_probe, c_ent, c_diag, cnt = (c_probe[order], c_ent[order],
                                   c_diag[order], cnt[order])
    run_start = np.concatenate([[True], c_probe[1:] != c_probe[:-1]])
    run_id = np.cumsum(run_start) - 1
    first = np.zeros(run_id[-1] + 1 if len(run_id) else 0, np.int64)
    if len(run_id):
        first[run_id[run_start]] = np.nonzero(run_start)[0]
        occ = np.arange(len(c_probe)) - first[run_id]
        sel = occ < p.max_targets
        return c_probe[sel], c_ent[sel], c_diag[sel]
    return c_probe, c_ent, c_diag


class _Votes:
    """Per-probe column-vote planes on one device, int32.

    votes (N, La, 7): alignments giving target base 0..3, N (4) or a
    deletion (5) at each probe column; ins_cnt (N, La+1) and ins_base
    (N, La+1, 4): target bases inserted before each column.  Integer
    index_add_ is exact in any order."""

    def __init__(self, N: int, La: int, device):
        self.La = La
        self.votes = torch.zeros((N, La, 7), dtype=torch.int32, device=device)
        self.ins_cnt = torch.zeros((N, La + 1), dtype=torch.int32,
                                   device=device)
        self.ins_base = torch.zeros((N, La + 1, 4), dtype=torch.int32,
                                    device=device)

    def sum_dp(self, mesh) -> None:
        """Sum the planes over the mesh's dp group, in place."""
        self.votes = sum_dp(mesh, self.votes)
        self.ins_cnt = sum_dp(mesh, self.ins_cnt)
        self.ins_base = sum_dp(mesh, self.ins_base)

    def add(self, out, ins_cnt, ins_base, pids, ok) -> None:
        """Add the decoded columns of the pairs where `ok`; pids (B,) int64."""
        B, La = out.shape
        cols = torch.arange(La, device=out.device)
        idx = ((pids[:, None] * La + cols) * 7 + out.to(torch.int64))
        keep = (ok[:, None] & (out < 6)).to(torch.int32)
        self.votes.view(-1).index_add_(0, idx.reshape(-1), keep.reshape(-1))
        w = ok.to(torch.int32)
        self.ins_cnt.index_add_(0, pids, ins_cnt * w[:, None])
        self.ins_base.index_add_(0, pids, ins_base * w[:, None, None])


class _StageTimes:
    """Summed device time of the SW and traceback launches (CUDA events;
    recording them does not wait for the device)."""

    def __init__(self, device: torch.device):
        self.on = device.type == "cuda"
        self.marks: dict[str, list] = {"sw": [], "trace": []}

    def event(self):
        if not self.on:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def add(self, stage: str, start, end) -> None:
        if self.on:
            self.marks[stage].append((start, end))

    def ms(self) -> dict:
        if not self.on:
            return {}
        torch.cuda.synchronize()
        return {f"{stage}_ms": sum(a.elapsed_time(b) for a, b in pairs)
                for stage, pairs in self.marks.items()}


def _pair_bytes(La: int, W: int) -> int:
    """Device bytes one SW pair holds at once: move words, band window,
    query and target rows, decode outputs and vote indices."""
    K = 2 * W + 1
    return (-(-La // 16) * K * 4 + band_window_len(La, W) + 2 * La
            + La * (1 + 4 + 16) + La * 8)


def _sw_and_vote(probes_t, plens_t, c_probe, c_ent, c_diag, didx,
                 votes: _Votes, p: ECParams, times: _StageTimes, mesh=None):
    """Align every (probe, candidate) pair in chunks and add the pairs that
    score at least p.min_overlap_score to the vote planes.  Target e is
    entry e of the index didx.  With a mesh, each chunk (a multiple of
    n_dp pairs) splits over dp and this rank aligns its share.  Returns
    the number of pairs this rank used."""
    tcat, tstarts = didx.genome, didx.entry_starts
    N, La = probes_t.shape
    dev = probes_t.device
    W = p.sw_band
    P = len(c_probe)
    chunk = max(16, p.sw_chunk_bytes // _pair_bytes(La, W))
    share, first = chunk, 0
    if mesh is not None:
        # ecreads.py:460-462: whole pair rows for every dp coordinate
        chunk = max(mesh.n_dp, chunk // mesh.n_dp * mesh.n_dp)
        share = chunk // mesh.n_dp
        first = mesh.dp * share
    cols = torch.arange(La, device=dev)
    n_used = torch.zeros((), dtype=torch.int64, device=dev)
    tlast = max(tcat.shape[0] - 1, 0)
    with span("ec.sw"):
        for s0 in range(0, P, chunk):
            s = s0 + first
            if s >= min(s0 + chunk, P):
                continue
            pids, ent, diag = (
                torch.from_numpy(x[s : min(s + share, P)].astype(np.int64)
                                 ).to(dev)
                for x in (c_probe, c_ent, c_diag))
            a = probes_t[pids]
            alen = plens_t[pids]
            t0 = tstarts[ent]
            blen = tstarts[ent + 1] - t0
            b = torch.where(cols < blen[:, None],
                            tcat[(t0[:, None] + cols).clamp(max=tlast)], 4)
            bwin, jlo, jhi = normalize_band(b.to(torch.int8), blen, diag, La,
                                            W)
            e0 = times.event()
            best, bi, bk, mv = banded_sw_moves(a, bwin, alen, jlo, jhi, W)
            e1 = times.event()
            out, ins_cnt, ins_base = traceback_cols_packed(mv, bi, bk, bwin, W,
                                                           La)
            e2 = times.event()
            times.add("sw", e0, e1)
            times.add("trace", e1, e2)
            del mv
            ok = (best >= p.min_overlap_score) & (alen > 0)
            votes.add(out, ins_cnt, ins_base, pids, ok)
            n_used += ok.sum()
    return int(n_used)


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (ties: lowest)."""
    best = x[..., 0]
    idx = torch.zeros(best.shape, dtype=torch.int64, device=x.device)
    for c in range(1, x.shape[-1]):
        better = x[..., c] > best
        best = torch.where(better, x[..., c], best)
        idx = torch.where(better, c, idx)
    return idx


def _consensus(votes: _Votes, probes_t, plens_t, min_cov: int):
    """Column-majority consensus call (ecreads.py:221-241).

    Returns (call (N, La) int8 with 4 = delete-this-base, ins_go
    (N, La+1) bool, ins_b (N, La+1) int8); argmax ties go to the first
    of [A, C, G, T, delete] and of the four inserted bases."""
    N, La = probes_t.shape
    base_votes = votes.votes[..., :4]
    del_votes = votes.votes[..., 5]
    tot = base_votes.sum(-1) + del_votes
    stacked = torch.cat([base_votes, del_votes[..., None]], -1)
    call = _first_argmax(stacked).to(torch.int8)
    use = tot >= min_cov
    live = torch.arange(La, device=probes_t.device)[None, :] < plens_t[:, None]
    out_call = torch.where(use & live, call, probes_t)
    zero = torch.zeros((N, 1), dtype=torch.bool, device=probes_t.device)
    use1 = torch.cat([zero, use], 1)
    ins_go = use1 & (votes.ins_cnt * 2 > torch.cat([zero.to(tot.dtype), tot],
                                                   1))
    ins_b = _first_argmax(votes.ins_base).to(torch.int8)
    return out_call, ins_go, ins_b


@spanned("ec.consensus")
def _finish_consensus(votes: _Votes, probes_t, plens, p: ECParams):
    """Consensus call + host-side edit application (ecreads.py:511-532)."""
    call, ins_go, ins_b = (t.cpu().numpy() for t in _consensus(
        votes, probes_t, torch.from_numpy(plens).to(probes_t.device),
        p.min_cov_for_call))
    corrected = []
    # vectorised interleave per read: token slots alternate
    # (insert-before-0, call-0, insert-before-1, call-1, ..., insert-L)
    for i in range(probes_t.shape[0]):
        L = int(plens[i])
        toks = np.empty(2 * L + 1, np.int8)
        sel = np.zeros(2 * L + 1, bool)
        toks[0::2] = ins_b[i, : L + 1]
        sel[0::2] = ins_go[i, : L + 1]
        toks[1::2] = call[i, :L]
        sel[1::2] = call[i, :L] != 4
        corrected.append(toks[sel])
    return corrected


def _sum_votes(votes: _Votes, used: int, mesh) -> int:
    """With a mesh, the planes and the used-pair count summed over dp."""
    if mesh is None:
        return used
    votes.sum_dp(mesh)
    n = torch.tensor(used, dtype=torch.int64, device=votes.votes.device)
    return int(sum_dp(mesh, n))


def _correct_probes(probe_reads, starts, didx, all_reads, p,
                    times: _StageTimes, probe_gids=None, mesh=None):
    """Correct `probe_reads` against the prebuilt all-reads index
    (ecreads.py:535-560)."""
    dev = didx.device
    n = len(probe_reads)
    probes, plens = _pad_reads(probe_reads,
                               pad_to=max(len(r) for r in all_reads))
    N, La = probes.shape
    c_probe, c_ent, c_diag = find_overlap_candidates_batch(
        didx, starts, probes, plens, p,
        probe_gids=probe_gids, n_reads_total=len(all_reads),
    )
    probes_t = torch.from_numpy(probes).to(dev)
    plens_t = torch.from_numpy(plens).to(dev)
    votes = _Votes(N, La, dev)
    used = _sum_votes(votes, _sw_and_vote(
        probes_t, plens_t, c_probe, c_ent, c_diag, didx, votes, p, times,
        mesh), mesh)
    corrected = _finish_consensus(votes, probes_t, plens, p)[:n]
    return corrected, {"reads": n, "overlaps_used": used,
                       "pairs": len(c_probe)}


def ec_reads(
    reads: list[np.ndarray],
    params: ECParams | None = None,
    target_chunk: int | None = None,
    rounds: int = 1,
    device: torch.device | str | None = None,
    mesh=None,
) -> tuple[list[np.ndarray], dict]:
    """Correct every read against the others. Returns (corrected, stats).

    rounds: iterated consensus — round r+1 corrects round r's output
    reads against each other; overlaps_used is summed over the rounds.

    target_chunk: index at most this many target reads at a time; column
    votes accumulate exactly across target chunks.  The top-max_targets
    candidate cut applies per chunk, so a chunked run may use up to
    max_targets x n_chunks overlaps per probe (as in the JAX package).

    device: where the index, the SW kernels and the votes run (default
    `cuda`, or the mesh's device); `cuda` raises without CUDA.  stats also
    gives the pairs aligned and, on a CUDA device, the summed device time
    of this rank's SW (`sw_ms`) and traceback (`trace_ms`) launches.

    mesh: a parallel/dist.py mesh; each SW chunk's pairs split over its
    dp ranks and the vote planes are summed over dp (module docstring).
    Every rank of the mesh makes the same call and returns the same
    corrected reads."""
    p = params or ECParams()
    if mesh is not None and device is not None and \
            torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    dev = resolve_device(mesh.device if mesh is not None else
                         device or "cuda")
    if rounds > 1:
        cur = reads
        st: dict = {}
        total = {"overlaps_used": 0, "pairs": 0, "sw_ms": 0.0,
                 "trace_ms": 0.0}
        for _ in range(rounds):
            cur, st = ec_reads(cur, p, target_chunk=target_chunk, rounds=1,
                               device=dev, mesh=mesh)
            for key in total:
                total[key] += st.get(key, 0)
        st = dict(st)
        st.update({k: v for k, v in total.items() if k in st})
        st["rounds"] = rounds
        return cur, st
    times = _StageTimes(dev)
    n = len(reads)
    if target_chunk is None or target_chunk >= n:
        entries = [(f"r{i}", s) for i, s in enumerate(reads)]
        entries += [(f"rc{i}", revcomp(s)) for i, s in enumerate(reads)]
        didx, starts = _build_ec_index(entries, dev)
        corrected, st = _correct_probes(reads, starts, didx, reads, p,
                                        times, mesh=mesh)
        return corrected, {**st, **times.ms()}

    probes, plens = _pad_reads(reads, pad_to=max(len(r) for r in reads))
    N, La = probes.shape
    probes_t = torch.from_numpy(probes).to(dev)
    plens_t = torch.from_numpy(plens).to(dev)
    votes = _Votes(N, La, dev)
    n_pairs_used = n_pairs = 0
    for t0 in range(0, n, target_chunk):
        tids = list(range(t0, min(t0 + target_chunk, n)))
        entries = [(f"r{i}", reads[i]) for i in tids]
        entries += [(f"rc{i}", revcomp(reads[i])) for i in tids]
        ent_gids = np.asarray(tids + tids, np.int64)
        didx, starts = _build_ec_index(entries, dev)
        c_probe, c_ent, c_diag = find_overlap_candidates_batch(
            didx, starts, probes, plens, p,
            probe_gids=np.arange(n), n_reads_total=n, ent_gids=ent_gids,
        )
        n_pairs_used += _sw_and_vote(probes_t, plens_t, c_probe, c_ent,
                                     c_diag, didx, votes, p, times, mesh)
        n_pairs += len(c_probe)
    n_pairs_used = _sum_votes(votes, n_pairs_used, mesh)
    corrected = _finish_consensus(votes, probes_t, plens, p)
    return corrected, {"reads": n, "overlaps_used": n_pairs_used,
                       "target_chunks": -(-n // target_chunk),
                       "pairs": n_pairs, **times.ms()}


def ec_reads_checkpointed(
    reads: list[np.ndarray],
    params: ECParams | None = None,
    checkpoint_dir: str | None = None,
    group: int = 128,
    device: torch.device | str = "cuda",
) -> tuple[list[np.ndarray], dict]:
    """ec_reads in resumable probe GROUPS (biokanga_tpu/pacbio/ecreads.py:
    329-380): each group of `group` probes is corrected against the full
    read set and persisted as one atomic cell (utils/checkpoint.
    SweepCheckpoint); a killed run resumes at the first missing group.
    One round, as in the JAX package; the corrected reads equal
    `ec_reads(..., rounds=1)`'s, since a probe's votes do not depend on
    the other probes of its group."""
    from ..utils.checkpoint import SweepCheckpoint, config_signature

    p = params or ECParams()
    dev = resolve_device(device)
    ckpt = None
    if checkpoint_dir:
        sig = config_signature(
            ["ecreads", len(reads),
             [int(len(r)) for r in reads[:64]], p, group]
        )
        ckpt = SweepCheckpoint(checkpoint_dir, sig)
    entries = [(f"r{i}", s) for i, s in enumerate(reads)]
    entries += [(f"rc{i}", revcomp(s)) for i, s in enumerate(reads)]
    didx, starts = _build_ec_index(entries, dev)
    times = _StageTimes(dev)
    corrected: list[np.ndarray] = []
    overlaps = pairs = 0
    for g0 in range(0, len(reads), group):
        gi = g0 // group
        rows = list(range(g0, min(g0 + group, len(reads))))
        if ckpt is not None and ckpt.has(0, gi):
            z = ckpt.load(0, gi)
            ofs = 0
            for L in z["lengths"]:
                corrected.append(z["flat"][ofs:ofs + int(L)].astype(np.int8))
                ofs += int(L)
            overlaps += int(z["overlaps"])
            continue
        sub, st = _correct_probes([reads[i] for i in rows], starts, didx,
                                  reads, p, times, probe_gids=rows)
        if ckpt is not None:
            ckpt.save(0, gi, {
                "lengths": np.asarray([len(c) for c in sub], np.int64),
                "flat": (np.concatenate(sub) if sub
                         else np.zeros(0, np.int8)),
                "overlaps": np.int64(st["overlaps_used"]),
            })
        corrected.extend(sub)
        overlaps += st["overlaps_used"]
        pairs += st["pairs"]
    return corrected, {"reads": len(reads), "overlaps_used": overlaps,
                       "pairs": pairs, **times.ms()}
