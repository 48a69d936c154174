"""The seed stage's plain versions (ops/seed_rows.py) against a numpy
reference written row by row, on the CPU.

The reference finds each core's range of the host index's sorted
suffixes with `np.searchsorted` on the (hi, lo) keys joined into one
64-bit key, reads its positions one by one, applies the diagonal rules,
then sorts, drops repeated diagonals, cuts the row at the candidate cap
and packs the read, a row at a time.  The cases cover reads with Ns and
ragged lengths, both strands, cores within and past the LUT (one and two
key words), occ_skip on and off, an ownership limit and none, H 16, 48
and 1,024, and caps below and at S*H; the genome holds a repeated block
whose cores pass 16 and 48 positions.
"""
import numpy as np
import pytest
import torch

from biokanga_tpu_torch.index.build import build_index
from biokanga_tpu_torch.index.device import to_device
from biokanga_tpu_torch.ops import seed_rows as sr
from biokanga_tpu_torch.sim.simreads import random_genome

I32_MAX = 2**31 - 1
LUT_BASES = 8
B, L = 40, 72


@pytest.fixture(scope="module")
def index():
    seqs = random_genome([("chrA", 40_000), ("chrB", 24_000)], seed=91)
    block = seqs[0][1][3_000:3_090].copy()
    for i in range(60):
        seqs[1][1][1_000 + 200 * i: 1_090 + 200 * i] = block
    seqs[0][1][20_000:20_040] = 4                # a run of Ns
    host = build_index(seqs, lut_bases=LUT_BASES)
    return host, to_device(host, torch.device("cpu"))


@pytest.fixture(scope="module")
def reads(index):
    host = index[0]
    rng = np.random.default_rng(5)
    g = host.codes
    starts = np.concatenate([
        rng.integers(0, 39_000, B - 12),
        41_000 + 200 * rng.integers(0, 60, 8) + rng.integers(0, 18, 8),
        rng.integers(19_950, 20_010, 4)])    # the repeat, the Ns
    r = np.stack([g[s:s + L] for s in starts]).astype(np.int8)
    # every other read from the reverse strand: found on the rc strand
    r[1::2] = np.where(r[1::2] >= 4, r[1::2], 3 - r[1::2])[:, ::-1]
    sub = rng.random(r.shape) < 0.02
    r[sub] = (r[sub] + 1) % 4
    r[3, 10] = r[17, 40] = 4                     # Ns inside reads
    lengths = np.full(B, L, np.int32)
    lengths[::5] = rng.integers(30, L, len(lengths[::5]))
    lengths[7] = 0                               # a pad row
    r[np.arange(L)[None, :] >= lengths[:, None]] = 4
    return r, lengths


def _strand(read, length, rc):
    if not rc:
        return read.copy()
    comp = np.where(read >= 4, read, 3 - read).astype(np.int8)
    out = np.empty_like(read)
    for i in range(L):
        out[i] = comp[length - 1 - i] if i < length else comp[
            L - 1 - (i - length)]
    return out


def _reference(host, read, length, rc, offsets, k, H, owned, occ_skip,
               cap):
    """One row: (flat, overflow, loci, valid, n_over, trunc, rcodes,
    rnlane) by the stage's rules, from the host index."""
    keys = ((host.key_hi.astype(np.uint64) << np.uint64(32))
            | host.key_lo.astype(np.uint64))
    seq = _strand(read, length, rc)
    flat, over = [], []
    for off in offsets:
        bases = seq[off:off + k].astype(np.int64)
        has_n = bool((bases >= 4).any())
        q = 0
        for i, b in enumerate(bases):
            q |= (0 if b >= 4 else int(b)) << (2 * (31 - i))
        qhigh = q | ((1 << (2 * (32 - k))) - 1)
        start = int(np.searchsorted(keys, np.uint64(q), side="left"))
        end = int(np.searchsorted(keys, np.uint64(qhigh), side="right"))
        size = end - start
        o = size > H and not has_n
        over.append(o)
        if occ_skip and o:
            size = 0
        live = 0 if has_n else min(size, H)
        for j in range(H):
            d = I32_MAX
            if j < live:
                d = int(host.pos_sorted[start + j]) - off
                if d < 0 or (owned is not None and d >= owned):
                    d = I32_MAX
            flat.append(d)
    srt = sorted(flat)
    v = [x != I32_MAX and (c == 0 or x != srt[c - 1])
         for c, x in enumerate(srt)]
    C = min(cap, len(srt))
    trunc = any(v[C:]) or (not occ_skip and any(over))
    n_over = sum(over) if occ_skip else 0
    W = -(-L // 16)
    padded = np.concatenate([seq, np.full(16 * W - L, 4, np.int8)])
    codes, nlane = [], []
    for w in range(W):
        c = n = 0
        for i in range(16):
            b = int(padded[16 * w + i])
            c |= (0 if b >= 4 else b) << (2 * (15 - i))
            n |= (3 if b >= 4 else 0) << (2 * (15 - i))
        codes.append(c)
        nlane.append(n)
    i32 = np.uint32
    return (flat, over, srt[:C], v[:C], n_over, trunc,
            np.array(codes, i32).view(np.int32),
            np.array(nlane, i32).view(np.int32))


# (rc, core_len, H, occ_skip, owned, cap; core_len vs LUT_BASES 8)
CASES = [
    (False, 12, 16, True, None, 32),      # binary search, cap < S*H
    (True, 12, 16, True, None, 32),
    (False, 8, 48, False, 30_000, 10**6),  # the LUT alone, cap = S*H
    (True, 6, 48, True, 50_000, 96),       # a run of LUT buckets
    (False, 20, 16, True, None, 24),       # two key words
    (True, 20, 48, False, 40_000, 10**6),
    (False, 14, 1024, False, None, 512),
    (True, 10, 1024, True, 60_000, 10**6),
    (True, 16, 16, False, None, 40),       # one full key word
    (False, 9, 48, True, None, 10**6),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_twins_equal_the_numpy_reference(index, reads, case):
    rc, k, H, occ_skip, owned, cap = CASES[case]
    host, didx = index
    r, lengths = reads
    offsets = list(range(0, L - k + 1, max(k, 11)))
    S = len(offsets)
    rt, lt = torch.from_numpy(r), torch.from_numpy(lengths)
    offs = torch.tensor(offsets, dtype=torch.int32)
    args = (didx, rt, lt, rc, offs, k, H, owned, occ_skip)
    flat, overflow = sr.seed_rows(*args)
    plain = sr.seed_rows_plain(*args)
    assert torch.equal(flat, plain[0]) and torch.equal(overflow, plain[1])
    assert flat.shape == (B, S * H) and overflow.shape == (B, S)
    srt = torch.sort(flat, dim=1).values
    C = min(cap, S * H)
    W = -(-L // 16)
    out = (torch.empty((B, C), dtype=torch.int32),
           torch.empty((B, C), dtype=torch.bool),
           torch.empty(B, dtype=torch.int32), torch.empty(B, dtype=torch.bool),
           torch.empty((B, W), dtype=torch.int32),
           torch.empty((B, W), dtype=torch.int32))
    got = sr.dedup_pack(srt, overflow, rt, lt, rc, cap, occ_skip, out=out)
    assert all(g is o for g, o in zip(got, out))
    for g, p in zip(got, sr.dedup_pack_plain(srt, overflow, rt, lt, rc, cap,
                                             occ_skip)):
        assert torch.equal(g, p)
    counts = {"over": 0, "filled": 0, "valid": 0}
    for b in range(B):
        want = _reference(host, r[b], int(lengths[b]), rc, offsets, k, H,
                          owned, occ_skip, cap)
        np.testing.assert_array_equal(flat[b].numpy(), want[0])
        np.testing.assert_array_equal(overflow[b].numpy(), want[1])
        np.testing.assert_array_equal(got[0][b].numpy(), want[2])
        np.testing.assert_array_equal(got[1][b].numpy(), want[3])
        assert int(got[2][b]) == want[4] and bool(got[3][b]) == want[5]
        np.testing.assert_array_equal(got[4][b].numpy(), want[6])
        np.testing.assert_array_equal(got[5][b].numpy(), want[7])
        counts["over"] += sum(want[1])
        counts["filled"] += sum(x != I32_MAX for x in want[0])
        counts["valid"] += sum(want[3])
    # the rows reach the paths the rules cut through
    assert counts["filled"] >= B // 4 and counts["valid"] >= B // 4
    if H < 1024:
        assert counts["over"] > 0


def test_wrappers_check_their_arguments(index, reads):
    _, didx = index
    r, lengths = reads
    rt, lt = torch.from_numpy(r), torch.from_numpy(lengths)
    offs = torch.tensor([0, 20], dtype=torch.int32)
    with pytest.raises(ValueError):
        sr.seed_rows(didx, rt, lt.to(torch.int64), False, offs, 12, 16,
                     None, True)
    with pytest.raises(ValueError):
        sr.seed_rows(didx, rt, lt, False, offs, 33, 16, None, True)
    with pytest.raises(ValueError):
        sr.seed_rows(didx, rt, lt, False, offs, 12, 16, None, True,
                     out=(torch.empty((B, 31), dtype=torch.int32),
                          torch.empty((B, 2), dtype=torch.bool)))
    flat, overflow = sr.seed_rows(didx, rt, lt, False, offs, 12, 16, None,
                                  True)
    with pytest.raises(ValueError):
        sr.dedup_pack(flat.to(torch.int64), overflow, rt, lt, False, 8, True)
    with pytest.raises(ValueError):
        sr.dedup_pack(flat, overflow, rt[:-1], lt[:-1], False, 8, True)
