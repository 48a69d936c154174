"""Inputs that drive the SW kernels and the traceback decode to their edges,
made with numpy from a seed; shared by tests/test_torch_sw_edges.py and
tests/test_torch_swservice.py (the plain versions against the JAX
package), tests/test_torch_cuda.py (the kernels against the plain
versions) and chip_smoke.py.  Imports neither jax nor torch.
"""
import numpy as np

STOP, DIAG, UP, LEFT = 0, 1, 2, 3

# (match, mismatch, gap_open, gap_ext) under which near_identical_pairs
# score just below 2**15 and past it: the edge of what 16-bit lanes hold
SCORING_BELOW_2_15 = (100, -100, -300, -100)
SCORING_PAST_2_15 = (120, -120, -240, -120)


def pack_planes(codes: np.ndarray) -> np.ndarray:
    """(B, 16 * Wd, K) 2-bit codes -> (B, Wd, K) int32 move words."""
    B, R, K = codes.shape
    words = np.zeros((B, R // 16, K), np.int64)
    for r in range(16):
        words |= codes[:, r::16, :].astype(np.int64) << (2 * r)
    return words.astype(np.uint32).view(np.int32)


def decode_planes(seed: int, B: int, La: int, W: int):
    """Move planes, best cells and band windows whose walks take the
    decode's edge cases: LEFT runs of 33-90 columns, runs that reach
    column 0 (no non-LEFT column is left: land = -1), walks that sink to
    column 0 and stay there, UP runs of 40-90 rows that climb across
    several 32- and 64-column windows and leave the band at column K-1,
    starts at row La - 1 and at the band's top and bottom columns.
    Returns (mv (B, ceil(La/16), K) int32, best_i, best_k (B,) int32,
    bwin (B, ceil(La/16) * 16 + K) int8)."""
    rng = np.random.default_rng(seed)
    K = 2 * W + 1
    Wd = -(-La // 16)
    codes = rng.choice(4, size=(B, Wd * 16, K), p=[0.05, 0.35, 0.2, 0.4])
    bi = np.zeros(B, np.int32)
    bk = np.zeros(B, np.int32)
    for p in range(B):
        case = p % 6
        i = La - 1 if case in (0, 3, 4) else int(rng.integers(La // 2, La))
        k = {3: int(rng.integers(0, 8)), 5: K - 1}.get(
            case, int(rng.integers(K // 2, K)))
        bi[p], bk[p] = i, k
        up_left = int(rng.integers(40, 91)) if case == 3 else 0
        while i >= 0:
            run = 0
            x = rng.random()
            if case == 0 and x < 0.08:
                run = int(rng.integers(33, 91))          # long insertion
            elif case == 1 and x < 0.01:
                run = k + 1                               # down past column 0
            elif case == 2:
                run = int(rng.integers(0, 6)) if x < 0.3 else 0
            elif x < 0.05:
                run = int(rng.integers(1, 5))
            codes[p, i, max(k - run + 1, 0):k + 1] = LEFT
            land = k - run
            if land < 0:
                break
            if case == 3 and up_left == 0 and x < 0.05:
                up_left = int(rng.integers(40, 91))       # a climb
            if up_left:
                up_left -= 1
                code = UP
            elif rng.random() < 0.003 and case != 3:
                code = STOP
            else:
                code = DIAG if rng.random() < 0.9 else UP
            codes[p, i, land] = code
            if code == STOP:
                break
            k = land if code == DIAG else land + 1
            if k >= K:
                break
            i -= 1
    bwin = rng.integers(0, 4, (B, Wd * 16 + K)).astype(np.int8)
    bwin[rng.random(bwin.shape) < 0.05] = 4
    return pack_planes(codes), bi, bk, bwin


def near_identical_pairs(seed: int, B: int, La: int, W: int):
    """(a, b, alen, blen, diag) of B pairs that are copies of one another
    but for a few substitutions and indels, so that the best scores come
    near match * La; pair 1 has alen 0 and pair 2 runs to row La - 1."""
    rng = np.random.default_rng(seed)
    Lb = La + 32
    a = np.full((B, La), 4, np.int8)
    b = np.full((B, Lb), 4, np.int8)
    alen = np.full(B, La, np.int32)
    blen = np.zeros(B, np.int32)
    diag = np.zeros(B, np.int32)
    for p in range(B):
        src = rng.integers(0, 4, Lb + 64).astype(np.int8)
        d = int(rng.integers(-W // 4, W // 4 + 1))
        q = src[max(d, 0):max(d, 0) + La].copy()
        t = src[max(-d, 0):max(-d, 0) + Lb].copy()
        sub = rng.random(La) < 0.01
        q[sub] = (q[sub] + 1) % 4
        if p % 2:
            at = int(rng.integers(La // 4, La // 2))
            t = np.delete(t, np.arange(at, at + 2))       # a deletion
        a[p] = q
        b[p, :len(t)], blen[p] = t, len(t)
        diag[p] = d
    alen[1] = 0
    return a, b, alen, blen, diag


def tie_rich_pairs(seed: int, B: int, La: int):
    """(a, b, alen, blen, diag) numpy: every third pair a tandem repeat of
    a 1-4 base unit (with a few substitutions), then noisy copies, then
    unrelated pairs; Ns in one query and one target."""
    rng = np.random.default_rng(seed)
    Lb = La + 24
    a = np.full((B, La), 4, np.int8)
    b = np.full((B, Lb), 4, np.int8)
    alen = np.zeros(B, np.int32)
    blen = np.zeros(B, np.int32)
    diag = rng.integers(-10, 11, B).astype(np.int32)
    for p in range(B):
        n = La - int(rng.integers(0, 30))
        if p % 3 == 0:
            unit = rng.integers(0, 4, int(rng.integers(1, 5))).astype(np.int8)
            s = np.tile(unit, 2 * Lb // len(unit) + 2)
            q = s[:n].copy()
            t = s[int(rng.integers(0, 5)):][:Lb - int(rng.integers(0, 30))]
            q[rng.random(n) < 0.03] = rng.integers(0, 4)
        elif p % 3 == 1:
            q = rng.integers(0, 4, n).astype(np.int8)
            t = q.copy()
            t[rng.random(n) < 0.08] = rng.integers(0, 4)
            t = t[:Lb]
        else:
            q = rng.integers(0, 4, n).astype(np.int8)
            t = rng.integers(0, 4, Lb - int(rng.integers(0, 30))).astype(
                np.int8)
        a[p, :len(q)], alen[p] = q, len(q)
        b[p, :len(t)], blen[p] = t, len(t)
    a[1, 20:23] = 4
    b[4, 30] = 4
    return a, b, alen, blen, diag
