"""The port's banded Smith-Waterman and traceback decode against the JAX
package's Pallas kernels (interpret mode on the CPU).

Pairs are made from a numpy seed: noisy copies with indels, ragged query
and target lengths, diagonals of both signs, Ns in queries and targets, a
pair with no positive cell and a pair whose best path starts at target
position 0 behind an out-of-band diagonal (the second local floor).  The
port runs its plain versions (CPU tensors).  Scores, best cells and each
package's own decode of its own move planes must be equal, exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biokanga_tpu.ops.pallas_sw import banded_sw_moves as jax_moves
from biokanga_tpu.ops.pallas_sw import banded_sw_score as jax_score
from biokanga_tpu.ops.sw_trace import traceback_cols_packed as jax_trace
from biokanga_tpu_torch.ops import banded_sw as sw
from biokanga_tpu_torch.ops.sw_trace import (
    traceback_cols_packed,
    traceback_cols_packed_plain,
)

torch.set_num_threads(2)


def _noisy(rng, seq, err):
    out = []
    for c in seq:
        r = rng.random()
        if r < err * 0.3:
            continue
        if r < err * 0.6:
            out.append(rng.integers(0, 4))
        out.append((c + 1 + rng.integers(0, 3)) % 4
                   if rng.random() < err * 0.4 else c)
    return np.array(out, np.int8)


def make_pairs(seed, B, La, W):
    """(a, b, alen, blen, diag) numpy inputs of B pairs, queries <= La."""
    rng = np.random.default_rng(seed)
    Lb = La + 32
    a = np.full((B, La), 4, np.int8)
    b = np.full((B, Lb), 4, np.int8)
    alen = np.zeros(B, np.int32)
    blen = np.zeros(B, np.int32)
    diag = np.zeros(B, np.int32)
    for p in range(B):
        n = La - int(rng.integers(0, 40))
        src = rng.integers(0, 4, 2 * Lb + 64).astype(np.int8)
        d = int(rng.integers(-W // 2, W // 2 + 1))  # target j ~ query i + d
        q = _noisy(rng, src[max(d, 0):], 0.12)[:n]
        t = _noisy(rng, src[max(-d, 0):], 0.12)
        t = t[:Lb - int(rng.integers(0, 30))]
        a[p, :len(q)], alen[p] = q, len(q)
        b[p, :len(t)], blen[p] = t, len(t)
        diag[p] = d
        if p % 3 == 1:                           # band centre off by a few
            diag[p] += int(rng.integers(-6, 7))
    a[1, 30:34] = 4                              # Ns in a query
    b[2, La // 5:La // 5 + 3] = 4                # and in a target
    b[2, La // 2] = 4
    a[3] = rng.integers(0, 4, La)                # unrelated pair
    a[4, :] = 4                                  # no positive cell
    alen[4] = La // 2
    # best path from (row 5, target 0): its diagonal predecessor is out of
    # the band, so only the second floor max(H0, sub > 0) starts it
    a[5, :La] = rng.integers(0, 4, La)
    b[5, :] = 4
    b[5, :La - 5] = a[5, 5:La]
    alen[5], blen[5], diag[5] = La, La - 5, -5
    return a, b, alen, blen, diag


def _port_inputs(a, b, alen, blen, diag, La, W):
    bwin, jlo, jhi = sw.normalize_band(
        torch.from_numpy(b), torch.from_numpy(blen), torch.from_numpy(diag),
        La, W)
    return torch.from_numpy(a), bwin, torch.from_numpy(alen), jlo, jhi


@pytest.mark.parametrize("W", [24, 96])
def test_moves_and_decode_match_jax(W):
    La, B = 256, 8
    a, b, alen, blen, diag = make_pairs(W, B, La, W)
    jb, ji, jk, jmv, jbw = jax_moves(a, b, alen, blen, diag, W,
                                     interpret=True)
    jo, jc, jn = jax_trace(jmv, ji, jk, jnp.asarray(jbw), W, La)

    args = _port_inputs(a, b, alen, blen, diag, La, W)
    best, bi, bk, mv = sw.banded_sw_moves(*args, W)
    assert mv.shape == (B, La // 16, 2 * W + 1)
    for want, got in ((jb, best), (ji, bi), (jk, bk)):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    out, ins_cnt, ins_base = traceback_cols_packed(mv, bi, bk, args[1], W, La)
    np.testing.assert_array_equal(np.asarray(jo), out.numpy())
    np.testing.assert_array_equal(np.asarray(jc), ins_cnt.numpy())
    np.testing.assert_array_equal(np.asarray(jn), ins_base.numpy())
    # the cases the inputs were built for
    assert (best[4], bi[4], bk[4]) == (0, 0, 0)
    assert int(best[5]) == La - 5 and int(bi[5]) == La - 1
    assert (out.numpy() == 5).any() and (ins_cnt.numpy() > 0).any()
    assert (out.numpy() == 4).any()              # a target N on a DIAG step


@pytest.mark.parametrize("W", [24, 96])
def test_score_matches_jax_and_moves(W):
    La, B = 256, 8
    a, b, alen, blen, diag = make_pairs(W + 1, B, La, W)
    want = jax_score(a, b, alen, blen, diag, W, interpret=True)
    args = _port_inputs(a, b, alen, blen, diag, La, W)
    got = sw.banded_sw_score(*args, W)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    for g, m in zip(got, sw.banded_sw_moves_plain(*args, W)[:3]):
        assert torch.equal(g, m)


@pytest.mark.parametrize("W", [256, 320])
def test_wide_bands_match_jax(W):
    """Bands past the one-warp path (W > 255): moves, score and each
    package's decode of its own planes, on pairs of up to 400 bases."""
    La, B = 400, 7
    a, b, alen, blen, diag = make_pairs(W, B, La, W)
    jb, ji, jk, jmv, jbw = jax_moves(a, b, alen, blen, diag, W,
                                     interpret=True)
    jo, jc, jn = jax_trace(jmv, ji, jk, jnp.asarray(jbw), W, La)
    want_score = jax_score(a, b, alen, blen, diag, W, interpret=True)

    args = _port_inputs(a, b, alen, blen, diag, La, W)
    best, bi, bk, mv = sw.banded_sw_moves(*args, W)
    assert mv.shape == (B, La // 16, 2 * W + 1)
    for want, got in ((jb, best), (ji, bi), (jk, bk)):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    for want, got in zip(want_score, sw.banded_sw_score(*args, W)):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    out, ins_cnt, ins_base = traceback_cols_packed(mv, bi, bk, args[1], W, La)
    np.testing.assert_array_equal(np.asarray(jo), out.numpy())
    np.testing.assert_array_equal(np.asarray(jc), ins_cnt.numpy())
    np.testing.assert_array_equal(np.asarray(jn), ins_base.numpy())
    assert int(best.max()) > La // 4 and (out.numpy() == 5).any()


def test_bands_past_the_register_paths_match_jax():
    """A band past W = 4,095 (the card's segmented path): moves, score and
    each package's decode of its own planes on two pairs of 64 bases."""
    La, W = 64, 4_096
    a, b, alen, blen, diag = (x[:2] for x in make_pairs(5, 6, La, 24))
    jb, ji, jk, jmv, jbw = jax_moves(a, b, alen, blen, diag, W,
                                     interpret=True)
    jo, jc, jn = jax_trace(jmv, ji, jk, jnp.asarray(jbw), W, La)
    want_score = jax_score(a, b, alen, blen, diag, W, interpret=True)

    args = _port_inputs(a, b, alen, blen, diag, La, W)
    best, bi, bk, mv = sw.banded_sw_moves(*args, W)
    assert mv.shape == (2, La // 16, 2 * W + 1)
    for want, got in ((jb, best), (ji, bi), (jk, bk)):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    for want, got in zip(want_score, sw.banded_sw_score(*args, W)):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    out, ins_cnt, ins_base = traceback_cols_packed(mv, bi, bk, args[1], W, La)
    np.testing.assert_array_equal(np.asarray(jo), out.numpy())
    np.testing.assert_array_equal(np.asarray(jc), ins_cnt.numpy())
    np.testing.assert_array_equal(np.asarray(jn), ins_base.numpy())
    assert int(best.min()) > 8 and (out.numpy() < 4).any()


def test_short_queries_stop_the_planes_at_alen():
    La, W = 64, 8
    a, b, alen, blen, diag = make_pairs(3, 6, La, W)
    alen[0] = 21
    args = _port_inputs(a, b, alen, blen, diag, La, W)
    _, bi, _, mv = sw.banded_sw_moves_plain(*args, W)
    assert int(bi[0]) < 21
    codes = (mv[0, 1] >> (2 * torch.arange(16)[:, None])) & 3
    assert not codes[5:].any() and not mv[0, 2:].any()


def test_wrappers_refuse_what_the_kernel_refuses():
    a, b, alen, blen, diag = make_pairs(1, 6, 64, 8)
    args = _port_inputs(a, b, alen, blen, diag, 64, 8)
    with pytest.raises(ValueError, match="gap_open"):
        sw.banded_sw_moves(*args, 8, match=3, gap_open=-3)
    # past the one-warp path's band the DP runs all the same (one block a
    # pair on the card, any W in the plain version)
    W = sw.MAX_SW_BAND + 1
    wide = _port_inputs(a, b, alen, blen, diag, 64, W)
    got = sw.banded_sw_score(*wide, W)
    for g, m in zip(got, sw.banded_sw_moves_plain(*wide, W)[:3]):
        assert torch.equal(g, m)
    assert int(got[0].max()) > 0
    with pytest.raises(ValueError, match="band half-width"):
        sw.banded_sw_score(*args, -1)
    with pytest.raises(ValueError, match="bwin"):
        sw.banded_sw_moves(args[0], args[1][:, :-1], *args[2:], 8)


def test_normalize_band_matches_jax():
    from biokanga_tpu.ops.pallas_sw import normalize_band as jax_norm

    a, b, alen, blen, diag = make_pairs(5, 6, 128, 24)
    bwin, jlo, jhi = sw.normalize_band(torch.from_numpy(b),
                                       torch.from_numpy(blen),
                                       torch.from_numpy(diag), 128, 24)
    jw, jl, jh = jax_norm(b, blen, diag, 128, 24)
    T = bwin.shape[1]
    np.testing.assert_array_equal(jw[:, :T], bwin.numpy())
    np.testing.assert_array_equal(jl, jlo.numpy())
    np.testing.assert_array_equal(jh, jhi.numpy())


def test_decode_wrapper_runs_the_plain_version_on_the_cpu():
    a, b, alen, blen, diag = make_pairs(8, 6, 128, 16)
    args = _port_inputs(a, b, alen, blen, diag, 128, 16)
    _, bi, bk, mv = sw.banded_sw_moves(*args, 16)
    before = traceback_cols_packed.launches
    got = traceback_cols_packed(mv, bi, bk, args[1], 16, 128)
    assert traceback_cols_packed.launches == before
    for g, w in zip(got, traceback_cols_packed_plain(mv, bi, bk, args[1],
                                                     16, 128)):
        assert torch.equal(g, w)
