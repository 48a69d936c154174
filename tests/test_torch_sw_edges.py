"""Edge cases of the port's traceback decode and banded SW against the JAX
package.

The decode's plain version walks move planes made for its edge cases
(tests/sw_edge_cases.py): LEFT runs longer than 32 columns, runs to column
0, walks that stay at column 0 or climb out of the band at column K-1 by
UP steps across several 32-column windows, starts at row La - 1, and La
not a multiple of 16 or 32.  The SW plain versions align pairs whose
scores come just below 2**15 and pass it, a pair with alen 0 and queries
of a length that is not a multiple of 16.  Inputs come from numpy
seeds; the JAX side runs as its own tests run it on the CPU (Pallas in
interpret mode).  Everything must be equal, exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biokanga_tpu.ops.pallas_sw import banded_sw_moves as jax_moves
from biokanga_tpu.ops.pallas_sw import banded_sw_score as jax_score
from biokanga_tpu.ops.sw_trace import traceback_cols_packed as jax_trace
from biokanga_tpu_torch.ops import banded_sw as sw
from biokanga_tpu_torch.ops.sw_trace import traceback_cols_packed_plain
from sw_edge_cases import (
    SCORING_BELOW_2_15,
    SCORING_PAST_2_15,
    decode_planes,
    near_identical_pairs,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("La,W", [(100, 24), (77, 40), (256, 96)])
def test_decode_edge_cases_match_jax(La, W):
    B = 12
    mv, bi, bk, bwin = decode_planes(La + W, B, La, W)
    jo, jc, jn = jax_trace(jnp.asarray(mv), jnp.asarray(bi), jnp.asarray(bk),
                           jnp.asarray(bwin.astype(np.int32)), W, La)
    out, ins_cnt, ins_base = traceback_cols_packed_plain(
        *(torch.from_numpy(x) for x in (mv, bi, bk, bwin)), W, La)
    np.testing.assert_array_equal(np.asarray(jo), out.numpy())
    np.testing.assert_array_equal(np.asarray(jc), ins_cnt.numpy())
    np.testing.assert_array_equal(np.asarray(jn), ins_base.numpy())
    # the edges the planes were made for
    assert int(ins_cnt.max()) > 32                  # a LEFT run past a warp
    assert (out[:, La - 1] != 6).any()              # a walk from row La - 1
    ups = (out == 5).int().numpy()
    longest = max(max((len(r) for r in "".join(map(str, row)).split("0")),
                      default=0) for row in ups)
    assert longest > 32                             # a climb across windows


def _jax_and_port(a, b, alen, blen, diag, La, W, scoring):
    match, mismatch, gap_open, gap_ext = scoring
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_ext=gap_ext)
    jb, ji, jk, jmv, jbw = jax_moves(a, b, alen, blen, diag, W,
                                     interpret=True, **kw)
    want = jax_trace(jmv, ji, jk, jnp.asarray(jbw), W, La)
    bwin, jlo, jhi = sw.normalize_band(
        torch.from_numpy(b), torch.from_numpy(blen), torch.from_numpy(diag),
        La, W)
    args = (torch.from_numpy(a), bwin, torch.from_numpy(alen), jlo, jhi)
    best, bi, bk, mv = sw.banded_sw_moves(*args, W, **kw)
    got = traceback_cols_packed_plain(mv, bi, bk, bwin, W, La)
    for w, g in zip((jb, ji, jk, *want), (best, bi, bk, *got)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    return best, bi


@pytest.mark.parametrize("La,W,scoring,past", [
    (256, 24, SCORING_BELOW_2_15, False),
    (320, 24, SCORING_PAST_2_15, True),
])
def test_scores_near_and_past_2_15_match_jax(La, W, scoring, past):
    B = 6
    a, b, alen, blen, diag = near_identical_pairs(La, B, La, W)
    best, bi = _jax_and_port(a, b, alen, blen, diag, La, W, scoring)
    top = int(best.max())
    assert (top > 32767) if past else (24_000 < top <= 32767)
    assert int(best[1]) == 0 and int(bi[2]) == La - 1


@pytest.mark.parametrize("La,W,scoring", [
    (256, 24, SCORING_BELOW_2_15),
    (320, 24, SCORING_PAST_2_15),
    (77, 16, (1, -1, -3, -1)),
])
def test_scores_without_moves_match_jax(La, W, scoring):
    a, b, alen, blen, diag = near_identical_pairs(La + 1, 5, La, W)
    kw = dict(zip(("match", "mismatch", "gap_open", "gap_ext"), scoring))
    want = jax_score(a, b, alen, blen, diag, W, interpret=True, **kw)
    bwin, jlo, jhi = sw.normalize_band(
        torch.from_numpy(b), torch.from_numpy(blen), torch.from_numpy(diag),
        La, W)
    got = sw.banded_sw_score(torch.from_numpy(a), bwin,
                             torch.from_numpy(alen), jlo, jhi, W, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert int(got[0][1]) == 0 and int(got[0].max()) > La // 2


def test_short_and_empty_queries_match_jax():
    La, W = 77, 16
    a, b, alen, blen, diag = near_identical_pairs(3, 5, La, W)
    alen[3] = 13                                    # a partial move word
    best, bi = _jax_and_port(a, b, alen, blen, diag, La, W,
                             (1, -1, -3, -1))
    assert (int(best[1]), int(bi[1])) == (0, 0)
    assert int(bi[3]) < 13
