"""The port's `blitz` against the JAX package: the rolling-key seed
lookup on its valid slots, the chain DP (the plain version of kernel #8)
against `_chain_scan` on random and edge-case block sets, the PSL, PSLX,
BED and MAF rows of `blitz_query` and of a batch of queries on the
fixture of tests/test_blitz.py, and the CLI's files.  Inputs come from
numpy seeds; the port runs on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biokanga_tpu.cli import main as jax_main
from biokanga_tpu.index.build import build_index as jax_build
from biokanga_tpu.index.device import to_device as jax_device
from biokanga_tpu.ops.lookup import rolling_seed_lookup as jax_rolling
from biokanga_tpu.seq.encode import revcomp
from biokanga_tpu.seq.fasta import write_fasta
from biokanga_tpu.sim.simreads import random_genome
from biokanga_tpu.tools import blitz as jbz
from biokanga_tpu_torch.cli import main as torch_main
from biokanga_tpu_torch.index.build import build_index as torch_build
from biokanga_tpu_torch.index.device import to_device as torch_device
from biokanga_tpu_torch.ops.blitz_chain import chain_scan_plain
from biokanga_tpu_torch.ops.lookup import rolling_seed_lookup
from biokanga_tpu_torch.tools import blitz as tbz

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def blz():
    """tests/test_blitz.py's fixture, indexed by both packages."""
    seqs = random_genome([("tA", 50000), ("tB", 30000)], seed=71)
    tidx = torch_build(seqs, lut_bases=8)
    return (seqs, jax_device(jax_build(seqs, lut_bases=8)), tidx,
            torch_device(tidx, CPU, pack=False))


@pytest.mark.parametrize("k,stride", [(12, 1), (16, 7)])
def test_rolling_seed_lookup_matches_jax_on_valid_slots(blz, k, stride):
    seqs, jd, _, td = blz
    rng = np.random.default_rng(k)
    g = seqs[0][1]
    rows = np.full((3, 320), 4, np.int8)
    rows[0] = g[1000:1320]
    rows[1, :300] = revcomp(g[4000:4300])
    rows[1, 50:53] = 4
    rows[2] = rng.integers(0, 4, 320)
    rows[2, 100:140] = g[100:140]          # an over-occurring-free repeat
    S = (320 - k) // stride + 1
    jp, jv, js = (np.asarray(x) for x in jax_rolling(
        jd.key_hi, jd.key_lo, jd.lut, jd.pos_rows, jnp.asarray(rows), k,
        stride, S, 64, jd.lut_bases, jd.max_bsearch_steps))
    tp, tv, ts = (x.numpy() for x in rolling_seed_lookup(
        td.key_hi, td.key_lo, td.lut, td.pos_sorted, torch.from_numpy(rows),
        k, stride, S, 64, td.lut_bases, td.max_bsearch_steps))
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tp[tv], jp[jv])
    assert jv.sum() > 10


def _blocks(case: str, rng) -> np.ndarray:
    """(M, 3) [q, t, len] block sets, sorted by (t, q) as _chain_blocks
    sorts them."""
    if case == "m1":
        b = np.array([[5, 100, 30]])
    elif case == "ties":
        # equal candidates: several predecessors at the same score and gap
        q = np.repeat(np.arange(0, 400, 40), 3)
        b = np.stack([q, q + np.tile([0, 1000, 2000], 10),
                      np.full(30, 20)], 1)
    elif case == "gap_limit":
        # target gaps on both sides of 100,000
        t = np.cumsum([0, 99_970, 30, 100_001, 50, 99_960, 20])
        b = np.stack([np.arange(7) * 40, t, np.full(7, 30)], 1)
    elif case in ("overlap7", "overlap8"):
        ov = int(case[-1])
        b = np.array([[0, 1000, 40], [40 - ov, 1040 - ov, 40],
                      [80 - ov, 1080, 40], [200, 1200 - ov, 40]])
    else:
        M = 512 if case == "m512" else int(rng.integers(2, 120))
        q = rng.integers(0, 5000, M)
        b = np.stack([q, q * 3 + rng.integers(-500, 500, M) + 10_000,
                      rng.integers(16, 80, M)], 1)
    b = b.astype(np.int64)
    return b[np.lexsort((b[:, 0], b[:, 1]))]


def _jax_chain(b: np.ndarray, gap_open: int):
    """JAX _chain_scan on the blocks padded as _chain_blocks pads them."""
    M = len(b)
    Mp = 64
    while Mp < M:
        Mp *= 2
    cols = []
    for c in range(3):
        x = np.zeros(Mp, np.int32)
        x[:M] = b[:, c]
        cols.append(x)
    f, pred = jbz._chain_scan(*(jnp.asarray(x) for x in cols),
                              jnp.asarray(cols[2]),
                              jnp.asarray(np.arange(Mp) < M), Mp, gap_open)
    return np.asarray(f), np.asarray(pred)


CHAIN_CASES = ["random", "ties", "m1", "m512", "gap_limit", "overlap7",
               "overlap8"]


@pytest.mark.parametrize("case", CHAIN_CASES)
def test_chain_scan_plain_matches_jax(case):
    """One chain a call, and the same chain padded beside others in one
    batch: f and pred equal to the JAX scan's on every slot."""
    rng = np.random.default_rng(CHAIN_CASES.index(case))
    b = _blocks(case, rng)
    jf, jp = _jax_chain(b, 5)
    others = [_blocks("random", rng) for _ in range(2)]
    W = max(len(jf), *(len(o) for o in others))
    batch = [b] + others
    x = np.zeros((3, len(batch), W), np.int32)
    valid = np.zeros((len(batch), W), bool)
    for r, blk in enumerate(batch):
        x[:, r, :len(blk)] = blk.T
        valid[r, :len(blk)] = True
    q0, t0, ln = (torch.from_numpy(c) for c in x)
    f, pred = chain_scan_plain(q0, t0, ln, ln.clone(),
                               torch.from_numpy(valid), 5)
    np.testing.assert_array_equal(f[0, :len(jf)].numpy(), jf)
    np.testing.assert_array_equal(pred[0, :len(jp)].numpy(), jp)
    for r, blk in enumerate(others, 1):
        of, op = _jax_chain(blk, 5)
        np.testing.assert_array_equal(f[r, :len(blk)].numpy(), of[:len(blk)])
        np.testing.assert_array_equal(pred[r, :len(blk)].numpy(),
                                      op[:len(blk)])
    if case in ("overlap7", "overlap8"):
        # an overlap of 7 chains (> -8), one of 8 does not
        assert (jp[1] == 0) == (case == "overlap7")


def _queries(seqs):
    g, h = seqs[0][1], seqs[1][1]
    rng = np.random.default_rng(4)
    m = g[20000:21500].copy()
    sub = rng.random(1500) < 0.03
    m[sub] = (m[sub] + 1) % 4
    return [("q1", g[1000:1600].copy()),
            ("qr", revcomp(h[5000:5500].copy())),
            ("qs", np.concatenate([g[2000:2300], g[12300:12600]])),
            ("junk", rng.integers(0, 4, 500).astype(np.int8)),
            ("mut", revcomp(m)),
            ("twoent", np.concatenate([g[49700:50000], h[:300]])),
            ("tiny", g[5:30].copy()),
            ("ns", np.where(np.arange(800) % 97 < 3, 4, g[30000:30800])
             .astype(np.int8))]


def _rows(mod, paths, didx, q):
    return ([mod.psl_row(p) for p in paths],
            [mod.pslx_row(p, didx, q) for p in paths],
            [mod.bed_row(p) for p in paths],
            [mod.maf_block(p, didx, q) for p in paths])


def test_blitz_rows_match_jax(blz):
    """Each query alone and all of them in one batch: every PSL, PSLX, BED
    and MAF row equal to the JAX package's."""
    seqs, jd, tidx, td = blz
    qs = _queries(seqs)
    batch = tbz.blitz_queries(td, qs)
    n_paths = 0
    for (name, q), paths in zip(qs, batch):
        jp = jbz.blitz_query(jd, name, q, jbz.BlitzParams())
        want = _rows(jbz, jp, jd, q)
        assert _rows(tbz, paths, tidx, q) == want
        assert _rows(tbz, tbz.blitz_query(td, name, q), tidx, q) == want
        n_paths += len(jp)
    assert n_paths >= 6


@pytest.fixture(scope="module")
def blitz_files(blz, tmp_path_factory):
    seqs = blz[0]
    d = tmp_path_factory.mktemp("blitz")
    write_fasta(str(d / "t.fa"), seqs)
    assert jax_main(["index", "-i", str(d / "t.fa"), "-o", str(d / "t.npz"),
                     "--lut-bases", "8"]) == 0
    write_fasta(str(d / "q.fa"), _queries(seqs))
    return d


@pytest.mark.parametrize("fmt,opts", [("psl", []), ("pslx", ["-m", "more"]),
                                      ("bed", ["-R", "1"]),
                                      ("maf", ["-s", "200", "-a", "60"])])
def test_blitz_cli_matches_jax(blitz_files, fmt, opts):
    d = blitz_files
    argv = ["blitz", "-i", str(d / "q.fa"), "-I", str(d / "t.npz"), "-M", fmt,
            *opts]
    assert jax_main(argv + ["-o", str(d / f"jax.{fmt}")]) == 0
    assert torch_main(argv + ["-o", str(d / f"torch.{fmt}"), "--device",
                              "cpu"]) == 0
    want = (d / f"jax.{fmt}").read_bytes()
    assert (d / f"torch.{fmt}").read_bytes() == want and len(want) > 200
