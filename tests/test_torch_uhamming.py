"""The port's `uhamming` sweep against the JAX package: the watson and
reverse-complement sweeps, node partitions and their merge, genomes of
several entries with Ns and an entry shorter than K, and the CLI's
.hmg and CSV files in modes 0, 2 and 3.  Inputs come from numpy seeds;
the port runs its plain version on the CPU (kernel #7 is held against it
on the card by tests/test_torch_cuda.py and chip_smoke.py)."""
import numpy as np
import pytest

from biokanga_tpu.cli import main as jax_main
from biokanga_tpu.seq.fasta import write_fasta
from biokanga_tpu.tools import uhamming as juh
from biokanga_tpu_torch.cli import main as torch_main
from biokanga_tpu_torch.tools import uhamming as tuh


def _ns_genome():
    """Two entries and one of 28 bases (past K 24, short of K 30), N runs
    in two of them, an exact and a near (2 substitutions) repeat."""
    rng = np.random.default_rng(12)
    g = rng.integers(0, 4, 400).astype(np.int8)
    g[100:110] = 4
    g[175:178] = 4
    g[300:340] = g[20:60]
    g[350:390] = g[60:100]
    g[[360, 380]] = (g[[360, 380]] + 1) % 4
    return g, np.array([0, 150, 178, 400])


@pytest.mark.parametrize("include_rc", [False, True])
def test_sweep_matches_jax(include_rc):
    """The JAX test's genome: 300 bases with a planted duplicate."""
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 4, size=300).astype(np.int8)
    codes[200:230] = codes[50:80]
    starts = np.array([0, 300])
    want = juh.hamming_sweep(codes, starts, K=24, include_rc=include_rc,
                             block=64)
    got = tuh.hamming_sweep(codes, starts, K=24, include_rc=include_rc,
                            device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8 and (got[50:57] == 0).all()


def test_node_partitions_match_jax():
    """Three static shift ranges (reference -n/-N) and their merge."""
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, size=400).astype(np.int8)
    starts = np.array([0, 400])
    top = 400 - 20 + 1
    bounds = [1, top // 3, 2 * top // 3, top]
    parts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        want = juh.hamming_sweep(codes, starts, K=20, shift_lo=lo,
                                 shift_hi=hi, include_rc=False)
        got = tuh.hamming_sweep(codes, starts, K=20, shift_lo=lo,
                                shift_hi=hi, include_rc=False, device="cpu")
        np.testing.assert_array_equal(got, want)
        parts.append(got)
    np.testing.assert_array_equal(
        tuh.merge_partials(parts),
        juh.hamming_sweep(codes, starts, K=20, include_rc=False))


@pytest.mark.parametrize("K", [24, 30])
@pytest.mark.parametrize("include_rc", [False, True])
def test_entries_ns_and_short_entry_match_jax(K, include_rc):
    g, starts = _ns_genome()
    for lo, hi in ((1, None), (7, 90)):
        want = juh.hamming_sweep(g, starts, K=K, shift_lo=lo, shift_hi=hi,
                                 include_rc=include_rc, block=64)
        got = tuh.hamming_sweep(g, starts, K=K, shift_lo=lo, shift_hi=hi,
                                include_rc=include_rc, device="cpu")
        np.testing.assert_array_equal(got, want)
    assert (got[150:178] == tuh.H_INVALID).all() == (K > 28)


def test_window_longer_than_the_genome():
    g = np.random.default_rng(1).integers(0, 4, 20).astype(np.int8)
    want = juh.hamming_sweep(g, np.array([0, 20]), K=24)
    got = tuh.hamming_sweep(g, np.array([0, 20]), K=24, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert (got == tuh.H_INVALID).all()


@pytest.fixture(scope="module")
def uh_fasta(tmp_path_factory):
    d = tmp_path_factory.mktemp("uh")
    g, starts = _ns_genome()
    write_fasta(str(d / "g.fa"), [(f"e{i}", g[a:b]) for i, (a, b) in
                                  enumerate(zip(starts[:-1], starts[1:]))])
    return d


def _same_hmg(a: str, b: str):
    x, y = juh.load_hmg(a), tuh.load_hmg(b)
    np.testing.assert_array_equal(x[0], y[0])
    np.testing.assert_array_equal(x[2], y[2])
    assert x[0].dtype == y[0].dtype and (x[1], x[3]) == (y[1], y[3])


@pytest.mark.parametrize("mode", [0, 2, 3])
def test_uhamming_cli_matches_jax(uh_fasta, mode):
    """-m 0 with its CSV, -m 2 (node 2 of 3; the JAX CLI runs no reverse
    complement sweep there, and neither does the port) and -m 3 of the
    three partials."""
    d = uh_fasta
    fa = str(d / "g.fa")
    for tag, run, dev in (("jax", jax_main, []),
                          ("torch", torch_main, ["--device", "cpu"])):
        common = ["-K", "24"]
        if mode == 0:
            argv = ["-i", fa, "-o", str(d / f"m0_{tag}.hmg.npz"), "-O",
                    str(d / f"m0_{tag}.csv")]
        elif mode == 2:
            argv = ["-m", "2", "-n", "3", "-N", "2", "-i", fa, "-o",
                    str(d / f"m2_{tag}.hmg.npz"), "-O",
                    str(d / f"m2_{tag}.csv")]
        else:
            for node in (1, 2, 3):
                assert run(["uhamming", "-m", "2", "-n", "3", "-N",
                            str(node), "-i", fa, "-o",
                            str(d / f"p{node}_{tag}.hmg.npz"), *common,
                            *dev]) == 0
            argv = ["-m", "3", "-o", str(d / f"m3_{tag}.hmg.npz"), "-O",
                    str(d / f"m3_{tag}.csv")]
            for node in (1, 2, 3):
                argv += ["-I", str(d / f"p{node}_{tag}.hmg.npz")]
        assert run(["uhamming", *argv, *common, *dev]) == 0
    _same_hmg(str(d / f"m{mode}_jax.hmg.npz"), str(d / f"m{mode}_torch.hmg.npz"))
    assert (d / f"m{mode}_jax.csv").read_bytes() == \
        (d / f"m{mode}_torch.csv").read_bytes()


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1_000])
def test_pack_planes_round_trip(n):
    """The kernel's bit planes hold each code's two bits, its N bit and
    its valid bit at pad + p (top bit first); the padding reads N."""
    import torch

    from biokanga_tpu_torch.ops import uhamming_sweep as us

    rng = np.random.default_rng(n)
    codes = rng.integers(-1, 6, n).astype(np.int8)
    valid = rng.random(n) < 0.7
    pad = us.plane_pad(24)
    planes = us.pack_planes(torch.from_numpy(codes), torch.from_numpy(valid),
                            pad).numpy()
    assert planes.shape == (4, (2 * pad + n + 31) // 32)
    bits = np.unpackbits(planes.astype(">u4").view(np.uint8),
                         axis=1).astype(bool)
    body = slice(pad, pad + n)
    is_n = (codes < 0) | (codes >= 4)
    np.testing.assert_array_equal(bits[2, body], is_n)
    np.testing.assert_array_equal(bits[3, body], valid)
    c = np.where(is_n, 0, codes)
    np.testing.assert_array_equal(bits[0, body], (c & 1).astype(bool))
    np.testing.assert_array_equal(bits[1, body], (c >> 1).astype(bool))
    outside = np.ones(bits.shape[1], bool)
    outside[body] = False
    assert bits[2, outside].all()
    assert not bits[[0, 1, 3]][:, outside].any()


def _palindrome_genome(K):
    """Three entries, the second shorter than K, with N runs, an exact
    repeat of the first window in the last entry and, at its end, a
    K-window that is its own reverse complement (the cross sweep's
    self-pair)."""
    rng = np.random.default_rng(K)
    n = 3 * K + 200
    g = rng.integers(0, 4, n).astype(np.int8)
    g[K + 60:K + 65] = 4
    g[2 * K + 150:2 * K + 160] = 4
    g[K + 140:2 * K + 140] = g[:K]
    half = rng.integers(0, 4, K // 2).astype(np.int8)
    g[n - K:] = np.concatenate([half, 3 - half[::-1]])
    return g, np.array([0, K + 100, K + 130, n])


@pytest.mark.parametrize("K", [32, 300])
@pytest.mark.parametrize("include_rc", [False, True])
def test_word_multiple_and_saturating_k_match_jax(K, include_rc):
    """K a multiple of the 32-position word, and K past 255, where the
    counts saturate; the cross sweep counts each unordered pair once
    (the palindrome's self-pair too), as the JAX sweep's every shift
    does."""
    g, starts = _palindrome_genome(K)
    want = juh.hamming_sweep(g, starts, K=K, include_rc=include_rc,
                             block=256)
    got = tuh.hamming_sweep(g, starts, K=K, include_rc=include_rc,
                            device="cpu")
    np.testing.assert_array_equal(got, want)
    assert (got[starts[1]:starts[2]] == tuh.H_INVALID).all()
    assert got[0] == 0
    assert (got[len(g) - K] == 0) == include_rc


def test_check_genome_of_the_card_check_matches_jax():
    """The pair-once cross sweep against the JAX sweep's every shift at
    the size the card check runs: chip_smoke.py phase 25's check genome
    (6,080 bases in three entries, one shorter than K, Ns, exact, near
    and reverse-complement repeats, a 300 bp palindrome), K 100, with the
    reverse complement."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("_chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    g, starts = cs._uh_check_genome()
    want = juh.hamming_sweep(g, starts, K=cs.UH_K, include_rc=True,
                             block=1024)
    got = tuh.hamming_sweep(g, starts, K=cs.UH_K, include_rc=True,
                            device="cpu")
    np.testing.assert_array_equal(got, want)
    at, ln = cs.UH_PALINDROME
    assert got[at + (ln - cs.UH_K) // 2] == 0
    assert got[200:401].max() == 0 and got[1_000:1_201].max() <= 3
