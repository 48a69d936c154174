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
