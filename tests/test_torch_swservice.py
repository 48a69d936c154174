"""The port's SW service: ops/sw.banded_sw_batch, parallel/swservice.py
run_sw_jobs and the `swservice` subcommand, against the JAX package's.

Pairs come from a numpy seed and are rich in ties: tandem repeats of
1-4 base units (many cells reach the best score), beside noisy copies
and unrelated pairs, ragged lengths, diagonals of both signs and Ns.
The port's ranks are gloo processes on the CPU (tests/torch_dist_ranks.py);
the JAX package runs on the conftest's 8 virtual CPU devices.  Scores,
best cells and move codes must be equal, exactly; the CSV byte for byte.
"""
import numpy as np
import pytest
import torch

from biokanga_tpu.cli import main as jax_main
from biokanga_tpu.ops.sw import banded_sw_batch as jax_banded_sw_batch
from biokanga_tpu.parallel.swservice import SWJobBatch as JaxJobs
from biokanga_tpu.parallel.swservice import make_sw_mesh as jax_sw_mesh
from biokanga_tpu.parallel.swservice import run_sw_jobs as jax_run_sw_jobs
from biokanga_tpu_torch.cli import main as port_main
from biokanga_tpu_torch.ops.sw import banded_sw_batch, banded_sw_batch_plain
from biokanga_tpu_torch.parallel.swservice import SWJobBatch
from biokanga_tpu_torch.seq.fasta import write_fasta
from sw_edge_cases import tie_rich_pairs
from torch_dist_ranks import load, spawn, sw_job_ranks

torch.set_num_threads(2)


@pytest.mark.parametrize("W", [2, 8, 24])
def test_banded_sw_batch_plain_equals_jax(W):
    a, b, alen, blen, diag = tie_rich_pairs(W, 30, 120)
    want = [np.asarray(x) for x in jax_banded_sw_batch(
        a, b, alen, blen, diag, W, a.shape[1], b.shape[1])]
    args = [torch.from_numpy(x) for x in (a, b, alen, blen, diag)]
    got = banded_sw_batch_plain(*args, W, moves=True)
    for g, w, name in zip(got, want, ("best", "best_i", "best_k", "moves")):
        assert g.dtype == {"moves": torch.uint8}.get(name, torch.int32)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert (want[0][::3] > 40).all()            # the repeats score high
    # the wrapper takes the plain version for CPU tensors; without moves
    # it returns None in their place
    best, bi, bk, mv = banded_sw_batch(*args, W)
    assert mv is None
    np.testing.assert_array_equal(bk.numpy(), want[2])


def test_run_sw_jobs_two_ranks_equals_jax(tmp_path):
    a, b, alen, blen, diag = tie_rich_pairs(7, 13, 90)   # 13: odd count
    W = 16
    spawn(sw_job_ranks, 2, str(tmp_path), SWJobBatch(a, b, alen, blen, diag),
          W)
    got = load(str(tmp_path), "sw_jobs")
    want = jax_run_sw_jobs(jax_sw_mesh(8), JaxJobs(a, b, alen, blen, diag), W,
                           return_moves=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    d = tmp_path_factory.mktemp("swservice")
    a, b, alen, blen, _ = tie_rich_pairs(11, 6, 150)
    write_fasta(str(d / "p.fa"), ((f"probe{i}", a[i, :alen[i]])
                                  for i in range(6)))
    write_fasta(str(d / "t.fa"), ((f"targ{i}", b[i, :blen[i]])
                                  for i in range(6)))
    return d


@pytest.mark.parametrize("pairs,n", [("zip", 1), ("zip", 2), ("cross", 1),
                                     ("cross", 2)])
def test_swservice_csv_is_byte_identical_to_jax_cli(fastas, pairs, n,
                                                    monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    common = ["-a", str(fastas / "p.fa"), "-b", str(fastas / "t.fa"),
              "--pairs", pairs, "--sw-band", "20", "-n", str(n)]
    want = fastas / f"jax_{pairs}_{n}.csv"
    got = fastas / f"port_{pairs}_{n}.csv"
    assert jax_main(["swservice", "-o", str(want), *common]) == 0
    assert port_main(["swservice", "-o", str(got), *common,
                      "--device", "cpu"]) == 0
    assert got.read_bytes() == want.read_bytes()
    assert len(got.read_text().splitlines()) == 1 + (6 if pairs == "zip"
                                                     else 36)
