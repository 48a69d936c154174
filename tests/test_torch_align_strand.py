"""The port's SE align engine against the JAX AlignEngine, one strand.

Same inputs and rules as tests/test_torch_align.py, with `-Q sense` and
`-Q antisense`; every RESULT_KEYS and ladder field must be equal.
"""
import numpy as np
import pytest
import torch

from biokanga_tpu.align.params import AlignParams
from biokanga_tpu.align.pipeline import AlignEngine as JaxEngine
from biokanga_tpu_torch.align.pipeline import AlignEngine
from torch_align_data import assert_equal, build_setup, run_with_rescue

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    return build_setup()


@pytest.mark.parametrize("strand,fast_pass,source", [
    ("sense", True, "from_arrays"),
    ("antisense", False, "to_device"),
])
def test_single_strand_matches_jax(setup, strand, fast_pass, source):
    want = run_with_rescue(setup, strand, fast_pass, source)
    assert want["unique"].sum() > 20
    assert want["is_rc"].all() if strand == "antisense" else \
        not want["is_rc"].any()


def test_long_reads_are_refused(setup):
    """Reads past the packed extension's 4,096 bases are no longer
    refused: they take the dense extension, with the JAX engine's result
    (one strand each; two reads from the genome, one of N)."""
    jd, indexes, _, _ = setup
    g = indexes["to_device"].genome.numpy()
    reads = np.stack([g[10_000:14_097], g[70_000:74_097],
                      np.full(4_097, 4, np.int8)])
    lengths = np.full(3, 4_097, np.int32)
    for strand in ("sense", "antisense"):
        ap = AlignParams(strand=strand)
        want = JaxEngine(jd, ap).align_batch(reads, lengths)
        got = AlignEngine(indexes["to_device"], ap).align_batch(reads,
                                                                lengths)
        assert_equal(got, want)
    assert (want["unique"] == [False, False, False]).all()
    sense = JaxEngine(jd, AlignParams(strand="sense")).align_batch(
        reads, lengths)
    assert sense["unique"][:2].all() and sense["locus"][1] == 70_000
