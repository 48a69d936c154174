"""The port's `utils/stats.py` and GO tools against the JAX package.

Each statistics function is called by both packages on the same seeded
inputs and must return the same values; `goenrichment` and `goassoc` run
through both CLIs on a small GO DAG (is_a and part_of parents, an
obsolete term, a NOT row, genes off the DAG) and their files and stdout
lines compare equal (tests/cli_parity.py)."""
import numpy as np
import pytest

from biokanga_tpu.utils import stats as jax_stats
from biokanga_tpu_torch.utils import stats as torch_stats
from cli_parity import check_subcommand


def _stat_args(name, rng):
    """Seeded argument tuples for one statistics function."""
    if name == "fishers_exact_test":
        return [tuple(int(v) for v in rng.integers(0, 40, 4))
                for _ in range(12)] + [(3, 1, 1, 3), (10, 0, 0, 10)]
    if name == "chisqr_pval":
        return [(int(df), float(x)) for df, x in
                zip(rng.integers(1, 6, 10), rng.uniform(-1, 20, 10))]
    if name == "calc_chisqr":
        return [(rng.integers(0, 60, (r, c)),) for r, c in
                ((2, 2), (2, 3), (3, 4), (2, 2))] + [
            (np.array([[1, 2], [3, 4]]),), (np.zeros((2, 2)),)]
    if name == "calc_nck":
        return [(int(n), int(k)) for n, k in
                zip(rng.integers(0, 60, 10), rng.integers(-2, 62, 10))]
    if name == "prob_k_eql_k":
        return [(int(n), int(k), float(p)) for n, k, p in
                zip(rng.integers(1, 80, 10), rng.integers(0, 80, 10),
                    rng.uniform(0, 1, 10))]
    if name == "binomial":
        n = rng.integers(1, 200, 50)
        return [(n, rng.integers(0, 200, 50), rng.uniform(0, 1, 50)),
                (10, 10, 0.5), (7, 3, 0.2)]
    assert name == "benjamini_hochberg"
    return [(rng.uniform(0, 1, 40),), (np.array([0.01, 0.02, 0.5]),),
            (np.array([0.3, 0.3, 0.01, 0.3]),), (np.zeros(0),)]


@pytest.mark.parametrize("name", [
    "fishers_exact_test", "chisqr_pval", "calc_chisqr", "calc_nck",
    "prob_k_eql_k", "binomial", "benjamini_hochberg"])
def test_stats_function_matches_jax(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    for args in _stat_args(name, rng):
        want = getattr(jax_stats, name)(*args)
        got = getattr(torch_stats, name)(*args)
        assert type(got) is type(want), args
        np.testing.assert_array_equal(got, want, err_msg=str(args))


@pytest.fixture(scope="module")
def go_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("go_in")
    (d / "go.obo").write_text(
        "format-version: 1.2\n\n"
        "[Term]\nid: GO:0000001\nname: root\nnamespace: biological_process\n\n"
        "[Term]\nid: GO:0000002\nname: child\n"
        "namespace: biological_process\nis_a: GO:0000001 ! root\n\n"
        "[Term]\nid: GO:0000003\nname: other\n"
        "namespace: biological_process\nis_a: GO:0000001 ! root\n\n"
        "[Term]\nid: GO:0000004\nname: part\nnamespace: cellular_component\n"
        "relationship: part_of GO:0000002 ! child\n\n"
        "[Term]\nid: GO:0000005\nname: gone\n"
        "namespace: biological_process\nis_obsolete: true\n\n"
        "[Typedef]\nid: part_of\nname: part of\n")
    rows = []

    def gaf(gene, goid, qual=""):
        rows.append(f"DB\t{gene}id\t{gene}\t{qual}\t{goid}\tref\tIEA\t\tP\t\t"
                    f"\tprotein\ttaxon:9606\t20240101\tDB\n")

    for g in ("g1", "g2", "g3", "g4"):
        gaf(g, "GO:0000002")
    for g in ("g1", "g2", "g11"):
        gaf(g, "GO:0000004")
    for g in ("g5", "g6", "g7", "g8", "g9", "g10"):
        gaf(g, "GO:0000003")
    gaf("g5", "GO:0000002", "NOT")
    gaf("g12", "GO:0009999")        # a term off the DAG
    gaf("g6", "GO:0000005")
    (d / "assoc.gaf").write_text("!gaf-version: 2.1\n" + "".join(rows))
    (d / "study.txt").write_text("g1\ng2\ng3\ng4\ng4\ng11\nnotagene\n")
    (d / "pop.txt").write_text("".join(f"g{i}\n" for i in range(1, 13)))
    (d / "empty.txt").write_text("nobody\n")
    return d


CASES = [
    ("goenrichment", ["goenrichment", "-i", "{i}/study.txt", "-I",
                      "{i}/pop.txt", "-b", "{i}/go.obo", "-a",
                      "{i}/assoc.gaf", "-o", "o.csv"]),
    ("goenrichment-min1", ["goenrichment", "-i", "{i}/study.txt", "-I",
                           "{i}/pop.txt", "-b", "{i}/go.obo", "-a",
                           "{i}/assoc.gaf", "-o", "o.csv", "-n", "1"]),
    ("goenrichment-empty", ["goenrichment", "-i", "{i}/empty.txt", "-I",
                            "{i}/pop.txt", "-b", "{i}/go.obo", "-a",
                            "{i}/assoc.gaf", "-o", "o.csv"]),
    ("goassoc", ["goassoc", "-b", "{i}/go.obo", "-a", "{i}/assoc.gaf",
                 "-o", "o.csv"]),
]


@pytest.mark.parametrize("case,argv", CASES, ids=[c[0] for c in CASES])
def test_go_subcommand_matches_jax_cli(go_inputs, tmp_path, capsys,
                                       monkeypatch, case, argv):
    argv = [a.replace("{i}", str(go_inputs)) for a in argv]
    out, names = check_subcommand(tmp_path, argv, capsys, monkeypatch)
    assert names == ["o.csv"]
    if case == "goenrichment":
        assert '"GO:0000002"' in (tmp_path / "torch" / "o.csv").read_text()
