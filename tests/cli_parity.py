"""Run one subcommand through the JAX CLI and the port's CLI and compare
what each wrote.

Each CLI runs in a working directory of its own and is given its outputs
as relative paths, so the two runs see the same argv and print the same
line.  Files compare byte for byte, with two exceptions: `.npz` files
(numpy's zip members carry the time they were written) compare array by
array, and SQLite files compare table by table, row by row, outside the
time columns (`Started`, `Finished` and the `seconds` result of a `-q`
row).
"""
from __future__ import annotations

import sqlite3
from pathlib import Path

import numpy as np

from biokanga_tpu.cli import main as jax_main
from biokanga_tpu_torch.cli import main as torch_main

TIME_COLUMNS = ("Started", "Finished")


def run_both(base: Path, argv: list[str], capsys, monkeypatch,
             make_dirs=(), torch_extra=()) -> tuple[Path, Path, str, str]:
    """Run `argv` through both CLIs in base/jax and base/torch (created
    here, with `make_dirs` inside each); the port also gets
    `torch_extra`.  Returns the two directories and the two stdouts."""
    outs = []
    for name, main, extra in (("jax", jax_main, ()),
                              ("torch", torch_main, tuple(torch_extra))):
        d = base / name
        d.mkdir(parents=True)
        for sub in make_dirs:
            (d / sub).mkdir(parents=True)
        monkeypatch.chdir(d)
        capsys.readouterr()
        assert main(list(argv) + list(extra)) == 0, name
        outs.append(capsys.readouterr().out)
    return base / "jax", base / "torch", outs[0], outs[1]


def _files(d: Path) -> list[str]:
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def sqlite_rows(path: Path) -> dict:
    """{table: rows} outside the time columns."""
    con = sqlite3.connect(str(path))
    out = {}
    tables = [r[0] for r in con.execute(
        "SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")]
    for t in tables:
        cols = [r[1] for r in con.execute(f'PRAGMA table_info("{t}")')]
        keep = [c for c in cols if c not in TIME_COLUMNS]
        rows = con.execute(
            "SELECT " + ",".join(f'"{c}"' for c in keep) + f' FROM "{t}"'
        ).fetchall()
        if t == "TblResults":
            i, j = keep.index("ResultName"), keep.index("ResultValue")
            rows = [tuple(None if (k == j and r[i] == "seconds") else v
                          for k, v in enumerate(r)) for r in rows]
        out[t] = (keep, rows)
    con.close()
    return out


def assert_same_file(a: Path, b: Path) -> None:
    ba, bb = a.read_bytes(), b.read_bytes()
    if ba.startswith(b"SQLite format 3\0"):
        assert sqlite_rows(a) == sqlite_rows(b), a.name
    elif a.name.endswith(".npz"):
        za, zb = np.load(str(a)), np.load(str(b))
        assert sorted(za.files) == sorted(zb.files), a.name
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, (a.name, k)
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    else:
        assert ba == bb, a.name


def assert_same_outputs(dj: Path, dt: Path) -> list[str]:
    """Every file under dj equals its namesake under dt, and no file is
    missing on either side.  Returns the relative names compared."""
    names = _files(dj)
    assert names == _files(dt)
    assert names, "the subcommand wrote nothing"
    for n in names:
        assert_same_file(dj / n, dt / n)
    return names


def check_subcommand(base: Path, argv, capsys, monkeypatch, make_dirs=(),
                     torch_extra=()) -> tuple[str, list[str]]:
    """run_both, then the files and the stdout line compare equal."""
    dj, dt, oj, ot = run_both(base, argv, capsys, monkeypatch, make_dirs,
                              torch_extra)
    names = assert_same_outputs(dj, dt)
    assert oj == ot
    return oj, names
