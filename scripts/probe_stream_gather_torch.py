"""Gather curve of one CUDA card: random 64-byte row gathers per second
against the table's size, through the port's checksum kernel
(biokanga_tpu_torch/ops/stream_gather.py over csrc/stream_gather.cu).

The counterpart of scripts/probe_stream_gather.py for the PyTorch port.
For each table size it asserts kernel == plain version bit for bit, on
random and on sorted indices, and prints the regions the wrapper swept
the table in (`gather_plan`), the bound (each distinct row, each index
and the sum once: `distinct x 64 + n x 4 + 4` bytes at 3.35 TB/s, or
the checksum's int32 operations; chip_smoke.py's rates), the kernel's
share of it, the floor of a gather in index order (the indices and, of
the n rows, the share L2 does not hold, from device memory) and the
rows/s of

  random        the kernel on random indices
  sorted        the kernel on the same indices, sorted beforehand
  sort+sorted   the same with the time of `torch.sort` added
  index_select  `torch.index_select` of the rows alone (no checksum: the
                gather without its consumer, as context)

With --root DIR (repeatable; a directory holding another
`biokanga_tpu_torch`, e.g. an older commit unpacked with `git archive`),
each root's wrapper is loaded as a package of its own, checked on the
same random indices and timed beside this tree's in turns: the roots in
order, this tree twice, the roots in reverse (old, new, new, old).

All times are CUDA-event means over `--iters` launches after a warm-up.
The default sweep puts the card's 50 MB L2 inside the range.  The last
line is one JSON object with every number and the card's name and power
limit.  Needs one card; exits non-zero without CUDA.

Usage: python scripts/probe_stream_gather_torch.py [--mb 128 ...]
           [--n 6291456] [--iters 10] [--root DIR ...]
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEFAULT_MB = (2.3, 16.0, 40.0, 64.0, 128.0, 512.0, 2048.0)
DEFAULT_N = 6_291_456


def make_inputs(mb: float, n: int, device, seed: int = 0):
    """(table (R, 16) int32 bits, idx (n,) int32) of a `mb` MB table, from
    numpy's generator as scripts/probe_stream_gather.py draws them."""
    import numpy as np
    import torch

    from biokanga_tpu_torch.device import u32_from_numpy

    R = int(mb * 1e6 / 64)
    rng = np.random.default_rng(seed)
    table = u32_from_numpy(
        rng.integers(0, 2**32, size=(R, 16), dtype=np.uint32), device)
    idx = torch.from_numpy(rng.integers(0, R, size=n, dtype=np.int32))
    return table, idx.to(device)


def timed_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def load_root(root: str, tag: str):
    """The `ops.stream_gather` module of the `biokanga_tpu_torch` under
    `root`, imported as a package of its own name (its kernels build into
    its own `build/`)."""
    pkg = os.path.join(os.path.abspath(root), "biokanga_tpu_torch")
    name = f"_gather_root_{tag}"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.stream_gather")


def bounds(n: int, distinct: int, table_bytes: int, l2: int) -> dict:
    """The least time of the function (bytes or operations) and the floor
    of a gather in index order, in ms on one H100."""
    from chip_smoke import (GATHER_OPS_PER_WORD, HBM_BYTES_PER_S,
                            INT32_OPS_PER_S)

    by_bytes = (distinct * 64 + n * 4 + 4) / HBM_BYTES_PER_S * 1e3
    by_ops = n * 16 * GATHER_OPS_PER_WORD / INT32_OPS_PER_S * 1e3
    missed = max(0.0, 1.0 - l2 / table_bytes)
    floor = max(distinct * 64 + n * 4 + 4, n * 4 + n * 64 * missed)
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "direct_floor_ms": floor / HBM_BYTES_PER_S * 1e3}


def probe_size(mb: float, n: int, device, iters: int = 10,
               others=()) -> dict:
    """One point of the curve; raises if a kernel and the plain version
    disagree.  `others`: (label, stream_gather module) of other trees,
    timed beside this one in turns."""
    import torch

    from biokanga_tpu_torch.ops import stream_gather as sg

    table, idx = make_inputs(mb, n, device)
    want = int(sg.stream_gather_consume_plain(table, idx))
    sidx = torch.sort(idx).values
    got = {"random": int(sg.stream_gather_consume(table, idx))}
    regions = sg.stream_gather_consume.last_regions
    got["sorted"] = int(sg.stream_gather_consume(table, sidx))
    got["sort_rows"] = int(sg.stream_gather_consume(table, idx,
                                                    sort_rows=True))
    for label, mod in others:
        got[label] = int(mod.stream_gather_consume(table, idx))
    if any(v != want for v in got.values()):
        raise AssertionError(f"{mb} MB: kernel {got} != plain {want}")
    idx64 = idx.to(torch.int64)
    ms = {
        "random": timed_ms(lambda: sg.stream_gather_consume(table, idx),
                           iters),
        "sorted": timed_ms(lambda: sg.stream_gather_consume(table, sidx),
                           iters),
        "sort": timed_ms(lambda: torch.sort(idx), iters),
        "index_select": timed_ms(
            lambda: torch.index_select(table, 0, idx64), iters),
    }
    ms["sort+sorted"] = ms["sort"] + ms["sorted"]
    versions = [*others, ("this tree", sg)]
    order = []
    if others:
        order = (list(range(len(others))) + [len(others)] * 2
                 + list(reversed(range(len(others)))))
    turns = {label: [] for label, _ in versions}
    for k in order:
        label, mod = versions[k]
        turns[label].append(timed_ms(
            lambda: mod.stream_gather_consume(table, idx), iters))
    distinct = int(torch.unique(idx).numel())
    b = bounds(n, distinct, table.numel() * 4, sg.l2_bytes(table.device))
    res = {"mb": mb, "rows": table.shape[0], "n": n, "checksum": want,
           "regions": regions, "distinct": distinct, **b,
           "share": b["bound_ms"] / ms["random"], "ms": ms, "turns": turns,
           "rows_per_s": {k: n / (v / 1e3) for k, v in ms.items()
                          if k != "sort"}}
    r = res["rows_per_s"]
    print(f"table {table.numel() * 4 / 1e6:8.1f} MB ({table.shape[0]:9d} "
          f"rows), {n} gathers of {distinct} distinct rows, exact; "
          f"{regions} region(s): random {r['random'] / 1e9:7.3f} G rows/s "
          f"({ms['random']:.4f} ms; bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}), share {res['share']:.3f}; in index order "
          f"{b['direct_floor_ms']:.4f} ms at best), sorted "
          f"{r['sorted'] / 1e9:7.3f}, sort+sorted "
          f"{r['sort+sorted'] / 1e9:7.3f} (sort {ms['sort']:.4f} ms), "
          f"index_select {r['index_select'] / 1e9:7.3f}", flush=True)
    if others:
        print("  turns (ms): " + "; ".join(
            f"{k} {' / '.join(f'{t:.4f}' for t in v)}"
            for k, v in turns.items()), flush=True)
    return res


def run(mbs, n: int, iters: int = 10, roots=()) -> dict:
    """The curve over `mbs` on the current CUDA device."""
    import torch

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    others = [(root, load_root(root, str(k))) for k, root in enumerate(roots)]
    return {"card": smi, "n": n, "iters": iters, "roots": list(roots),
            "sizes": [probe_size(mb, n, device, iters, others)
                      for mb in mbs]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, nargs="+", default=list(DEFAULT_MB))
    ap.add_argument("--n", type=int, default=DEFAULT_N)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--root", action="append", default=[],
                    help="another tree to time beside this one")
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe_stream_gather_torch: torch.cuda.is_available() is "
              "False", file=sys.stderr)
        return 1
    print(json.dumps(run(a.mb, a.n, a.iters, a.root)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
