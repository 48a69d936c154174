"""Gather curve of one CUDA card: random 64-byte row gathers per second
against the table's size, through the port's checksum kernel
(biokanga_tpu_torch/ops/stream_gather.py over csrc/stream_gather.cu).

The counterpart of scripts/probe_stream_gather.py for the PyTorch port.
For each table size it asserts kernel == plain version bit for bit, on
random and on sorted indices, and prints the rows/s of

  random        the kernel on random indices
  sorted        the kernel on the same indices, sorted beforehand
  sort+sorted   the same with the time of `torch.sort` added
  index_select  `torch.index_select` of the rows alone (no checksum: the
                gather without its consumer, as context)

All times are CUDA-event means over `--iters` launches after a warm-up.
The default sweep puts the card's 50 MB L2 inside the range.  The last
line is one JSON object with every number and the card's name and power
limit.  Needs one card; exits non-zero without CUDA.

Usage: python scripts/probe_stream_gather_torch.py [--mb 128 ...]
           [--n 6291456] [--iters 10]
"""
from __future__ import annotations

import argparse
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


def probe_size(mb: float, n: int, device, iters: int = 10) -> dict:
    """One point of the curve; raises if the kernel and the plain version
    disagree."""
    import torch

    from biokanga_tpu_torch.ops.stream_gather import (
        stream_gather_consume,
        stream_gather_consume_plain,
    )

    table, idx = make_inputs(mb, n, device)
    want = int(stream_gather_consume_plain(table, idx))
    sidx = torch.sort(idx).values
    got = {"random": int(stream_gather_consume(table, idx)),
           "sorted": int(stream_gather_consume(table, sidx)),
           "sort_rows": int(stream_gather_consume(table, idx,
                                                  sort_rows=True))}
    if any(v != want for v in got.values()):
        raise AssertionError(f"{mb} MB: kernel {got} != plain {want}")
    idx64 = idx.to(torch.int64)
    ms = {
        "random": timed_ms(lambda: stream_gather_consume(table, idx), iters),
        "sorted": timed_ms(lambda: stream_gather_consume(table, sidx), iters),
        "sort": timed_ms(lambda: torch.sort(idx), iters),
        "index_select": timed_ms(
            lambda: torch.index_select(table, 0, idx64), iters),
    }
    ms["sort+sorted"] = ms["sort"] + ms["sorted"]
    res = {"mb": mb, "rows": table.shape[0], "n": n, "checksum": want,
           "ms": ms,
           "rows_per_s": {k: n / (v / 1e3) for k, v in ms.items()
                          if k != "sort"}}
    r = res["rows_per_s"]
    print(f"table {table.numel() * 4 / 1e6:8.1f} MB ({table.shape[0]:9d} "
          f"rows), {n} gathers, exact: random {r['random'] / 1e9:7.3f} "
          f"G rows/s ({ms['random']:.4f} ms), sorted "
          f"{r['sorted'] / 1e9:7.3f}, sort+sorted "
          f"{r['sort+sorted'] / 1e9:7.3f} (sort {ms['sort']:.4f} ms), "
          f"index_select {r['index_select'] / 1e9:7.3f}", flush=True)
    return res


def run(mbs, n: int, iters: int = 10) -> dict:
    """The curve over `mbs` on the current CUDA device."""
    import torch

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return {"card": smi, "n": n, "iters": iters,
            "sizes": [probe_size(mb, n, device, iters) for mb in mbs]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, nargs="+", default=list(DEFAULT_MB))
    ap.add_argument("--n", type=int, default=DEFAULT_N)
    ap.add_argument("--iters", type=int, default=10)
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe_stream_gather_torch: torch.cuda.is_available() is "
              "False", file=sys.stderr)
        return 1
    print(json.dumps(run(a.mb, a.n, a.iters)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
