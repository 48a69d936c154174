"""Run one cell of the benchmark and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (process start to the first timed
batch) builds everything the cell needs from the seed; --trace 0 then
measures the window for --seconds and reports the cell's end-to-end
metrics, --trace 1 traces a fixed number of batches and reports its
per-layer metrics.  Either way the sampled outputs are judged against the
plain reference once the window has closed and the program's state is
freed; each number compared is printed beside its limit as the last lines
of standard error and under "checks", last in the result line.  The last
line of standard output is the result, one JSON object.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, and when jax, jaxlib, flax or biokanga_tpu was loaded.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "biokanga_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card(device) -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(bench, cell: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float, parts: dict | None = None) -> dict:
    """Set up, measure, free, judge.  Returns the result object; `parts`
    are set-up stages timed before the call, reported with the others."""
    import torch

    cuda = device.type == "cuda"
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    driver = bench.driver(traffic["driver"])
    sut = driver(config, traffic, bench.generator(traffic["generator"]),
                 seed, device)
    setup_s = time.monotonic() - t_start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace:
        got = sut.traced(int(traffic["trace_batches"]))
    else:
        got = sut.window(seconds)
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated(device))
    sut.close()
    t = time.monotonic()
    judged = sut.check()
    parts = {**(parts or {}), **sut.parts, "setup_s": setup_s,
             "check_s": time.monotonic() - t}

    metrics = {}
    if trace:
        ctx = dict(got)
        for m in bench.per_layer(cell["name"]):
            v = bench.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {**got, "setup_s": setup_s}
        for m in bench.end_to_end(cell["name"]):
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else
           device.type, "count": int(cell["chips"]),
           "memory_peak_bytes": int(peak)}
    result = {"correct": None, "attempted": int(got["mates"]),
              "failed": int(sut.failed), "metrics": metrics, "device": dev}
    if trace:
        t = got["trace"]
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": t.device_ops,
                               "idle_gaps": t.idle_gaps}
    result["card"] = card(device) if cuda else device.type
    result["timing"] = parts
    if trace:
        t = got["trace"]
        result["trace"] = {"cats": t.cats, "host_calls": t.host_calls,
                           "group_kernels": t.group_kernels,
                           "group_s": t.group_s, "counts": got["counts"]}
    g = judged["guarantee"]
    result["guarantee"] = {"max_mm": g.max_mm, "best_mm": g.best_mm,
                           "multi_mm": g.multi_mm,
                           "pairs_past_guarantee":
                           judged["pairs_past_guarantee"]}
    checks = {
        "wrong_mates": {"value": judged["wrong_mates"], "rule": "<=",
                        "limit": 0},
        "wrong_pairs": {"value": judged["wrong_pairs"], "rule": "<=",
                        "limit": 0},
        "checked_pairs": {"value": judged["checked_pairs"], "rule": ">=",
                          "limit": 1},
    }
    result["correct"] = result["failed"] == 0 and all(
        c["value"] <= c["limit"] if c["rule"] == "<=" else
        c["value"] >= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from .spec import ROOT, Bench

    bench = Bench(ROOT)
    try:
        cell = bench.workload(args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")

    t = time.monotonic()
    import torch

    parts = {"import_s": time.monotonic() - t}
    need = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    t = time.monotonic()
    torch.cuda.init()
    parts["cuda_init_s"] = time.monotonic() - t
    result = run_cell(bench, cell, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), T_START,
                      parts)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    print(f"card: {result['card']}", file=sys.stderr)
    print(f"timing: {json.dumps(result['timing'])}", file=sys.stderr)
    if "trace" in result:
        print(f"trace: {json.dumps(result['trace'])}", file=sys.stderr)
    print(f"guarantee: {json.dumps(result['guarantee'])}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} {c['rule']} {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
