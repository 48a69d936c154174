"""Read a torch.profiler Chrome trace into the numbers the per-layer
metrics take.

- The window is the host range named `bench.window`; device activity
  (kernels, copies, sets) is clipped to it, and its union is the busy
  time: overlapping events count once.
- Host ranges (`record_function`) are summed by name over the window.
- A kernel belongs to a group when the host call that launched it (the
  runtime or driver launch with its correlation id) lies inside a host
  range named `bench.kernel.<group>`; PyTorch's own kernels there (the
  copies a wrapper makes) are left out of the group.
- An idle gap is an interval of the window in which nothing ran on the
  device; it is labelled by the innermost `pe.*` range that the host
  was in at its middle, or `outside_pe` where none.
"""
from __future__ import annotations

import json
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
WINDOW = "bench.window"
GROUP_PREFIX = "bench.kernel."
HOST_PREFIX = "pe."
TORCH_KERNEL_MARKS = ("at::native", "at::cuda", "Memcpy", "Memset")
TOP = 10


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    host_s: dict = field(default_factory=dict)       # range name -> s
    host_calls: dict = field(default_factory=dict)   # range name -> count
    group_s: dict = field(default_factory=dict)      # kernel group -> s
    group_kernels: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)   # [[name, s]], top 10
    idle_gaps: list = field(default_factory=list)    # [[label, s]], top 10
    cats: dict = field(default_factory=dict)         # event count a cat


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(ranges, t):
    """Name of the shortest range of [(start, end, name)] holding t."""
    best = None
    for a, b, name in ranges:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return None if best is None else best[2]


def summarize(events: list) -> TraceSummary:
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    cats = defaultdict(int)
    for e in xs:
        cats[e.get("cat", "")] += 1
    notes = [e for e in xs if e.get("cat") == "user_annotation"]
    win = [e for e in notes if e["name"] == WINDOW]
    if len(win) != 1:
        raise ValueError(f"want one {WINDOW} range, found {len(win)}")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    host_tid = win[0].get("tid")

    device = []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, b = max(a, w0), min(b, w1)
        if b > a:
            device.append((a, b, e))
    busy = _union([(a, b) for a, b, _ in device])
    busy_us = sum(b - a for a, b in busy)

    op_s = defaultdict(float)
    for a, b, e in device:
        op_s[e["name"][:96]] += (b - a) / 1e6
    device_ops = sorted(([k, v] for k, v in op_s.items()),
                        key=lambda kv: -kv[1])[:TOP]

    host_s, host_calls = defaultdict(float), defaultdict(int)
    host_ranges = []
    for e in notes:
        a = float(e["ts"])
        if not (w0 <= a <= w1) or e["name"] == WINDOW:
            continue
        host_s[e["name"]] += float(e["dur"]) / 1e6
        host_calls[e["name"]] += 1
        if e["name"].startswith(HOST_PREFIX) and e.get("tid") == host_tid:
            host_ranges.append((a, a + float(e["dur"]), e["name"]))

    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_innermost(host_ranges, (a + b) / 2) or "outside_pe",
             (b - a) / 1e6] for a, b in gaps[:TOP]]

    # kernels of each bench.kernel.<group> range, by correlation id
    launches = {}
    for e in xs:
        if e.get("cat") in LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launches[c] = (e.get("tid"), float(e["ts"]))
    group_ranges = defaultdict(list)
    for e in notes:
        if e["name"].startswith(GROUP_PREFIX):
            group_ranges[e.get("tid")].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e["name"][len(GROUP_PREFIX):]))
    for rs in group_ranges.values():
        rs.sort()
    starts = {tid: [r[0] for r in rs] for tid, rs in group_ranges.items()}
    group_s, group_kernels = defaultdict(float), defaultdict(int)
    for a, b, e in device:
        if e.get("cat") != "kernel" or any(
                m in e["name"] for m in TORCH_KERNEL_MARKS):
            continue
        c = e.get("args", {}).get("correlation")
        if c not in launches:
            continue
        tid, ts = launches[c]
        rs = group_ranges.get(tid)
        if not rs:
            continue
        i = bisect_right(starts[tid], ts) - 1
        if i >= 0 and rs[i][0] <= ts <= rs[i][1]:
            group_s[rs[i][2]] += (b - a) / 1e6
            group_kernels[rs[i][2]] += 1
    return TraceSummary(
        window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
        host_s=dict(host_s), host_calls=dict(host_calls),
        group_s=dict(group_s), group_kernels=dict(group_kernels),
        device_ops=device_ops, idle_gaps=idle, cats=dict(cats))


def read_trace(path) -> TraceSummary:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return summarize(events)
