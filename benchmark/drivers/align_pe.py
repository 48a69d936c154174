"""The paired-end aligner as `biokanga_tpu_torch align -u` drives it.

Set-up makes the genome on the device from the seed, builds the index on
the device (`index/device_build.device_build_index`), makes the pool of
read pairs in host memory with the traffic's generator, and warms up the
loop on the pool's first batches.

The window runs the CLI's paired-end loop (`cli._align_pairs`): one batch
in flight, `PEAligner.launch_pairs` of batch k + 1 enqueued before
`finish_pairs` of batch k, from reads as int8 codes in host memory to
the host result of both mates with the pair flags.  It cycles the pool
until the window's seconds have passed; the program keeps nothing
between batches.  From each finished batch the harness copies the rows
of a sample of pairs drawn from the seed, and the check judges them
against the reference (benchmark/reference) once the window has closed.
"""
from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from ..genome import SEED_MASK, make_genome
from ..reference.aligner import build_seed_index, find_hits
from ..reference.guarantee import guarantee
from ..reference.judge import FIELDS, control_output, judge
from ..roofline import (bound_s, extend_counts, sort2_rows_counts,
                        sort_rows_counts)
from ..trace import GROUP_PREFIX, WINDOW, read_trace

DRIVER = "AlignPE"
SAMPLE_STREAM = 0x5A4D_0002     # the sample's stream of the run's seed
WARMUP_BATCHES = 3
# (program module, attribute) -> kernel group, wrapped in a traced run
KERNEL_ENTRIES = (
    ("biokanga_tpu_torch.align.pipeline", "sort_rows", "sort_rows"),
    ("biokanga_tpu_torch.align.pipeline", "sort2_rows", "sort2_rows"),
    ("biokanga_tpu_torch.align.pipeline", "hamming_extend_packed", "extend"),
    ("biokanga_tpu_torch.align.pe", "hamming_extend_packed", "extend"),
)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counts(group, args):
    """(bytes, operations) of one kernel call from its arguments."""
    if group == "sort_rows":
        return sort_rows_counts(*args[0].shape)
    if group == "sort2_rows":
        return sort2_rows_counts(*args[0].shape)
    pg, starts, loci, valid, rcodes, _, lengths = args
    return extend_counts(pg.length, pg.n_rows is not None, starts, loci,
                         valid, lengths, rcodes.shape[1])


def draw_sample(seed: int, pool_pairs: int, sample_pairs: int) -> np.ndarray:
    """The sorted pool indices of the pairs the check judges."""
    rng = np.random.default_rng([int(seed) & SEED_MASK, SAMPLE_STREAM])
    return np.sort(rng.choice(pool_pairs, size=min(sample_pairs, pool_pairs),
                              replace=False))


class _Wrapped:
    """Replace the kernel entry points the program calls with wrappers:
    a `bench.kernel.<group>` host range around each call (mode "range"),
    or each call's byte and operation counts (mode "count")."""

    def __init__(self, mode: str):
        import importlib

        from torch.profiler import record_function

        self.saved = []
        self.counts = {}
        for mod_name, attr, group in KERNEL_ENTRIES:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr, None)
            if fn is None:
                continue
            self.saved.append((mod, attr, fn))
            if mode == "range":
                def wrapped(*a, _fn=fn, _g=group, **k):
                    with record_function(GROUP_PREFIX + _g):
                        return _fn(*a, **k)
            else:
                def wrapped(*a, _fn=fn, _g=group, **k):
                    nb, ops = _counts(_g, a)
                    c = self.counts.setdefault(
                        _g, {"bytes": 0, "ops": 0, "bound_s": 0.0,
                             "calls": 0})
                    c["bytes"] += nb
                    c["ops"] += ops
                    c["bound_s"] += bound_s(nb, ops)
                    c["calls"] += 1
                    return _fn(*a, **k)
            setattr(mod, attr, wrapped)

    def close(self):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)


class AlignPE:
    def __init__(self, config: dict, traffic: dict, generator, seed: int,
                 device: torch.device):
        from biokanga_tpu_torch.align.params import AlignParams, Sensitivity
        from biokanga_tpu_torch.align.pe import PEAligner, PEParams
        from biokanga_tpu_torch.align.pipeline import AlignEngine
        from biokanga_tpu_torch.index.device_build import device_build_index

        self.device = device
        self.config, self.traffic = config, traffic
        self.parts = {}
        t = time.perf_counter()
        codes, self.starts = make_genome(config["entries"], seed, device)
        self.genome = codes.cpu().numpy()
        del codes
        self.parts["genome_s"] = time.perf_counter() - t
        t = time.perf_counter()
        didx = device_build_index(self.genome, self.starts,
                                  int(config["lut_bases"]), device=device)
        _sync(device)
        self.parts["index_s"] = time.perf_counter() - t
        a = config["align"]
        self.params = AlignParams(
            max_subs_per100=int(a["subs_per100"]),
            min_edit_dist=int(a["min_edit_dist"]),
            max_multi=int(a["max_multi"]), mode=Sensitivity(a["mode"]),
            strand=a["strand"])
        self.pe = PEAligner(AlignEngine(didx, self.params), PEParams(
            pair_min_len=int(traffic["pair_min_len"]),
            pair_max_len=int(traffic["pair_max_len"])))
        t = time.perf_counter()
        pool = generator.make_pool(self.genome, self.starts, traffic, seed)
        self.parts["pool_s"] = time.perf_counter() - t
        self.reads1, self.reads2 = pool["reads1"], pool["reads2"]
        self.lengths = pool["lengths"]
        P = len(self.reads1)
        self.B = int(traffic["batch_pairs"])
        if P % self.B:
            raise ValueError(f"pool of {P} pairs is not whole batches of "
                             f"{self.B}")
        self.n_batches = P // self.B
        self.ln = self.lengths[: self.B]
        self.sample = draw_sample(seed, P, int(traffic["sample_pairs"]))
        bounds = np.searchsorted(self.sample,
                                 np.arange(self.n_batches + 1) * self.B)
        self.sample_of = [np.arange(bounds[b], bounds[b + 1])
                          for b in range(self.n_batches)]
        self.rows_of = [self.sample[s] - b * self.B
                        for b, s in enumerate(self.sample_of)]
        self._reset_sample()
        self.failed = 0
        t = time.perf_counter()
        self._run(min(WARMUP_BATCHES, self.n_batches))
        _sync(device)
        self.parts["warmup_s"] = time.perf_counter() - t
        self._reset_sample()

    def _reset_sample(self):
        S = len(self.sample)
        K = max(1, self.params.max_multi)
        self.got = {}
        for m in (1, 2):
            for f in FIELDS:
                shape = (S, K) if f.startswith("ml_") else (S,)
                dtype = bool if f in ("unique", "any_hit", "is_rc", "ml_rc") \
                    else np.int64
                self.got[(m, f)] = np.zeros(shape, dtype)
        self.got["proper"] = np.zeros(S, bool)
        self.seen = np.zeros(S, bool)
        self.unstable = np.zeros(S, bool)

    def _launch(self, b: int):
        s = slice(b * self.B, (b + 1) * self.B)
        return self.pe.launch_pairs(self.reads1[s], self.ln, self.reads2[s],
                                    self.ln)

    def _finish(self, pending, b: int) -> None:
        res = self.pe.finish_pairs(pending)
        mates = (res["res1"], res["res2"])
        if (len(res["proper"]) != self.B
                or any(len(m[f]) != self.B for m in mates for f in FIELDS)):
            self.failed += 2 * self.B
            return
        rows, idx = self.rows_of[b], self.sample_of[b]
        if not len(rows):
            return
        new = {(m, f): mates[m - 1][f][rows] for m in (1, 2) for f in FIELDS}
        new["proper"] = res["proper"][rows]
        old = self.seen[idx]
        for key, v in new.items():
            prev = self.got[key][idx]
            diff = prev != v
            if diff.ndim > 1:
                diff = diff.any(axis=1)
            self.unstable[idx] |= old & diff
            self.got[key][idx] = v
        self.seen[idx] = True

    def _run(self, n: int, deadline: float | None = None) -> int:
        """Batches 0, 1, ... of the pool in turn, one in flight, until n
        are done or the deadline has passed; returns the batches done."""
        inflight, k = None, 0
        while k < n and (deadline is None or time.perf_counter() < deadline):
            b = k % self.n_batches
            nxt = (self._launch(b), b)
            if inflight is not None:
                self._finish(*inflight)
            inflight = nxt
            k += 1
        if inflight is not None:
            self._finish(*inflight)
        return k

    def window(self, seconds: float) -> dict:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        _sync(self.device)
        t0 = time.perf_counter()
        k = self._run(1 << 62, deadline=t0 + seconds)
        t1 = time.perf_counter()
        mates = 2 * self.B * k
        return {"mates": mates, "window_s": t1 - t0,
                "reads_per_s": mates / (t1 - t0)}

    def traced(self, n: int) -> dict:
        """n batches under torch.profiler, then the same n batches again
        with each kernel call's bytes and operations counted."""
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.reset_peak_memory_stats(self.device)
        t = time.perf_counter()
        wrap = _Wrapped("range")
        try:
            _sync(self.device)
            with profile(activities=acts) as prof:
                with record_function(WINDOW):
                    self._run(n)
                    _sync(self.device)
        finally:
            wrap.close()
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        self.parts["traced_s"] = time.perf_counter() - t
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            self.parts["trace_mb"] = os.path.getsize(path) / 2**20
            summary = read_trace(path)
        del prof
        self.parts["trace_read_s"] = time.perf_counter() - t
        t = time.perf_counter()
        count = _Wrapped("count")
        try:
            self._run(n)
            _sync(self.device)
        finally:
            count.close()
        self.parts["replay_s"] = time.perf_counter() - t
        return {"trace": summary, "counts": count.counts,
                "mates": 2 * self.B * n, "peak_bytes": peak}

    def close(self) -> None:
        """Free the program's state on the device."""
        self.pe = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """Judge the sampled pairs the window returned."""
        idx = np.nonzero(self.seen)[0]
        pairs = self.sample[idx]
        prog = [{f: self.got[(m, f)][idx] for f in FIELDS} for m in (1, 2)]
        return check_pairs(self.config, self.traffic, self.genome,
                           self.starts, self.reads1[pairs],
                           self.reads2[pairs], prog[0], prog[1],
                           self.got["proper"][idx], self.device,
                           unstable=self.unstable[idx])


def check_pairs(config, traffic, genome_h, starts, r1, r2, prog1, prog2,
                proper, device, unstable=None, control_span=None) -> dict:
    """Judge pairs (r1, r2) against the reference.  With control_span the
    reference itself, counting over the first control_span bases only,
    stands in the program's place (prog1, prog2 and proper unused)."""
    a = config["align"]
    L = r1.shape[1]
    g = guarantee(L, len(genome_h), int(config["lut_bases"]),
                  int(a["subs_per100"]), int(a["min_edit_dist"]), a["mode"])
    genome = torch.from_numpy(genome_h).to(device)
    index = build_seed_index(genome, g.seed_k)
    reads = [torch.from_numpy(r).to(device) for r in (r1, r2)]
    hits = [find_hits(genome, starts, r, g.max_mm, index) for r in reads]
    settings = {"min_edit_dist": int(a["min_edit_dist"]),
                "max_multi": int(a["max_multi"]),
                "pair_min_len": int(traffic["pair_min_len"]),
                "pair_max_len": int(traffic["pair_max_len"])}
    if control_span is not None:
        bad = [find_hits(genome, starts, r, g.max_mm, index,
                         span=control_span) for r in reads]
        prog1, prog2, proper = control_output(
            bad[0], bad[1], genome, starts, r1, r2, g, settings,
            control_span)
    del index
    out = judge(prog1, prog2, proper, hits[0], hits[1], genome, starts, r1,
                r2, g, settings, unstable=unstable)
    out["guarantee"] = g
    return out
