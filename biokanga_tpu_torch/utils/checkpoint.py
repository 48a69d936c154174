"""Copy of biokanga_tpu/utils/checkpoint.py: sweep checkpointing.

Resumable long-running alignment: `align --checkpoint-dir` persists
each block's result and resumes at the first missing one.  The
reference has no in-process checkpointing — a crashed multi-hour align
run restarts from zero (SURVEY §5 checkpoint/resume; only file
granularity between pipeline stages exists, e.g. SaveAssembSeqs,
deNovoAssemb.cpp:378).  Here the chunk-major sweep gives a natural
finer-grained unit: every (chunk, block) partial result dict is persisted
as one atomic .npz, and on restart completed cells are loaded instead of
recomputed — a killed 10-hour big-genome run resumes at the first
missing cell.  A manifest carries a configuration signature (genome
layout + params + block shapes) so stale checkpoints never silently
resume a different run.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

_SKIP_KEYS = ("derived",)


def config_signature(parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(p.tobytes())
        else:
            h.update(repr(p).encode())
    return h.hexdigest()[:24]


class SweepCheckpoint:
    """Per-(chunk, block) partial-result store under one directory."""

    def __init__(self, dirpath: str, signature: str):
        self.dir = dirpath
        os.makedirs(dirpath, exist_ok=True)
        man = os.path.join(dirpath, "MANIFEST.json")
        if os.path.exists(man):
            got = json.load(open(man)).get("signature")
            if got != signature:
                raise ValueError(
                    f"checkpoint dir {dirpath} belongs to a different run "
                    f"(signature {got} != {signature}); use a fresh dir"
                )
        else:
            with open(man, "w") as f:
                json.dump({"signature": signature, "version": 1}, f)
        self.signature = signature

    def _path(self, chunk: int, block: int) -> str:
        return os.path.join(self.dir, f"c{chunk:04d}_b{block:06d}.npz")

    def has(self, chunk: int, block: int) -> bool:
        return os.path.exists(self._path(chunk, block))

    def load(self, chunk: int, block: int) -> dict:
        with np.load(self._path(chunk, block)) as z:
            return {k: z[k] for k in z.files}

    def save(self, chunk: int, block: int, res: dict) -> None:
        path = self._path(chunk, block)
        tmp = path + ".tmp.npz"
        np.savez(tmp, **{k: np.asarray(v) for k, v in res.items()
                         if k not in _SKIP_KEYS})
        os.replace(tmp, path)

    def cells_done(self) -> int:
        return sum(1 for f in os.listdir(self.dir) if f.endswith(".npz")
                   and f.startswith("c"))
