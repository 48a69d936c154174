"""Copy of biokanga_tpu/index/chunked.py: only `is_chunked_index`.

Chunked (genome-range) indexes are not ported yet; the CLI uses this
check to refuse them.
"""
from __future__ import annotations

import json

import numpy as np


def is_chunked_index(path: str) -> bool:
    with np.load(path) as z:
        if "meta" not in z:
            return False
        return bool(json.loads(z["meta"].tobytes().decode()
                               ).get("chunked", False))
