"""Banded Smith-Waterman jobs over a mesh of ranks.

Counterpart of biokanga_tpu/parallel/swservice.py.  The reference runs
SW providers behind the BKS TCP work service (pacbiokanga/BKSRequester.cpp,
BKSProvider.cpp, PBSWService.cpp): sessions, payloads of up to 64 MB and
re-queued jobs.  Here rank 0 holds the job batch, broadcasts it to the
mesh, every dp coordinate aligns an even share of it on its own device
(ops/sw.banded_sw_batch) and rank 0 gathers the results in job order; a
failed collective raises, as everywhere in parallel/dist.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.sw import banded_sw_batch
from .dist import Mesh, broadcast, gather_results, make_mesh


@dataclass
class SWJobBatch:
    """A batch of banded SW jobs (the BKS job queue's role)."""
    a: np.ndarray      # (B, La) int8
    b: np.ndarray      # (B, Lb) int8
    alen: np.ndarray
    blen: np.ndarray
    diag: np.ndarray


def make_sw_mesh(n_ranks: int | None = None, device=None) -> Mesh | None:
    """A one-axis mesh of n_ranks ranks (default: the whole world) over
    'dp'; device as in dist.rank_device."""
    import torch.distributed as dist

    return make_mesh(n_ranks or dist.get_world_size(), 1, device)


def _share(mesh: Mesh, jobs: SWJobBatch | None):
    """Rank 0's jobs on every rank, padded to a multiple of n_dp (query
    and target codes 4, lengths 0), cut to this rank's share; tensors on
    the rank's device, and the job count."""
    dev = mesh.device
    dims = torch.tensor(
        [*jobs.a.shape, jobs.b.shape[1]] if mesh.rank == 0 else [0, 0, 0],
        dtype=torch.int64, device=dev)
    B, La, Lb = broadcast(mesh, dims).tolist()
    Bp = -(-B // mesh.n_dp) * mesh.n_dp

    def send(name, shape, dtype, fill):
        h = np.full((Bp,) + shape, fill, dtype)
        if mesh.rank == 0:
            h[:B] = getattr(jobs, name)
        return broadcast(mesh, torch.from_numpy(h).to(dev))[mesh.rows(Bp)]

    return (send("a", (La,), np.int8, 4), send("b", (Lb,), np.int8, 4),
            send("alen", (), np.int32, 0), send("blen", (), np.int32, 0),
            send("diag", (), np.int32, 0)), B


def run_sw_jobs(mesh: Mesh, jobs: SWJobBatch | None, W: int,
                return_moves: bool = False) -> dict | None:
    """Align the job batch over the mesh.  `jobs` is read on rank 0 only
    (other ranks may pass None).  Returns, on rank 0, {"score", "best_i",
    "best_k"} (B,) int32 and, with return_moves, "moves" (B, La, 2W+1)
    uint8, in job order; None on the other ranks."""
    args, B = _share(mesh, jobs)
    best, bi, bk, moves = banded_sw_batch(*args, W, moves=return_moves)
    out = {"score": best.cpu().numpy(), "best_i": bi.cpu().numpy(),
           "best_k": bk.cpu().numpy()}
    if return_moves:
        out["moves"] = moves.cpu().numpy()
    out = gather_results(mesh, out)
    return None if out is None else {k: v[:B] for k, v in out.items()}
