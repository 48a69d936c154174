"""Ranks, the (dp, sp) mesh and its collectives on torch.distributed.

Counterpart of `make_mesh` (biokanga_tpu/parallel/sharded.py:43) and
`global_mesh` (biokanga_tpu/parallel/multihost.py:44).  The JAX package
runs one program over a device mesh; here every rank is one process, as
PyTorch has it, and the mesh is a record of where this process sits:

  - the first n_dp x n_sp ranks of the world form the mesh, row-major
    (rank = dp * n_sp + sp), the order of make_mesh's reshape, so chunk
    k is sp coordinate k;
  - `sp_group`: the n_sp ranks of one dp coordinate, which hold one read
    block over every genome chunk (the per-read summaries are gathered
    over it);
  - `dp_group`: the n_dp ranks of one sp coordinate, which hold one chunk
    over every read block (pileup planes and vote planes are summed over
    it);
  - `group`: every rank of the mesh.

The backend is the caller's: NCCL where each rank has a card of its own,
gloo otherwise (several ranks on one card, or the CPU).  A collective
runs on its backend's device: CUDA tensors under NCCL, and under gloo the
CPU copies of the (small) tensors it carries.  The work around the
collectives stays on the rank's own device.  Nothing here changes
backend or device when a collective fails: the failure raises.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def init_ranks(backend: str, init_method: str, world_size: int,
               rank: int) -> None:
    """Join the default process group: `backend` is "nccl" or "gloo",
    `init_method` a rendezvous URL (`file://...`, `tcp://host:port` or
    `env://`)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: want 'nccl' or 'gloo'")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """`device` if named, else cuda:(local rank % visible cards), the
    local rank being LOCAL_RANK (set by torchrun) or else the global rank;
    raises without CUDA."""
    if device is not None:
        return resolve_device(device)
    resolve_device("cuda")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclass
class Mesh:
    """This rank's place in an (n_dp, n_sp) mesh of ranks."""

    n_dp: int
    n_sp: int
    dp: int
    sp: int
    device: torch.device
    backend: str
    group: object       # every rank of the mesh
    dp_group: object    # ranks (*, sp): one chunk, every read block
    sp_group: object    # ranks (dp, *): one read block, every chunk
    host_group: object = None   # this host's ranks (*, sp): global_mesh

    @property
    def rank(self) -> int:
        """Global rank (the mesh's ranks are the world's first)."""
        return self.dp * self.n_sp + self.sp

    def rows(self, n: int) -> slice:
        """This rank's dp block of a batch of n rows (n % n_dp == 0)."""
        if n % self.n_dp:
            raise ValueError(f"a batch of {n} rows does not split into "
                             f"{self.n_dp} dp blocks")
        b = n // self.n_dp
        return slice(self.dp * b, (self.dp + 1) * b)


def make_mesh(n_dp: int, n_sp: int,
              device: str | torch.device | None = None) -> Mesh | None:
    """The (n_dp, n_sp) mesh over the first n_dp * n_sp ranks of the world;
    None on a rank outside it.  Every rank of the world must call it, in
    the same order as its other group creations (torch.distributed.new_group
    is collective).  `device` as in rank_device."""
    world = dist.get_world_size()
    n = n_dp * n_sp
    if n_dp < 1 or n_sp < 1 or n > world:
        raise ValueError(f"mesh ({n_dp}, {n_sp}) needs {n} ranks, the world "
                         f"has {world}")
    backend = dist.get_backend()
    group = dist.group.WORLD if n == world else dist.new_group(range(n))
    rank = dist.get_rank()
    dp_group = sp_group = None
    for d in range(n_dp):
        g = dist.new_group([d * n_sp + s for s in range(n_sp)])
        if rank // n_sp == d:
            sp_group = g
    for s in range(n_sp):
        g = dist.new_group([d * n_sp + s for d in range(n_dp)])
        if rank % n_sp == s:
            dp_group = g
    if rank >= n:
        return None
    dev = rank_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, not "
                             f"{dev}")
        torch.cuda.set_device(dev)
    return Mesh(n_dp=n_dp, n_sp=n_sp, dp=rank // n_sp, sp=rank % n_sp,
                device=dev, backend=backend, group=group, dp_group=dp_group,
                sp_group=sp_group)


def _comm(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """t on the device the backend's collectives take."""
    return (t if mesh.backend == "nccl" else t.cpu()).contiguous()


def all_gather_sp(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """(n_sp, *t.shape): t of every rank of this rank's sp group, in sp
    order, on t's device."""
    c = _comm(mesh, t)
    parts = [torch.empty_like(c) for _ in range(mesh.n_sp)]
    dist.all_gather(parts, c, group=mesh.sp_group)
    return torch.stack(parts).to(t.device)


def sum_dp(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Elementwise sum of t over this rank's dp group, on t's device."""
    c = _comm(mesh, t)
    if c is t:
        c = c.clone()
    dist.all_reduce(c, op=dist.ReduceOp.SUM, group=mesh.dp_group)
    return c.to(t.device)


def broadcast(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank src's t on every rank of the mesh, on t's device (every rank
    passes a tensor of the same shape and dtype)."""
    c = _comm(mesh, t)
    if c is t:
        c = c.clone()
    dist.broadcast(c, src=src, group=mesh.group)
    return c.to(t.device)


def gather_results(mesh: Mesh, rows: dict) -> dict | None:
    """Every dp block's rows (dicts of host arrays) concatenated in dp
    order, which is the global row order, on rank 0; None on the other
    ranks.  The sp ranks of a dp coordinate hold the same rows: those of
    sp 0 are sent."""
    if mesh.sp != 0:
        return None
    parts = [None] * mesh.n_dp if mesh.rank == 0 else None
    dist.gather_object(rows, parts, dst=0, group=mesh.dp_group)
    return None if parts is None else concat_rows(parts)


def concat_rows(parts: list[dict]) -> dict:
    """Row dicts joined key by key; a key that holds no array of rows (the
    derived parameters) comes from the first part."""
    return {k: (np.concatenate([p[k] for p in parts])
                if isinstance(v, np.ndarray) and v.ndim else v)
            for k, v in parts[0].items()}
