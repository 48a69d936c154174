"""Several hosts: the rendezvous and per-host input.

Counterpart of biokanga_tpu/parallel/multihost.py.  The reference spreads
work over nodes by uhamming's static sweep partitions
(uhamming/uhamming.cpp:222-238) and the BKS TCP work service
(pacbiokanga/BKSRequester.cpp).  Here:

- `init_multihost` joins the ranks of every host into one
  torch.distributed world, with the rendezvous of `torchrun` (MASTER_ADDR,
  MASTER_PORT, WORLD_SIZE, RANK in the environment) or an explicit one;
- `global_mesh` is parallel/dist.py's (dp, sp) mesh over every rank of
  every host, dp a multiple of the host count, so a host feeds whole dp
  blocks; torchrun numbers a host's ranks consecutively, so host h holds
  dp coordinates [h * n_dp / H, (h + 1) * n_dp / H) exactly when the
  world is the mesh, which global_mesh demands;
- `host_block_iter` hands each host its round-robin share of the input
  blocks (every host parses only its own);
- `global_batch` cuts this rank's dp block from its host's block, and
  `local_results` joins the result rows of the host's dp blocks over a
  group of that host's ranks only (nothing crosses to another host).

The sharded aligner (parallel/sharded.py) runs unchanged: its gathers
ride whatever links the backend uses between the ranks.
"""
from __future__ import annotations

import os

import numpy as np
import torch.distributed as dist

from .dist import Mesh, concat_rows, init_ranks, make_mesh


def init_multihost(backend: str, init_method: str | None = None,
                   world_size: int | None = None,
                   rank: int | None = None) -> None:
    """Join every host's ranks into one world (the backend as in
    dist.init_ranks).  Without an init_method the rendezvous is torchrun's
    (`env://`: MASTER_ADDR and MASTER_PORT), and WORLD_SIZE and RANK come
    from the environment where not given."""
    if init_method is None:
        init_method = "env://"
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    init_ranks(backend, init_method, world_size, rank)


def global_mesh(n_dp: int, n_sp: int, n_hosts: int,
                device=None) -> Mesh:
    """(dp, sp) mesh over every rank of every host.  The world must be the
    mesh (n_dp * n_sp ranks) and n_dp a multiple of n_hosts, so that host
    h's consecutive ranks are exactly its dp blocks.  The mesh's
    `host_group` holds the ranks of this rank's host at its sp coordinate
    (local_results gathers over it)."""
    world = dist.get_world_size()
    if world != n_dp * n_sp:
        raise ValueError(f"mesh ({n_dp}, {n_sp}) has {n_dp * n_sp} ranks, "
                         f"the world {world}: every host's ranks must be "
                         f"its dp blocks")
    if n_dp % n_hosts:
        raise ValueError(f"dp = {n_dp} is not a multiple of the {n_hosts} "
                         f"hosts")
    mesh = make_mesh(n_dp, n_sp, device)
    per_host = n_dp // n_hosts
    for h in range(n_hosts):
        for s in range(n_sp):
            g = dist.new_group([d * n_sp + s for d in range(
                h * per_host, (h + 1) * per_host)])
            if mesh.dp // per_host == h and mesh.sp == s:
                mesh.host_group = g
    return mesh


def host_block_iter(paths, block_size: int, process_id: int,
                    num_processes: int):
    """Round-robin block assignment: host p parses blocks p, p+N, p+2N…
    of the concatenated input stream; copied from
    biokanga_tpu/parallel/multihost.py:63-77."""
    from ..seq.fasta import read_blocks

    i = 0
    if isinstance(paths, str):
        paths = [paths]
    for path in paths:
        for blk in read_blocks(path, block_size=block_size):
            if i % num_processes == process_id:
                yield blk
            i += 1


def global_batch(mesh: Mesh, host_reads: np.ndarray,
                 host_lengths: np.ndarray, n_hosts: int):
    """This rank's dp block of its host's block (the host's block splits
    over its n_dp / n_hosts dp coordinates)."""
    per_host = mesh.n_dp // n_hosts
    n = len(host_reads)
    if n % per_host:
        raise ValueError(f"a host block of {n} rows does not split into "
                         f"{per_host} dp blocks")
    b = n // per_host
    part = mesh.dp % per_host
    rows = slice(part * b, (part + 1) * b)
    return host_reads[rows], host_lengths[rows]


def local_results(mesh: Mesh, out: dict, n_hosts: int) -> dict:
    """The result rows of this rank's host (its dp blocks in order), on
    every rank of the host.  `out` holds this rank's rows; they are
    gathered over the host's own ranks (`mesh.host_group`)."""
    if mesh.host_group is None:
        raise ValueError("local_results needs a mesh from global_mesh")
    per_host = mesh.n_dp // n_hosts
    parts = [None] * per_host
    dist.all_gather_object(parts, out, group=mesh.host_group)
    return concat_rows(parts)
