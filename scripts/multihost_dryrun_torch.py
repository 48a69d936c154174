"""Sharded alignment of the PyTorch port over torchrun's ranks.

    torchrun --nproc-per-node R [--nnodes H --node-rank h \
        --master-addr A --master-port P] \
        scripts/multihost_dryrun_torch.py --backend nccl|gloo \
        --dp D --sp S [--device cpu]

D x S must equal the world size, and D must be a multiple of the host
count H.  NCCL needs a card a rank (rank r takes cuda:(LOCAL_RANK % cards));
gloo serves several ranks on one card or, with --device cpu, the CPU.
Every rank builds the same chunked index (S chunks) of a random genome
from a seed, every host simulates the same reads and keeps only its
share, as biokanga_tpu's scripts/multihost_dryrun.py does, each rank
aligns its dp block with parallel/sharded.ShardedAligner, and every rank
prints one line with its host's accepted count; rank 0 also checks its
host's rows against the single-device AlignEngine and exits non-zero on
any difference.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from biokanga_tpu_torch.align.params import AlignParams  # noqa: E402
from biokanga_tpu_torch.align.pipeline import (  # noqa: E402
    RESULT_KEYS,
    AlignEngine,
)
from biokanga_tpu_torch.index.build import build_index  # noqa: E402
from biokanga_tpu_torch.index.chunked import build_chunked_index  # noqa: E402
from biokanga_tpu_torch.index.device import to_device  # noqa: E402
from biokanga_tpu_torch.parallel.multihost import (  # noqa: E402
    global_batch,
    global_mesh,
    init_multihost,
    local_results,
)
from biokanga_tpu_torch.parallel.sharded import ShardedAligner  # noqa: E402
from biokanga_tpu_torch.sim.simreads import (  # noqa: E402
    random_genome,
    simulate_reads,
)

READS_A_BLOCK = 512   # a dp block's reads


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--backend", required=True, choices=("nccl", "gloo"))
    p.add_argument("--dp", type=int, required=True)
    p.add_argument("--sp", type=int, required=True)
    p.add_argument("--device", default=None,
                   help="a device for every rank (default: a card a rank)")
    args = p.parse_args()

    init_multihost(args.backend)
    world = dist.get_world_size()
    n_hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    host = dist.get_rank() * n_hosts // world
    mesh = global_mesh(args.dp, args.sp, n_hosts, args.device)
    try:
        seqs = random_genome([("c1", 300_000), ("c2", 200_000)], seed=31)
        ci = build_chunked_index(seqs, num_chunks=args.sp, overlap=256,
                                 lut_bases=8)
        params = AlignParams(cand_per_core=32)
        per_host = READS_A_BLOCK * args.dp // n_hosts
        _, reads, _ = simulate_reads(seqs, per_host * n_hosts, read_len=100,
                                     sub_rate=0.02, seed=13)
        lengths = np.full(len(reads), 100, np.int32)
        mine = slice(host * per_host, (host + 1) * per_host)
        r, ln = global_batch(mesh, reads[mine], lengths[mine], n_hosts)
        rows = local_results(mesh, ShardedAligner(mesh, ci, params).align(
            r, ln), n_hosts)
        n_acc = int(rows["unique"].sum())
        print(f"rank {mesh.rank} of {world} (host {host} of {n_hosts}), "
              f"mesh dp={args.dp} x sp={args.sp} over {mesh.backend} on "
              f"{mesh.device}: {n_acc}/{per_host} host reads accepted, "
              f"max global locus {int(rows['locus'][rows['unique']].max())}",
              flush=True)
        if mesh.rank == 0:
            want = AlignEngine(to_device(build_index(seqs, lut_bases=8),
                                         mesh.device),
                               params).align_with_rescue(reads[mine],
                                                         lengths[mine])
            bad = [k for k in RESULT_KEYS
                   if not np.array_equal(rows[k], want[k])]
            if bad or n_acc < 0.9 * per_host:
                print(f"host 0 rows differ from AlignEngine: {bad}",
                      file=sys.stderr)
                return 1
            print("host 0 rows equal to the single-device AlignEngine",
                  flush=True)
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(max(1, torch.get_num_threads()
                              // int(os.environ.get("LOCAL_WORLD_SIZE", 1))))
    sys.exit(main())
