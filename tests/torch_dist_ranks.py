"""Ranks of the port's multi-rank tests, spawned over gloo on the CPU.

`spawn(fn, world, *args)` starts `world` processes (torch.multiprocessing,
spawn start), each with one torch thread, joins them into one gloo world
through a `file://` rendezvous in a fresh temporary directory (no TCP
port to collide across pytest-xdist workers) and calls
fn(rank, world, *args) in each.  A rank that raises fails the spawn.

The rank functions below import torch, numpy and the port only (the
children never import jax); they write what rank 0 gathers to `out`, a
directory the test reads back.
"""
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world, init_method, fn, args):
    torch.set_num_threads(1)
    if init_method is None:         # fn joins the world itself
        return fn(rank, world, *args)
    from biokanga_tpu_torch.parallel.dist import init_ranks

    init_ranks("gloo", init_method, world, rank)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, join: bool = True) -> None:
    """Run fn(rank, world, *args) in `world` processes, joined into one
    gloo world first unless `join` is False."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, nprocs=world, args=(
            world, f"file://{tmp}/rendezvous" if join else None, fn, args))


def save(out: str, name: str, obj) -> None:
    with open(os.path.join(out, name + ".pkl"), "wb") as f:
        pickle.dump(obj, f)


def load(out: str, name: str):
    with open(os.path.join(out, name + ".pkl"), "rb") as f:
        return pickle.load(f)


def sharded_ranks(rank, world, out, data):
    """The sharded aligner at several layouts of one world of 4 ranks:
    align at (2, 2), (1, 4) and (1, 2); align_extended at (1, 4); the
    sharded pileup at (2, 2)."""
    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.align.pipeline import _rc_reads
    from biokanga_tpu_torch.index.chunked import build_chunked_index
    from biokanga_tpu_torch.parallel.dist import all_gather_sp, make_mesh
    from biokanga_tpu_torch.parallel.sharded import (
        ShardedAligner,
        build_sharded_pileup_fn,
        combine_pileup_planes,
        gather_results,
    )

    reads, lengths = data["reads"], data["lengths"]
    params = AlignParams(cand_per_core=48, batch_size=len(reads))
    for n_dp, n_sp in ((2, 2), (1, 4), (1, 2)):
        mesh = make_mesh(n_dp, n_sp, "cpu")
        if mesh is None:
            continue
        ci = build_chunked_index(data["seqs"], num_chunks=n_sp, overlap=256,
                                 lut_bases=8)
        rows = mesh.rows(len(reads))
        res = ShardedAligner(mesh, ci, params).align(reads[rows],
                                                     lengths[rows])
        full = gather_results(mesh, res)
        if rank == 0:
            save(out, f"align_{n_dp}x{n_sp}", full)

    ext = data["extended"]
    mesh = make_mesh(1, 4, "cpu")
    ci = build_chunked_index(ext["seqs"], num_chunks=4, overlap=8192,
                             lut_bases=10)
    res = ShardedAligner(mesh, ci, AlignParams(
        batch_size=len(ext["reads"]))).align_extended(
            ext["reads"], ext["lengths"], micro_indel_len=9,
            splice_junct_len=50_000)
    if rank == 0:
        save(out, "extended", res)

    pile = data["pileup"]
    mesh = make_mesh(2, 2, "cpu")
    ci = build_chunked_index(pile["seqs"], num_chunks=2, overlap=256,
                             lut_bases=8)
    sa = ShardedAligner(mesh, ci, AlignParams())
    rows = mesh.rows(len(pile["reads"]))
    r, ln = pile["reads"][rows], pile["lengths"][rows]
    res = sa.align(r, ln)
    rt, lt = torch.from_numpy(r), torch.from_numpy(ln)
    flip = torch.from_numpy(res["is_rc"] & res["unique"])
    aligned = torch.where(flip[:, None], _rc_reads(rt, lt), rt).numpy()
    local = (res["locus"] - sa.sidx.bases[res["chunk"]]).astype(np.int32)
    planes = build_sharded_pileup_fn(mesh, sa.sidx)(
        res["chunk"], local, aligned, ln, res["unique"])
    planes = [all_gather_sp(mesh, p).numpy() for p in planes]
    block = gather_results(mesh, res)
    if rank == 0:
        save(out, "pileup", {
            "planes": planes, "unique": block["unique"],
            "global": [combine_pileup_planes(p, sa.sidx) for p in planes]})


def multihost_ranks(rank, world, out, fastq, block_size):
    """Two "hosts" of two ranks each (ranks 0-1 and 2-3): the world joins
    through init_multihost with RANK and WORLD_SIZE from the environment,
    each host parses its round-robin blocks of the FASTQ, and every rank
    aligns its dp block of each at (2, 2) and (4, 1) and keeps its host's
    rows."""
    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.index.chunked import build_chunked_index
    from biokanga_tpu_torch.parallel.multihost import (
        global_batch,
        global_mesh,
        host_block_iter,
        local_results,
    )
    from biokanga_tpu_torch.parallel.sharded import ShardedAligner

    seqs = load(out, "genome")
    host = rank // 2
    for n_dp, n_sp in ((2, 2), (4, 1)):
        mesh = global_mesh(n_dp, n_sp, n_hosts=2, device="cpu")
        ci = build_chunked_index(seqs, num_chunks=n_sp, overlap=256,
                                 lut_bases=8)
        sa = ShardedAligner(mesh, ci, AlignParams(cand_per_core=32))
        rows = []
        for blk in host_block_iter(fastq, block_size, host, 2):
            r, ln = global_batch(mesh, blk.codes, blk.lengths, n_hosts=2)
            rows.append((blk.names, local_results(
                mesh, sa.align(r, ln), n_hosts=2)))
        save(out, f"host_{n_dp}x{n_sp}_rank{rank}", rows)


def multihost_world(rank, world, out, fastq, block_size):
    """multihost_ranks after init_multihost, rendezvous through the
    environment's RANK and WORLD_SIZE and a file:// init_method."""
    from biokanga_tpu_torch.parallel.multihost import init_multihost

    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world)
    init_multihost("gloo", f"file://{out}/rendezvous")
    try:
        multihost_ranks(rank, world, out, fastq, block_size)
    finally:
        dist.destroy_process_group()


def collective_ranks(rank, world, out):
    """The three collective helpers of parallel/dist.py on a (2, 2) mesh."""
    from biokanga_tpu_torch.parallel.dist import (
        all_gather_sp,
        broadcast,
        make_mesh,
        sum_dp,
    )

    mesh = make_mesh(2, 2, "cpu")
    mine = torch.tensor([[rank, 10 * rank]], dtype=torch.int32)
    got = {"coords": (mesh.dp, mesh.sp, mesh.rank),
           "gather": all_gather_sp(mesh, mine).numpy(),
           "sum": sum_dp(mesh, mine).numpy(),
           "bcast": broadcast(mesh, mine + 1, src=3).numpy(),
           "bool": all_gather_sp(mesh, torch.tensor([rank % 2 == 0])).numpy()}
    save(out, f"collectives_rank{rank}", got)


def global_mesh_ranks(rank, world, out):
    """global_mesh on a world of 4: the layouts it refuses (a mesh smaller
    than the world, dp not a multiple of the hosts, local_results on a
    mesh it did not make) and the host groups of those it takes."""
    from biokanga_tpu_torch.parallel.dist import make_mesh
    from biokanga_tpu_torch.parallel.multihost import (
        global_mesh,
        local_results,
    )

    got = {"refused": []}
    for n_dp, n_sp, n_hosts in ((2, 1, 2), (1, 2, 2), (4, 1, 3)):
        try:
            global_mesh(n_dp, n_sp, n_hosts, device="cpu")
            got["refused"].append(None)
        except ValueError as e:
            got["refused"].append(str(e))
    try:
        local_results(make_mesh(4, 1, "cpu"), {}, 2)
        got["refused"].append(None)
    except ValueError as e:
        got["refused"].append(str(e))
    for n_dp, n_sp in ((2, 2), (4, 1)):
        mesh = global_mesh(n_dp, n_sp, 2, device="cpu")
        got[f"{n_dp}x{n_sp}"] = dist.get_process_group_ranks(mesh.host_group)
        got[f"rows_{n_dp}x{n_sp}"] = local_results(
            mesh, {"r": np.asarray([rank])}, 2)["r"].tolist()
    save(out, f"global_mesh_rank{rank}", got)


def sw_job_ranks(rank, world, out, jobs, W):
    """run_sw_jobs over all ranks, moves included; jobs given to rank 0
    only."""
    from biokanga_tpu_torch.parallel.swservice import make_sw_mesh, run_sw_jobs

    res = run_sw_jobs(make_sw_mesh(device="cpu"), jobs if rank == 0 else None,
                      W, return_moves=True)
    if rank == 0:
        save(out, "sw_jobs", res)


def ec_mesh_ranks(rank, world, out, reads, params):
    """ec_reads with a mesh of every rank; each rank keeps its output."""
    from biokanga_tpu_torch.pacbio.ecreads import ec_reads
    from biokanga_tpu_torch.parallel.swservice import make_sw_mesh

    mesh = make_sw_mesh(device="cpu")
    save(out, f"ec_rank{rank}", ec_reads(reads, params, mesh=mesh))


def sharded_card_ranks(rank, world, out, data):
    """The sharded aligner at (1, world), every rank on its default card
    (cuda:(rank % cards)), gloo between them; rank 0 keeps the rows."""
    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.index.chunked import build_chunked_index
    from biokanga_tpu_torch.parallel.dist import make_mesh
    from biokanga_tpu_torch.parallel.sharded import (
        ShardedAligner,
        gather_results,
    )

    mesh = make_mesh(1, world)
    ci = build_chunked_index(data["seqs"], num_chunks=world, overlap=256,
                             lut_bases=8)
    res = ShardedAligner(mesh, ci, AlignParams(cand_per_core=48)).align(
        data["reads"], data["lengths"])
    full = gather_results(mesh, res)
    if rank == 0:
        save(out, "card", (full, str(mesh.device)))
