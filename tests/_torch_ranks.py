"""Spawned gloo ranks for the multi-process tests of lxt_tpu_torch.

``spawn(fn, world, tmp_path, *args)`` runs ``fn(rank, world, *args)`` on
``world`` processes (multiprocessing "spawn") that meet through a
``file://`` store under ``tmp_path`` (no ports to clash between test
workers), and returns rank 0's result. A rank that fails or outlives the
timeout fails the test. ``fn`` must live in a module that a spawned
process can import without jax: the test modules import it inside their
test functions only.
"""

import multiprocessing
import time

import torch
import torch.distributed as dist

RANK_TIMEOUT = 240  # seconds for a whole spawned group


def _rank_main(fn, rank, world, store, out, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        res = fn(rank, world, *args)
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()


def spawn(fn, world, tmp_path, *args, timeout=RANK_TIMEOUT):
    ctx = multiprocessing.get_context("spawn")
    out = tmp_path / "rank0.pt"
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world,
                                                  str(tmp_path / "store"),
                                                  str(out), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    assert not hung, f"ranks {hung} hung past {timeout} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return torch.load(out, weights_only=False)
