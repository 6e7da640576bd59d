"""Start P processes, one ``torch.distributed`` rank each, in a gloo group.

The counterpart of building a mesh over P devices in the reference
(``jaxcompat.make_mesh``, ``launch/mesh.py::make_debug_mesh``) for the
per-rank BSP forward (:mod:`repro_torch.gnn.ranks`): a helper that tests
and ``chip_smoke.py`` call, not a command line.

    results = run_ranks(fn, 8, *args)

runs ``fn(rank, *args)`` in 8 processes started with the ``spawn`` method
(``fork`` breaks once the parent holds a CUDA context), each joined to a
gloo group over a ``FileStore`` in a fresh temporary directory (TCP ports
would collide between concurrent callers), and returns each rank's
picklable result in rank order.  ``fn`` must be importable by name (a
module-level function).  A rank that raises makes the call raise, with the
rank's traceback; ``timeout`` bounds the group's collectives and the whole
call, so a lost rank fails the run instead of hanging it.  Each rank runs
with the machine's cores shared out between the ranks.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, fn, world, tmp, timeout, args):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, *args)
        dist.barrier()           # no rank leaves while a peer still sends
    finally:
        dist.destroy_process_group()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)


def run_ranks(fn, world_size: int, *args, timeout: float = 600.0) -> list:
    """``[fn(0, *args), ..., fn(world_size - 1, *args)]``, each computed in
    its own process, a rank of one gloo group of ``world_size``."""
    if world_size < 1:
        raise ValueError(f"world_size {world_size} < 1")
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, tmp, timeout, args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish "
                                       f"within {timeout} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join(timeout=30)
        results = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
