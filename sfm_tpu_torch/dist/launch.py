"""Run a function on several local processes joined in one process group:
a launcher for one host, without torchrun (the tests' gloo ranks on the
CPU, several processes on one card).

    results = run_ranks(fn, 2, args, init_file="/tmp/x/init")

Each process joins torch.distributed (init_method file://init_file, which
must not exist yet), calls fn(mesh, *args) with its dist.mesh.Mesh and
sends the result back; run_ranks returns the results in rank order. fn
must be importable by name in a fresh interpreter (multiprocessing's spawn).
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback

import torch
import torch.distributed as dist

from sfm_tpu_torch.dist.mesh import make_mesh


def _rank_main(fn, rank: int, world_size: int, init_file: str, device: str, backend: str,
               threads: int, args: tuple, out) -> None:
    torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world_size)
    try:
        out.put((rank, True, fn(make_mesh(world_size, device), *args)))
    except Exception:   # the parent raises it, with this traceback
        out.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, args: tuple = (), *, init_file: str, device: str = "cpu",
              backend: str = "gloo", timeout: float = 120.0, threads: int = 1) -> list:
    """fn(mesh, *args) on `world_size` new processes (one group, `backend`,
    each process's mesh on `device` with `threads` intra-op threads) ->
    their results in rank order. A process that raises makes this raise
    with its traceback; processes still running after `timeout` seconds
    (a deadlock) are killed and a TimeoutError raised. Every process is
    stopped before this returns."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world_size, init_file, device, backend, threads, args, out))
             for rank in range(world_size)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_ranks: {world_size - len(results)} of {world_size} processes "
                                   f"still running after {timeout:g} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_ranks: a process exited with code {dead[0]}")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10 if len(results) == world_size else 0)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world_size)]
