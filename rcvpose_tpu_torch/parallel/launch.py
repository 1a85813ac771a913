"""Run a function on several ranks of one ``torch.distributed`` world.

``run_ranks`` is the port's launcher for work that must cross processes
on one host (the multi-process tests, and two ranks on one card in
``chip_smoke.py``): it spawns one process per rank with the torchrun
environment set (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), optionally makes the process group over
``tcp://127.0.0.1``, and returns each rank's result. A rank that fails or
hangs fails the call instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port():
    """A TCP port on 127.0.0.1 that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, backend, init_group, args, out_dir,
               timeout, threads):
    torch.set_num_threads(threads)
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port)})
    try:
        if init_group:
            dist.init_process_group(
                backend, init_method=f"tcp://127.0.0.1:{port}",
                world_size=world, rank=rank,
                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            if init_group:
                dist.destroy_process_group()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world_size, args=(), timeout=300.0, backend="gloo",
              init_group=True):
    """``fn(rank, world_size, *args)`` in ``world_size`` spawned processes;
    returns their results in rank order (each must be ``torch.save``-able).

    ``fn`` and ``args`` are pickled into the children, so ``fn`` must be a
    module-level function. With ``init_group`` every rank joins a
    ``backend`` process group before ``fn`` and leaves it after; without
    it ``fn`` finds the torchrun environment and makes its own. Raises
    ``RuntimeError`` with the traceback of a rank that failed, and
    ``TimeoutError`` (after killing every rank) when the ranks have not
    ended within ``timeout`` seconds. Each rank gets its share of the
    host's cores as intra-op CPU threads: ranks that each take every core
    slow one another down many times over.
    """
    threads = max(1, (os.cpu_count() or 1) // world_size)
    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, port, backend,
                                   init_group, tuple(args), out_dir,
                                   timeout, threads))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            # a rank that failed leaves the others waiting in a collective:
            # stop them all as soon as one has failed
            while (any(p.is_alive() for p in procs)
                   and not any(p.exitcode for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            hung = [r for r, p in enumerate(procs) if p.is_alive()
                    and not any(q.exitcode for q in procs)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        errors = []
        for r in range(world_size):
            path = os.path.join(out_dir, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        if errors:
            raise RuntimeError("\n".join(errors))
        if hung:
            raise TimeoutError(f"ranks {hung} still running after "
                               f"{timeout} s")
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad}")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]
