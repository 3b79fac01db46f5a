"""Start a ``torch.distributed`` group of ranks and run one function on each.

The JAX package runs one controller over all its devices and has no
counterpart.  Here each rank is a process of its own (SPMD):
:func:`run_ranks` spawns ``world`` of them, joins them into a group through a
``file://`` rendezvous, gives each its device and its collective time
limit, calls ``fn(rank, world, device, *args)`` on each and returns their
return values in rank order.  A rank that raises, exits or hangs makes the
whole group fail: the other ranks are killed and :func:`run_ranks` raises
within its own time limit, so a deadlocked collective ends as a failure,
never as a hang.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..runtime.device_mesh import resolve_device


def _rank_main(rank, world, backend, device, out_dir, collective_timeout):
    torch.set_num_threads(1)
    out = Path(out_dir)

    def failed():
        # Written before the group is torn down, so that it exists by the
        # time another rank fails on the broken connection.
        (out / f"rank{rank}.err").write_text(traceback.format_exc())

    try:
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device(device)
        with open(out / "call.pkl", "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(
            backend, init_method=f"file://{out / 'rendezvous'}",
            world_size=world, rank=rank,
            timeout=timedelta(seconds=collective_timeout))
    except BaseException:
        failed()
        raise
    try:
        result = fn(rank, world, dev, *args)
    except BaseException:
        failed()
        raise
    finally:
        dist.destroy_process_group()
    with open(out / f"rank{rank}.pkl.tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out / f"rank{rank}.pkl.tmp", out / f"rank{rank}.pkl")


def run_ranks(fn, world: int, backend: str = "gloo", device: str | None = None,
              timeout: float = 600.0, args: tuple = (),
              collective_timeout: float = 90.0) -> list:
    """Run ``fn(rank, world, device, *args)`` on ``world`` spawned ranks of
    one ``backend`` group ("gloo" or "nccl") and return the results in rank
    order (each must pickle; return host data, not CUDA tensors).

    ``device``: "cuda" (the default, also for None) for
    ``cuda:{rank % device_count}`` (several ranks share a card when there are
    fewer cards than ranks), or "cpu", which must be named: with no GPU
    present the default raises, as ``resolve_device`` does.  ``fn`` must
    be importable by name from a module that the spawned ranks can import
    (the ranks start a fresh interpreter).  Each rank runs with one CPU
    thread.  ``collective_timeout`` bounds every collective of the group;
    ``timeout`` bounds the whole run: past it, or as soon as a rank fails,
    every rank still running is killed and RuntimeError is raised with the
    failed ranks' tracebacks.  The rendezvous file, the call and the
    results go through a temporary directory, removed after."""
    if world < 1:
        raise ValueError(f"world {world} < 1")
    device = "cuda" if device is None else device
    resolve_device(device)
    tmp = Path(tempfile.mkdtemp(prefix="ranks-"))
    # The call goes through a file: arguments pickled into the spawn pipe
    # would make each start() wait until that rank's interpreter is up.
    with open(tmp / "call.pkl", "wb") as f:
        pickle.dump((fn, args), f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, device, str(tmp),
                               collective_timeout))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = []
        while True:
            alive = [p for p in procs if p.exitcode is None]
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed or not alive:
                break
            if time.monotonic() > deadline:
                break
            alive[0].join(0.05)
        hung = [r for r, p in enumerate(procs) if p.exitcode is None]
        for p in procs:
            if p.exitcode is None:
                p.kill()
        for p in procs:
            p.join(10)
        if failed or hung:
            # Every traceback written, also by a rank that had not yet been
            # reaped when the first failure was seen.
            notes = [f"rank {r} exited with code {procs[r].exitcode}"
                     for r in failed]
            notes += [f"rank {r}:\n{(tmp / f'rank{r}.err').read_text()}"
                      for r in range(world)
                      if (tmp / f"rank{r}.err").exists()]
            if hung and not failed:
                notes.append(f"ranks {hung} still running after {timeout} s")
            raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, "
                               f"world={world}, {backend}) failed:\n"
                               + "\n".join(notes))
        results = []
        for r in range(world):
            with open(tmp / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
