"""Run one function on several ranks of one machine.

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``'s
"spawn" method; they meet through a ``FileStore`` in a fresh temporary
directory and join a process group of the named backend. A timeout bounds
the rendezvous, every collective (the process group's own) and the whole
run (the parent's wait), so a deadlocked collective fails in seconds and
never hangs the caller. The tests and ``chip_smoke.py`` share it. On a
machine with one card a rank, ``torchrun`` takes its place: it starts the
ranks and ``parallel.mesh.make_mesh`` joins the process group it set up.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn"]


def _child(rank, world, fn, args, backend, device, store_path, timeout, results):
    try:
        args = pickle.loads(args)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else rank % torch.cuda.device_count())
        dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            value = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(value)))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, *, backend: str, device, timeout: float = 300.0,
          args=()) -> list:
    """``fn(rank, world, *args)`` on ``world`` ranks; returns their return
    values in rank order.

    ``fn``, ``args`` and the return values must pickle (a module-level
    function; tensors on the CPU). ``backend``: the process group's,
    "gloo" or "nccl". ``device``: "cpu"; "cuda" (rank r on
    card r modulo the cards, as NCCL wants); or "cuda:i" (every rank on card
    i, which only gloo allows). A rank that raises fails the call with its
    traceback (``RuntimeError``); ranks that have not all returned within
    ``timeout`` seconds are killed and the call raises ``TimeoutError``.
    Every process is stopped before this returns or raises.
    """
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        # Arguments and results travel pickled by value: torch would share a
        # CPU tensor's memory between the processes, and with it every
        # in-place update one rank makes.
        payload = pickle.dumps(tuple(args))
        procs = [ctx.Process(target=_child, args=(r, world, fn, payload, backend, str(device),
                                                  store, timeout, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        done = {}
        try:
            while len(done) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"spawn: ranks {sorted(set(range(world)) - set(done))} "
                                       f"did not finish within {timeout} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    # _child reports before a normal exit; a code other
                    # than 0 is a rank killed or crashed without a report.
                    lost = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode not in (None, 0)]
                    if lost:
                        raise RuntimeError(f"spawn: rank {lost[0]} exited with code "
                                           f"{procs[lost[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
                done[rank] = pickle.loads(value)
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
            results.close()
    return [done[r] for r in range(world)]
