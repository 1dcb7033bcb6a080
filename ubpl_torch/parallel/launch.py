"""Process launch of a data-parallel run: one process per device.

It has no counterpart in ``ubpl_tpu``: the JAX package is one controller
that drives every chip of its mesh (``ubpl_tpu/parallel/mesh.py``); the
port runs one process per card.  ``launch(fn, mesh, device_type)`` runs
``fn(rank_ctx, *args)`` on every rank of ``mesh`` and returns the ranks'
results in rank order:

  * under ``torchrun`` (``RANK``/``WORLD_SIZE`` in the environment) the
    process joins the world torchrun made (``env://``) and runs its own
    rank only; the list holds that one result;
  * otherwise it spawns ``mesh.size`` processes (``multiprocessing``'s
    spawn method) that meet at a file of their own (``file://`` in a fresh
    temporary directory): no port to pick, so two launches at once on one
    host cannot meet at the same address.

Each rank's device is ``cuda:{local_rank}`` (set as the current device
before the process group starts) or ``cpu``, where each rank computes with
its share of the launching process's torch threads (under torchrun, of the
host's cores): several processes with a thread per core each slow one
another down many times over.  The backend is NCCL on CUDA
and gloo on the CPU; ``backend="gloo"`` on CUDA puts several ranks on one
card (``cuda:{local_rank % device_count}``), which NCCL refuses — the smoke
run uses it to run two ranks on its one card.

A rank that raises stops the launch: the others are terminated and
``launch`` raises with the failing rank's traceback.  ``timeout`` (seconds)
bounds the whole launch and each collective, so a hang fails too.
"""
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist


class RankContext(NamedTuple):
    mesh: object            # parallel.mesh.Mesh
    rank: int
    local_rank: int
    device: torch.device


def _rank_device(device_type, local_rank, threads, backend):
    if device_type != "cuda":
        torch.set_num_threads(threads)
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if local_rank >= n and backend == "nccl":
        raise RuntimeError(f"local rank {local_rank} has no card of its own "
                           f"({n} on this host): NCCL runs one rank per card")
    device = torch.device("cuda", local_rank % n)
    torch.cuda.set_device(device)
    return device


def _init(rank, world, local_rank, threads, mesh, device_type, backend,
          init_method, timeout):
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    device = _rank_device(device_type, local_rank, threads, backend)
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kw)
    return RankContext(mesh, rank, local_rank, device)


def _worker(rank, world, threads, mesh, device_type, backend, init_method,
            timeout, fn, args, results):
    """One spawned rank: run ``fn`` and report its result or traceback."""
    try:
        ctx = _init(rank, world, rank, threads, mesh, device_type, backend,
                    init_method, timeout)
        out = fn(ctx, *args)
    except BaseException:       # reported to the parent, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put((rank, True, out))


def under_torchrun():
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def world_size_from_env():
    return int(os.environ["WORLD_SIZE"])


def launch(fn, mesh, device_type, backend=None, args=(), timeout=None):
    """Run ``fn(ctx, *args)`` on every rank of ``mesh`` (see the module
    docstring).  ``fn`` and ``args`` are pickled for spawned ranks: ``fn``
    must be a module-level function.  Returns the results in rank order."""
    if under_torchrun():
        world = world_size_from_env()
        if world != mesh.size:
            raise ValueError(f"mesh {mesh.shape} has {mesh.size} devices, "
                             f"torchrun started {world} processes")
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        ctx = _init(int(os.environ["RANK"]), world,
                    int(os.environ.get("LOCAL_RANK", 0)),
                    max(1, (os.cpu_count() or 1) // local_world), mesh,
                    device_type, backend, "env://", timeout)
        try:
            return [fn(ctx, *args)]
        finally:
            dist.destroy_process_group()
    mp = torch.multiprocessing.get_context("spawn")
    results = mp.Queue()
    meet = tempfile.mkdtemp(prefix="ubpl_launch_")
    init_method = "file://" + os.path.join(meet, "store")
    threads = max(1, torch.get_num_threads() // mesh.size)
    procs = [mp.Process(target=_worker, daemon=True, args=(
        r, mesh.size, threads, mesh, device_type, backend, init_method,
        timeout, fn, args, results)) for r in range(mesh.size)]
    for p in procs:
        p.start()
    try:
        return _collect(procs, results, timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(meet, ignore_errors=True)


def _collect(procs, results, timeout):
    """Each rank's result, in rank order; raises for the first rank that
    failed, died without a word, or outlived ``timeout``."""
    deadline = None if timeout is None else time.monotonic() + timeout
    got = {}
    while len(got) < len(procs):
        try:
            rank, ok, out = results.get(timeout=1.0)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in got and p.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no "
                                   "result")
            if deadline is not None and time.monotonic() > deadline:
                late = sorted(set(range(len(procs))) - set(got))
                raise TimeoutError(f"ranks {late} did not finish in time")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{out}")
        got[rank] = out
    return [got[r] for r in range(len(procs))]
