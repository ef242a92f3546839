"""Start a world of ranks, one process each, and collect their results.

JAX runs one controller over every device, so the JAX package has no
counterpart of this module.  The port runs one process per rank:
:func:`run_ranks` starts ``world`` processes with ``torch.multiprocessing``
(start method ``spawn``: each rank imports afresh, so ``fn`` must be a
module-level function), initializes ``torch.distributed`` in each through a
``file://`` store in a fresh temporary directory (parallel test workers
never compete for a port), calls ``fn(*args)`` and returns the ranks'
results in rank order.

A rank that reports its result stays in the world until every rank has
reported (a rank that an elastic shrink lost returns early, and leaves no
peer a closed connection).  A rank that raises fails the call with that
rank's traceback, and the
other ranks are stopped; a collective that waits past ``timeout`` raises in
its rank and so fails the call too; a world that does not finish within
``deadline`` (default ``timeout`` plus the start-up allowance) is stopped
and raises :class:`TimeoutError`.  Nothing hangs, nothing is swallowed, and every
process started is gone when the call returns.

Results travel pickled through a queue: keep them to plain Python, numpy
and CPU tensors.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

__all__ = ["run_ranks", "choose_backend", "STARTUP_S"]

STARTUP_S = 120.0  # allowance for the ranks' imports and CUDA start-up


def choose_backend(device: str, world: int) -> str:
    """``nccl`` when every rank owns a card of its own, ``gloo`` on the CPU
    and for ranks that share one card (NCCL refuses two ranks on one
    device)."""
    if str(device).startswith("cuda"):
        import torch

        if torch.cuda.device_count() >= world:
            return "nccl"
    return "gloo"


def _rank_main(rank, world, fn, args, backend, device, init_file, timeout, out,
               done, limit):
    import torch
    import torch.distributed as dist

    try:
        try:
            if str(device).startswith("cuda"):
                # nccl: a card a rank; gloo on a shared card: all on the first
                torch.cuda.set_device(rank if backend == "nccl" else 0)
            else:
                # a rank's share of the cores: ranks that each take them all
                # spin against each other in every collective
                torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
            dist.init_process_group(backend, init_method=f"file://{init_file}",
                                    rank=rank, world_size=world,
                                    timeout=datetime.timedelta(seconds=timeout))
            result = fn(*args)
            if str(device).startswith("cuda"):
                torch.cuda.synchronize()
            report = (rank, True, pickle.dumps(result))
        except BaseException:  # noqa: BLE001 - reported to the parent, then re-raised
            # the report reaches the pipe before this rank leaves the group, so
            # it precedes the errors its peers then see in their collectives
            out.put((rank, False, traceback.format_exc()))
            out.close()
            out.join_thread()
            raise
        out.put(report)
        # a rank whose body ends early (one a shrunk mesh lost) stays in the
        # world until every rank has reported: it leaves no peer a closed
        # connection, and the world keeps its size for the next body
        done.wait(limit)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _drain(out, grace: float) -> list[int]:
    """The ranks that report a failure within ``grace`` seconds more."""
    failed, end = [], time.monotonic() + grace
    while time.monotonic() < end:
        try:
            rank, ok, _ = out.get(timeout=max(end - time.monotonic(), 0.01))
        except queue_mod.Empty:
            break
        if not ok:
            failed.append(rank)
    return failed


def run_ranks(fn, world: int, *, args: tuple = (), backend: str | None = None,
              device: str = "cpu", init_file: str | None = None,
              timeout: float = 300.0, deadline: float | None = None) -> list:
    """Run ``fn(*args)`` on ``world`` ranks of one ``torch.distributed``
    world and return their results in rank order.

    ``backend`` defaults to :func:`choose_backend` for ``device``
    (``"cpu"`` or ``"cuda"``); ``init_file`` is the ``file://`` store's
    path (default: in a fresh temporary directory, removed afterwards; the
    file must not exist yet); ``timeout`` bounds each collective;
    ``deadline`` the whole call, in seconds from its start (default
    ``timeout`` + :data:`STARTUP_S`: a longer one lets the ranks wait for
    something that is not a collective, and a collective still fails
    after ``timeout``).
    """
    import torch.multiprocessing as mp

    backend = backend or choose_backend(device, world)
    tmpdir = None
    if init_file is None:
        tmpdir = tempfile.mkdtemp(prefix="repro_ranks_")
        init_file = os.path.join(tmpdir, "store")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    done = ctx.Event()
    limit = timeout + STARTUP_S if deadline is None else deadline
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, fn, args, backend, device, init_file,
                               timeout, out, done, limit))
             for r in range(world)]
    results: dict[int, object] = {}
    failure = None
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + limit
        while len(results) < world and failure is None:
            left = end - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world)) - set(results))
                raise TimeoutError(f"ranks {missing} of {world} did not finish "
                                   f"within {limit:.0f} s")
            try:
                rank, ok, payload = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in results]
                if dead and out.empty():
                    # a rank died without reporting (killed, or a crash in C)
                    time.sleep(0.5)
                    if out.empty():
                        failure = (dead[0], f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no report")
                continue
            if ok:
                results[rank] = pickle.loads(payload)
            else:
                failure = (rank, payload)
        if failure is not None:
            rank, tb = failure
            others = _drain(out, 2.0)
            also = f"\n(ranks {others} failed after it)" if others else ""
            raise RuntimeError(f"rank {rank} of {world} failed:\n{tb}{also}")
    finally:
        done.set()
        for p in procs:
            if p.is_alive() and (failure is not None or len(results) < world):
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        out.close()
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)
    return [results[r] for r in range(world)]
