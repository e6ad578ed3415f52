"""Start the ranks of a data-parallel group (or a data,space grid) on this
host.

- `run_ranks(fn, world_size, ...)`: ``fn(mesh, *args)`` in ``world_size``
  fresh processes (the spawn start method), each joined to one group over
  ``tcp://localhost:<free port>`` with its device; returns the ranks'
  results in rank order. Every join and collective has a timeout, and the
  whole run one more: a rank that fails or hangs ends every rank and
  raises here with its traceback.
- `run_cli_ranks(module, argv, world_size)`: ``python -m module argv`` in
  ``world_size`` processes with torchrun's environment (``RANK``,
  ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``); the train CLI's launch over every visible card.

``fn`` and its arguments and results cross process boundaries by pickle:
``fn`` must be importable by name, and results are best numpy arrays or
plain values.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import subprocess
import sys
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

from facesr_torch.parallel.mesh import DEFAULT_TIMEOUT_S

__all__ = ["free_port", "torchrun_env", "run_ranks", "run_cli_ranks"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def torchrun_env(rank: int, world_size: int, port: int) -> dict:
    """The environment torchrun gives rank ``rank`` of a one-host group."""
    return {"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world_size),
            "LOCAL_WORLD_SIZE": str(world_size), "MASTER_ADDR": "localhost",
            "MASTER_PORT": str(port)}


def _rank_main(fn, rank, world_size, port, device, backend, timeout, axis_names, shape, args,
               results):
    import torch.distributed as dist

    from facesr_torch.parallel.mesh import get_mesh

    os.environ.update(torchrun_env(rank, world_size, port))
    try:
        mesh = get_mesh(devices=None if device is None else [device], axis_names=axis_names,
                        shape=shape, backend=backend, timeout=timeout)
        try:
            results.put((rank, True, fn(mesh, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world_size: int, args: Sequence[Any] = (),
              devices: Optional[Sequence[Any]] = None, backend: Optional[str] = None,
              timeout: float = DEFAULT_TIMEOUT_S, run_timeout: Optional[float] = None,
              axis_names: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None
              ) -> List[Any]:
    """``[fn(mesh_r, *args) for r in range(world_size)]``, each in its own
    process on ``devices[r]`` (default: ``cuda:r``); ``backend``,
    ``axis_names`` and ``shape`` as `get_mesh`'s (``("data", "space")``
    with ``shape=(d, s)``: the d * s ranks of a dp x sp grid; ranks that
    share a card need ``backend="gloo"``); ``timeout`` bounds each
    collective, ``run_timeout`` (default ``2 * timeout``) the whole run."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    devs = list(devices) if devices is not None else [None] * world_size
    if len(devs) != world_size:
        raise ValueError(f"{len(devs)} devices for {world_size} ranks")
    procs = [ctx.Process(target=_rank_main, daemon=True, name=f"facesr-rank{r}",
                         args=(fn, r, world_size, port, None if devs[r] is None else str(devs[r]),
                               backend, timeout, tuple(axis_names),
                               None if shape is None else tuple(shape), tuple(args), results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + (run_timeout or 2 * timeout)
    got: dict = {}
    try:
        while len(got) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(got))} "
                                       f"did not finish in {run_timeout or 2 * timeout} s")
                dead = [p.name for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(f"{dead} exited without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30 if len(got) == world_size else 1)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world_size)]


def run_cli_ranks(module: str, argv: Sequence[str], world_size: int,
                  timeout: Optional[float] = None, log_dir: Optional[str] = None,
                  env: Optional[dict] = None, cwd: Optional[str] = None) -> List[int]:
    """``python -m module *argv`` as ``world_size`` ranks of one group (the
    train CLI joins it from the environment), in ``cwd``. With ``log_dir``
    each rank's output goes to ``rank<r>.log`` there, else to this
    process's. When a rank fails, the others are stopped. Returns the exit
    codes."""
    port = free_port()
    procs, logs = [], []
    for r in range(world_size):
        out = None
        if log_dir is not None:
            out = open(os.path.join(log_dir, f"rank{r}.log"), "w")
            logs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv],
            env={**os.environ, **(env or {}), **torchrun_env(r, world_size, port)},
            stdout=out, stderr=subprocess.STDOUT if out is not None else None, cwd=cwd))
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break  # a failed rank: the others would wait on it
            if deadline is not None and time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    return [p.returncode for p in procs]
