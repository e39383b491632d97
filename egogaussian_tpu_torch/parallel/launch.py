"""Start a (scene, data) grid of ranks on this host.

`spawn(fn, n_scene, n_data, backend, device, args, timeout)` runs
fn(mesh, *args) on n_scene * n_data processes
(`torch.multiprocessing.spawn`), each with its default process group
initialized from a file store in a temporary directory and its
`make_mesh` grid built. It returns every rank's return value in rank order
and re-raises any rank's failure in the parent (the other ranks are then
terminated).

Every wait is bounded by `timeout` (default: the module's WAIT_LIMIT, read
when spawn is called, so a caller can lower it for the runs a CLI
starts): each collective and barrier of the ranks' process group, and
the ranks' whole run, which the parent joins with that deadline. A rank
that stops answering, inside a collective or outside one, ends the run:
the parent terminates every rank still running and raises TimeoutError.

The backend is explicit and never swapped for another:
  * "nccl": rank r on cuda:r; refuses more ranks than visible GPUs (NCCL
    takes one GPU per rank).
  * "gloo": rank r on cuda:(r mod GPU count) for device "cuda" (ranks may
    share a card), or on the CPU for device "cpu".
An unavailable backend or device raises.

Ranks run with the parent's intra-op thread count (CPU reductions split by
it, so a rank's sums match the parent's). Each rank's kernel launch
counters are added to the parent's after the ranks end, so a caller that
resets the counters, spawns and reads them sees the launches its ranks
made. With device "cuda" the parent builds the kernel library before
spawning, once, where the ranks would each run nvcc.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from egogaussian_tpu_torch.parallel.mesh import make_mesh

BACKENDS = ("nccl", "gloo")
# a rank may wait at a barrier while its scene row's first rank runs the
# pose stages (pipeline.py): hours at the reference schedule. A rank that
# fails ends the run from the parent, so the wait never outlives a fault;
# one that hangs ends it at this limit (spawn's default timeout).
WAIT_LIMIT = datetime.timedelta(hours=48)
# how often the parent looks at its ranks while it waits for them
_POLL_S = 1.0


def placeable(backend: str, device: torch.device) -> int:
    """How many ranks `backend` can place for `device` (0: none); a large
    number where it places any number."""
    if backend == "nccl":
        if device.type != "cuda" or not dist.is_nccl_available():
            return 0
        return torch.cuda.device_count()
    if backend == "gloo":
        if not dist.is_gloo_available():
            return 0
        if device.type == "cuda":
            return 1 << 30 if torch.cuda.is_available() else 0
        return 1 << 30 if device.type == "cpu" else 0
    raise ValueError(f"unknown backend {backend!r}: expected one of {BACKENDS}")


def default_backend(device: torch.device) -> str:
    """nccl on the card, gloo on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def _counters():
    from egogaussian_tpu_torch.render.cuda_raster import TileGridCompositor
    from egogaussian_tpu_torch.render.stream_raster import StreamCompositor
    from egogaussian_tpu_torch.render.window_raster import (
        WindowChunkedCompositor,
        WindowCompositor,
    )

    return [(cls, attr) for cls in (TileGridCompositor, StreamCompositor,
                                    WindowChunkedCompositor, WindowCompositor)
            for attr in ("fwd_launches", "bwd_launches", "bwd_exact_launches")
            if hasattr(cls, attr)]


def _rank_main(rank: int, fn, n_scene: int, n_data: int, backend: str, device_type: str,
               threads: int, tmp: str, timeout: datetime.timedelta, args) -> None:
    torch.set_num_threads(threads)
    if device_type == "cuda":
        device = torch.device("cuda", rank if backend == "nccl"
                              else rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    world = n_scene * n_data
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timeout)
    try:
        mesh = make_mesh(n_data=n_data, n_scene=n_scene, device=device)
        out = fn(mesh, *args)
        launches = [dict(getattr(cls, attr)) for cls, attr in _counters()]
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump((out, launches), f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable[..., Any], n_scene: int, n_data: int, backend: str,
          device: torch.device, args: Sequence = (),
          timeout: Optional[datetime.timedelta] = None) -> List[Any]:
    """fn(mesh, *args) on every rank of an n_scene x n_data grid; returns
    the ranks' return values in rank order (each must pickle). `fn` must be
    importable by name (a module-level function). `timeout` (None:
    WAIT_LIMIT) bounds each wait of the ranks' process group and their
    whole run; past it the ranks are terminated and TimeoutError raised."""
    timeout = WAIT_LIMIT if timeout is None else timeout
    world = n_scene * n_data
    if n_scene < 1 or n_data < 1:
        raise ValueError(f"mesh {n_scene}x{n_data}: every axis needs a rank")
    n = placeable(backend, device)
    if world > n:
        raise RuntimeError(f"backend {backend} places {n} ranks on {device.type}, "
                           f"{world} asked for")
    if device.type == "cuda":
        from egogaussian_tpu_torch.render.cuda_raster import build_library

        build_library()
    with tempfile.TemporaryDirectory(prefix="egogs_mesh_") as tmp:
        ctx = torch.multiprocessing.spawn(
            _rank_main, args=(fn, n_scene, n_data, backend, device.type,
                              torch.get_num_threads(), tmp, timeout, tuple(args)),
            nprocs=world, join=False)
        _join(ctx, timeout)
        results = []
        for r in range(world):
            # written by the ranks just spawned, nothing else
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out, launches = pickle.load(f)
            for (cls, attr), counts in zip(_counters(), launches):
                total = getattr(cls, attr)
                for k, v in counts.items():
                    total[k] += v
            results.append(out)
    return results


def _join(ctx, timeout: datetime.timedelta) -> None:
    """Wait for the spawned ranks until `timeout` has passed. A rank's
    failure is re-raised (ProcessContext.join terminates the others);
    past the deadline every rank still running is terminated (killed if
    it ignores that) and TimeoutError raised."""
    deadline = time.monotonic() + timeout.total_seconds()
    while not ctx.join(timeout=max(0.0, min(_POLL_S, deadline - time.monotonic()))):
        if time.monotonic() < deadline:
            continue
        alive = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        raise TimeoutError(f"ranks {alive} still running after {timeout}; terminated")
