"""The (scene, data) process grid and its collectives.

Port of `egogaussian_tpu/parallel/mesh.py`. A JAX mesh is one process over
several devices; here a mesh is a grid of `torch.distributed` ranks of the
initialized default process group, rank = s * D + d on S scene rows of D
data ranks each:

  * `data` axis: frame-data parallelism. The ranks of one scene row render
    different frames against replicated Gaussians, and their gradients
    are reduced over the row.
  * `scene` axis: multi-scene parallelism. Each scene row trains its own
    videos (the reference's one job per video).

`make_mesh` creates one `data` subgroup per scene row and one `scene`
subgroup per data column. `torch.distributed.new_group` must be called by
every rank of the default group, for every subgroup, in the same order, so
every rank creates all of them.

Reductions are deterministic: `gather_blocks` gathers each rank's flat
buffer, and every rank reduces the blocks in rank order itself (no float
atomics), so every replica holds the same bits. gloo's collectives run on
host memory: a CUDA buffer on a gloo mesh is copied to the host for the
collective and back (one copy each way per collective). NCCL runs on the
card's tensors directly and adds no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the grid. `shape` = {"scene": S, "data": D} (as
    JAX's mesh.shape); `coords` its (scene, data) coordinates; `groups[a]`
    the subgroup of this rank's ranks along axis a (its scene row for
    "data", its data column for "scene") and `ranks[a]` their global
    ranks in axis order; `device` where this rank computes."""

    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, Any]
    ranks: Dict[str, List[int]]
    device: torch.device
    backend: str

    @property
    def writes(self) -> bool:
        """Whether this rank writes its scene row's files: rank (s, 0)."""
        return self.coords["data"] == 0

    def barrier(self, axis: str = "data") -> None:
        """Wait for every rank along `axis`."""
        dist.barrier(group=self.groups[axis])


def make_mesh(n_data: Optional[int] = None, n_scene: int = 1,
              device: Optional[torch.device] = None) -> Mesh:
    """The (scene, data) grid over the initialized default process group;
    n_data defaults to world_size // n_scene. `device`: where this rank
    computes; None means the current CUDA device. Raises ValueError when
    n_scene * n_data is not the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process group "
                           "(parallel/launch.py:spawn sets one up)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_scene
    if n_scene < 1 or n_data < 1 or n_scene * n_data != world:
        raise ValueError(f"{n_scene} x {n_data} != {world} ranks")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    s, d = divmod(rank, n_data)
    # every rank creates every subgroup, rows first, in one order
    rows = [[r * n_data + j for j in range(n_data)] for r in range(n_scene)]
    cols = [[r * n_data + j for r in range(n_scene)] for j in range(n_data)]
    row_groups = [dist.new_group(r) for r in rows]
    col_groups = [dist.new_group(c) for c in cols]
    return Mesh(shape={"scene": n_scene, "data": n_data}, rank=rank,
                coords={"scene": s, "data": d},
                groups={"data": row_groups[s], "scene": col_groups[d]},
                ranks={"data": rows[s], "scene": cols[d]},
                device=device, backend=dist.get_backend())


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """`tree` with fn applied to every tensor inside dataclasses, dicts,
    lists, tuples and named tuples; other leaves unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)
            if f.init})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def host_staged(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The tensor a collective of `mesh` takes for x: x itself, or a host
    copy when gloo meets a CUDA tensor."""
    return x.cpu() if mesh.backend == "gloo" and x.is_cuda else x


def replicate(mesh: Mesh, tree):
    """Every tensor of `tree` on mesh.device, broadcast from the first rank
    of this rank's scene row, so the row holds one replica (JAX's
    NamedSharding(mesh, P()))."""
    src = mesh.ranks["data"][0]

    def bcast(x):
        buf = host_staged(mesh, x.to(mesh.device).contiguous())
        dist.broadcast(buf, src=src, group=mesh.groups["data"])
        return buf.to(mesh.device)

    return tree_map(bcast, tree)


def shard_batch(mesh: Mesh, tree, axis: str = "data"):
    """This rank's block of the leading axis of every tensor of `tree`:
    rank d of the axis gets the d-th of n equal contiguous blocks (JAX's
    NamedSharding(mesh, P(axis))). Raises ValueError when the leading axis
    does not divide by the axis size."""
    n, i = mesh.shape[axis], mesh.coords[axis]

    def block(x):
        if x.shape[0] % n:
            raise ValueError(f"leading axis {x.shape[0]} does not divide by {axis}={n}")
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k].to(mesh.device)

    return tree_map(block, tree)


def gather_blocks(mesh: Mesh, flat: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """[n, *flat.shape]: every rank's `flat` along `axis`, in rank order,
    on flat's device (one all_gather; every rank passes the same shape)."""
    buf = host_staged(mesh, flat.contiguous())
    out = [torch.empty_like(buf) for _ in range(mesh.shape[axis])]
    dist.all_gather(out, buf, group=mesh.groups[axis])
    return torch.stack(out).to(flat.device)


def sum_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Sum of blocks[0], blocks[1], ... added in rank order."""
    total = blocks[0]
    for b in blocks[1:]:
        total = total + b
    return total


def max_blocks(blocks: torch.Tensor) -> torch.Tensor:
    total = blocks[0]
    for b in blocks[1:]:
        total = torch.maximum(total, b)
    return total
