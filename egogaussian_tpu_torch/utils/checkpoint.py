"""Full-state checkpoints: model, Adam moments, step counts and poses.

Port of `egogaussian_tpu/utils/checkpoint.py`, with its file layout: one
`.npz` holding the state's tensors as `leaf_0`, `leaf_1`, ... and an
optional `__host__` uint8 blob (the pickled host state of
train/ckpt_hook.py), written to `path + ".tmp.npz"` and then renamed over
`path`. Device state and host state land in one atomic rename, so a kill
can never pair a newer state with an older iteration.

A state is a flat sequence of tensors. The port's state types each have
one flatten order, used by save and restore alike (`state_tensors` /
`state_from_tensors`):

  GaussianModel   params in PARAM_FIELDS order, then aux in AUX_FIELDS
                  order (leaf 0 is xyz, so its leading dim is the capacity)
  AdamState       mu's fields, nu's fields (the params' field order), count
  PoseSequence    translations, rotations, solved
  ObjectPose      translation, rot6d
  torch.Tensor    itself

A file of plain arrays reads back bit for bit through the JAX package's
`load_train_state`, and a file of plain arrays JAX writes reads back here.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from egogaussian_tpu_torch.models.gaussians import (
    AUX_FIELDS,
    PARAM_FIELDS,
    GaussianAux,
    GaussianModel,
    GaussianParams,
)
from egogaussian_tpu_torch.models.optim import AdamState
from egogaussian_tpu_torch.models.pose import ObjectPose, PoseSequence


def _fields(x) -> List[str]:
    return [f.name for f in dataclasses.fields(x)]


def _flatten(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, GaussianModel):
        return ([getattr(obj.params, k) for k in PARAM_FIELDS]
                + [getattr(obj.aux, k) for k in AUX_FIELDS])
    if isinstance(obj, AdamState):
        return ([getattr(obj.mu, k) for k in _fields(obj.mu)]
                + [getattr(obj.nu, k) for k in _fields(obj.nu)] + [obj.count])
    if isinstance(obj, (PoseSequence, ObjectPose)):
        return [getattr(obj, k) for k in _fields(obj)]
    raise TypeError(f"no checkpoint flatten order for {type(obj).__name__}")


def _unflatten(like, leaves: List[torch.Tensor]):
    """`like` rebuilt from the front of `leaves` (consumed in place)."""
    def take(n):
        out = leaves[:n]
        del leaves[:n]
        return out

    if isinstance(like, torch.Tensor):
        return take(1)[0]
    if isinstance(like, GaussianModel):
        params = GaussianParams(**dict(zip(PARAM_FIELDS, take(len(PARAM_FIELDS)))))
        aux = GaussianAux(**dict(zip(AUX_FIELDS, take(len(AUX_FIELDS)))))
        return dataclasses.replace(like, params=params, aux=aux)
    if isinstance(like, AdamState):
        names = _fields(like.mu)
        mu = type(like.mu)(**dict(zip(names, take(len(names)))))
        nu = type(like.nu)(**dict(zip(names, take(len(names)))))
        return AdamState(mu=mu, nu=nu, count=take(1)[0])
    if isinstance(like, (PoseSequence, ObjectPose)):
        names = _fields(like)
        return type(like)(**dict(zip(names, take(len(names)))))
    raise TypeError(f"no checkpoint flatten order for {type(like).__name__}")


def state_tensors(state: Sequence[Any]) -> List[torch.Tensor]:
    """The flat tensor list of a sequence of state objects."""
    return [t for obj in state for t in _flatten(obj)]


def state_from_tensors(like: Sequence[Any], tensors: Sequence[torch.Tensor]) -> tuple:
    """The inverse of state_tensors: `like`'s objects rebuilt from tensors."""
    leaves = list(tensors)
    out = tuple(_unflatten(obj, leaves) for obj in like)
    if leaves:
        raise AssertionError(f"{len(leaves)} tensors left over after unflattening")
    return out


def save_train_state(path: str, tensors: Sequence, host_blob: Optional[bytes] = None) -> None:
    """Write tensors (or arrays) as leaf_0.. plus the optional host blob to
    `path`, atomically (tmp file + os.replace)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    for i, x in enumerate(tensors):
        arrays[f"leaf_{i}"] = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                               else np.asarray(x))
    if host_blob is not None:
        arrays["__host__"] = np.frombuffer(host_blob, dtype=np.uint8)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_train_state(path: str, like: Sequence[torch.Tensor], return_host: bool = False):
    """Tensors saved by save_train_state, each with the shape of the same
    leaf of `like` (AssertionError otherwise, as JAX raises) and landing on
    that leaf's device and dtype. With return_host=True also returns the
    host blob (None when the file has none)."""
    with np.load(path) as data:
        n_leaf = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_leaf != len(like):
            raise AssertionError(f"checkpoint has {n_leaf} leaves, expected {len(like)}")
        out = []
        for i, want in enumerate(like):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(want.shape):
                raise AssertionError(
                    f"leaf {i}: checkpoint shape {arr.shape} != expected {tuple(want.shape)}")
            out.append(torch.as_tensor(arr).to(device=want.device, dtype=want.dtype))
        blob = data["__host__"].tobytes() if "__host__" in data.files else None
    return (out, blob) if return_host else out
