"""Mid-stage checkpoints for the long training loops.

Port of `egogaussian_tpu/train/ckpt_hook.py`. The pipeline resumes at
stage granularity from its PLY and pose files (pipeline.py); this hook adds
iteration granularity inside a stage: every `every` iterations it
snapshots the stage's state (model, Adam state, poses; utils/checkpoint.py
gives the flatten order), the iteration, the host RandomState, the
densify torch.Generator and an optional host payload into one npz, and a
fresh run of the same stage resumes from the latest snapshot.

The host blob pickles {"it", "rng": RandomState.get_state(),
"gen": Generator.get_state(), "extra"}: the torch generator state takes
the place of JAX's PRNG key, so a stage checkpoint written by the JAX
package does not resume here (and the reverse), although files of plain
arrays are interchangeable (utils/checkpoint.py).

Tensors inside `extra` are copied to the host only when a save happens:
the save is the only host sync the hook adds, at the save interval.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from egogaussian_tpu_torch.models.gaussians import ensure_capacity
from egogaussian_tpu_torch.utils.checkpoint import (
    load_train_state,
    save_train_state,
    state_from_tensors,
    state_tensors,
)
from egogaussian_tpu_torch.utils.console import CONSOLE
from egogaussian_tpu_torch.utils.logging import log_metrics


def _to_host(x):
    """`x` with every tensor inside dicts, lists and tuples as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


class StageCheckpointer:
    def __init__(self, path: Optional[str], every: int = 0, mesh=None):
        """path=None or every=0 turns checkpointing off. `mesh`
        (parallel/mesh.py): its rank (s, 0) alone writes the file, and the
        scene row waits at a barrier after each save; every rank restores
        from the same file."""
        self.path = path
        self.every = every
        self.mesh = mesh
        self.extra: Any = None

    def maybe_save(self, it: int, state: Sequence[Any], rng: np.random.RandomState,
                   gen: torch.Generator, extra: Any = None) -> None:
        """Save `state` (a sequence of state objects) when `it` is a
        multiple of `every`. `extra`: an optional picklable host payload
        (tensors in it are copied to the host here), given back as
        `self.extra` by try_restore."""
        if not self.path or not self.every or it % self.every:
            return
        if self.mesh is None or self.mesh.writes:
            blob = pickle.dumps({"it": it, "rng": rng.get_state(), "gen": gen.get_state(),
                                 "extra": _to_host(extra)})
            save_train_state(self.path, state_tensors(state), host_blob=blob)
        if self.mesh is not None:
            self.mesh.barrier()

    def exists(self) -> bool:
        return bool(self.path) and os.path.exists(self.path)

    def peek_capacity(self) -> int:
        """Capacity (leading dim of leaf 0, the model's xyz) of the saved
        state, so the caller can grow a fresh model to it before restore."""
        with np.load(self.path) as data:
            return int(data["leaf_0"].shape[0])

    def try_restore(self, state_like: Sequence[Any], rng: np.random.RandomState,
                    gen: torch.Generator, stage: str = "ckpt") -> Tuple[tuple, int]:
        """(state, start iteration); the iteration is 0 and `state_like`
        comes back when there is no checkpoint (or it has no host blob).
        Sets `rng` and `gen` in place; the saved payload is `self.extra`
        afterwards. Logs a metrics record event="ckpt_resume" (it, file)
        under `stage`."""
        self.extra = None
        state_like = tuple(state_like)
        if not self.exists():
            return state_like, 0
        like = state_tensors(state_like)
        tensors, blob = load_train_state(self.path, like, return_host=True)
        if blob is None:  # no host payload: unusable
            return state_like, 0
        host = pickle.loads(blob)
        rng.set_state(host["rng"])
        gen.set_state(host["gen"])
        self.extra = host.get("extra")
        it = int(host["it"])
        CONSOLE.log(f"[ckpt] resuming {stage} from iteration {it} ({self.path})")
        log_metrics(stage, it, event="ckpt_resume", file=os.path.basename(self.path))
        return state_from_tensors(state_like, tensors), it


def grow_to_capacity(model, opt_state, capacity: int):
    """Double a fresh model (and its Adam moments) until it reaches the
    capacity of a saved state, which grew from the same start by
    doubling, so the saved tensors restore into its shapes."""
    while model.capacity < capacity:
        model, opt_state, _ = ensure_capacity(model, opt_state, min_free=model.capacity + 1)
    return model, opt_state


def restore_loop(extra: dict, device) -> dict:
    """A trainer's saved loop state (tile config, running-max counters,
    crop window) with its arrays back on `device` as tensors. The trainers
    save it beside the tensors so that a resumed run renders with the
    capacities and crop window the unbroken run had at that iteration."""
    return {k: torch.as_tensor(v, device=device) if isinstance(v, np.ndarray) else v
            for k, v in extra.items()}
