"""Training metrics logging.

Port of `egogaussian_tpu/utils/logging.py`:
  * MetricsLogger writes JSONL locally and mirrors to wandb when that
    package is importable and enabled.
  * log_metrics() emits through the installed logger; trainers call it
    only at their host-sync boundaries (densify intervals).
  * trace(): a torch.profiler trace of a region, written to a directory.
  * StepTimer: steady-state steps per second, the warm-up steps left out.
  * span(name) / @spanned(name): a named range of the training step in
    whatever profiler trace is being recorded (`trace(dir)`, or a
    benchmark's), `spanned` over the backward too; with no profiler
    recording either does nothing but ask whether one is.

What an operator sees in `trace(dir)`'s Chrome trace: beside PyTorch's own
ops, the training step's spans, each as "egogs.<name>":
  project    the covariance (models/gaussians.py) and the EWA projection
             (render/project.py), forward and backward
  bin        tile binning (render/tiled.py:bin_scenes), forward only
  layout     the pair layouts (render/tiled.py:*_layout_scenes): slot
             sources and the pair gather, forward and backward; `bin`
             runs inside it
  composite  the compositor kernels and their glue
             (render/tiled.py:composite_scenes), forward and backward
  loss       the hand-mask gating and L1 + SSIM (train/common.py:
             mask_grad, image_loss), forward and backward
  adam       the densify statistics and the Adam update
             (parallel/multi_scene.py, models/optim.py:adam_update)
  densify    clone, split and prune (models/densify.py)
  step       one iteration of a stage loop, up to the step's return
             (parallel/scene_trainer.py)
  interval   the densify / regrow / log / reset / checkpoint block of a
             stage loop
A kernel launched inside a span belongs to the innermost one open on the
launching thread: the forward's on the calling thread, the backward's on
autograd's device thread, where a layer's span opens when the gradient
reaches its outputs and closes when it leaves through its inputs.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from typing import Any, Optional

import torch


class MetricsLogger:
    def __init__(
        self,
        log_dir: Optional[str] = None,
        use_wandb: bool = False,
        project: str = "egogaussian_tpu",
        run_name: Optional[str] = None,
    ):
        self._file = None
        self._wandb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            # line-buffered: each record reaches the file whole when it is
            # logged, so a killed run leaves no torn line for a resumed one
            # to append to
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=project, name=run_name)
            except Exception:  # offline / not installed: JSONL only
                self._wandb = None

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": int(step)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(rec, step=int(step))

    def flush(self) -> None:
        if self._file:
            self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None


# The installed logger: a pipeline installs one MetricsLogger; stage trainers
# emit through log_metrics() at their host-sync boundaries only.
_ACTIVE: Optional[MetricsLogger] = None


def set_active_logger(logger: Optional[MetricsLogger]) -> None:
    global _ACTIVE
    if _ACTIVE is not None and logger is not _ACTIVE:
        _ACTIVE.flush()
    _ACTIVE = logger


def get_active_logger() -> Optional[MetricsLogger]:
    return _ACTIVE


def log_metrics(stage: str, step: int, **metrics: Any) -> None:
    """Emit stage metrics through the active logger (no-op when none is
    installed). Values may be device scalars: converting them syncs, so
    call this only at host-sync boundaries."""
    if _ACTIVE is not None:
        _ACTIVE.log(step, stage=stage, **metrics)


@contextlib.contextmanager
def use_logger(logger: Optional[MetricsLogger]):
    """Route log_metrics to `logger` in the enclosed region and restore the
    one installed before (None leaves it as it is); the logger stays open.
    The lockstep drivers log each scene to its own video's logger."""
    if logger is None:
        yield get_active_logger()
        return
    previous = get_active_logger()
    set_active_logger(logger)
    try:
        yield logger
    finally:
        set_active_logger(previous)


@contextlib.contextmanager
def active_logger(logger: MetricsLogger):
    """Install `logger` for the enclosed region and close it after."""
    set_active_logger(logger)
    try:
        yield logger
    finally:
        set_active_logger(None)
        logger.close()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the enclosed region (CPU, and CUDA when a
    card is present), written as a Chrome trace under log_dir (view with
    chrome://tracing or Perfetto). Usage: `with trace(dir): ... steps ...`"""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    """Steady-state step rate: call tick() after every step. The first
    `warmup` steps (first allocations, kernel builds) are left out:
    steps_per_sec is the steps after them over the time since the last of
    them ended (None until one such step). End each step in a sync when
    the device's time is to be counted."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._ticks = 0
        self._t0: Optional[float] = time.perf_counter() if warmup == 0 else None
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        """Record a finished step; returns the steady-state seconds per
        step so far, or None."""
        self._last = time.perf_counter()
        self._ticks += 1
        if self._ticks == self.warmup:
            self._t0 = self._last
        rate = self.steps_per_sec
        return None if rate is None else 1.0 / rate

    @property
    def steps_per_sec(self) -> Optional[float]:
        steps = self._ticks - self.warmup
        if steps <= 0 or self._t0 is None or self._last == self._t0:
            return None
        return steps / (self._last - self._t0)


SPAN_PREFIX = "egogs."
_profiler_enabled = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager naming a region of the training step in the trace a
    profiler is recording, as "egogs.<name>" (forward only: for a layer
    whose backward is to carry the name too, see `spanned`). With no
    profiler recording it is a shared object that does nothing: no range,
    no launch, no sync."""
    if not _profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


def spanned(name: str):
    """Decorator: each call runs in span(name), and while a profiler records,
    the backward of what the call computed is recorded under the same name.
    Every tensor that takes a gradient among the call's arguments and among
    its results (inside tuples, lists, dicts and named tuples too) passes
    through an identity marker: the gradient reaching the results' marker
    opens the backward's range, leaving through the arguments' marker
    closes it, both on the thread that runs the backward. With no profiler
    recording the call is the function's own: no marker enters the
    autograd graph."""
    full = SPAN_PREFIX + name

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(full):
                bwd = _BackwardRange(full)
                (args, kwargs), marked = _mark(bwd.close, (args, kwargs))
                out = fn(*args, **kwargs)
                # a range opened on the results must close on the arguments
                return _mark(bwd.open, out)[0] if marked else out

        return call

    return wrap


class _BackwardRange:
    """The record_function range of one call's backward."""

    def __init__(self, name: str):
        self.name = name
        self._open = []

    def open(self):
        rf = torch.profiler.record_function(self.name)
        rf.__enter__()
        self._open.append(rf)

    def close(self):
        if self._open:
            self._open.pop().__exit__(None, None, None)


def _mark(action, tree):
    """(tree with each tensor that takes a gradient, also inside tuples,
    named tuples, lists and dicts, passed through one _Marker calling
    `action`, whether any was)."""
    found, holders = [], set()
    _collect(tree, found, holders)
    if not found or not torch.is_grad_enabled():
        return tree, False
    return _replace(tree, iter(_Marker.apply(action, *found)), holders), True


def _collect(x, found, holders) -> bool:
    """Appends x's tensors that take a gradient to `found`, and the id of
    each container holding one to `holders`; whether x holds one."""
    if isinstance(x, torch.Tensor):
        if x.requires_grad:
            found.append(x)
        return x.requires_grad
    if isinstance(x, (tuple, list)):
        held = [_collect(y, found, holders) for y in x]
    elif isinstance(x, dict):
        held = [_collect(y, found, holders) for y in x.values()]
    else:
        return False
    if any(held):
        holders.add(id(x))
        return True
    return False


def _replace(x, marked, holders):
    """x with its tensors that take a gradient taken from `marked`, in the
    order _collect found them (containers holding none kept as they are)."""
    if isinstance(x, torch.Tensor):
        return next(marked) if x.requires_grad else x
    if id(x) not in holders:
        return x
    if isinstance(x, dict):
        return {k: _replace(v, marked, holders) for k, v in x.items()}
    ys = [_replace(y, marked, holders) for y in x]
    if isinstance(x, list):
        return ys
    return type(x)(*ys) if hasattr(x, "_fields") else tuple(ys)


class _Marker(torch.autograd.Function):
    """Identity on tensors whose backward calls `action` first."""

    @staticmethod
    def forward(ctx, action, *xs):
        ctx.set_materialize_grads(False)  # an unused output stays without a gradient
        ctx.action = action
        # detached, not returned as they are: an output of a Function that is
        # one of its inputs becomes a view, which refuses in-place updates
        return tuple(x.detach() for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.action()
        return (None,) + grads
