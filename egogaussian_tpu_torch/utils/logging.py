"""Training metrics logging.

Port of `egogaussian_tpu/utils/logging.py`:
  * MetricsLogger writes JSONL locally and mirrors to wandb when that
    package is importable and enabled.
  * log_metrics() emits through the installed logger; trainers call it
    only at their host-sync boundaries (densify intervals).
  * trace(): a torch.profiler trace of a region, written to a directory.
  * StepTimer: steady-state steps per second, the warm-up steps left out.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Optional


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
    import torch
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
