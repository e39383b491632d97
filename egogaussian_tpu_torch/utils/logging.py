"""Training metrics logging.

Port of the metrics half of `egogaussian_tpu/utils/logging.py`:
  * MetricsLogger writes JSONL locally and mirrors to wandb when that
    package is importable and enabled.
  * log_metrics() emits through the installed logger; trainers call it
    only at their host-sync boundaries (densify intervals).
"""
from __future__ import annotations

import contextlib
import json
import os
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
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
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


def log_metrics(stage: str, step: int, **metrics: Any) -> None:
    """Emit stage metrics through the active logger (no-op when none is
    installed). Values may be device scalars: converting them syncs, so
    call this only at host-sync boundaries."""
    if _ACTIVE is not None:
        _ACTIVE.log(step, stage=stage, **metrics)


@contextlib.contextmanager
def active_logger(logger: MetricsLogger):
    """Install `logger` for the enclosed region and close it after."""
    set_active_logger(logger)
    try:
        yield logger
    finally:
        set_active_logger(None)
        logger.close()
