"""The measured window, clocked from the program's own step observer.

An entry calls `Window.step(units)` once per completed step (a training
iteration of every video, or a returned frame). The first `warmup` steps
are set-up. The window opens at the next step with a device
synchronisation and the host clock, and closes at the first step after
`seconds` have passed (or, traced, after `trace_steps` steps) with a
second synchronisation; `StopWindow` is then raised out of the program's
loop. Nothing else synchronises, and the observer never reads a device
value, so the program's asynchronous dispatch is what is measured.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch


class StopWindow(Exception):
    """Raised from the observer to end the program's loop."""


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    def __init__(self, device, seconds: float, warmup: int, trace_steps: int = 0,
                 on_open: Optional[Callable[[], None]] = None,
                 on_close: Optional[Callable[[], None]] = None,
                 process_start: Optional[float] = None):
        """`process_start`: the monotonic time set-up is counted from."""
        self.device = device
        self.process_start = time.monotonic() if process_start is None else process_start
        self.seconds = seconds
        self.warmup = warmup
        self.trace_steps = trace_steps
        self.on_open, self.on_close = on_open, on_close
        self.steps = 0  # steps seen, warm-up included
        self.units = 0  # units completed inside the window
        self.window_steps = 0
        self.t_first = self.t_open = self.t_close = None
        self.setup_s = None
        self.marks = []  # host clock after each window step (not synchronised)

    def step(self, units: int = 1) -> None:
        self.steps += 1
        if self.t_first is None:
            self.t_first = time.monotonic()
        if self.t_open is None:
            if self.steps >= self.warmup:
                sync(self.device)
                self.setup_s = time.monotonic() - self.process_start
                if self.on_open is not None:  # the profiler starts outside the window
                    self.on_open()
                    sync(self.device)
                self.t_open = time.monotonic()
            return
        self.units += units
        self.window_steps += 1
        now = time.monotonic()
        self.marks.append(now)
        done = (self.window_steps >= self.trace_steps if self.trace_steps
                else now - self.t_open >= self.seconds)
        if done:
            sync(self.device)
            self.t_close = time.monotonic()
            if self.on_close is not None:
                self.on_close()
            raise StopWindow()

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open
