"""Step timing and tracing (counterpart of ``team_tpu/analysis/profiler.py``).

* :class:`StepTimer`: rolling per-step wall time and items per second,
  logged every ``log_every`` steps;
* :func:`trace`: a ``torch.profiler`` trace of a block, written to
  ``Config.profile_dir`` (a no-op when it is unset; view with TensorBoard);
* :func:`device_sync`: wait until the card has run what was queued, so a
  host clock around a block measures the device's work too.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import deque
from typing import Optional

import torch


def device_sync(x: Optional[torch.Tensor] = None) -> None:
    """``torch.cuda.synchronize`` on the device of ``x`` (the current card
    when ``x`` is None); nothing for a CPU tensor or without a card."""
    if x is not None:
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(profile_dir: Optional[str], name: str = "train"):
    """``torch.profiler`` trace of the block, written to ``profile_dir`` under
    the worker name ``name`` (a no-op when ``profile_dir`` is unset)."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir, worker_name=name)):
        with torch.profiler.record_function(name):
            yield


class StepTimer:
    """Context manager around one step: keeps the last ``window`` step times
    and logs their mean every ``log_every`` steps (0: never)."""

    def __init__(self, window: int = 50, log_every: int = 0, name: str = "step"):
        self.window = deque(maxlen=window)
        self.log_every = log_every
        self.name = name
        self._count = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.window.append(dt)
        self._count += 1
        if self.log_every and self._count % self.log_every == 0:
            logging.info("%s: %.2f ms/step (avg over %d)", self.name,
                         1e3 * self.mean_time, len(self.window))
        return False

    @property
    def mean_time(self) -> float:
        return sum(self.window) / max(len(self.window), 1)

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.mean_time if self.window else 0.0
