"""Tracing (counterpart of ``team_tpu/analysis/profiler.py``).

* :func:`trace`: a ``torch.profiler`` trace of a block, written to
  ``Config.profile_dir`` (a no-op when it is unset; view with TensorBoard);
* :func:`device_sync`: wait until the card has run what was queued, so a
  host clock around a block measures the device's work too.
"""

from __future__ import annotations

import contextlib
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
