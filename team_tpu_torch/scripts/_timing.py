"""Timing shared by the probe entry points."""

from __future__ import annotations

import time
from typing import Callable

import torch


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def best_seconds(run: Callable[[], torch.Tensor], device: torch.device, rounds: int) -> float:
    """The fastest of ``rounds`` calls of ``run`` after one warm-up call: CUDA
    events around each call on the card (the inputs are on the device
    already), the host clock on the CPU."""
    run()
    best = float("inf")
    for _ in range(rounds):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize(device)
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
    return best


def spin_ms(run: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds a call of ``run`` over ``iters`` calls after
    ``warmup`` ones, CUDA events around them. The card first spins for some
    20 ms, so that the host has queued every call before the start event:
    the time is the device's, not the host's launch rate (a kernel of 0.03
    ms launches slower than it runs)."""
    for _ in range(warmup):
        run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)  # cycles, about 20 ms at the H100's clock
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
