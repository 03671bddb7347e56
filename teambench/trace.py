"""The profiled window: device intervals from ``torch.profiler``'s trace.

The window is the benchmark's own ``record_function`` range around the
traced batches and their final synchronise. Busy time is the union of the
device's kernel, copy and set intervals inside it; each idle gap is named by
the innermost host range that was open when it began.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

WINDOW = "teambench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NAME_CHARS = 160
GAPS = 10  # idle gaps named and kept, longest first


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    kernels: Dict[str, float]           # device seconds inside the window, by kernel name
    gaps: List[Tuple[str, float]]       # idle gaps, longest first: (host range, seconds)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def read_events(events: List[Dict]) -> DeviceTrace:
    """The window's device time from a chrome trace's events (µs)."""
    span = next(e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation")
    w0, w1 = span["ts"], span["ts"] + span["dur"]
    kernels: Dict[str, float] = defaultdict(float)
    intervals = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b > a:
            intervals.append((a, b))
            kernels[e["name"]] += (b - a) * 1e-6
    busy = _union(intervals)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    idle = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                  key=lambda g: g[0] - g[1])[:GAPS]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    gaps = []
    for start, end in idle:
        open_ranges = [e for e in host if e["ts"] <= start < e["ts"] + e["dur"]]
        name = min(open_ranges, key=lambda e: e["dur"])["name"] if open_ranges else "host idle"
        gaps.append((name[:NAME_CHARS], (end - start) * 1e-6))
    return DeviceTrace((w1 - w0) * 1e-6, sum(b - a for a, b in busy) * 1e-6, dict(kernels), gaps)


def profile_window(body: Callable[[], None]) -> DeviceTrace:
    """Run ``body`` (which ends in a synchronise) under the profiler, inside
    the window range, and read the device's intervals from its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            body()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    del prof
    torch.cuda.synchronize()
    return read_events(events)


def breakdown(trace: DeviceTrace, top: int = 10) -> Dict[str, list]:
    """The kernels that took most device time, and the longest idle gaps."""
    ops = sorted(trace.kernels.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:NAME_CHARS], s] for name, s in ops],
            "idle_gaps": [[name, s] for name, s in trace.gaps[:top]]}
