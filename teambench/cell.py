"""One run of one cell: set-up, the measured (or profiled) window, the check
of the window's outputs against the reference, and the result.

What a cell runs is its traffic file's ``driver``: ``drivers/<driver>.py``,
found by name, whose ``System(cfg, traffic, seed, device, families)`` builds
the system under test and its inputs from the seed and offers

- ``items_per_step`` and ``shape`` (what the readers and work functions read),
  ``phases`` (seconds of its set-up by part, printed beside ``setup_s``);
- ``step(i)``: dispatch the window's ``i``-th unit of work, return its output;
- ``after_window(kernels)``: read what the check needs from the program
  before it is freed (``kernels``: the traced window's, else None);
- ``free()``; ``check(outputs)`` -> (checks, failed, ok), run after ``free``;
  ``all_failed()``: whether every step was served wrong.

This module times the steps, reads the metrics and assembles the result.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, Tuple

import torch

from teambench import trace as tracing
from teambench import traffic as gen
from teambench import work
from teambench.manifest import Manifest, family_of
from teambench.readings import Readings


@dataclasses.dataclass
class Cell:
    manifest: Manifest
    workload: Dict[str, Any]
    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    device: torch.device
    system: Any
    setup_s: float = 0.0
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def set_up(manifest: Manifest, workload: str, seed: int, device: torch.device,
           t_start: float) -> Cell:
    """The driver's system from the seed, and the warm-up; ``setup_s``
    counts from ``t_start``."""
    wl = manifest.workload(workload)
    cfg = manifest.config(wl["config"])
    traffic = manifest.traffic(wl["traffic"])
    driver = manifest.driver(traffic["driver"])
    t0 = time.perf_counter()
    system = driver.System(cfg, traffic, seed, device, manifest.kernel_families())
    sync(device)
    t1 = time.perf_counter()
    for i in range(traffic["warmup_batches"]):
        system.step(i)
    sync(device)
    t2 = time.perf_counter()
    phases = {"before_system": t0 - t_start, **system.phases, "warmup": t2 - t1}
    return Cell(manifest, wl, cfg, traffic, seed, device, system, t2 - t_start, phases)


class Stamps:
    """Each step's start and end: events on the card's stream, else the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[Tuple[Any, Any]] = []

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def latencies_ms(self) -> List[float]:
        if self.cuda:
            return [start.elapsed_time(end) for start, end in self.marks]
        return [1e3 * (end - start) for start, end in self.marks]


def dispatch(cell: Cell, until: Callable[[int], bool], stamps: Stamps) -> Tuple[int, Dict[int, Any]]:
    """Send steps in turn, no synchronise between them, while ``until(i)``
    is false (at least one); keep the outputs of the first
    ``check.from_first``, among which the check draws its sample."""
    outputs: Dict[int, Any] = {}
    kept = cell.traffic["check"]["from_first"]
    i = 0
    while i == 0 or not until(i):
        start = stamps.mark()
        out = cell.system.step(i)
        stamps.marks.append((start, stamps.mark()))
        if i < kept:
            outputs[i] = out
        i += 1
    return i, outputs


def _readings(cell: Cell, n: int, window_s: float, stamps: Stamps) -> Readings:
    peaks = work.peaks_for(torch.cuda.get_device_name(cell.device)) if stamps.cuda else None
    peak = torch.cuda.max_memory_allocated(cell.device) if stamps.cuda else 0
    return Readings(cell.system.shape, cell.cfg.get("precision", {}), cell.system.items_per_step, n,
                    window_s, cell.setup_s, stamps.latencies_ms(), peak, peaks)


def measure(cell: Cell, seconds: float):
    """The measured window: steps for ``seconds`` on the host clock, then
    one synchronise; the window ends when the last step has."""
    stamps = Stamps(cell.device)
    sync(cell.device)
    t0 = time.perf_counter()
    n, outputs = dispatch(cell, lambda i: time.perf_counter() - t0 >= seconds, stamps)
    sync(cell.device)
    return _readings(cell, n, time.perf_counter() - t0, stamps), outputs


def profile(cell: Cell):
    """The host's time per step on an idle device, then the profiled window
    of ``trace.batches`` steps; returns the readings, the outputs and the trace."""
    spec = cell.traffic["trace"]
    host = []
    for i in range(spec["host_batches"]):
        sync(cell.device)
        t0 = time.perf_counter()
        cell.system.step(i)
        host.append(1e3 * (time.perf_counter() - t0))
    sync(cell.device)
    stamps = Stamps(cell.device)
    box: Dict[str, Any] = {}

    def body():
        box["n"], box["outputs"] = dispatch(cell, lambda i: i >= spec["batches"], stamps)
        sync(cell.device)

    device_trace = tracing.profile_window(body)
    r = _readings(cell, box["n"], device_trace.window_s, stamps)
    r.host_ms = sum(host) / len(host)
    r.busy_s = device_trace.busy_s
    families = {f["name"]: f for f in cell.manifest.kernel_families()}
    for kernel, seconds in device_trace.kernels.items():
        family = families[family_of(kernel, list(families.values()))]
        r.layer_s[family["layer"]] = r.layer_s.get(family["layer"], 0.0) + seconds
        r.layer_work[family["layer"]] = family.get("work")
    return r, box["outputs"], device_trace


def free_program(cell: Cell) -> None:
    """Drop the system under test, so that the reference runs on a card the program left."""
    cell.system.free()
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()


def device_info(cell: Cell, peak_bytes: int) -> Dict[str, Any]:
    if cell.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(cell.device),
            "count": cell.workload["chips"], "memory_peak_bytes": peak_bytes}


def run(workload: str, seed: int, seconds: float, trace: bool, *, manifest: Manifest,
        device: torch.device, t_start: float) -> Dict[str, Any]:
    """One run of the cell; the result line as a dict (``checks`` last)."""
    cell = set_up(manifest, workload, seed, device, t_start)
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    extra: Dict[str, Any] = {}
    if trace:
        readings, kept, device_trace = profile(cell)
        extra["breakdown"] = tracing.breakdown(device_trace)
    else:
        readings, kept, device_trace = *measure(cell, seconds), None
    outputs = {i: kept[i] for i in gen.check_sample(cell.traffic, seed, len(kept))}
    del kept
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics(kind, workload):
        value = manifest.reader(m["name"])(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_entry = device_info(cell, max(setup_peak, readings.peak_mem_bytes))
    if trace:
        device_entry.update(busy_s=readings.busy_s, window_s=readings.window_s)
    cell.system.after_window(device_trace.kernels if device_trace else None)
    free_program(cell)
    checks, failed, ok = cell.system.check(outputs)
    attempted = readings.n_batches
    if cell.system.all_failed():
        failed = attempted
    return {"correct": ok, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device_entry, **extra, "setup_phases_s": cell.phases, "checks": checks}
