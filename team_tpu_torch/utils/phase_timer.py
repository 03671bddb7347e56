"""Host spans and counters of the port (its copy of ``team_tpu/utils/phase_timer.py``,
extended).

A span is a named stretch of the host's work: ``with phase(name):`` around a
protocol phase or a stage of the image tower's encode. It covers the stage's
host dispatch, so every kernel launched inside it belongs to it. With tracing
on, each span

- opens a ``torch.profiler.record_function`` range of its name, which lands
  in a profiler's trace beside the device's kernels, on one clock;
- records its parent, the innermost span open on its thread;
- adds its host duration to its name's count, sum, first call, mean of the
  rest and self time (the duration less its child spans'), and keeps its
  first ``CALLS_KEPT`` durations.

``count(name, n)`` adds to a counter kept beside the spans. :func:`report`
gives both. Tracing is off unless ``TEAM_PHASE_TIMES=1`` is set when the
module is imported or :func:`enable` turns it on. Off, ``phase`` returns one
preallocated no-op context and ``count`` returns at once: a disabled span
is a dict lookup and two calls into C (0.10-0.18 µs on the H100 machine's
host), and records nothing; an enabled one costs 12-15 µs there, most of it
the profiler range.

Spans nest (``task_total`` holds ``train_epochs``; ``runtime.encode_image``
holds the tower's stages): sum the self times, not everything.
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

from torch.autograd.profiler import record_function

# the spans and counter of the encode path, by the names that readers of the
# benchmark's traces import
ENCODE_IMAGE = "runtime.encode_image"   # BackboneRuntime.encode_image, every route
CALIBRATE = "runtime.calibrate"         # the int8 tier's calibration forward and quantize
GATE = "runtime.gate"                   # the int8 tier's held-out gate, commit or fallback
EMBED = "tower.embed"                   # input normalize, patch GEMM, CLS and positions, ln_pre
ATTN_BLOCK = "tower.attn_block"         # LN1, qkv GEMM, attention, out GEMM, residual
MLP_BLOCK = "tower.mlp_block"           # LN2, fc GEMM, GELU, proj GEMM, residual
HEAD = "tower.head"                     # ln_post and the projection, or SigLIP's attention pool
KERNELS_BUILD = "kernels.build"         # the nvcc jobs of one build
KERNELS_BUILT = "kernels.built"         # counter: sources compiled
FLASH_CALLS = "attention.flash_calls"   # counter: calls of the flash kernel's entry

CALLS_KEPT = 64  # durations kept a name, the first ones: memory stays bounded

_on = os.environ.get("TEAM_PHASE_TIMES", "0") == "1"
_local = threading.local()


class _Stat:
    __slots__ = ("count", "sum", "self", "calls", "parents")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.self = 0.0
        self.calls = []
        self.parents: Dict[Optional[str], int] = defaultdict(int)


_SPANS: Dict[str, _Stat] = defaultdict(_Stat)
_COUNTERS: Dict[str, int] = defaultdict(int)


class _Off:
    """The span of a disabled timer. Its methods are ``"".format``, bound
    once: a call into C that takes any arguments and returns ``""``, which is
    false, so an exception passes through; no Python frame runs."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()


def _stack() -> list:
    """This thread's open spans, innermost last: [span, start, child seconds, range]."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """A name's span while tracing is on."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rf = record_function(self.name)
        rf.__enter__()
        _stack().append([self, time.perf_counter(), 0.0, rf])

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        stack = _stack()
        _, t0, child_s, rf = stack.pop()
        rf.__exit__(exc_type, exc, tb)
        dt = t1 - t0
        parent = stack[-1] if stack else None
        if parent is not None:
            parent[2] += dt
        stat = _SPANS[self.name]
        stat.count += 1
        stat.sum += dt
        stat.self += dt - child_s
        if len(stat.calls) < CALLS_KEPT:
            stat.calls.append(dt)
        stat.parents[parent[0].name if parent is not None else None] += 1


class _ByName(dict):
    """Each name's span, made at its first use: the no-op while tracing is off."""

    def __missing__(self, name: str):
        span = self[name] = _Span(name) if _on else _OFF
        return span


_BY_NAME = _ByName()
# phase(name): the span named ``name``, a context manager. A dict lookup, so
# that a disabled span costs two calls into C and no Python frame.
phase = _BY_NAME.__getitem__


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (nothing while tracing is off)."""
    if _on:
        _COUNTERS[name] += n


def enable(on: bool) -> None:
    """Switch tracing on or off; what was recorded stays until :func:`reset`."""
    global _on
    _on = bool(on)
    _BY_NAME.clear()


def enabled() -> bool:
    return _on


def reset() -> None:
    _SPANS.clear()
    _COUNTERS.clear()


def report() -> Dict[str, Dict]:
    """``{"spans": {name: {count, sum, first, rest_mean, self, parents,
    calls}}, "counters": {name: n}}``, seconds unrounded; ``first`` against
    ``rest_mean`` separates a first call's build or warm-up from the steady
    state; ``parents`` counts the calls under each parent (None: none)."""
    spans = {}
    for name, s in sorted(_SPANS.items()):
        rest = s.count - 1
        spans[name] = {"count": s.count, "sum": s.sum, "first": s.calls[0],
                       "rest_mean": (s.sum - s.calls[0]) / rest if rest else None,
                       "self": s.self, "parents": dict(s.parents), "calls": list(s.calls)}
    return {"spans": spans, "counters": dict(sorted(_COUNTERS.items()))}


def format_report() -> str:
    """The report as a table, milliseconds."""
    r = report()
    rows = [f"{'span':<26} {'n':>6} {'sum_ms':>10} {'self_ms':>10} {'first_ms':>9} "
            f"{'rest_ms':>9}  parent"]
    for name, s in r["spans"].items():
        rest = f"{1e3 * s['rest_mean']:.3f}" if s["rest_mean"] is not None else "-"
        parents = ",".join(str(p) for p in s["parents"])
        rows.append(f"{name:<26} {s['count']:>6} {1e3 * s['sum']:>10.2f} {1e3 * s['self']:>10.2f} "
                    f"{1e3 * s['first']:>9.3f} {rest:>9}  {parents}")
    rows += [f"{name:<26} {n:>6}  (counter)" for name, n in r["counters"].items()]
    return "\n".join(rows)
