"""The program's spans in a profiled window: which stage of the encode path
launched each kernel, and the readings of the encode path's per-layer metrics.

    python3 teambench/spans.py --workload <name> --seed <n> [--pairs 2] [--out <dir>]

With the port's tracing on (:mod:`team_tpu_torch.utils.phase_timer`) each
span is a ``record_function`` range, a ``user_annotation`` event in the same
chrome trace as the device's kernels. A device operation belongs to the
innermost program span that was open on the launching thread when its launch
call ran: the ``cuda_runtime`` or ``cuda_driver`` event whose
``args.correlation`` is the operation's. An operation whose launch no span
holds belongs to none. The window itself (its profile, busy and idle time,
idle gaps) is read by ``trace.py``'s ``profile_window`` and ``read_events``;
this module adds the attribution, and names a gap ``<span> > <host range>``
by renaming each host range that a program span holds.

The tool runs one cell's set-up with tracing on (the span report of the
calibration, the gate and the kernels' build goes to standard error), times
the host's work a call on an idle device with tracing off and on, takes the
cost of a span off and on, then profiles the cell's traced window
(``trace.batches`` steps) ``--pairs`` times with tracing off and on in turn,
and prints one JSON line: each window's existing readings (window, busy,
idle) and, with tracing on, the five readings of :func:`metrics`, the stage
split and the idle gaps named by the program span they opened in. ``--out``
keeps the first window of each kind as a gzipped chrome trace. The
benchmark's runs never run this; its harness would need the edits that
``PERF.md`` lists to read these metrics itself.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from team_tpu_torch.utils import phase_timer as pt  # noqa: E402
from teambench import trace as tracing  # noqa: E402

PROGRAM_SPANS = (pt.ENCODE_IMAGE, pt.CALIBRATE, pt.GATE, pt.EMBED, pt.ATTN_BLOCK, pt.MLP_BLOCK,
                 pt.HEAD, pt.KERNELS_BUILD)
STAGES = {"stage.embed_ms": pt.EMBED, "stage.attn_block_ms": pt.ATTN_BLOCK,
          "stage.mlp_block_ms": pt.MLP_BLOCK}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class SpanTrace:
    window_s: float
    batches: int                          # ENCODE_IMAGE spans that start in the window
    device_s: Dict[Optional[str], float]  # device seconds by the innermost program span of the
                                          # launch (None: none), whole operations
    encode_s: float                       # device seconds launched inside ENCODE_IMAGE
    launches: int                         # kernel launch calls inside ENCODE_IMAGE
    program_idle_s: float                 # device idle while the host is inside ENCODE_IMAGE
    gaps: List[Tuple[str, float]]         # read_events' idle gaps, named by the program span too


def _inside(spans: List[Dict], events: List[Dict]) -> Dict[int, Tuple[Optional[str], bool]]:
    """For each event (by ``id``): the innermost program span open on its
    thread when it started, and whether an ENCODE_IMAGE span was open."""
    points = []
    for s in spans:
        thread = (s.get("pid"), s.get("tid"))
        points.append((s["ts"], 1, -s["dur"], thread, s))
        points.append((s["ts"] + s["dur"], 0, 0.0, thread, s))
    for e in events:
        points.append((e["ts"], 2, 0.0, (e.get("pid"), e.get("tid")), e))
    stacks: Dict[tuple, list] = defaultdict(list)
    inside = {}
    # at one instant a span ends before another starts, and starts before an event
    for _, kind, _, thread, e in sorted(points, key=lambda p: p[:3]):
        stack = stacks[thread]
        if kind == 1:
            stack.append(e)
        elif kind == 0:
            del stack[max(j for j, s in enumerate(stack) if s is e)]
        else:
            inner = stack[-1]["name"] if stack else None
            inside[id(e)] = (inner, any(s["name"] == pt.ENCODE_IMAGE for s in stack))
    return inside


def _idle_s(events: List[Dict], window: Dict, a: float, b: float) -> float:
    """The device's idle seconds from ``a`` to ``b`` (µs), as ``read_events``
    reads a window that spans them."""
    near = [e for e in events if e is not window and e.get("ph") == "X"
            and e["ts"] < b and e["ts"] + e["dur"] > a]
    dt = tracing.read_events([dict(window, ts=a, dur=b - a)] + near)
    return dt.window_s - dt.busy_s


def read_spans(events: List[Dict], names=PROGRAM_SPANS) -> SpanTrace:
    """The device time of the window's operations by program span, from a
    chrome trace's events (µs); idle time and gaps as ``read_events`` reads them."""
    window = next(e for e in events
                  if e.get("name") == tracing.WINDOW and e.get("cat") == "user_annotation")
    w0, w1 = window["ts"], window["ts"] + window["dur"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"] in names and e["dur"] > 0]
    program = {id(s) for s in spans}
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in tracing.HOST_CATS
            and id(e) not in program]
    inside = _inside(spans, host)
    launches = [e for e in host if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})]
    by_launch = {e["args"]["correlation"]: inside[id(e)] for e in launches}
    device_s: Dict[Optional[str], float] = defaultdict(float)
    encode_s = 0.0
    # whole operations, by their launch: the profiler's device clock can put the
    # last ones past the host's window end (20 ms of a 1.6 s int8 window)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in tracing.DEVICE_CATS:
            continue
        inner, in_encode = by_launch.get(e.get("args", {}).get("correlation"), (None, False))
        device_s[inner] += e["dur"] * 1e-6
        if in_encode:
            encode_s += e["dur"] * 1e-6
    # launch calls, which the host records even where a kernel's record is lost
    n_launches = sum("LaunchKernel" in e["name"] and inside[id(e)][1] for e in launches)
    encode = [s for s in spans if s["name"] == pt.ENCODE_IMAGE]
    clipped = [(max(s["ts"], w0), min(s["ts"] + s["dur"], w1)) for s in encode]
    idle = sum(_idle_s(events, window, a, b) for a, b in clipped if b > a)
    # a host range inside a program span takes its name: "<span> > <range>"
    named = [dict(e, name=f"{inside[id(e)][0]} > {e['name']}")
             if inside.get(id(e), (None,))[0] else e for e in events]
    return SpanTrace((w1 - w0) * 1e-6, sum(w0 <= s["ts"] < w1 for s in encode), dict(device_s),
                     encode_s, n_launches, idle, tracing.read_events(named).gaps)


def metrics(st: SpanTrace) -> Dict[str, Optional[float]]:
    """The five per-layer readings; None where the window holds no batch."""
    if not st.batches:
        return dict.fromkeys(["runtime.launches_per_batch", "runtime.device_idle_pct", *STAGES])
    out = {"runtime.launches_per_batch": st.launches / st.batches,
           "runtime.device_idle_pct": 100.0 * st.program_idle_s / st.window_s}
    out.update({m: 1e3 * st.device_s.get(span, 0.0) / st.batches for m, span in STAGES.items()})
    return out


def split(st: SpanTrace) -> Dict[str, float]:
    """Device ms a batch by innermost span, and the share of the device time
    launched inside ENCODE_IMAGE that the four stages hold."""
    n = max(st.batches, 1)
    out = {str(k): 1e3 * v / n for k, v in sorted(st.device_s.items(), key=lambda kv: -kv[1])}
    stages = sum(st.device_s.get(s, 0.0) for s in (pt.EMBED, pt.ATTN_BLOCK, pt.MLP_BLOCK, pt.HEAD))
    out["stage_share_of_encode"] = stages / st.encode_s if st.encode_s else None
    return out


# ---------------------------------------------------------------------------
# the tool
# ---------------------------------------------------------------------------

def profile_events(body: Callable[[], None]) -> Tuple[tracing.DeviceTrace, List[Dict]]:
    """``trace.profile_window(body)``, and the chrome trace's events that it read."""
    read_events, kept = tracing.read_events, []

    def keep(events):
        kept.append(events)
        return read_events(events)

    tracing.read_events = keep
    try:
        return tracing.profile_window(body), kept[0]
    finally:
        tracing.read_events = read_events


def span_cost_us(on: bool, n: int = 200_000) -> float:
    """Host microseconds a span, ``with phase(...): pass`` as the program
    writes it, less the empty loop."""
    was = pt.enabled()
    pt.enable(on)
    phase = pt.phase
    try:
        t0 = time.perf_counter()
        for _ in range(n):
            pass
        t1 = time.perf_counter()
        for _ in range(n):
            with phase("teambench.span_cost"):
                pass
        t2 = time.perf_counter()
    finally:
        pt.enable(was)
    return 1e6 * ((t2 - t1) - (t1 - t0)) / n


def run(manifest, workload: str, seed: int, device, pairs: int, out: Optional[Path]) -> Dict:
    from teambench import cell as cells

    pt.reset()
    pt.enable(True)
    cell = cells.set_up(manifest, workload, seed, device, time.perf_counter())
    setup = pt.report()
    print(f"setup spans ({workload}, seed {seed}):\n{pt.format_report()}", file=sys.stderr)
    spec = cell.traffic["trace"]
    host_ms = {}
    for on in (False, True):
        pt.enable(on)
        times = []
        for i in range(spec["host_batches"]):
            cells.sync(device)
            t0 = time.perf_counter()
            cell.system.step(i)
            times.append(1e3 * (time.perf_counter() - t0))
        cells.sync(device)
        host_ms["on" if on else "off"] = sum(times) / len(times)
    pt.enable(False)
    row = {"workload": workload, "seed": seed, "host_ms": host_ms,
           "span_cost_us": {"off": span_cost_us(False), "on": span_cost_us(True)},
           "setup_spans": {k: {"count": v["count"], "sum_s": v["sum"]}
                           for k, v in setup["spans"].items() if k != pt.ENCODE_IMAGE},
           "setup_counters": setup["counters"], "windows": []}
    for i in range(2 * pairs):
        on = i % 4 in (1, 2)  # off, on, on, off, ...
        pt.reset()
        pt.enable(on)

        def body():
            cells.dispatch(cell, lambda k: k >= spec["batches"], cells.Stamps(device))
            cells.sync(device)

        dt, events = profile_events(body)
        pt.enable(False)
        w = {"spans": on, "window_s": dt.window_s, "busy_s": dt.busy_s,
             "idle_pct": 100.0 * (1.0 - dt.busy_s / dt.window_s)}
        if on:
            st = read_spans(events)
            w.update(metrics=metrics(st), split_ms=split(st), gaps=st.gaps,
                     batches=st.batches, spans_a_call=sum(
                         s["count"] for s in pt.report()["spans"].values()) / max(st.batches, 1))
        else:
            w["gaps"] = dt.gaps
        row["windows"].append(w)
        if out is not None and i < 2:
            out.mkdir(parents=True, exist_ok=True)
            name = f"trace_{workload}_{'on' if on else 'off'}.json.gz"
            with gzip.open(out / name, "wt") as f:
                json.dump({"traceEvents": events}, f)
    cells.free_program(cell)
    pt.reset()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch

    from teambench.manifest import Manifest
    from teambench.run import prepare_environment

    manifest = Manifest(ROOT)
    prepare_environment()
    if not torch.cuda.is_available():
        print("teambench spans: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    row = run(manifest, args.workload, args.seed, device, args.pairs, args.out)
    row["device"] = torch.cuda.get_device_name(device)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
