"""The span reader (``teambench/spans.py``) on a small chrome trace with
program spans, runtime and driver launches, correlated kernels and idle gaps
(``fixtures/trace_spans.json``, two batches, times in µs), and the tool's
run on the CPU at the tiny backbone.

What the fixture holds, by the innermost span that launched it: embed 2 + 10
+ 20 + 8 µs (a copy and three kernels), attention 10 + 50 + 20 + 50 (two of
them through ``cuLaunchKernel``/``cuLaunchKernelEx``, as the port's ``ctypes``
kernels launch), MLP 60 + 10 + 20 + 70, head 5 + 5; a harness kernel of 5
outside every span. Idle 0-30, 32-33, 43-75, 270-272 and 410-1000 µs of a
1000 µs window, 55 µs of it inside an ``encode_image`` span."""

import json
from pathlib import Path

import pytest
import torch

from team_tpu_torch.utils import phase_timer as pt
from teambench import spans, trace, work
from teambench.manifest import ROOT, Manifest, family_of
from teambench.readings import Readings
from teambench.tests.tiny import tiny_root

EVENTS = json.loads((Path(__file__).parent / "fixtures" / "trace_spans.json").read_text())[
    "traceEvents"]


def _without_program_spans(events):
    return [e for e in events
            if not (e.get("cat") == "user_annotation" and e["name"] in spans.PROGRAM_SPANS)]


def test_each_metric_reads_its_known_value():
    st = spans.read_spans(EVENTS)
    assert st.batches == 2 and st.launches == 13
    got = spans.metrics(st)
    want = {"runtime.launches_per_batch": 6.5, "runtime.device_idle_pct": 5.5,
            "stage.embed_ms": 0.020, "stage.attn_block_ms": 0.065, "stage.mlp_block_ms": 0.080}
    assert got == pytest.approx(want, rel=1e-9)
    split = spans.split(st)
    assert split[pt.HEAD] == pytest.approx(0.005)
    assert split["stage_share_of_encode"] == pytest.approx(1.0)


def test_a_kernel_whose_launch_has_no_span_is_unattributed():
    st = spans.read_spans(EVENTS)
    assert st.device_s[None] == pytest.approx(5e-6)
    assert st.encode_s == pytest.approx(340e-6)
    assert sum(st.device_s.values()) == pytest.approx(trace.read_events(EVENTS).busy_s)


def test_existing_readings_do_not_change_with_program_spans():
    """Every existing metric reads the window, the busy time and the kernels
    of ``read_events``: the same from the trace with and without the spans."""
    with_spans, without = trace.read_events(EVENTS), trace.read_events(_without_program_spans(EVENTS))
    assert (with_spans.window_s, with_spans.busy_s, with_spans.kernels) == (
        without.window_s, without.busy_s, without.kernels)
    assert [s for _, s in with_spans.gaps] == [s for _, s in without.gaps]
    manifest = Manifest(ROOT)
    for workload in (w["name"] for w in manifest.data["workloads"]):
        values = [_per_layer(manifest, workload, t) for t in (with_spans, without)]
        assert values[0] == values[1] and len(values[0]) >= 8


def _per_layer(manifest, workload, device_trace):
    """The cell's per-layer readers over the trace, as ``cell.profile`` reads it."""
    cfg = manifest.config(manifest.workload(workload)["config"])
    r = Readings(work.VisionShape.from_config(cfg), cfg["precision"], 128, 2,
                 device_trace.window_s, 1.0, [0.5, 0.6], 1 << 30,
                 work.peaks_for("NVIDIA H100 80GB HBM3"), host_ms=0.1, busy_s=device_trace.busy_s)
    families = manifest.kernel_families()
    by_name = {f["name"]: f for f in families}
    for kernel, seconds in device_trace.kernels.items():
        family = by_name[family_of(kernel, families)]
        r.layer_s[family["layer"]] = r.layer_s.get(family["layer"], 0.0) + seconds
        r.layer_work[family["layer"]] = family.get("work")
    return {m["name"]: manifest.reader(m["name"])(r) for m in manifest.metrics("per_layer", workload)}


def test_gaps_are_named_by_the_program_span_they_opened_in():
    st = spans.read_spans(EVENTS)
    assert [name for name, _ in st.gaps] == [
        "cudaDeviceSynchronize", "tower.embed > cudaStreamSynchronize", "teambench.window",
        "tower.mlp_block", "tower.embed"]
    assert [s for _, s in st.gaps] == pytest.approx([590e-6, 32e-6, 30e-6, 2e-6, 1e-6])
    bare = _without_program_spans(EVENTS)
    assert spans.read_spans(bare).gaps == trace.read_events(bare).gaps


def test_the_tool_runs_a_cell_on_the_cpu(tmp_path, capsys, monkeypatch):
    # trace.profile_window ends with the card's synchronise; the CPU has none
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    manifest = Manifest(tiny_root(tmp_path / "tiny"))
    row = spans.run(manifest, "vitb16-int8.encode-b128", 3, torch.device("cpu"), pairs=1,
                    out=tmp_path / "out")
    assert [w["spans"] for w in row["windows"]] == [False, True]
    on = row["windows"][1]
    assert on["batches"] == manifest.traffic("encode-b128")["trace"]["batches"]
    assert on["spans_a_call"] == 1 + 1 + 2 * 2 + 1  # the tiny tower has two layers
    assert set(on["metrics"]) == {"runtime.launches_per_batch", "runtime.device_idle_pct",
                                  *spans.STAGES}
    assert set(row["setup_spans"]) == {pt.CALIBRATE, pt.GATE, pt.EMBED, pt.ATTN_BLOCK,
                                       pt.MLP_BLOCK, pt.HEAD}
    assert row["span_cost_us"]["off"] < row["span_cost_us"]["on"]
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "trace_vitb16-int8.encode-b128_off.json.gz", "trace_vitb16-int8.encode-b128_on.json.gz"]
    assert "runtime.calibrate" in capsys.readouterr().err
    assert not pt.enabled()
