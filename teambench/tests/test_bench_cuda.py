"""On the card, at the cells' own size: the program passes its check and the
control fails it, on three seeds; a traced run reads the device.

    python3 -m pytest -m cuda teambench/tests/test_bench_cuda.py -q   # on the card
"""

import time

import pytest

from teambench import cell, control
from teambench.manifest import Manifest

CELLS = ("vitb16-bf16.encode-b128", "vitb16-int8.encode-b128")
SEEDS = (2 ** 31 + 101, 2 ** 31 + 211, 2 ** 31 + 307)


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_and_control_fails_at_full_size(workload):
    device = _card()
    manifest = Manifest()
    limit = manifest.config(manifest.workload(workload)["config"])["check"]["limit"]
    for seed in SEEDS:
        row = control.readings(manifest, workload, seed, device, with_control=True)
        assert row["correct"] and limit < row["control"], row
        assert row.get("committed", True), row


@pytest.mark.cuda
def test_int8_tower_served_by_bf16_is_not_correct(monkeypatch):
    """The int8 cell whose tower reports itself committed while every call
    runs the bf16 tower: the kernels' precision gives it away."""
    device = _card()
    manifest = Manifest()
    workload = CELLS[1]
    manifest.driver("encode").plant("bf16_tower", monkeypatch)
    for seed in SEEDS:
        row = control.readings(manifest, workload, seed, device, with_control=False)
        assert row["committed"] and not row["correct"], row
        assert row["checks"]["off_precision_share"] > 0.5, row


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_every_per_layer_metric(workload):
    device = _card()
    manifest = Manifest()
    result = cell.run(workload, SEEDS[0], 1.0, True, manifest=manifest, device=device,
                      t_start=time.perf_counter())
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in manifest.metrics("per_layer", workload)}
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    for name in ("gemm.roofline_pct", "attn.roofline_pct", "encode_mfu_pct"):
        assert 0 < result["metrics"][name]["value"] <= 100
