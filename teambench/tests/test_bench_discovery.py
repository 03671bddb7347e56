"""A configuration, a traffic mix, a metric, a kernel family and a driver are
added as new files and entries, and the harness finds them with no edit."""

import json
import time

import torch

from teambench import cell
from teambench.manifest import Manifest, family_of, matching_families
from teambench.tests.tiny import TINY_TRAFFIC, tiny_root


def test_new_files_are_found(tmp_path):
    root = tiny_root(tmp_path)
    pkg = root / "teambench"
    data = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((pkg / "configs" / "clip-vitb16-bf16.json").read_text())
    (pkg / "configs" / "clip-new.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "encode-new.json").write_text(json.dumps(dict(TINY_TRAFFIC, batch=8)))
    (pkg / "metrics" / "encode_p50_ms.py").write_text(
        "def read(r):\n    return r.latency_quantile_ms(50)\n")
    (pkg / "kernels" / "fused.json").write_text(json.dumps(
        {"layer": "fused blocks", "patterns": ["ln_qkv_kernel"], "work": None}))
    data["configs"].append({"name": "clip-new", "source": "https://example.org/new",
                            "file": "teambench/configs/clip-new.json", "reduced": [],
                            "why": "a new configuration"})
    data["workloads"].append({"name": "new.cell", "config": "clip-new", "traffic": "encode-new",
                              "chips": 1, "why": "a new cell"})
    data["end_to_end"].append({"name": "encode_p50_ms", "unit": "ms", "better": "lower",
                               "bound": 0.05, "source": "device_trace", "workloads": ["new.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))

    manifest = Manifest(root)
    result = cell.run("new.cell", 3, 0.5, False, manifest=manifest, device=torch.device("cpu"),
                      t_start=time.perf_counter())
    assert result["correct"]
    assert {"encode_p50_ms", "encode_img_per_s", "setup_s"} <= set(result["metrics"])
    families = manifest.kernel_families()
    assert family_of("ln_qkv_kernel_tc<64>", families) == "fused"
    assert matching_families("ln_qkv_kernel_tc<64>", families) == ["fused"]
    # the cells that list their metrics do not pick up the new one
    assert "encode_p50_ms" not in {m["name"] for m in
                                   manifest.metrics("end_to_end", "vitb16-bf16.encode-b128")}


ECHO_DRIVER = """
import torch


class System:
    def __init__(self, cfg, traffic, seed, device, families):
        g = torch.Generator().manual_seed(seed)
        self.x = torch.rand(traffic["batch"], 8, generator=g)
        self.shape, self.items_per_step, self.phases = None, traffic["batch"], {}

    def step(self, i):
        return self.x * 2

    def describe(self):
        return {}

    def after_window(self, kernels):
        pass

    def free(self):
        pass

    def check(self, outputs):
        worst = max(float((o - self.x * 2).abs().max()) for o in outputs.values())
        return {"echo_gap": {"value": worst, "limit": 0.0}}, 0, worst == 0.0

    def all_failed(self):
        return False
"""


def test_a_new_kind_of_traffic_is_a_new_driver_file(tmp_path):
    """A traffic file that names a driver of its own runs through the same
    harness: the window, the readers and the check, with no edit."""
    root = tiny_root(tmp_path)
    pkg = root / "teambench"
    data = json.loads((root / "BENCHMARK.json").read_text())
    (pkg / "drivers" / "echo.py").write_text(ECHO_DRIVER)
    (pkg / "traffic" / "echo-b4.json").write_text(json.dumps(
        {"driver": "echo", "batch": 4, "warmup_batches": 1, "check": {"batches": 2, "from_first": 3}}))
    data["workloads"].append({"name": "echo.cell", "config": "clip-vitb16-bf16",
                              "traffic": "echo-b4", "chips": 1, "why": "a new kind of traffic"})
    (root / "BENCHMARK.json").write_text(json.dumps(data))

    result = cell.run("echo.cell", 3, 0.05, False, manifest=Manifest(root),
                      device=torch.device("cpu"), t_start=time.perf_counter())
    assert result["correct"] and result["attempted"] >= 1
    assert result["checks"] == {"echo_gap": {"value": 0.0, "limit": 0.0}}
    assert result["metrics"]["encode_img_per_s"]["value"] > 0
