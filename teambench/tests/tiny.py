"""A benchmark root at the tiny backbone's sizes, for the CPU tests.

It holds a ``BENCHMARK.json`` with the repository's cells and metrics and
``teambench/`` with the repository's metric readers, kernel families and drivers, and
configurations and a traffic file cut to the port's tiny CLIP
(``CLIPConfig.tiny``: 32² images, two layers of width 64, two heads).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from teambench.manifest import ROOT

TINY_MODEL = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16, "head_width": 32},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 64, "heads": 2, "layers": 2},
}
TINY_TRAFFIC = {"driver": "encode", "batch": 16, "pool_batches": 3, "images": {"grid": 2, "noise": 24},
                "calibration_batch": 0, "gate_batch": 1, "warmup_batches": 1,
                "check": {"batches": 2, "from_first": 3}, "trace": {"host_batches": 1, "batches": 3}}


def tiny_root(tmp: Path) -> Path:
    """Write the tiny root under ``tmp`` and return it."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    pkg = tmp / "teambench"
    for sub in ("metrics", "kernels", "drivers"):
        shutil.copytree(ROOT / "teambench" / sub, pkg / sub)
    (pkg / "configs").mkdir(parents=True)
    (pkg / "traffic").mkdir()
    for entry in manifest["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        cfg.update(TINY_MODEL)
        cfg["runtime"] = dict(cfg["runtime"], tiny_backbone=True)
        (tmp / entry["file"]).write_text(json.dumps(cfg))
    for traffic in {w["traffic"] for w in manifest["workloads"]}:
        (pkg / "traffic" / f"{traffic}.json").write_text(json.dumps(TINY_TRAFFIC))
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp
