"""``BENCHMARK.json`` and the files it names, found by name under a root.

The root is the checkout (the directory that holds ``BENCHMARK.json``); tests
give another root to show that a file added there is found with no edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = "teambench"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


class Manifest:
    """The manifest at ``root`` and lookups of the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data: Dict[str, Any] = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / PACKAGE

    def _entry(self, key: str, name: str) -> Dict[str, Any]:
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"{key} has no entry named {name!r}")

    def workload(self, name: str) -> Dict[str, Any]:
        return self._entry("workloads", name)

    def config(self, name: str) -> Dict[str, Any]:
        """The configuration file that the ``configs`` entry ``name`` names."""
        return json.loads((self.root / self._entry("configs", name)["file"]).read_text())

    def traffic(self, name: str) -> Dict[str, Any]:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, kind: str, workload: str) -> List[Dict[str, Any]]:
        """The ``end_to_end`` or ``per_layer`` metrics that ``workload`` reports:
        those without a ``workloads`` key, and those that list it."""
        return [m for m in self.data[kind] if workload in m.get("workloads", [workload])]

    def _load(self, kind: str, name: str):
        """The module ``<kind>/<name>.py``, loaded by path (names hold dots)."""
        path = self.dir / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"{PACKAGE}_{kind}_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def reader(self, metric: str) -> Callable[[Any], Optional[float]]:
        """``read`` of ``metrics/<metric>.py``."""
        return self._load("metrics", metric).read

    def driver(self, name: str):
        """The module ``drivers/<name>.py`` that a traffic file's ``driver`` names."""
        return self._load("drivers", name)

    def kernel_families(self) -> List[Dict[str, Any]]:
        """Every ``kernels/*.json``, in file-name order, each with its ``name``."""
        families = []
        for path in sorted((self.dir / "kernels").glob("*.json")):
            family = json.loads(path.read_text())
            family["name"] = path.stem
            families.append(family)
        return families


def family_of(kernel: str, families: List[Dict[str, Any]]) -> str:
    """The family whose patterns (case-insensitive substrings) match the
    kernel's name; one that matches none belongs to the ``default`` family."""
    low = kernel.lower()
    for family in families:
        if any(p.lower() in low for p in family["patterns"]):
            return family["name"]
    return next(f["name"] for f in families if f.get("default"))


def off_precision_share(kernels: Dict[str, float], families: List[Dict[str, Any]],
                        precision: Dict[str, str]) -> Optional[float]:
    """Of the device time in kernels whose family has a ``work`` function
    (the tower's math), the share in families whose ``operands`` are not the
    precision that ``precision`` states for that work; None where no such
    kernel ran."""
    by_name = {f["name"]: f for f in families}
    total = off = 0.0
    for kernel, seconds in kernels.items():
        family = by_name[family_of(kernel, families)]
        if family.get("work") is None:
            continue
        total += seconds
        if family.get("operands") != precision[family["work"]]:
            off += seconds
    return off / total if total else None


def matching_families(kernel: str, families: List[Dict[str, Any]]) -> List[str]:
    """Every family whose patterns match the name (a test holds it to one)."""
    low = kernel.lower()
    return [f["name"] for f in families if any(p.lower() in low for p in f["patterns"])]
