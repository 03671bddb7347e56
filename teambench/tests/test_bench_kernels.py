"""Every kernel of each cell's first traced run on the card (saved beside
the tests) falls in exactly one kernel family, a family's layer is the layer
its metrics name, and the families' operand precision tells the cells'
towers apart."""

import json
from pathlib import Path

import pytest

from teambench.manifest import Manifest, family_of, matching_families, off_precision_share

FIXTURES = sorted((Path(__file__).parent / "fixtures").glob("kernels_*.json"))
MANIFEST = Manifest()
FAMILIES = MANIFEST.kernel_families()
METRIC_LAYER = {"tower.elementwise_ms": "tower elementwise and int8 epilogues",
                "gemm.device_ms": "tower GEMMs", "gemm.roofline_pct": "tower GEMMs",
                "attn.device_ms": "attention kernels", "attn.roofline_pct": "attention kernels"}


def _names(workload):
    fixture = next(p for p in FIXTURES if json.loads(p.read_text())["workload"] == workload)
    return json.loads(fixture.read_text())["kernels"]


def _precision(workload):
    return MANIFEST.config(MANIFEST.workload(workload)["config"])["precision"]


def test_a_fixture_for_every_cell():
    assert {json.loads(p.read_text())["workload"] for p in FIXTURES} == \
        {w["name"] for w in MANIFEST.data["workloads"]}


@pytest.mark.parametrize("fixture", FIXTURES, ids=lambda p: p.stem)
def test_each_kernel_in_exactly_one_family(fixture):
    names = json.loads(fixture.read_text())["kernels"]
    assert names
    for name in names:
        assert len(matching_families(name, FAMILIES)) == 1, name
    layers = {f["name"]: f["layer"] for f in FAMILIES}
    assert {layers[family_of(n, FAMILIES)] for n in names} == set(METRIC_LAYER.values())


def test_one_default_family_and_known_work():
    assert sum(bool(f.get("default")) for f in FAMILIES) == 1
    from teambench.work import WORK

    for f in FAMILIES:
        assert f.get("work") is None or (f["work"] in WORK and f["operands"] in ("bf16", "int8"))
    # the families of one layer read the same work
    work = {}
    for f in FAMILIES:
        assert work.setdefault(f["layer"], f.get("work")) == f.get("work"), f["name"]


def test_metric_layers_match_their_family():
    layers = {f["layer"] for f in FAMILIES}
    for m in MANIFEST.data["per_layer"]:
        if m["name"] in METRIC_LAYER:
            assert m["layer"] == METRIC_LAYER[m["name"]] and m["layer"] in layers


@pytest.mark.parametrize("workload", ["vitb16-bf16.encode-b128", "vitb16-int8.encode-b128"])
def test_each_tower_runs_its_stated_precision_and_not_the_other(workload):
    """Off-precision math kernels of each cell's own trace: the bf16 cell
    none, the int8 cell only the bf16 final projection (nvjet); the other
    cell's kernels under this cell's precision are all off."""
    own, other = _names(workload), _names(next(
        w["name"] for w in MANIFEST.data["workloads"] if w["name"] != workload))
    math = [n for n in own if next(f for f in FAMILIES if f["name"] == family_of(n, FAMILIES)).get("work")]
    off = [n for n in math if off_precision_share({n: 1.0}, FAMILIES, _precision(workload)) == 1.0]
    assert off == ([] if "bf16" in workload else [n for n in math if n.startswith("nvjet")])
    other_math = {n: 1.0 for n in other if not n.startswith("nvjet") and
                  next(f for f in FAMILIES if f["name"] == family_of(n, FAMILIES)).get("work")}
    assert other_math and off_precision_share(other_math, FAMILIES, _precision(workload)) == 1.0
    assert off_precision_share({"Memset (Device)": 1.0}, FAMILIES, _precision(workload)) is None
