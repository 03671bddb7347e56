"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its file."""

import json
import re

import pytest

from teambench.manifest import NAME, ROOT, UNIT, Manifest

MANIFEST = Manifest()
DATA = MANIFEST.data
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
LINE = re.compile(r"[^\n\t]{1,200}\Z")
# a key of ``reduced`` that names a width may never be cut
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|width|head|_dim\Z|_rank\Z|expan|per_tok)",
                   re.I)


def test_top_level_keys_and_size():
    assert set(DATA) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= DATA["run_seconds"] <= 51 and isinstance(DATA["run_seconds"], int)


def test_command_and_paths():
    assert 1 <= len(DATA["command"]) <= 32
    for word in DATA["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word
    assert 1 <= len(DATA["paths"]) <= 16
    for path in DATA["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and not path.endswith("_torch")
        assert (ROOT / path).is_dir()
    named = [w for w in DATA["command"] if "/" in w]
    assert all(any(w.startswith(p + "/") for p in DATA["paths"]) for w in named)


@pytest.mark.parametrize("kind", sorted(ENTRY_KEYS))
def test_entries_keys_names_and_units(kind):
    names = [e["name"] for e in DATA[kind]]
    assert len(names) == len(set(names))
    for entry in DATA[kind]:
        allowed = ENTRY_KEYS[kind] | ({"workloads"} if kind in ("end_to_end", "per_layer") else set())
        assert ENTRY_KEYS[kind] <= set(entry) <= allowed, entry
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
            assert entry["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in entry:
                assert LINE.match(entry[key]), entry[key]


def test_configs_files_and_reductions():
    files = [c["file"] for c in DATA["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in DATA["workloads"]}
    for c in DATA["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in DATA["paths"])
        assert json.loads((ROOT / c["file"]).read_text())["embed_dim"] > 0
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key)


def test_workloads_name_their_files():
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in DATA["workloads"]) <= max(1, len(pairs) // 4)
    for w in DATA["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        MANIFEST.config(w["config"])
        MANIFEST.traffic(w["traffic"])


def test_metrics_have_readers_and_each_cell_reports_enough():
    e2e = {m["name"] for m in DATA["end_to_end"]}
    assert "setup_s" in e2e
    for m in DATA["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in DATA["end_to_end"] + DATA["per_layer"]:
        assert callable(MANIFEST.reader(m["name"]))
        for w in m.get("workloads", []):
            MANIFEST.workload(w)
    for m in DATA["per_layer"]:
        assert m["moves"] in e2e
    for w in DATA["workloads"]:
        reported = {m["name"] for m in MANIFEST.metrics("end_to_end", w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        moves = {m["moves"] for m in MANIFEST.metrics("per_layer", w["name"])}
        assert moves and moves <= reported


def test_one_layer_name_per_metric_prefix():
    """Metrics of one layer give the layer letter for letter."""
    layers = {}
    for m in DATA["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_every_file_under_paths_is_named_from_name_characters():
    for path in (ROOT / "teambench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
