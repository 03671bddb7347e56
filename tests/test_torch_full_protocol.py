"""The port's full-protocol runner (team_tpu_torch/scripts/full_protocol.py)
against ``scripts/tpu_full_protocol.py``.

Its configuration equals team_tpu's runner's field by field for each
learner and tier, but for the log directory (team_tpu's writes under
``/tmp``, the port's under the checkout's ``logs/``) and the device (the
port's names its card). At the tiny size on the CPU: a missing golden
fails (team_tpu's runner writes one and passes, ROADMAP fault 3.6),
``TEAM_PIN=regen`` writes it, the rerun passes, a drift fails and a run
under its floor raises. The committed goldens are this port's, taken on the
card, never the TPU's. Goldens and logs go under ``tmp_path``.
"""

import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import pytest

from team_tpu_torch.scripts import full_protocol as fp

REPO = Path(__file__).resolve().parents[1]
CONFIGS = [("proof", "bf16"), ("simplecil", "bf16"), ("zs_clip", "bf16"),
           ("proof", "int8_static")]


class _Captured(Exception):
    pass


def _team_tpu_config(monkeypatch, model, tier, patch_major):
    """The Config ``scripts/tpu_full_protocol.py:main`` hands its trainer."""
    spec = importlib.util.spec_from_file_location("tpu_full_protocol",
                                                  REPO / "scripts" / "tpu_full_protocol.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = []

    def capture(cfg):
        seen.append(cfg)
        raise _Captured

    monkeypatch.setattr(mod, "train", capture)
    monkeypatch.setenv("TEAM_MODEL", model)
    monkeypatch.setenv("TEAM_ENCODER_QUANT", tier)
    monkeypatch.setenv("TEAM_PATCH_MAJOR", "1" if patch_major else "0")
    with pytest.raises(_Captured):
        mod.main()
    return seen[0]


@pytest.mark.parametrize("patch_major", [True, False])
@pytest.mark.parametrize("model,tier", CONFIGS)
def test_config_is_team_tpus_field_by_field(monkeypatch, model, tier, patch_major):
    want = dataclasses.asdict(_team_tpu_config(monkeypatch, model, tier, patch_major))
    got = dataclasses.asdict(fp.protocol_config(model, tier, patch_major, device=[0]))
    assert set(got) == set(want)
    differ = {k for k in got if got[k] != want[k]}
    assert differ == {"log_dir", "device"}, {k: (got[k], want[k]) for k in differ}
    assert got["device"] == [0] and not os.path.isabs(got["log_dir"])


def test_floors_are_team_tpus():
    text = (REPO / "scripts" / "tpu_full_protocol.py").read_text()
    assert 'floor = {"proof": 20.0, "simplecil": 6.0, "zs_clip": 0.0}[model]' in text
    assert fp.FLOORS == {"proof": 20.0, "simplecil": 6.0, "zs_clip": 0.0}


def _tiny(tmp_path, model="proof"):
    return fp.protocol_config(model, "bf16", device=["cpu"], log_dir=str(tmp_path / "logs"),
                              tiny=True)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """One tiny PROOF run through the runner, its golden regenerated."""
    d = tmp_path_factory.mktemp("full_protocol")
    res = fp.run(_tiny(d), golden_dir=str(d / "goldens"), pin="regen")
    return d, res


def test_tiny_run_writes_its_golden_on_regen(tiny_run):
    d, res = tiny_run
    path = fp.golden_path("proof", "bf16", str(d / "goldens"))
    golden = json.loads(Path(path).read_text())
    assert golden == {"model": "proof", "encoder_quant": "bf16", "cnn_top1": res["curve"],
                      "avg": round(res["avg"], 4), "card": "cpu"}
    assert len(res["curve"]) == 3 and res["pin"].startswith("golden written")


def test_tiny_rerun_passes_its_pin(tiny_run):
    d, res = tiny_run
    again = fp.run(_tiny(d), golden_dir=str(d / "goldens"), pin="1")
    assert again["curve"] == res["curve"] and again["pin"].startswith("golden pin OK")


def test_a_missing_golden_fails(tiny_run, tmp_path):
    d, _ = tiny_run
    with pytest.raises(AssertionError, match="no golden"):
        fp.run(_tiny(d), golden_dir=str(tmp_path / "empty"), pin="1")
    assert not (tmp_path / "empty").exists()


@pytest.mark.parametrize("field", ["cnn_top1", "avg"])
def test_a_drift_fails(tiny_run, tmp_path, field):
    d, res = tiny_run
    golden = json.loads(Path(fp.golden_path("proof", "bf16", str(d / "goldens"))).read_text())
    golden[field] = [a + 0.01 for a in golden[field]] if field == "cnn_top1" else golden[field] + 1
    (tmp_path / "g").mkdir()
    Path(fp.golden_path("proof", "bf16", str(tmp_path / "g"))).write_text(json.dumps(golden))
    with pytest.raises(AssertionError, match="curve drift"):
        fp.pin_curve(res["curve"], res["avg"], "proof", "bf16", "cpu", str(tmp_path / "g"), "1")
    assert fp.pin_curve(res["curve"], res["avg"], "proof", "bf16", "cpu", str(tmp_path / "g"),
                        "0").startswith("not pinned")


def test_a_run_under_its_floor_raises(tiny_run, monkeypatch, tmp_path):
    d, _ = tiny_run
    monkeypatch.setitem(fp.FLOORS, "zs_clip", 100.0)
    with pytest.raises(AssertionError, match="floor"):
        fp.run(_tiny(d, "zs_clip"), golden_dir=str(tmp_path / "g"), pin="regen")
    assert not (tmp_path / "g").exists()  # no golden for a run that failed


def test_the_committed_goldens_are_the_ports_card_runs():
    assert Path(fp.GOLDEN_DIR) == REPO / "team_tpu_torch" / "scripts" / "goldens"
    names = sorted(p.name for p in Path(fp.GOLDEN_DIR).glob("*.json"))
    assert names == sorted(f"h100_protocol_{m}_{t}.json" for m, t in CONFIGS)
    for model, tier in CONFIGS:
        golden = json.loads(Path(fp.golden_path(model, tier)).read_text())
        assert golden["model"] == model and golden["encoder_quant"] == tier
        assert len(golden["cnn_top1"]) == 10 and golden["avg"] >= fp.FLOORS[model]
        assert "H100" in golden["card"] and golden["card"].endswith(" W")
