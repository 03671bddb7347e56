"""The entry point's refusals, and the modules a run loads (top-level names
compared whole: ``team_tpu_torch`` begins with ``team_tpu``)."""

import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from teambench import run
from teambench.manifest import ROOT

ARGS = ["--workload", "vitb16-bf16.encode-b128", "--seed", "3", "--seconds", "1", "--trace", "0"]


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "team_tpu_torch_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "team_tpu.sub", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.forbidden_modules() == ["jax", "team_tpu"]


def test_a_tiny_run_loads_no_jax_and_no_team_tpu(tmp_path):
    """A whole CPU run of both tiny cells in a fresh process."""
    code = textwrap.dedent(f"""
        import json, sys, time, torch
        from pathlib import Path
        from teambench import cell
        from teambench.manifest import Manifest
        from teambench.run import forbidden_modules
        from teambench.tests.tiny import tiny_root
        manifest = Manifest(tiny_root(Path({str(tmp_path)!r})))
        for w in ("vitb16-bf16.encode-b128", "vitb16-int8.encode-b128"):
            r = cell.run(w, 4, 0.05, False, manifest=manifest, device=torch.device("cpu"),
                         t_start=time.perf_counter())
            assert r["correct"], r
        print(json.dumps({{"forbidden": forbidden_modules(),
                          "port": "team_tpu_torch" in sys.modules}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"forbidden": [], "port": True}


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, teambench.reference.clip; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'team_tpu_torch', 'team_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def _no_card():
    import torch

    return not torch.cuda.is_available()


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    if not _no_card():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "teambench/run.py", *ARGS], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A directory with only BENCHMARK.json and the files under ``paths``
    (no program) exits nonzero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "teambench", tmp_path / "teambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "teambench/run.py", *ARGS], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
