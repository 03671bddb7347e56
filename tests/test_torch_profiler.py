"""The port's trace and device sync (team_tpu_torch/analysis/profiler.py):
a trace written only where a directory is given, and a sync that returns on
the CPU. The trainer takes its ``trace`` from here, as team_tpu's does."""

import torch

from team_tpu_torch import trainer
from team_tpu_torch.analysis import profiler as tprof


def test_trace_writes_only_where_asked(tmp_path):
    with tprof.trace(None, "nothing"):
        torch.ones(3).sum()
    with tprof.trace(str(tmp_path / "prof"), "task_0"):
        torch.ones(3).sum()
    traces = [p.name for p in (tmp_path / "prof").iterdir()]
    assert len(traces) == 1 and traces[0].startswith("task_0")
    assert trainer.trace is tprof.trace


def test_device_sync_returns_on_the_cpu():
    tprof.device_sync()
    tprof.device_sync(torch.ones(2))
