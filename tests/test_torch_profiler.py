"""The port's step timer, trace and device sync
(team_tpu_torch/analysis/profiler.py) against team_tpu's
(team_tpu/analysis/profiler.py): the same window, mean, throughput and log
cadence for the same step times, a trace written only where a directory is
given, and a sync that returns on the CPU. The trainer takes its ``trace``
from here, as team_tpu's does."""

import logging

import pytest
import torch

from team_tpu.analysis import profiler as jprof
from team_tpu_torch import trainer
from team_tpu_torch.analysis import profiler as tprof


def _times(module, monkeypatch, steps, **kw):
    clock = iter(t for step in steps for t in step)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
    timer = module.StepTimer(**kw)
    for _ in steps:
        with timer:
            pass
    return timer


@pytest.mark.parametrize("window,log_every", [(50, 0), (3, 2), (1, 1)])
def test_step_timer_matches_team_tpu(monkeypatch, caplog, window, log_every):
    steps = [(0.0, 0.5), (1.0, 1.25), (2.0, 2.75), (3.0, 3.1), (4.0, 4.2)]
    caplog.set_level(logging.INFO)
    logs = {}
    for name, module in (("jax", jprof), ("torch", tprof)):
        caplog.clear()
        timer = _times(module, monkeypatch, steps, window=window, log_every=log_every, name="s")
        logs[name] = [r.getMessage() for r in caplog.records]
        logs[name + "_stats"] = (list(timer.window), timer.mean_time, timer.throughput(16))
    assert logs["torch"] == logs["jax"]
    assert logs["torch_stats"] == logs["jax_stats"]
    assert len(logs["torch"]) == (len(steps) // log_every if log_every else 0)


def test_an_empty_timer_reports_nothing():
    timer = tprof.StepTimer()
    assert timer.mean_time == 0.0 and timer.throughput(8) == 0.0


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
