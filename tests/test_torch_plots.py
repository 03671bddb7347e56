"""The port's state-evolution plots (team_tpu_torch/analysis/plots.py)
against team_tpu's: for the same prototypes both write the same files,
and under ``enable_plots`` a tiny PROOF run draws them where team_tpu
draws them, in the same calls (after each task's rehearsal memory; at the
last epoch, twice, around the duplicated evolution block). Everything is
written under ``tmp_path``.
"""

import collections
import os

import jax
import numpy as np
import pytest
import torch

from team_tpu.analysis import plots as jplots
from team_tpu.config import Config as JaxConfig
from team_tpu.trainer import train as jax_train
from team_tpu_torch.analysis import plots as tplots
from team_tpu_torch.config import Config
from team_tpu_torch.trainer import train as torch_train

Buffers = collections.namedtuple("Buffers", "proto_state proto_mask")


def _buffers(seed, c=5, s=6, d=16, present=((1, 4), (3, 4), (1, 3, 4), (4,), ())):
    rng = np.random.default_rng(seed)
    state = rng.standard_normal((c, s, d)).astype(np.float32)
    mask = np.zeros((c, s), np.float32)
    for cls, stages in enumerate(present):
        mask[cls, list(stages)] = 1.0
    return state, mask


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("present", [((1, 4), (3, 4), (1, 3, 4), (4,), ()), ((4,), (1,), ())])
def test_plots_write_team_tpus_files(tmp_path, present):
    state, mask = _buffers(0, present=present)
    jb = Buffers(jax.numpy.asarray(state), jax.numpy.asarray(mask))
    tb = Buffers(torch.from_numpy(state), torch.from_numpy(mask))
    for side, plots, b in (("jax", jplots, jb), ("torch", tplots, tb)):
        path = plots.analyze_state_evolution(b, ["a", "b", "c", "d", "e"],
                                             save_dir=str(tmp_path / side / "analysis"))
        if path:
            assert os.path.relpath(path, tmp_path / side) == "analysis/state_evolution_tsne.png"
        plots.visualize_evolution_path(b, save_dir=str(tmp_path / side / "evolution"))
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    for sub in ("analysis", "evolution"):  # made even where nothing is drawn
        assert (tmp_path / "torch" / sub).is_dir()
    assert all(os.path.getsize(tmp_path / "torch" / f) > 0 for f in _files(tmp_path / "torch"))


def _tiny(config_cls, model, tmp_path, **kw):
    return config_cls(
        prefix="t", dataset="synthetic_insects", model_name=model, convnet_type="clip",
        init_cls=2, increment=2, memory_size=12, tuned_epoch=2, batch_size=8, init_lr=0.01,
        optimizer="adam", context_prompt_length_per_task=3, seed=[1], shuffle=True,
        log_dir=str(tmp_path / "logs"), results_dir=str(tmp_path / "results"),
        enable_plots=True,
        extras={"tiny_backbone": True, "dataset_kwargs": {"num_classes": 6, "img_size": 32}}, **kw)


def _recorded(monkeypatch, module, root, calls):
    for name in ("analyze_state_evolution", "visualize_evolution_path"):
        fn = getattr(module, name)

        def record(*a, _fn=fn, _name=name, **k):
            calls.append((_name, os.path.relpath(k["save_dir"], root)))
            return _fn(*a, **k)

        monkeypatch.setattr(module, name, record)


def test_proof_draws_where_and_when_team_tpu_draws(tmp_path, monkeypatch):
    calls = {"jax": [], "torch": []}
    _recorded(monkeypatch, jplots, tmp_path / "jax" / "results", calls["jax"])
    _recorded(monkeypatch, tplots, tmp_path / "torch" / "results", calls["torch"])
    jax_train(_tiny(JaxConfig, "proof", tmp_path / "jax"))
    torch_train(_tiny(Config, "proof", tmp_path / "torch", device=["cpu"]))
    assert calls["torch"] == calls["jax"]
    want = []
    for t in range(3):
        want += [("visualize_evolution_path", f"task_{t}/evolution")] * 2
        want.append(("analyze_state_evolution", f"task_{t}/analysis"))
    assert calls["torch"] == want
    assert _files(tmp_path / "torch" / "results") == _files(tmp_path / "jax" / "results")
