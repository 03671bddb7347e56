"""Per-task checkpoint and resume in the port (team_tpu_torch/checkpoint.py
and the trainer's hooks), as tests/test_checkpoint.py holds team_tpu's.

A run stopped after task k and resumed gives the curves of the run that was
not stopped, exactly (the CPU is deterministic): PROOF and SimpleCIL on the
tiny protocol, and PROOF over two ranks of a gloo world that restore from
the file rank 0 saved (tests/torch_parallel_worker.py). The fix-mode
projectors survive, ``_proto_mask_any`` is recomputed after a restore
(ROADMAP fault 3.6: team_tpu keeps the flag of the learner it restores
into), and the file loads with ``torch.load(weights_only=True)``.
Everything is written under ``tmp_path``.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from team_tpu_torch.checkpoint import TaskCheckpointer
from team_tpu_torch.config import Config
from team_tpu_torch.learners.factory import get_model
from team_tpu_torch.trainer import train

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
KEYS = ("cnn_top1", "cnn_top5", "nme_top1")


def _cfg(tmp, model="proof", resume=False, **kw):
    return Config(
        prefix="ck", dataset="synthetic_insects", model_name=model, convnet_type="clip",
        init_cls=2, increment=2, memory_size=12, tuned_epoch=1, batch_size=8, init_lr=0.01,
        optimizer="adam", context_prompt_length_per_task=3, seed=[3], shuffle=True,
        device=["cpu"], log_dir=os.path.join(tmp, "logs"),
        checkpoint_dir=os.path.join(tmp, "ckpt"), resume=resume,
        extras={"tiny_backbone": True, "dataset_kwargs": {"num_classes": 6, "img_size": 32}},
        **kw)


def _curves(res):
    return {k: [float(a) for a in res[k]] for k in KEYS}


@pytest.mark.parametrize("model", ["proof", "simplecil"])
def test_resume_gives_the_uninterrupted_curves(model, tmp_path):
    tmp = str(tmp_path)
    whole = train(_cfg(tmp, model))
    assert len(whole["cnn_top1"]) == 3
    assert sorted(os.listdir(tmp_path / "ckpt")) == [f"task_{t}.pt" for t in range(3)]
    # nothing left to train: the curves (NME included) come back from the file
    done = train(_cfg(tmp, model, resume=True))
    assert _curves(done) == _curves(whole) and done["avg_acc"] == whole["avg_acc"]
    # stopped after task 0: tasks 1 and 2 are trained again from its state
    for t in (1, 2):
        os.remove(tmp_path / "ckpt" / f"task_{t}.pt")
    resumed = train(_cfg(tmp, model, resume=True))
    assert _curves(resumed) == _curves(whole)
    assert resumed["avg_acc"] == whole["avg_acc"]


def test_the_file_loads_with_weights_only_and_holds_the_state(tmp_path):
    train(_cfg(str(tmp_path)))
    state = torch.load(tmp_path / "ckpt" / "task_2.pt", weights_only=True)
    assert {"task", "known_classes", "total_classes", "curves", "nme_curves", "trainable", "aux",
            "buffers", "state_distance", "generators", "memory"} <= set(state)
    assert state["task"] == 2 and state["total_classes"] == 6
    assert len(state["curves"]["top1"]) == 3 and len(state["nme_curves"]["top1"]) == 3

    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, list):
            for v in tree:
                yield from leaves(v)
        else:
            yield tree

    kinds = {type(x) for x in leaves(state)}
    assert kinds <= {torch.Tensor, int, float, str}, kinds
    assert all(x.device.type == "cpu" for x in leaves(state) if isinstance(x, torch.Tensor))
    assert set(state["buffers"]) >= {"proto_state", "proto_mask", "img_prototypes"}


def test_restore_clears_the_proto_mask_flag(tmp_path):
    """A learner that had seen an empty proto_mask (flag False) restored from a
    task whose proto_mask is filled: the flag is recomputed, so the evolution
    runs (team_tpu would keep the stale False and skip it)."""
    train(_cfg(str(tmp_path)))
    fresh = get_model("proof", _cfg(str(tmp_path)))
    fresh._proto_mask_any = False
    assert TaskCheckpointer(str(tmp_path / "ckpt")).restore_latest(fresh, {}) == 2
    assert fresh._proto_mask_any is None
    assert fresh._protos_nonempty() is True
    assert fresh._cur_task == 2 and fresh._known_classes == fresh._total_classes == 6
    assert len(fresh._data_memory) == len(fresh._targets_memory) == len(fresh._stages_memory) > 0


def test_fix_mode_projectors_survive_resume(tmp_path):
    cfg = Config(parity_mode=False, lifecycle_weight=0.5, device=["cpu"],
                 extras={"tiny_backbone": True})
    learner = get_model("proof", cfg)
    learner.dims = type("D", (), {"feature_dim": 8})()
    learner.integrate_with_state_distance()
    want = learner._evo_projectors["3-4"]["b"].clone()
    ck = TaskCheckpointer(str(tmp_path))
    ck.save(0, learner, {"top1": [50.0]})
    fresh = get_model("proof", Config(parity_mode=False, device=["cpu"],
                                      extras={"tiny_backbone": True}))
    curves = {}
    assert ck.restore_latest(fresh, curves) == 0
    assert curves == {"top1": [50.0]}
    assert torch.equal(fresh._evo_projectors["3-4"]["b"], want)


def test_the_dropout_generator_carries_across(tmp_path):
    learner = get_model("proof", _cfg(str(tmp_path)))
    learner._dropout_gen.manual_seed(123)
    torch.rand(5, generator=learner._dropout_gen)
    ck = TaskCheckpointer(str(tmp_path / "g"))
    ck.save(0, learner, {"top1": []})
    want = torch.rand(4, generator=learner._dropout_gen)
    fresh = get_model("proof", _cfg(str(tmp_path)))
    ck.restore_latest(fresh, {})
    assert torch.equal(torch.rand(4, generator=fresh._dropout_gen), want)


def test_two_ranks_resume_the_same_curves(tmp_path):
    """Two ranks on a [2] data mesh: rank 0 saves, both restore from its file
    and give the uninterrupted curves."""
    inp = {"checkpoint": {"cfg": dict(
        prefix="ckdp", dataset="synthetic_insects", model_name="proof", convnet_type="clip",
        init_cls=3, increment=3, memory_size=12, tuned_epoch=1, batch_size=16, init_lr=0.01,
        optimizer="adam", context_prompt_length_per_task=2, seed=[7], shuffle=True,
        extras={"tiny_backbone": True, "dataset_kwargs": {
            "num_classes": 6, "img_size": 32, "train_per_stage": 5, "test_per_stage": 3}}),
        "log_dir": str(tmp_path / "logs"), "ckpt": str(tmp_path / "ckpt")}}
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                        "MASTER_ADDR")}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), "2", str(tmp_path / "rdzv"),
                               str(tmp_path / "inputs.pkl"), str(tmp_path / f"rank{r}.pkl")],
                              env=env, cwd=str(WORKER.parents[1]), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            res = pickle.load(f)
        assert res["modules"] == []
        results.append(res["checkpoint"])
    for res in results:
        assert res["files"] == ["task_0.pt", "task_1.pt"]
        assert len(res["whole_cnn_top1"]) == 2
        for k in KEYS:
            assert res[f"resumed_{k}"] == res[f"whole_{k}"], k
    assert results[0] == results[1]
    assert np.isfinite(results[0]["whole_cnn_top1"]).all()
