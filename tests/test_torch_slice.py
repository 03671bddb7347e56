"""The port's slice end to end against team_tpu: SimpleCIL and ZS-CLIP
through ``team_tpu_torch.trainer.train`` and ``team_tpu.trainer.train`` over
the 3-task tiny protocol of tests/test_end_to_end.py, with the JAX CLIP init
carried across by the bridge.

Curves (top-1, top-"5", zero-shot) agree within 0.1 pp and features within
1e-5 (float32; the sums run in another order). On the int8 static tier both
sides calibrate on their own bf16 towers, so their payloads may differ by a
rounding step and a borderline image may flip: curves agree within one test
image per task (8.33, 4.17 and 2.78 pp for the 12, 24 and 36 test images of
tasks 1-3). A subprocess runs the port's CLI and checks that jax is never
imported (this process has it: conftest)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from team_tpu.backbone.clip import CLIPConfig, init_clip_params
from team_tpu.config import Config
from team_tpu.data.manager import DataManager
from team_tpu.learners.factory import get_model as jax_get_model
from team_tpu.trainer import train as jax_train
from team_tpu_torch.bridge import params_from_numpy
from team_tpu_torch.learners.factory import get_model as torch_get_model
from team_tpu_torch.trainer import train as torch_train

REPO = Path(__file__).resolve().parents[1]
MODELS = ["simplecil", "zs_clip"]


def tiny_cfg(model_name: str, log_dir, **kw) -> Config:
    # the tiny_cfg of tests/test_end_to_end.py, with a log directory per run
    base = dict(
        prefix="t", dataset="synthetic_insects", model_name=model_name, convnet_type="clip",
        init_cls=2, increment=2, memory_size=12, tuned_epoch=2, batch_size=8, init_lr=0.01,
        optimizer="adam", context_prompt_length_per_task=3, seed=[1], shuffle=True,
        log_dir=str(log_dir),
        extras={"tiny_backbone": True, "dataset_kwargs": {"num_classes": 6, "img_size": 32}},
    )
    base["extras"] = {**base["extras"], **kw.pop("extras", {})}
    base.update(kw)
    return Config(**base)


@pytest.fixture(scope="module")
def clip_params():
    # the JAX learners' own init: BackboneRuntime seeds PRNGKey(0)
    jp = init_clip_params(jax.random.PRNGKey(0), CLIPConfig.tiny())
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _metrics(log_dir, model_name):
    path = Path(log_dir) / model_name / "synthetic_insects" / "0" / "2" / "metrics.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("model_name", MODELS)
def test_slice_curves_match_team_tpu(model_name, clip_params, tmp_path):
    want = jax_train(tiny_cfg(model_name, tmp_path / "jax"))
    got = torch_train(tiny_cfg(model_name, tmp_path / "torch", device=["cpu"]), clip_params)
    assert len(got["cnn_top1"]) == 3
    for key in ("cnn_top1", "cnn_top5", "avg_acc"):
        np.testing.assert_allclose(got[key], want[key], atol=0.1, err_msg=key)
    jm, tm = _metrics(tmp_path / "jax", model_name), _metrics(tmp_path / "torch", model_name)
    assert len(jm) == len(tm) == 3
    for a, b in zip(jm, tm):
        for key in ("top1", "top4_as_top5", "zs_seen", "zs_unseen", "zs_harmonic", "zs_total"):
            assert abs(a[key] - b[key]) <= 0.1, (key, a, b)


@pytest.mark.parametrize("model_name", MODELS)
def test_slice_features_match_team_tpu(model_name, clip_params, tmp_path):
    dm = DataManager("synthetic_insects", shuffle=True, seed=1, init_cls=2, increment=2,
                     num_classes=6, img_size=32)
    jm = jax_get_model(model_name, tiny_cfg(model_name, tmp_path))
    tm = torch_get_model(model_name, tiny_cfg(model_name, tmp_path, device=["cpu"]), clip_params)
    for model in (jm, tm):
        model.incremental_train(dm)
    jv, jy = jm._extract_vectors(jm.test_loader)
    tv, ty = tm._extract_vectors(tm.test_loader)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tm._zero_shot_text_features().numpy(),
                               np.asarray(jm._zero_shot_text_features()), rtol=1e-4, atol=1e-5)
    means = np.random.default_rng(5).standard_normal((tm._total_classes, tv.shape[1])).astype(np.float32)
    jp, jy = jm._eval_nme(jm.test_loader, means)
    tp, ty = tm._eval_nme(tm.test_loader, means)
    np.testing.assert_array_equal(tp, np.asarray(jp))
    np.testing.assert_array_equal(ty, jy)
    if model_name == "simplecil":
        n = tm._total_classes
        np.testing.assert_allclose(tm.fc["weight"][:n].numpy(), np.asarray(jm.fc["weight"])[:n],
                                   rtol=1e-4, atol=1e-5)


def _capture_instances(monkeypatch, cls) -> list:
    made = []
    init = cls.__init__

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(cls, "__init__", recording_init)
    return made


@pytest.mark.parametrize("model_name", MODELS)
def test_int8_slice_curves_match_team_tpu(model_name, clip_params, tmp_path, monkeypatch):
    from team_tpu.learners.backbone_runtime import BackboneRuntime as JaxRuntime
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime as TorchRuntime

    jax_rts = _capture_instances(monkeypatch, JaxRuntime)
    torch_rts = _capture_instances(monkeypatch, TorchRuntime)
    want = jax_train(tiny_cfg(model_name, tmp_path / "jax", encoder_quant="int8_static"))
    got = torch_train(tiny_cfg(model_name, tmp_path / "torch", device=["cpu"],
                               encoder_quant="int8_static"), clip_params)
    # both sides committed the quantized tower; neither fell back to bf16
    assert len(jax_rts) == len(torch_rts) == 1
    assert jax_rts[0]._qvision is not None and jax_rts[0].encoder_quant == "int8_static"
    assert torch_rts[0].int8_committed and torch_rts[0].encoder_quant == "int8_static"
    assert torch_rts[0].gate_cosine >= 0.999
    one_image = [100 / n for n in (12, 24, 36)]  # pp of one test image, tasks 1-3
    assert len(got["cnn_top1"]) == 3
    for key in ("cnn_top1", "cnn_top5"):
        assert all(abs(g - w) <= tol + 1e-9 for g, w, tol in zip(got[key], want[key], one_image)), (
            key, got[key], want[key])
    jm, tm = _metrics(tmp_path / "jax", model_name), _metrics(tmp_path / "torch", model_name)
    for a, b in zip(jm, tm):
        assert abs(a["zs_total"] - b["zs_total"]) <= one_image[-1] + 1e-9, (a, b)


def test_cli_runs_the_slice_without_jax(tmp_path):
    # no "device" in the JSON, so the --device flag decides
    cfg = {"prefix": "t", "dataset": "synthetic_insects", "model_name": "simplecil",
           "init_cls": 2, "increment": 2, "batch_size": 8, "seed": [1],
           "log_dir": str(tmp_path), "tiny_backbone": True,
           "dataset_kwargs": {"num_classes": 6, "img_size": 32}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    code = ("import runpy, sys\n"
            f"sys.argv = ['main', '--config', {str(tmp_path / 'cfg.json')!r}, '--device', 'cpu']\n"
            "runpy.run_module('team_tpu_torch.main', run_name='__main__')\n"
            "print('JAX_IMPORTED', 'jax' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_IMPORTED False" in proc.stdout
    assert len(_metrics(tmp_path, "simplecil")) == 3


def test_profile_dir_writes_a_trace(clip_params, tmp_path):
    cfg = tiny_cfg("zs_clip", tmp_path / "logs", device=["cpu"], profile_dir=str(tmp_path / "prof"))
    torch_train(cfg, clip_params)
    traces = sorted(p.name for p in (tmp_path / "prof").iterdir())
    assert len(traces) == 3 and all(name.startswith("task_") for name in traces)


@pytest.mark.parametrize("kw,env,exc", [
    pytest.param({"model_name": "proof"}, {}, NotImplementedError, id="proof"),
    pytest.param({"encoder_quant": "int8_static", "extras": {"int8_gemm_impl": "hybrid"}}, {},
                 NotImplementedError, id="int8_hybrid"),
    pytest.param({"checkpoint_dir": "ckpt"}, {}, NotImplementedError, id="checkpoint_dir"),
    pytest.param({"mesh_shape": [2]}, {}, NotImplementedError, id="mesh_shape"),
    pytest.param({}, {"TEAM_CLIP_CHECKPOINT": "clip.pt"}, NotImplementedError, id="clip_checkpoint"),
])
def test_unported_options_raise(kw, env, exc, tmp_path, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = tiny_cfg(kw.pop("model_name", "simplecil"), tmp_path, device=["cpu"], **kw)
    with pytest.raises(exc):
        torch_train(cfg)


def test_cuda_device_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_train(tiny_cfg("simplecil", tmp_path, device=[0]))


def test_toolkit_matches_team_tpu(clip_params):
    from team_tpu.utils import toolkit as jtk
    from team_tpu_torch.utils import toolkit as ttk

    rng = np.random.default_rng(4)
    y_true = rng.integers(0, 25, 200)
    y_pred = np.where(rng.random(200) < 0.6, y_true, rng.integers(0, 25, 200))
    topk = np.stack([y_pred] + [rng.integers(0, 25, 200) for _ in range(3)], axis=1)
    for nb_old in (0, 10, 25):
        assert ttk.accuracy(y_pred, y_true, nb_old) == jtk.accuracy(y_pred, y_true, nb_old)
    assert ttk.topk_accuracy(topk, y_true) == jtk.topk_accuracy(topk, y_true)
    jp = init_clip_params(jax.random.PRNGKey(0), CLIPConfig.tiny())
    assert ttk.count_parameters(clip_params) == jtk.count_parameters(jp)
