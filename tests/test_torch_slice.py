"""The port's slice end to end against team_tpu: SimpleCIL and ZS-CLIP
through ``team_tpu_torch.trainer.train`` and ``team_tpu.trainer.train`` over
the 3-task tiny protocol of tests/test_end_to_end.py, with the JAX CLIP init
carried across by the bridge.

Curves (top-1, top-"5", zero-shot) agree within 0.1 pp and features within
1e-5 (float32; the sums run in another order). On the int8 static tier both
sides calibrate on their own bf16 towers, so their payloads may differ by a
rounding step and a borderline image may flip: curves agree within one test
image per task (8.33, 4.17 and 2.78 pp for the 12, 24 and 36 test images of
tasks 1-3). Two more roundings differ there: the calibration forward runs
``attention_impl="auto"``, where the port's packed plain version rounds
q·dh^-0.5 to bf16 before QKᵀ and team_tpu's CPU route scales after it (the
two agree at dh=64, not at the tiny tower's dh=32; ROADMAP fault 3.10), and
team_tpu's runtime encodes under ``jax.jit``, where XLA on the CPU keeps bf16
intermediates in float32. Subprocesses run the port's CLI (SimpleCIL, and PROOF on the flash-attention
route) and check that neither jax nor team_tpu is imported (this process has
both: conftest)."""

import json
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from team_tpu.backbone.clip import CLIPConfig, init_clip_params
from team_tpu.config import Config
from team_tpu_torch.config import Config as TorchConfig
from team_tpu.data.manager import DataManager
from team_tpu.learners.factory import get_model as jax_get_model
from team_tpu.trainer import train as jax_train
from team_tpu_torch.bridge import params_from_numpy
from team_tpu_torch.learners.factory import get_model as torch_get_model
from team_tpu_torch.trainer import train as torch_train

REPO = Path(__file__).resolve().parents[1]
MODELS = ["simplecil", "zs_clip"]


def tiny_cfg(model_name: str, log_dir, config_cls=Config, **kw):
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
    return config_cls(**base)


def torch_cfg(model_name: str, log_dir, **kw) -> TorchConfig:
    """The same configuration as the port's own Config, on the CPU."""
    return tiny_cfg(model_name, log_dir, config_cls=TorchConfig, device=["cpu"], **kw)


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
    got = torch_train(torch_cfg(model_name, tmp_path / "torch"), clip_params)
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
    tm = torch_get_model(model_name, torch_cfg(model_name, tmp_path), clip_params)
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
    got = torch_train(torch_cfg(model_name, tmp_path / "torch", encoder_quant="int8_static"),
                      clip_params)
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


FUSED_ROUTES = ["attn_block", "mha_packed_proj"]


@pytest.fixture
def jax_fused_interpret(monkeypatch):
    """team_tpu's fused attention kernels, and the int8 producers of its
    ``static`` route, in interpret mode (the CPU takes no compiled Pallas),
    patched in as tests/test_backbone.py does."""
    import functools

    import team_tpu.backbone.quant as jquant
    import team_tpu.ops.mha_short as jms

    for name in ("fused_attn_block", "fused_mha_packed_proj"):
        monkeypatch.setattr(jms, name, functools.partial(getattr(jms, name), interpret=True))
    for name in ("ln_quantize_static", "row_quant_static"):
        fn = getattr(jquant, name)
        monkeypatch.setattr(jquant, name, lambda *a, _fn=fn, interpret=False, **k:
                            _fn(*a, interpret=True, **k))


@pytest.mark.parametrize("impl", FUSED_ROUTES)
@pytest.mark.parametrize("model_name", MODELS)
def test_fused_route_curves_and_features_match_team_tpu(model_name, impl, clip_params, tmp_path,
                                                        monkeypatch, jax_fused_interpret):
    """The same protocol on ``attention_impl`` attn_block or mha_packed_proj
    (both towers through the fused kernels' plain versions here): curves
    within 0.1 pp, and the trained learners' test features within 1e-5."""
    import team_tpu.trainer as jtrainer
    import team_tpu_torch.trainer as ttrainer

    learners = {}  # the learner each trainer builds
    for key, mod in (("jax", jtrainer), ("torch", ttrainer)):
        monkeypatch.setattr(mod, "get_model", lambda *a, _make=mod.get_model, _key=key, **k:
                            learners.setdefault(_key, _make(*a, **k)))
    want = jax_train(tiny_cfg(model_name, tmp_path / "jax", attention_impl=impl))
    got = torch_train(torch_cfg(model_name, tmp_path / "torch", attention_impl=impl), clip_params)
    assert len(got["cnn_top1"]) == 3
    for key in ("cnn_top1", "cnn_top5", "avg_acc"):
        np.testing.assert_allclose(got[key], want[key], atol=0.1, err_msg=key)
    for a, b in zip(_metrics(tmp_path / "jax", model_name), _metrics(tmp_path / "torch", model_name)):
        for key in ("top1", "top4_as_top5", "zs_total"):
            assert abs(a[key] - b[key]) <= 0.1, (key, a, b)
    jm, tm = learners["jax"], learners["torch"]
    assert tm.backbone.attn_impl == impl
    jv, jy = jm._extract_vectors(jm.test_loader)
    tv, ty = tm._extract_vectors(tm.test_loader)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tm._zero_shot_text_features().numpy(),
                               np.asarray(jm._zero_shot_text_features()), rtol=1e-4, atol=1e-5)


def test_int8_static_route_on_attn_block_matches_team_tpu(clip_params, tmp_path, monkeypatch,
                                                          jax_fused_interpret):
    """SimpleCIL on ``encoder_quant="int8_static"``, ``int8_gemm_impl="static"``
    with ``attention_impl="attn_block"``: team_tpu's int8 blocks (and their
    calibration forward) send that name to plain attention and its text tower
    through the fused kernel; the port does the same instead of raising. Both
    commit the quantized tower; curves within one test image per task, as
    test_int8_slice_curves_match_team_tpu."""
    from team_tpu.learners.backbone_runtime import BackboneRuntime as JaxRuntime
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime as TorchRuntime

    jax_rts = _capture_instances(monkeypatch, JaxRuntime)
    torch_rts = _capture_instances(monkeypatch, TorchRuntime)
    kw = dict(encoder_quant="int8_static", attention_impl="attn_block",
              extras={"int8_gemm_impl": "static"})
    want = jax_train(tiny_cfg("simplecil", tmp_path / "jax", **kw))
    got = torch_train(torch_cfg("simplecil", tmp_path / "torch", **kw), clip_params)
    assert jax_rts[0]._qvision is not None and jax_rts[0].encoder_quant == "int8_static"
    assert torch_rts[0].int8_committed and torch_rts[0].int8_impl == "static"
    assert torch_rts[0].attn_impl == "attn_block" and torch_rts[0].gate_cosine >= 0.999
    one_image = [100 / n + 0.01 for n in (12, 24, 36)]
    for key in ("cnn_top1", "cnn_top5"):
        assert len(got[key]) == 3
        assert all(abs(g - w) <= tol + 1e-9 for g, w, tol in zip(got[key], want[key], one_image)), (
            key, got[key], want[key])


def _run_cli_and_list_reference_modules(tmp_path, model_name: str, probes: bool = False,
                                        **extra) -> list:
    """Run the port's CLI in a fresh process on the CPU (then, with
    ``probes``, every probe entry point at a tiny size); returns the names of
    the loaded modules that are jax or team_tpu (or below either)."""
    # no "device" in the JSON, so the --device flag decides
    cfg = {"prefix": "t", "dataset": "synthetic_insects", "model_name": model_name,
           "init_cls": 2, "increment": 2, "batch_size": 8, "seed": [1],
           "log_dir": str(tmp_path), "tiny_backbone": True,
           "dataset_kwargs": {"num_classes": 6, "img_size": 32}, **extra}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    code = ("import runpy, sys\n"
            f"sys.argv = ['main', '--config', {str(tmp_path / 'cfg.json')!r}, '--device', 'cpu']\n"
            "runpy.run_module('team_tpu_torch.main', run_name='__main__')\n")
    if probes:
        probe_args = {
            "attn_shootout": ["--batch", "1", "--layers", "1"],
            "r4_attn_decomp": ["--batch", "1", "--layers", "1"],
            "int8_probe": ["--size", "64"],
            "int8_mxu_ceiling": ["--m", "16", "--k", "32", "--reps", "5"],
            "r5_megakernel_probe": ["--batch", "1", "--layers", "1", "--inputs", "1",
                                    "--variants", "xla,mk2d256,mk3d8"]}
        code += (f"for probe, args in {probe_args!r}.items():\n"
                 "    sys.argv = [probe, '--device', 'cpu', '--rounds', '1', *args]\n"
                 "    runpy.run_module('team_tpu_torch.scripts.' + probe, run_name='__main__')\n")
        # the full-protocol runner at its tiny size, its golden written under tmp_path
        runner_args = ["--device", "cpu", "--tiny", "--golden-dir", str(tmp_path / "goldens"),
                       "--log-dir", str(tmp_path / "full_protocol")]
        code += ("import os\nos.environ['TEAM_PIN'] = 'regen'\n"
                 f"sys.argv = ['full_protocol', *{runner_args!r}]\n"
                 "runpy.run_module('team_tpu_torch.scripts.full_protocol', run_name='__main__')\n")
    code += ("print('REFERENCE_MODULES', sorted(m for m in sys.modules if m.split('.')[0] "
             "in ('jax', 'team_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("REFERENCE_MODULES")][-1]
    assert len(_metrics(tmp_path, model_name)) == 3
    return eval(line.split(" ", 1)[1])


def test_cli_runs_the_slice_without_jax(tmp_path):
    assert _run_cli_and_list_reference_modules(tmp_path, "simplecil", probes=True) == []
    assert [p.name for p in (tmp_path / "goldens").iterdir()] == ["h100_protocol_proof_bf16.json"]


def test_cli_runs_proof_without_jax_or_team_tpu(tmp_path):
    results = tmp_path / "results"
    assert _run_cli_and_list_reference_modules(
        tmp_path, "proof", memory_size=12, tuned_epoch=2, context_prompt_length_per_task=3,
        attention_impl="pallas", enable_plots=True, results_dir=str(results)) == []
    # the trainer's PROOF hook draws the state-distance matrix after each task
    run_dir = tmp_path / "proof" / "synthetic_insects" / "0" / "2"
    assert sorted(p.name for p in run_dir.glob("*.png")) == [
        f"task{t}_state_distance.png" for t in range(3)]
    # PROOF's own plots, under results_dir: the t-SNE atlas after each task's
    # memory, the classes' evolution paths at the last epoch (where team_tpu
    # draws them, tests/test_torch_plots.py)
    drawn = sorted(str(p.relative_to(results)) for p in results.rglob("*.png"))
    assert [p for p in drawn if p.endswith("state_evolution_tsne.png")] == [
        f"task_{t}/analysis/state_evolution_tsne.png" for t in range(3)]
    assert any(p.startswith("task_2/evolution/class_") for p in drawn)


def test_port_sources_import_neither_jax_nor_team_tpu():
    """The subprocess tests see only the imports a run reaches; this scan also
    catches an import inside a function no run calls, and loads by path."""
    imports = re.compile(r"^\s*(?:import|from)\s+(?:jax\w*|team_tpu)\b", re.M)
    loads = re.compile(r"spec_from_file_location|import_module\(|__import__\(")
    sources = sorted((REPO / "team_tpu_torch").rglob("*.py"))
    assert len(sources) > 30
    found = [f"{p.relative_to(REPO)}: {m.group(0).strip()}" for p in sources
             for pat in (imports, loads) for m in pat.finditer(p.read_text())]
    assert found == []


def test_profile_dir_writes_a_trace(clip_params, tmp_path):
    cfg = torch_cfg("zs_clip", tmp_path / "logs", profile_dir=str(tmp_path / "prof"))
    torch_train(cfg, clip_params)
    traces = sorted(p.name for p in (tmp_path / "prof").iterdir())
    assert len(traces) == 3 and all(name.startswith("task_") for name in traces)


@pytest.mark.parametrize("kw,env,exc", [
    # the mha_short kernel is non-causal: the port refuses the causal text tower on
    # it, as team_tpu's front end asserts (team_tpu/ops/attention.py:55)
    pytest.param({"model_name": "proof", "attention_impl": "mha_short"}, {}, ValueError,
                 id="proof"),
    # ported: exc None holds the trainer on the option against team_tpu
    pytest.param({"encoder_quant": "int8_static", "attention_impl": "xla",
                  "extras": {"int8_gemm_impl": "hybrid"}}, {}, None, id="int8_hybrid"),
    # ported: PROOF lays its mesh over the launched ranks, one device each, so a
    # 2-rank mesh in one process raises (tests/test_torch_parallel.py runs two)
    pytest.param({"model_name": "proof", "mesh_shape": [2]}, {}, ValueError, id="mesh_shape"),
    # a file that exists but holds no checkpoint (one zero byte, under tmp_path): the
    # loader is ported (tests/test_torch_import_weights.py) and torch.load refuses it,
    # as in team_tpu
    pytest.param({}, {"TEAM_CLIP_CHECKPOINT": "<tmp>/clip.pt"}, pickle.UnpicklingError,
                 id="clip_checkpoint"),
])
def test_unported_options_raise(kw, env, exc, tmp_path, monkeypatch):
    """An option the port refuses raises (the causal text tower on
    ``mha_short``, as team_tpu), and so does a mesh larger than the launched
    world and a checkpoint file that holds none. ``int8_gemm_impl="hybrid"`` is
    ported: SimpleCIL through both trainers on it, with ``attention_impl=
    "xla"`` on both sides (ROADMAP 3.10) and team_tpu's kernels of the tier
    in interpret mode; both gate the static payload through the tier, both
    gates fail and both serve bf16, and the curves agree within 0.1 pp."""
    if exc is None:
        _hybrid_trainer_matches_team_tpu(kw, tmp_path, monkeypatch)
        return
    for k, v in env.items():
        if v.startswith("<tmp>/"):
            path = tmp_path / v[len("<tmp>/"):]
            path.write_bytes(b"\0")
            v = str(path)
        monkeypatch.setenv(k, v)
    cfg = torch_cfg(kw.pop("model_name", "simplecil"), tmp_path, **kw)
    with pytest.raises(exc):
        torch_train(cfg)


def _hybrid_trainer_matches_team_tpu(kw, tmp_path, monkeypatch):
    import team_tpu.backbone.quant as jquant
    from team_tpu.learners.backbone_runtime import BackboneRuntime as JaxRuntime
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime as TorchRuntime

    for name in ("ln_quantize", "int8_linear_gelu_quant", "int8_linear_blockscale"):
        fn = getattr(jquant, name)
        monkeypatch.setattr(jquant, name, lambda *a, _fn=fn, interpret=False, **k:
                            _fn(*a, interpret=True, **k))
    jax_rts = _capture_instances(monkeypatch, JaxRuntime)
    torch_rts = _capture_instances(monkeypatch, TorchRuntime)
    jp = init_clip_params(jax.random.PRNGKey(0), CLIPConfig.tiny())
    want = jax_train(tiny_cfg("simplecil", tmp_path / "jax", **kw))
    got = torch_train(torch_cfg("simplecil", tmp_path / "torch", **kw),
                      params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)))
    (jrt,), (trt,) = jax_rts, torch_rts
    assert jrt._qvision is None and jrt.encoder_quant == "bf16"
    assert trt.int8_impl == "hybrid" and trt.gate_cosine < 0.999
    assert not trt.int8_committed and trt.encoder_quant == "bf16"
    assert len(got["cnn_top1"]) == 3
    for key in ("cnn_top1", "cnn_top5", "avg_acc"):
        np.testing.assert_allclose(got[key], want[key], atol=0.1, err_msg=key)


def test_clip_checkpoint_that_names_no_file_trains_as_the_random_init(tmp_path, monkeypatch):
    """As team_tpu (``backbone_runtime.py:41-50``): a ``TEAM_CLIP_CHECKPOINT``
    that names no file means the random init, and the run is the same as one
    without the variable."""
    monkeypatch.delenv("TEAM_CLIP_CHECKPOINT", raising=False)
    want = torch_train(torch_cfg("simplecil", tmp_path / "plain"))
    monkeypatch.setenv("TEAM_CLIP_CHECKPOINT", str(tmp_path / "no_such_checkpoint.pt"))
    got = torch_train(torch_cfg("simplecil", tmp_path / "unset"))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_cuda_device_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_train(tiny_cfg("simplecil", tmp_path, config_cls=TorchConfig, device=[0]))


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
