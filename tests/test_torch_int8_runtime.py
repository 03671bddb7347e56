"""The int8 runtime on the routes of this group, against team_tpu on the CPU:
the dynamic ``xla`` tier through ``int8_gemm_impl`` (team_tpu's runtime
builds the static payload, encodes it through the ``xla`` blocks, its gate
fails and it serves bf16), a cached payload on the other route family (it
goes through the gate; team_tpu would commit it ungated, ROADMAP fault 3.6),
and the trainer on ``static3d_qis`` and on ``TEAM_CLS_LAST=kqs``.

Tolerances: the ``xla`` gate's min cosine within 2e-3 of team_tpu's (each
side calibrates on its own bf16 tower); trainer curves within one test image
per task (8.33, 4.17 and 2.78 pp for the 12, 24 and 36 test images of tasks
1-3), not 0.1 pp: team_tpu's runtime encodes under ``jax.jit``, and XLA on
the CPU then keeps the tower's bf16 intermediates in float32 (its features
differ from the same function run eagerly by up to 2e-2 and are not bf16
values), while the port rounds each to bf16, so a borderline test image can
flip. Both sides run ``attention_impl="xla"``, so that both calibrate
through the same attention arithmetic (on ``auto`` the port's packed plain
version rounds the scaled q at the tiny tower's dh=32 and team_tpu's CPU
route does not: ROADMAP fault 3.10)."""

import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import team_tpu_torch.backbone.quant as tq
from team_tpu.backbone.clip import CLIPConfig as JCLIPConfig
from team_tpu.backbone.clip import init_clip_params as jax_init
from team_tpu_torch.backbone.clip import CLIPConfig
from team_tpu_torch.bridge import params_from_numpy
from team_tpu_torch.config import Config
from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

JCFG, CFG = JCLIPConfig.tiny(), CLIPConfig.tiny()
SZ = CFG.vision.image_size


@pytest.fixture(scope="module")
def tp():
    jp = jax_init(jax.random.PRNGKey(0), JCFG)  # the JAX runtime's own init
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _u8_images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, SZ, SZ, 3)).astype(np.uint8)


def _extras(**kw):
    return {"tiny_backbone": True, **kw}


def _runtime(tp, **extras):
    cfg = Config(convnet_type="clip", device=["cpu"], compute_dtype="bfloat16",
                 attention_impl="xla", encoder_quant="int8_static", extras=_extras(**extras))
    return BackboneRuntime(cfg, params=tp)


def test_xla_runtime_gates_the_static_payload_and_serves_bf16_as_team_tpu(tp, caplog):
    from team_tpu.config import Config as JConfig
    from team_tpu.learners.backbone_runtime import BackboneRuntime as JaxRuntime

    batches = [_u8_images(8, seed) for seed in (50, 51, 52)]
    jrt = JaxRuntime(JConfig(convnet_type="clip", compute_dtype="bfloat16", attention_impl="xla",
                             encoder_quant="int8_static",
                             extras=_extras(int8_gemm_impl="xla")))
    rt = _runtime(tp, int8_gemm_impl="xla")
    with caplog.at_level(logging.INFO):
        for b in batches[:2]:
            jrt.encode_image(jnp.asarray(b))
            rt.encode_image(torch.from_numpy(b))
    # team_tpu's warning (the port's says "--" where it has an em dash)
    (jax_cos,) = [float(m) for m in re.findall(r"gate FAILED \(min ([0-9.]+)\) \u2014",
                                                caplog.text)]
    assert jrt.encoder_quant == "bf16" and jrt._qvision is None
    assert rt.encoder_quant == "bf16" and not rt.int8_committed
    assert rt.gate_cosine < 0.999 and abs(rt.gate_cosine - jax_cos) <= 2e-3, (rt.gate_cosine,
                                                                              jax_cos)
    bf16 = _runtime(tp)
    bf16.encoder_quant = "bf16"
    x = torch.from_numpy(batches[2])
    torch.testing.assert_close(rt.encode_image(x), bf16.encode_image(x), rtol=0, atol=0)


def test_a_payload_gated_on_the_other_route_family_is_gated_again(tp, tmp_path):
    """A payload saved after a gate on a static route loads on ``xla`` and
    goes through the held-out gate (which fails there, as a fresh static
    payload's does); one saved as gated on the dynamic family loads on
    ``static3d_qi``, passes the gate and is saved again as static."""
    batches = [torch.from_numpy(_u8_images(8, seed)) for seed in (60, 61, 62)]
    cache = str(tmp_path / "static")
    rt = _runtime(tp, int8_cache_dir=cache)
    rt.encode_image(batches[0])
    rt.encode_image(batches[1])
    assert rt.int8_committed
    qv, family = tq.load_quantized_tower(cache)
    assert family == "static"

    on_xla = _runtime(tp, int8_cache_dir=cache, int8_gemm_impl="xla")
    feats = on_xla.encode_image(batches[2])
    assert on_xla.gate_cosine is not None and on_xla.gate_cosine < 0.999
    assert not on_xla.int8_committed and on_xla.encoder_quant == "bf16"
    torch.testing.assert_close(feats, on_xla._calib_forward(batches[2])[1], rtol=0, atol=0)

    other = str(tmp_path / "dynamic")
    tq.save_quantized_tower(other, qv, "dynamic")
    back = _runtime(tp, int8_cache_dir=other)
    feats = back.encode_image(batches[2])
    assert back.int8_committed and back.gate_cosine is not None and back.gate_cosine >= 0.999
    torch.testing.assert_close(feats, back._encode_int8(back._qvision, batches[2]), rtol=0,
                               atol=0)
    assert tq.load_quantized_tower(other)[1] == "static"
    # on its own family a loaded payload commits without a gate, as before
    again = _runtime(tp, int8_cache_dir=other)
    again.encode_image(batches[0])
    assert again.int8_committed and again.gate_cosine is None


def _tiny_protocol(config_cls, log_dir, route, **kw):
    """The 3-task tiny SimpleCIL protocol of tests/test_torch_slice.py on one
    int8 route, with attention_impl="xla" (see the module docstring)."""
    return config_cls(
        prefix="t", dataset="synthetic_insects", model_name="simplecil", convnet_type="clip",
        init_cls=2, increment=2, memory_size=12, tuned_epoch=2, batch_size=8, init_lr=0.01,
        optimizer="adam", seed=[1], shuffle=True, log_dir=str(log_dir),
        encoder_quant="int8_static", attention_impl="xla",
        extras={"tiny_backbone": True, "int8_gemm_impl": route,
                "dataset_kwargs": {"num_classes": 6, "img_size": 32}}, **kw)


@pytest.mark.parametrize("route,env", [("static3d_qis", {}),
                                       ("static3d_qi", {"TEAM_CLS_LAST": "kqs"})],
                         ids=["qis", "kqs"])
def test_trainer_curves_on_the_new_routes_match_team_tpu(tp, route, env, tmp_path, monkeypatch):
    """SimpleCIL through both trainers on the same route and knobs, from the
    same CLIP init: both commit the quantized tower, and the curves agree
    within one test image per task (see the module docstring)."""
    from team_tpu.config import Config as JConfig
    from team_tpu.learners.backbone_runtime import BackboneRuntime as JaxRuntime
    from team_tpu.trainer import train as jax_train
    from team_tpu_torch.trainer import train as torch_train

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    made = {"jax": [], "torch": []}
    for key, cls in (("jax", JaxRuntime), ("torch", BackboneRuntime)):
        init = cls.__init__

        def recording_init(self, *a, _init=init, _made=made[key], **k):
            _init(self, *a, **k)
            _made.append(self)

        monkeypatch.setattr(cls, "__init__", recording_init)
    want = jax_train(_tiny_protocol(JConfig, tmp_path / "jax", route))
    got = torch_train(_tiny_protocol(Config, tmp_path / "torch", route, device=["cpu"]), tp)
    (jrt,), (trt,) = made["jax"], made["torch"]
    assert jrt._qvision is not None and jrt.encoder_quant == "int8_static"
    assert trt.int8_committed and trt.gate_cosine >= 0.999 and trt.int8_impl == route
    one_image = [100 / n + 0.01 for n in (12, 24, 36)]  # pp, as the trainer rounds them
    for key in ("cnn_top1", "cnn_top5"):
        assert len(got[key]) == 3
        assert all(abs(g - w) <= tol + 1e-9 for g, w, tol in zip(got[key], want[key], one_image)), (
            key, got[key], want[key])
