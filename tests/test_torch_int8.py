"""The int8 static-W8A8 image tower of the port against team_tpu, on the CPU.

The JAX side runs as tests/test_int8.py runs it (its Pallas kernels in
interpret mode); both sides get the same tiny CLIP init and the same inputs,
made with numpy and carried across by the bridge. Tolerances:
- quantize_weight and the payload fed the same (JAX) calibration stats:
  bit for bit, except ``patch_q.const``, a float32 sum taken in another
  order (1e-6 relative to the sum of its terms' magnitudes);
- calibration stats: two bf16 steps (2^-6 relative): the bf16 erf GELU
  rounds at other places in XLA and torch, and a one-step change in one
  block moves the next block's maxima by another;
- ``_ln_quant3``, ``_static_quant3`` and ``_static_linear3`` to int8: one
  int8 step (the dequant product and bias may be one FMA in XLA);
  ``_static_linear3`` to bf16: one bf16 step;
- tower features on the same payload: cosine >= 0.9999 and max |Δ| <=
  5e-3·rms, the bound of tests/test_int8.py:375."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import team_tpu.backbone.quant as jq
import team_tpu.ops.int8_matmul as jim
import team_tpu_torch.backbone.quant as tq
from team_tpu.backbone.clip import CLIPConfig as JCLIPConfig
from team_tpu.backbone.clip import init_clip_params as jax_init
from team_tpu.backbone.clip import patch_pixels as jax_patch_pixels
from team_tpu.ops.int8_matmul import quantize_weight as jax_quantize_weight
from team_tpu_torch.backbone.clip import CLIPConfig
from team_tpu_torch.bridge import params_from_numpy, params_to_numpy
from team_tpu_torch.config import Config
from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
from team_tpu_torch.ops.int8_matmul import int8_matmul, quantize_weight
from team_tpu_torch.ops.mha_short import fused_mha_packed_q3i, fused_mha_packed_q3i_cls
from team_tpu_torch.ops.preprocess import patch_norm_consts

JCFG, CFG = JCLIPConfig.tiny(), CLIPConfig.tiny()
SZ = CFG.vision.image_size


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """The JAX init and calibration on a float batch, the JAX payload, and
    both carried across."""
    rng = np.random.default_rng(0)
    jp = jax_init(jax.random.PRNGKey(0), JCFG)
    imgs = rng.standard_normal((8, SZ, SZ, 3)).astype(np.float32)
    jstats = jq.calibrate_vision_tower(jp, jnp.asarray(imgs), JCFG, attn_impl="xla")
    jqv = jq.quantize_vision_tower_static(jp, jstats, heads=JCFG.vision.heads)
    return {"jp": jp, "tp": params_from_numpy(_np(jp)), "imgs": imgs, "jstats": jstats,
            "jqv": jqv, "jqv_np": _np(jqv), "tqv": params_from_numpy(_np(jqv))}


def test_bridge_carries_int8_leaves():
    tree = {"w_q": np.arange(-127, 128, dtype=np.int8).reshape(5, 51), "s": [np.float32(2.5)]}
    got = params_from_numpy(tree)
    assert got["w_q"].dtype == torch.int8
    back = params_to_numpy(got)
    assert back["w_q"].dtype == np.int8 and np.array_equal(back["w_q"], tree["w_q"])


def test_quantize_weight_matches_jitted_jax():
    w = np.random.default_rng(1).standard_normal((96, 200)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column gets scale 1
    wq, ws = jax.jit(jax_quantize_weight)(jnp.asarray(w))
    got_q, got_s = quantize_weight(torch.from_numpy(w))
    assert got_q.dtype == torch.int8 and got_s.shape == (1, 200)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ws))


def test_int8_matmul_is_exact():
    rng = np.random.default_rng(2)
    x = rng.integers(-127, 128, (3, 5, 64)).astype(np.int8)
    w = rng.integers(-127, 128, (64, 24)).astype(np.int8)
    got = int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (3, 5, 24)
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int64) @ w.astype(np.int64))
    with pytest.raises(TypeError):
        int8_matmul(torch.from_numpy(x).float(), torch.from_numpy(w))


def test_calibration_matches_jax(setup):
    jstats, feats_j = jq.calibrate_vision_tower(setup["jp"], jnp.asarray(setup["imgs"]), JCFG,
                                               attn_impl="xla", return_features=True)
    tstats, feats_t = tq.calibrate_vision_tower(setup["tp"], torch.from_numpy(setup["imgs"]), CFG,
                                               attn_impl="xla", return_features=True)
    js = _np(jstats)
    np.testing.assert_array_equal(tstats["patch_in"].numpy(), js["patch_in"])
    for jb, tb in zip(js["blocks"], tstats["blocks"]):
        assert set(jb) == set(tb)
        for key in jb:
            np.testing.assert_allclose(tb[key].numpy(), jb[key], rtol=2 ** -6, atol=0, err_msg=key)
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), rtol=0.02, atol=2e-2)


def test_payload_is_bit_equal_to_jax(setup):
    tqv = tq.quantize_vision_tower_static(setup["tp"], params_from_numpy(_np(setup["jstats"])),
                                          heads=CFG.vision.heads)
    want = setup["jqv_np"]
    scale, bias = (t.numpy() for t in patch_norm_consts(CFG.vision.patch_size))
    w = want["patch_w"]
    magnitude = 128 * np.abs(w * scale[:, None]).sum(0) + np.abs(bias[:, None] * w).sum(0)

    def walk(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), (path, set(a) ^ set(b))
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        else:
            got = b.numpy()
            assert got.dtype == a.dtype and got.shape == a.shape, path
            if path == "/patch_q/const":
                # relative to the size of the summands: the sum cancels to
                # values far smaller than its terms
                assert (np.abs(got - a) <= 1e-6 * magnitude).all(), path
            else:
                np.testing.assert_array_equal(got, a, err_msg=path)

    walk(want, tqv, "")
    assert tqv["blocks"][0]["qkv"]["w_q"].dtype == torch.int8


def _within_one_step(got: torch.Tensor, want) -> None:
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1, diff.max()


def test_ln_quant3_and_static_quant3_match_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 9, 64)) * 3 + 0.5).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ln = {"scale": rng.standard_normal(64).astype(np.float32),
          "bias": rng.standard_normal(64).astype(np.float32)}
    inv_a = np.full((1, 64), 11.7, np.float32)
    want = jq._ln_quant3(xb, {k: jnp.asarray(v) for k, v in ln.items()}, jnp.asarray(inv_a))
    got = tq._ln_quant3(xt, params_from_numpy(ln), torch.from_numpy(inv_a))
    assert got.dtype == torch.int8
    _within_one_step(got, want)
    _within_one_step(tq._static_quant3(xt, torch.from_numpy(inv_a)),
                     jq._static_quant3(xb, jnp.asarray(inv_a)))


@pytest.mark.parametrize("activation,requant", [(None, False), ("gelu", True), (None, True)])
def test_static_linear3_matches_jax(setup, activation, requant):
    rng = np.random.default_rng(4)
    site = setup["jqv_np"]["blocks"][0]["fc"]
    q3 = rng.integers(-127, 128, (2, 5, site["w_q"].shape[0])).astype(np.int8)
    inv = np.full((1, site["w_q"].shape[1]), 9.5, np.float32) if requant else None
    want = np.asarray(jq._static_linear3(jnp.asarray(q3), jax.tree_util.tree_map(jnp.asarray, site),
                                         activation=activation,
                                         quant_inv_a=None if inv is None else jnp.asarray(inv)
                                         ).astype(jnp.float32))
    got = tq._static_linear3(torch.from_numpy(q3), params_from_numpy(site), activation=activation,
                             quant_inv_a=None if inv is None else torch.from_numpy(inv))
    if requant:
        assert got.dtype == torch.int8
        _within_one_step(got, want)
    else:
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=1e-6)


def _u8_images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, SZ, SZ, 3)).astype(np.uint8)


def _features(route, cls, qv_j, qv_t, seed=5):
    """(JAX, port) tower features of one route on held-out data."""
    jcls = False if cls == "0" else cls
    if route == "float":
        x = np.random.default_rng(seed).standard_normal((6, SZ, SZ, 3)).astype(np.float32)
        want = jq.encode_image_int8(qv_j, jnp.asarray(x), JCFG, attn_impl="xla",
                                    gemm_impl="static3d_qi", interpret=True, cls_last=jcls)
        got = tq.encode_image_int8(qv_t, torch.from_numpy(x), CFG, cls_last=cls)
    elif route == "u8":
        x = _u8_images(6, seed)
        want = jq.encode_image_int8_u8(qv_j, jnp.asarray(x), JCFG, attn_impl="xla",
                                       gemm_impl="static3d_qi", interpret=True, cls_last=jcls)
        got = tq.encode_image_int8_u8(qv_t, torch.from_numpy(x), CFG, cls_last=cls)
    else:
        patch_dot = route.split("-")[1]
        x = np.array(jax_patch_pixels(jnp.asarray(_u8_images(6, seed)), JCFG,
                                      compute_dtype=jnp.uint8))
        want = jq.encode_image_int8_patches(qv_j, jnp.asarray(x), JCFG, attn_impl="xla",
                                            gemm_impl="static3d_qi", interpret=True,
                                            patch_dot=patch_dot, cls_last=jcls)
        got = tq.encode_image_int8_patches(qv_t, torch.from_numpy(x), CFG, patch_dot=patch_dot,
                                           cls_last=cls)
    return np.asarray(want, np.float64), got.double().numpy()


@pytest.mark.parametrize("cls", ["kq", "0"])
@pytest.mark.parametrize("route", ["float", "u8", "patch-int8", "patch-bf16"])
def test_tower_features_match_jax(setup, route, cls):
    want, got = _features(route, cls, setup["jqv"], setup["tqv"])
    assert got.shape == (6, CFG.embed_dim)
    cos = (want * got).sum(-1) / (np.linalg.norm(want, axis=-1) * np.linalg.norm(got, axis=-1))
    assert cos.min() >= 0.9999, cos
    rms = np.sqrt((want ** 2).mean())
    assert np.abs(got - want).max() <= 5e-3 * rms + 1e-6


def test_tower_launches_q3i_per_block(setup):
    """On the CPU nothing is launched; the block structure is counted by
    wrapping the two wrappers."""
    calls = {"full": 0, "cls": 0}
    orig = (tq.fused_mha_packed_q3i_tp, tq.fused_mha_packed_q3i_cls)

    def full(*a, **k):
        calls["full"] += 1
        return orig[0](*a, **k)

    def cls(*a, **k):
        calls["cls"] += 1
        return orig[1](*a, **k)

    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, SZ, SZ, 3)).astype(np.float32))
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(tq, "fused_mha_packed_q3i_tp", full)
        m.setattr(tq, "fused_mha_packed_q3i_cls", cls)
        tq.encode_image_int8(setup["tqv"], x, CFG)
        assert calls == {"full": CFG.vision.layers - 1, "cls": 1}
        tq.encode_image_int8(setup["tqv"], x, CFG, cls_last="0")
        assert calls == {"full": 2 * CFG.vision.layers - 1, "cls": 1}
    assert fused_mha_packed_q3i.launches == 0 and fused_mha_packed_q3i_cls.launches == 0


@pytest.mark.parametrize("kw,env", [
    pytest.param({"gemm_impl": "hybrid"}, {}, id="gemm-hybrid"),
    pytest.param({"gemm_impl": "static3d_qi2"}, {}, id="gemm-qi2"),
    pytest.param({"cls_last": "kqs"}, {}, id="cls-kqs"),
    pytest.param({"cls_last": True}, {}, id="cls-attn"),
    pytest.param({}, {"TEAM_CLS_LAST": "mlp"}, id="env-cls-mlp"),
    pytest.param({}, {"TEAM_LN_MODE": "2pass"}, id="env-ln-2pass"),
    pytest.param({}, {"TEAM_GELU": "sigmoid"}, id="env-gelu-sigmoid"),
])
def test_unported_routes_raise(setup, kw, env, monkeypatch):
    """Every route, CLS mode and knob here is ported: each is held against
    team_tpu on the same payload to the tower bound; ``hybrid`` on the
    dynamic payload of ``quantize_vision_tower`` (its own), with team_tpu's
    ``quantize_rows`` jitted as in its runtime and ``attn_impl="xla"`` on both
    sides. team_tpu reads ``TEAM_LN_MODE`` into a module global when
    imported, so it is set there too."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if "TEAM_LN_MODE" in env:
        monkeypatch.setattr(jq, "_LN_MODE", env["TEAM_LN_MODE"])
    qv_j, qv_t, kw_t = setup["jqv"], setup["tqv"], dict(kw)
    if kw.get("gemm_impl") == "hybrid":
        monkeypatch.setattr(jq, "quantize_rows", jax.jit(jim.quantize_rows))
        qv_j = jax.jit(jq.quantize_vision_tower)(setup["jp"])
        qv_t, kw_t["attn_impl"] = params_from_numpy(_np(qv_j)), "xla"
    x = np.random.default_rng(7).standard_normal((6, SZ, SZ, 3)).astype(np.float32)
    want = np.asarray(jq.encode_image_int8(qv_j, jnp.asarray(x), JCFG, attn_impl="xla",
                                           interpret=True, **{"gemm_impl": "static3d_qi", **kw}),
                      np.float64)
    got = tq.encode_image_int8(qv_t, torch.from_numpy(x), CFG, **kw_t).double().numpy()
    cos = (want * got).sum(-1) / (np.linalg.norm(want, axis=-1) * np.linalg.norm(got, axis=-1))
    assert cos.min() >= 0.9999, cos
    assert np.abs(got - want).max() <= 5e-3 * np.sqrt((want ** 2).mean()) + 1e-6


# -- the runtime: calibrate, gate, commit, reuse ---------------------------

def _runtime(tp, **extras):
    cfg = Config(convnet_type="clip", device=["cpu"], compute_dtype="bfloat16",
                 encoder_quant="int8_static", extras={"tiny_backbone": True, **extras})
    return BackboneRuntime(cfg, params=tp)


@pytest.mark.parametrize("route", ["float", "u8", "patch"])
def test_runtime_calibrates_gates_commits_and_reuses(setup, route, tmp_path):
    batches = [_u8_images(8, seed) for seed in (10, 11, 12)]
    if route == "float":
        batches = [b.astype(np.float32) / 255.0 for b in batches]
    elif route == "patch":
        batches = [np.array(jax_patch_pixels(jnp.asarray(b), JCFG, compute_dtype=jnp.uint8))
                   for b in batches]
    rt = _runtime(setup["tp"], int8_cache_dir=str(tmp_path / "q"))
    first = rt.encode_image(torch.from_numpy(batches[0]))
    assert rt._qvision_pending is not None and not rt.int8_committed
    calib, ref = rt._calib_forward(torch.from_numpy(batches[0]))
    torch.testing.assert_close(first, ref, rtol=0, atol=0)  # the bf16 tower's features
    second = rt.encode_image(torch.from_numpy(batches[1]))
    assert rt.int8_committed and rt.gate_cosine >= 0.999 and rt.encoder_quant == "int8_static"
    assert rt._vision_f32 is None
    # the payload is the quantization of this run's own calibration stats
    want = tq.quantize_vision_tower_static(setup["tp"], calib, heads=CFG.vision.heads)
    torch.testing.assert_close(rt._qvision["blocks"][1]["qkv"]["qk_m2"],
                               want["blocks"][1]["qkv"]["qk_m2"], rtol=0, atol=0)
    torch.testing.assert_close(second, rt._encode_int8(rt._qvision, torch.from_numpy(batches[1])),
                               rtol=0, atol=0)
    third = rt.encode_image(torch.from_numpy(batches[2]))
    # a later runtime loads the saved payload and skips calibration
    rt2 = _runtime(setup["tp"], int8_cache_dir=str(tmp_path / "q"))
    torch.testing.assert_close(rt2.encode_image(torch.from_numpy(batches[2])), third,
                               rtol=0, atol=0)
    assert rt2.int8_committed and rt2.gate_cosine is None


def test_runtime_failed_gate_serves_bf16(setup, monkeypatch):
    import team_tpu_torch.learners.backbone_runtime as br

    monkeypatch.setattr(br, "GATE_MIN_COSINE", 1.5)  # no cosine passes
    rt = _runtime(setup["tp"])
    x = [torch.from_numpy(_u8_images(4, seed)) for seed in (20, 21, 22)]
    rt.encode_image(x[0])
    feats = rt.encode_image(x[1])
    assert not rt.int8_committed and rt.encoder_quant == "bf16" and rt.gate_cosine < 1.5
    torch.testing.assert_close(feats, rt._calib_forward(x[1])[1], rtol=0, atol=0)
    bf16 = _runtime(setup["tp"])
    bf16.encoder_quant = "bf16"
    torch.testing.assert_close(rt.encode_image(x[2]), bf16.encode_image(x[2]), rtol=0, atol=0)


def test_runtime_rejects_unported_tiers(setup):
    """``hybrid`` is ported: as in team_tpu, the runtime gates the static
    payload through its blocks, where the gate fails, and serves bf16
    (held against team_tpu's gate in tests/test_torch_int8_gemm.py). The
    encoder_quant="int8" tier of no route is still refused."""
    rt = _runtime(setup["tp"], int8_gemm_impl="hybrid")
    x = [torch.from_numpy(_u8_images(4, seed)) for seed in (30, 31)]
    rt.encode_image(x[0])
    feats = rt.encode_image(x[1])
    assert rt.int8_impl == "hybrid" and rt.gate_cosine < 0.999
    assert not rt.int8_committed and rt.encoder_quant == "bf16"
    torch.testing.assert_close(feats, rt._calib_forward(x[1])[1], rtol=0, atol=0)
    cfg = Config(convnet_type="clip", device=["cpu"], encoder_quant="int8",
                 extras={"tiny_backbone": True})
    with pytest.raises(NotImplementedError):
        BackboneRuntime(cfg, params=setup["tp"])
