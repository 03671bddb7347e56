"""The int8 tier's last static routes, CLS modes and knobs, and the dynamic
``xla`` tier, against team_tpu on the CPU.

The routes: ``static3d_qis`` (sequence-major), ``static3d_qib`` (flat batch,
``TEAM_FLAT_B``), ``static3d_qi2`` (the int8 PV), the CLS-last modes ``kqs``,
``mlp`` and ``attn`` of ``static3d_qi``, the knobs ``TEAM_QI_SOFTMAX``,
``TEAM_QI_ROWSUM``, ``TEAM_QI_DEFER``, ``TEAM_LN_MODE`` and ``TEAM_GELU``, and
``xla`` on the dynamic payload of ``quantize_vision_tower``. The JAX side runs
as tests/test_int8.py runs it (its Pallas kernels in interpret mode); both
sides get the same tiny CLIP init, the same payload and the same inputs,
made with numpy and carried across by the bridge. team_tpu reads
``TEAM_QI_SOFTMAX``, ``TEAM_QI_ROWSUM`` and ``TEAM_LN_MODE`` into module
globals when it is imported, and its jitted kernels keep their first trace,
so the ``knobs`` fixture sets the globals and clears JAX's caches; the port
reads the environment at each call. Tolerances:
- ``quantize_rows``, the dynamic payload: bit for bit against jitted JAX;
- ``int8_linear_xla``: one bf16 step (the exact GELU's last bit may differ);
- tower features on the same payload: cosine >= 0.9999 and max |Δ| <=
  5e-3·rms, the bound of tests/test_torch_int8.py;
- the ``xla`` runtime's held-out gate: within 2e-3 of team_tpu's (both
  fail on the static payload, as team_tpu's does, and serve bf16);
- trainer curves on ``static3d_qis`` and ``kqs``: within 0.1 pp, with
  ``attention_impl="xla"`` on both sides, so that both calibrate through the
  same attention arithmetic (on ``auto`` the port's packed plain version
  rounds the scaled q at the tiny tower's dh=32, team_tpu's CPU route does
  not: ROADMAP fault 3.10)."""

import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import team_tpu.backbone.quant as jq
import team_tpu.ops.int8_matmul as jim
import team_tpu.ops.mha_short as jmha
import team_tpu_torch.backbone.quant as tq
from team_tpu.backbone.clip import CLIPConfig as JCLIPConfig
from team_tpu.backbone.clip import init_clip_params as jax_init
from team_tpu.backbone.clip import patch_pixels as jax_patch_pixels
from team_tpu_torch.backbone.clip import CLIPConfig
from team_tpu_torch.bridge import params_from_numpy
from team_tpu_torch.config import Config
from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
from team_tpu_torch.ops import int8_matmul as tim

JCFG, CFG = JCLIPConfig.tiny(), CLIPConfig.tiny()
SZ = CFG.vision.image_size
LAYERS = CFG.vision.layers


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """The JAX init and calibration on a float batch, the JAX static and
    dynamic payloads, and all carried across."""
    rng = np.random.default_rng(0)
    jp = jax_init(jax.random.PRNGKey(0), JCFG)
    imgs = rng.standard_normal((8, SZ, SZ, 3)).astype(np.float32)
    jstats = jq.calibrate_vision_tower(jp, jnp.asarray(imgs), JCFG, attn_impl="xla")
    jqv = jq.quantize_vision_tower_static(jp, jstats, heads=JCFG.vision.heads)
    jdyn = jax.jit(jq.quantize_vision_tower)(jp)
    return {"jp": jp, "tp": params_from_numpy(_np(jp)), "jqv": jqv,
            "tqv": params_from_numpy(_np(jqv)), "jdyn": jdyn, "tdyn": params_from_numpy(_np(jdyn))}


@pytest.fixture
def knobs(monkeypatch):
    """``set(env)``: the knobs on both sides (team_tpu's module globals where
    it keeps them). The attention knobs are read when team_tpu's jitted
    kernels are traced, so JAX's caches are cleared around a case that sets
    one of them."""
    globals_of = {"TEAM_QI_SOFTMAX": (jmha, "_QI_SOFTMAX"), "TEAM_QI_ROWSUM": (jmha, "_QI_ROWSUM"),
                  "TEAM_LN_MODE": (jq, "_LN_MODE")}
    traced = []

    def set_knobs(env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
            if k in globals_of:
                monkeypatch.setattr(*globals_of[k], v)
        if {"TEAM_QI_SOFTMAX", "TEAM_QI_ROWSUM"} & set(env):
            traced.append(True)
            jax.clear_caches()

    yield set_knobs
    monkeypatch.undo()
    if traced:
        jax.clear_caches()


def _assert_tower_close(want, got):
    assert got.shape == want.shape == (len(want), CFG.embed_dim)
    cos = (want * got).sum(-1) / (np.linalg.norm(want, axis=-1) * np.linalg.norm(got, axis=-1))
    assert cos.min() >= 0.9999, cos
    assert np.abs(got - want).max() <= 5e-3 * np.sqrt((want ** 2).mean()) + 1e-6


def _u8_images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, SZ, SZ, 3)).astype(np.uint8)


def _features(qv_j, qv_t, ingest="float", seed=5, **kw):
    """(JAX, port) tower features on held-out data, ``kw`` to both encoders."""
    kw_j = dict(attn_impl="xla", interpret=True, **kw)
    kw_t = dict(attn_impl="xla", **kw)
    if ingest == "float":
        x = np.random.default_rng(seed).standard_normal((6, SZ, SZ, 3)).astype(np.float32)
        encode_j, encode_t = jq.encode_image_int8, tq.encode_image_int8
    elif ingest == "u8":
        x = _u8_images(6, seed)
        encode_j, encode_t = jq.encode_image_int8_u8, tq.encode_image_int8_u8
    else:
        x = np.array(jax_patch_pixels(jnp.asarray(_u8_images(6, seed)), JCFG,
                                      compute_dtype=jnp.uint8))
        encode_j, encode_t = jq.encode_image_int8_patches, tq.encode_image_int8_patches
        kw_j["patch_dot"] = kw_t["patch_dot"] = "int8"

    want = encode_j(qv_j, jnp.asarray(x), JCFG, **kw_j)
    got = encode_t(qv_t, torch.from_numpy(x), CFG, **kw_t)
    return np.asarray(want, np.float64), got.double().numpy()


# -- the xla tier's pieces ----------------------------------------------------

def test_quantize_rows_is_bit_equal_to_jitted_jax():
    x = (np.random.default_rng(1).standard_normal((37, 96)) * 3).astype(np.float32)
    x[5] = 0.0  # a zero row gets scale 1
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wq, ws = jax.jit(jim.quantize_rows)(xb)
    got_q, got_s = tim.quantize_rows(torch.from_numpy(x).to(torch.bfloat16))
    assert got_q.dtype == torch.int8 and got_s.shape == (37, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ws))


@pytest.mark.parametrize("activation", [None, "gelu"])
def test_int8_linear_xla_matches_jitted_jax(activation):
    rng = np.random.default_rng(2)
    xq = rng.integers(-127, 128, (21, 64)).astype(np.int8)
    wq = rng.integers(-127, 128, (64, 40)).astype(np.int8)
    xs = rng.uniform(1e-3, 1e-2, (21, 1)).astype(np.float32)
    ws = rng.uniform(1e-3, 1e-2, (1, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    want = jax.jit(lambda *a: jim.int8_linear_xla(*a, activation=activation))(
        *(jnp.asarray(t) for t in (xq, wq, xs, ws, b)))
    got = tim.int8_linear_xla(*(torch.from_numpy(t) for t in (xq, wq, xs, ws, b)),
                              activation=activation)
    assert got.dtype == torch.bfloat16 and got.shape == (21, 40)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_dynamic_payload_is_bit_equal_to_jitted_jax(setup):
    got = tq.quantize_vision_tower(setup["tp"])
    want = _np(setup["jdyn"])

    def walk(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        else:
            np.testing.assert_array_equal(b.numpy(), a, err_msg=path)
            assert b.numpy().dtype == a.dtype, path

    walk(want, got, "")


def test_ln_quant_rows_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((9, 64)) * 2 + 0.3).astype(np.float32)
    ln = {"scale": rng.uniform(0.5, 1.5, 64).astype(np.float32),
          "bias": rng.uniform(-0.2, 0.2, 64).astype(np.float32)}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wq, ws = jax.jit(jq._ln_quant_jnp)(xb, jnp.asarray(ln["scale"]), jnp.asarray(ln["bias"]))
    got_q, got_s = tq._ln_quant_rows(torch.from_numpy(x).to(torch.bfloat16), params_from_numpy(ln))
    diff = np.abs(got_q.numpy().astype(np.int32) - np.asarray(wq, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ws), rtol=1e-6)


@pytest.mark.parametrize("ingest", ["float", "u8", "patch"])
def test_xla_tier_features_match_jax(setup, ingest, monkeypatch):
    """team_tpu's tower runs eagerly here (jitted whole, XLA on the CPU would
    skip its bf16 roundings), but its ``quantize_rows`` jitted, as it is in
    team_tpu's runtime: XLA then compiles ``amax / 127.0`` to a product with
    f32(1/127), the port's arithmetic (eager JAX divides, which moves a
    scale by an ulp and can flip an int8 step)."""
    monkeypatch.setattr(jq, "quantize_rows", jax.jit(jim.quantize_rows))
    _assert_tower_close(*_features(setup["jdyn"], setup["tdyn"], ingest, gemm_impl="xla"))


# -- the static routes, CLS modes and knobs through the tower ----------------

# (gemm_impl, cls_last, knobs)
ROUTE_CASES = [
    pytest.param("static3d_qis", None, {}, id="qis"),
    pytest.param("static3d_qis", "attn", {"TEAM_LN_MODE": "2pass"}, id="qis-ignores-cls-2pass"),
    pytest.param("static3d_qib", None, {}, id="qib-flat1"),
    pytest.param("static3d_qib", "attn", {"TEAM_FLAT_B": "3"}, id="qib-flat3-last-kq"),
    pytest.param("static3d_qib", None, {"TEAM_FLAT_B": "2", "TEAM_QI_ROWSUM": "reduce",
                                        "TEAM_QI_DEFER": "1"}, id="qib-flat2-reduce-defer"),
    pytest.param("static3d_qi2", None, {}, id="qi2"),
    pytest.param("static3d_qi2", "kq", {"TEAM_QI_DEFER": "1", "TEAM_QI_SOFTMAX": "f32"},
                 id="qi2-defer-f32"),
    pytest.param("static3d_qi", "kqs", {}, id="kqs"),
    pytest.param("static3d_qi", "kqs", {"TEAM_QI_SOFTMAX": "exp2i"}, id="kqs-exp2i"),
    pytest.param("static3d_qi", "mlp", {"TEAM_QI_ROWSUM": "reduce", "TEAM_QI_DEFER": "1"},
                 id="mlp-reduce-defer"),
    pytest.param("static3d_qi", True, {"TEAM_QI_SOFTMAX": "exp2i"}, id="attn-true-exp2i"),
    pytest.param("static3d_qi", "kq", {"TEAM_QI_SOFTMAX": "exp2i"}, id="kq-exp2i"),
    pytest.param("static3d_qi", "0", {"TEAM_QI_ROWSUM": "reduce"}, id="full-reduce"),
    pytest.param("static3d_qi", "kq", {"TEAM_QI_ROWSUM": "reduce", "TEAM_QI_DEFER": "1"},
                 id="kq-reduce-defer"),
    pytest.param("static3d_qi", "kq", {"TEAM_GELU": "none"}, id="gelu-none"),
]


@pytest.mark.parametrize("route,cls_last,env", ROUTE_CASES)
def test_route_features_match_jax(setup, knobs, route, cls_last, env):
    knobs(env)
    _assert_tower_close(*_features(setup["jqv"], setup["tqv"], gemm_impl=route, cls_last=cls_last))


@pytest.mark.parametrize("route,cls_last", [("static3d_qis", None), ("static3d_qi", "kqs")])
@pytest.mark.parametrize("ingest", ["u8", "patch"])
def test_route_features_match_jax_on_uint8_ingest(setup, route, cls_last, ingest):
    _assert_tower_close(*_features(setup["jqv"], setup["tqv"], ingest, gemm_impl=route,
                                   cls_last=cls_last))


COUNTED = ("fused_mha_packed_q3i_tp", "fused_mha_packed_q3i_cls", "fused_mha_packed_q3i_cls_split",
           "fused_mha_packed_q3i_sb", "_cls_attn_q3i", "attention_core")


# (gemm_impl, cls_last, knobs, calls per encode of each COUNTED function, and
#  the keyword arguments every full-kernel call gets)
STRUCTURE = [
    pytest.param("static3d_qis", "kqs", {}, (0, 0, 0, LAYERS, 0, 0), {}, id="qis"),
    pytest.param("static3d_qib", None, {"TEAM_CLS_LAST": "kqs", "TEAM_QI_DEFER": "1"},
                 (LAYERS - 1, 1, 0, 0, 0, 0), {"defer_norm": True}, id="qib"),
    pytest.param("static3d_qi2", "kq", {}, (LAYERS, 0, 0, 0, 0, 0), {"pv_int8": True}, id="qi2"),
    pytest.param("static3d_qi", "kqs", {}, (LAYERS - 1, 0, 1, 0, 0, 0), {"pv_int8": False},
                 id="kqs"),
    pytest.param("static3d_qi", "mlp", {"TEAM_QI_DEFER": "1"}, (LAYERS, 0, 0, 0, 0, 0),
                 {"defer_norm": True}, id="mlp"),
    pytest.param("static3d_qi", "attn", {}, (LAYERS - 1, 0, 0, 0, 1, 0), {}, id="attn"),
    pytest.param("xla", "kq", {}, (0, 0, 0, 0, 0, LAYERS), {}, id="xla"),
]


@pytest.mark.parametrize("route,cls_last,env,per_encode,full_kw", STRUCTURE)
def test_route_calls_its_attention_in_every_block(setup, monkeypatch, route, cls_last, env,
                                                  per_encode, full_kw):
    """On the CPU nothing is launched; the calls are counted by wrapping the
    functions that ``quant`` calls. ``static3d_qib``'s last block is ``kq``
    whatever ``TEAM_CLS_LAST`` says; ``static3d_qi2``, ``static3d_qis`` and
    ``xla`` have no CLS-last block; ``kqs`` projects q for the CLS row only."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = dict.fromkeys(COUNTED, 0)
    seen_kw = []

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            if name == "fused_mha_packed_q3i_tp":
                seen_kw.append(k)
            return fn(*a, **k)
        return wrapped

    rows = []
    linear = tq._static_linear3

    def recording_linear(q3, site, *a, **k):
        rows.append(q3.shape[:-1])
        return linear(q3, site, *a, **k)

    with pytest.MonkeyPatch.context() as m:
        for name in COUNTED:
            m.setattr(tq, name, counting(name, getattr(tq, name)))
        m.setattr(tq, "_static_linear3", recording_linear)
        qv = setup["tdyn"] if route == "xla" else setup["tqv"]
        x = torch.from_numpy(np.random.default_rng(9).standard_normal((4, SZ, SZ, 3))
                             .astype(np.float32))
        tq.encode_image_int8(qv, x, CFG, gemm_impl=route, cls_last=cls_last)
    assert tuple(calls[n] for n in COUNTED) == per_encode
    assert all(all(k.get(key, False) == v for key, v in full_kw.items()) for k in seen_kw)
    if cls_last == "kqs" and route == "static3d_qi":
        assert (4, 1) in rows  # the q projection of the CLS rows
