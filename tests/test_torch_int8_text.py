"""The int8 text tower (``encode_text_int8``, its payloads and calibration)
against team_tpu on the CPU.

Both sides get the same tiny CLIP init and the same tokens (team_tpu's
tokenizer, carried across as numpy). The JAX side runs its Pallas kernels in
interpret mode and its ``quantize_rows`` jitted, as in its runtime. Tolerances:
- calibration stats within 2^-5 relative: two bf16 steps, since a step of
  block 0's exact-GELU output (erf from another library) carries into the
  next block's activations;
- payloads from the same stats: bit for bit;
- features on every route of the tower's block table, on the same payload:
  cosine >= 0.9999 and max |Δ| <= 5e-3·rms, the image tower's bound;
- the prompt-set payload each side calibrates itself (team_tpu under
  ``jax.jit``, where XLA keeps the bf16 intermediates in f32, so a scale may
  differ by a rounding step): cosine >= 0.999 against team_tpu's features and
  against the port's own bf16 text tower, the gate of the static tier."""

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
from team_tpu.backbone.tokenizer import Tokenizer
from team_tpu_torch.backbone.clip import CLIPConfig, encode_text
from team_tpu_torch.bridge import params_from_numpy

JCFG, CFG = JCLIPConfig.tiny(), CLIPConfig.tiny()
DYNAMIC = ["xla", "hybrid", "pallas"]
STATIC = ["static", "static_qa", "static3d", "static3d_qa", "static3d_qaf", "static3d_qi",
          "static3d_qi2"]
PROMPTS = ["a photo of a beetle, a type of insect", "a photo of a moth larva",
           "an adult dragonfly", "a photo of a ladybird pupa"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def setup():
    """The JAX init, the prompt tokens, team_tpu's dynamic and prompt-set text
    payloads (both jitted, as team_tpu builds them), and all carried across."""
    jp = jax_init(jax.random.PRNGKey(0), JCFG)
    toks = np.asarray(Tokenizer()(PROMPTS))
    jdyn = jax.jit(jq.quantize_text_tower)(jp)
    jst = jq.quantize_text_tower_for_prompts(jp, jnp.asarray(toks), JCFG, attn_impl="xla",
                                             heads=JCFG.text.heads)
    return {"jp": jp, "tp": params_from_numpy(_np(jp)), "toks": toks, "jdyn": jdyn,
            "tdyn": params_from_numpy(_np(jdyn)), "jst": jst, "tst": params_from_numpy(_np(jst))}


def test_calibrate_text_tower_matches_jax(setup):
    jstats = _np(jq.calibrate_text_tower(setup["jp"], jnp.asarray(setup["toks"]), JCFG,
                                         attn_impl="xla"))
    tstats = tq.calibrate_text_tower(setup["tp"], torch.from_numpy(setup["toks"]), CFG,
                                     attn_impl="xla")
    assert len(tstats) == len(jstats) == CFG.text.layers
    for jb, tb in zip(jstats, tstats):
        assert set(jb) == set(tb)
        for key in jb:
            np.testing.assert_allclose(tb[key].numpy(), jb[key], rtol=2 ** -5, atol=0, err_msg=key)


def _walk_equal(want, got, path=""):
    if isinstance(want, dict):
        assert set(want) == set(got), (path, set(want) ^ set(got))
        for k in want:
            _walk_equal(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            _walk_equal(a, b, f"{path}[{i}]")
    else:
        assert got.numpy().dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)


def test_text_payloads_are_bit_equal_to_jax(setup):
    _walk_equal(_np(setup["jdyn"]), tq.quantize_text_tower(setup["tp"]))
    jstats = jq.calibrate_text_tower(setup["jp"], jnp.asarray(setup["toks"]), JCFG,
                                     attn_impl="xla")
    want = jq.quantize_text_tower_static(setup["jp"], jstats, margin=1.0, heads=JCFG.text.heads)
    got = tq.quantize_text_tower_static(setup["tp"], params_from_numpy(_np(jstats)), margin=1.0,
                                        heads=CFG.text.heads)
    _walk_equal(_np(want), got)


@pytest.mark.parametrize("route", DYNAMIC + STATIC)
def test_encode_text_int8_routes_match_jax(setup, route, monkeypatch):
    monkeypatch.setattr(jq, "quantize_rows", jax.jit(jim.quantize_rows))
    qj, qt = (setup["jdyn"], setup["tdyn"]) if route in DYNAMIC else (setup["jst"], setup["tst"])
    toks = setup["toks"]
    want = np.asarray(jq.encode_text_int8(qj, jnp.asarray(toks), JCFG, attn_impl="xla",
                                          gemm_impl=route, interpret=True), np.float64)
    got = tq.encode_text_int8(qt, torch.from_numpy(toks), CFG, attn_impl="xla",
                              gemm_impl=route).double().numpy()
    assert got.shape == want.shape == (len(PROMPTS), CFG.text.embed_dim)
    assert _cos(want, got).min() >= 0.9999, _cos(want, got)
    assert np.abs(got - want).max() <= 5e-3 * np.sqrt((want ** 2).mean()) + 1e-6


def test_prompt_set_payload_clears_the_gate_and_follows_jax(setup):
    """The port's own prompt-set payload on the default static route."""
    toks = torch.from_numpy(setup["toks"])
    tst = tq.quantize_text_tower_for_prompts(setup["tp"], toks, CFG, attn_impl="xla",
                                             heads=CFG.text.heads)
    got = tq.encode_text_int8(tst, toks, CFG, attn_impl="xla",
                              gemm_impl="static3d_qi").double().numpy()
    want = np.asarray(jq.encode_text_int8(setup["jst"], jnp.asarray(setup["toks"]), JCFG,
                                          attn_impl="xla", gemm_impl="static3d_qi",
                                          interpret=True), np.float64)
    bf16 = encode_text(setup["tp"], toks, CFG, compute_dtype=torch.bfloat16,
                       attn_impl="xla").double().numpy()
    assert _cos(want, got).min() >= 0.999, _cos(want, got)
    assert _cos(bf16, got).min() >= 0.999, _cos(bf16, got)


@pytest.mark.parametrize("route", ["static3d_qis", "static3d_qib", "nope"])
def test_encode_text_int8_rejects_routes_outside_its_table(setup, route):
    """team_tpu's table (``quant.py:1010-1019``) has no sequence-major or
    flat-batch route: it raises a KeyError there, the port a ValueError."""
    with pytest.raises(KeyError):
        jq.encode_text_int8(setup["jdyn"], jnp.asarray(setup["toks"]), JCFG, gemm_impl=route)
    with pytest.raises(ValueError, match="gemm_impl"):
        tq.encode_text_int8(setup["tdyn"], torch.from_numpy(setup["toks"]), CFG, gemm_impl=route)
