"""The dynamic int8 tiers ``hybrid`` and ``pallas`` and their kernels' plain
versions, against team_tpu on the CPU.

The kernels: the int8 GEMM (``int8_linear`` and its TPU tilings ``_nk``,
``_kgrid``, ``_wres``, ``_dma``; ``quantized_linear``), its GELU-and-requantize
form (``int8_linear_gelu_quant``), the block-scale consumer
(``int8_linear_blockscale``), the layer norm to dynamic int8
(``ln_quantize``) and the 3-D static producer (``ln_quantize_static3``). The
JAX side runs its Pallas kernels in interpret mode, as tests/test_int8.py
does; inputs are made with numpy from a seed and carried across. team_tpu's
``quantize_rows`` and ``quantize_weight`` run jitted, as in its runtime: XLA
then compiles ``amax / 127.0`` to a product with f32(1/127), the port's
arithmetic. Tolerances:
- GEMMs with a float32 output: 1e-6 of the output's largest magnitude (both
  sides round each product and sum in the same order; XLA may fuse one
  multiply-add); bfloat16: one bf16 step (2^-7 relative); with the tanh GELU
  1e-5 (tanh from another library);
- ``gelu_quant`` and ``ln_quantize``: scales within 1e-6 relative, int8 at
  most one step apart on under 1 % of the outputs (a value at a rounding
  edge); ``blockscale`` on the same block-scale input: 1e-5 relative;
- ``ln_quantize_static3``: bit for bit ``ln_quantize_static`` on the
  ``[B*S, D]`` view;
- the towers on the dynamic payload: cosine >= 0.9999 and max |Δ| <=
  5e-3·rms, the bound of tests/test_torch_int8.py;
- the runtime's held-out gate on the static payload: within 2e-3 of
  team_tpu's and the same decision (both fail there and serve bf16, as the
  ``xla`` tier does in tests/test_torch_int8_runtime.py)."""

import functools
import logging
import re

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
from team_tpu_torch.backbone.clip import CLIPConfig
from team_tpu_torch.bridge import params_from_numpy
from team_tpu_torch.config import Config
from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
from team_tpu_torch.ops import int8_matmul as tim

JCFG, CFG = JCLIPConfig.tiny(), CLIPConfig.tiny()
SZ = CFG.vision.image_size
LAYERS = CFG.vision.layers
BF16_STEP = 2.0 ** -7
TIERS = ["hybrid", "pallas"]
# team_tpu's kernels of the two tiers, which its blocks call without interpret
JAX_TIER_KERNELS = ("ln_quantize", "int8_linear", "int8_linear_gelu_quant",
                    "int8_linear_blockscale")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def assert_within_one_step(got, want):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.01, (diff > 0).mean()


def _gemm_inputs(m, k, n, seed):
    """Row-quantized activations, a quantized weight and a bias, as JAX arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    xq, xs = jax.jit(jim.quantize_rows)(jnp.asarray(x))
    wq, ws = jax.jit(jim.quantize_weight)(jnp.asarray(w))
    return xq, wq, xs, ws, jnp.asarray(b)


def _assert_close(got, want, activation, out_dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    if out_dtype == "bf16":
        assert (err <= BF16_STEP * np.abs(want) + 1e-30).all(), err.max()
    elif activation == "gelu":
        assert err.max() <= 1e-5, err.max()
    else:
        assert err.max() <= 1e-6 * np.abs(want).max(), err.max()


# the five entries of the one kernel: name -> (JAX call, port call), weight [K, N]
ENTRIES = {
    "int8_linear": (lambda xq, wq, *a, **k: jim.int8_linear(xq, wq, *a, block_m=16, block_n=32, **k),
                    lambda xq, wq, *a, **k: tim.int8_linear(xq, wq, *a, block_m=16, **k)),
    "nk": (lambda xq, wq, *a, **k: jim.int8_linear_nk(xq, jnp.asarray(np.asarray(wq).T), *a,
                                                      block_m=16, block_n=32, **k),
           lambda xq, wq, *a, **k: tim.int8_linear_nk(xq, wq.t().contiguous(), *a, **k)),
    "kgrid": (lambda *a, **k: jim.int8_linear_kgrid(*a, block_m=16, block_n=32, block_k=32, **k),
              lambda *a, **k: tim.int8_linear_kgrid(*a, block_k=32, **k)),
    "wres": (lambda *a, **k: jim.int8_linear_wres(*a, block_m=8, n_split=2, **k),
             lambda *a, **k: tim.int8_linear_wres(*a, n_split=2, **k)),
    "dma": (lambda *a, **k: jim.int8_linear_dma(*a, block_m=8, **k),
            lambda *a, **k: tim.int8_linear_dma(*a, **k)),
}


@pytest.mark.parametrize("activation,out_dtype", [(None, "f32"), (None, "bf16"), ("gelu", "f32")])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_int8_linear_entries_match_jax(entry, activation, out_dtype):
    xq, wq, xs, ws, b = _gemm_inputs(40, 64, 96, seed=1)
    jdt, tdt = (jnp.float32, torch.float32) if out_dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jax_call, port_call = ENTRIES[entry]
    want = jax_call(xq, wq, xs, ws, b, activation=activation, out_dtype=jdt, interpret=True)
    got = port_call(_t(xq), _t(wq), _t(xs), _t(ws), _t(b), activation=activation, out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (40, 96)
    _assert_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), activation, out_dtype)


def test_int8_linear_without_bias_and_quantized_linear_match_jax():
    xq, wq, xs, ws, _ = _gemm_inputs(33, 128, 64, seed=2)
    want = jim.int8_linear(xq, wq, xs, ws, None, out_dtype=jnp.float32, interpret=True)
    got = tim.int8_linear(_t(xq), _t(wq), _t(xs), _t(ws), out_dtype=torch.float32)
    _assert_close(got.numpy(), want, None, "f32")
    x = np.random.default_rng(3).standard_normal((33, 128)).astype(np.float32)
    want = jax.jit(functools.partial(jim.quantized_linear, activation="gelu",
                                     out_dtype=jnp.float32, interpret=True))(jnp.asarray(x), wq, ws)
    got = tim.quantized_linear(torch.from_numpy(x), _t(wq), _t(ws), activation="gelu",
                               out_dtype=torch.float32)
    _assert_close(got.numpy(), want, "gelu", "f32")


@pytest.mark.parametrize("m,k,n,block_n,bn", [(40, 64, 128, 32, 32), (45, 64, 1024, 512, 512),
                                              (70, 96, 768, 256, 256), (48, 64, 384, 128, 128)],
                         ids=["block_n32", "default-two-blocks", "bn256-three-blocks",
                              "bk128-three-blocks"])
def test_gelu_quant_and_blockscale_match_jax(m, k, n, block_n, bn):
    """``int8_linear_gelu_quant`` at the caller's ``block_n=32``, at the
    default with N=1024 (two scale blocks of 512), at ``block_n=256`` with
    N=768 and K=96 (three blocks of 256; on the card ``bn`` 256 and 512 take
    the wgmma kernel, other widths the mma.sync one) and at ``block_n=128``
    with N=384, and ``int8_linear_blockscale`` fed by its output (team_tpu's,
    on both sides): K blocks of 32, 512, 256 and 128 (three blocks of 128,
    the smallest the blockscale wgmma kernel takes on the card)."""
    xq, wq, xs, ws, b = _gemm_inputs(m, k, n, seed=4)
    jkw = dict(block_m=32, block_n=block_n, interpret=True)
    gq, gs = jim.int8_linear_gelu_quant(xq, wq, xs, ws, b, **jkw)
    tq_, ts = tim.int8_linear_gelu_quant(_t(xq), _t(wq), _t(xs), _t(ws), _t(b), block_n=block_n)
    assert tq_.dtype == torch.int8 and tq_.shape == (m, n) and ts.shape == (n // bn, m)
    assert tim._pick_block_n(n, block_n) == bn
    np.testing.assert_allclose(ts.numpy(), np.asarray(gs), rtol=1e-6, atol=0)
    assert_within_one_step(tq_.numpy(), gq)
    rng = np.random.default_rng(5)
    w2q, w2s = jax.jit(jim.quantize_weight)(jnp.asarray(rng.standard_normal((n, 96)).astype(np.float32)))
    b2 = jnp.asarray(rng.standard_normal(96).astype(np.float32) * 0.1)
    want = np.asarray(jim.int8_linear_blockscale(gq, w2q, gs, w2s, b2, out_dtype=jnp.float32, **jkw))
    got = tim.int8_linear_blockscale(_t(gq), _t(w2q), _t(gs), _t(w2s), _t(b2),
                                     out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_ln_quantize_matches_jax():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((45, 64)) * 2).astype(np.float32)
    x[7] = 0.0  # the row becomes beta
    g = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    q, s = jim.ln_quantize(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), block_m=32,
                           interpret=True)
    tq_, ts = tim.ln_quantize(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
    assert tq_.dtype == torch.int8 and ts.shape == (1, 45)
    np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=1e-6, atol=0)
    assert_within_one_step(tq_.numpy(), q)


def test_ln_quantize_static3_is_the_2d_producer_on_the_flat_view():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 37, 64)) * rng.uniform(0.5, 3, (4, 37, 1))).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    g, b = (torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32)) for _ in range(2))
    inv_a = torch.from_numpy(rng.uniform(10, 60, (1, 64)).astype(np.float32))
    got = tim.ln_quantize_static3(xb, g, b, inv_a, group=2)
    assert got.shape == (4, 37, 64) and got.dtype == torch.int8
    torch.testing.assert_close(got.reshape(-1, 64), tim.ln_quantize_static(xb.reshape(-1, 64), g, b,
                                                                           inv_a), rtol=0, atol=0)
    want = jim.ln_quantize_static3(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(g.numpy()),
                                   jnp.asarray(b.numpy()), jnp.asarray(inv_a.numpy()), group=2,
                                   interpret=True)
    assert_within_one_step(got.numpy(), want)


def test_wrappers_on_cpu_are_the_plain_versions_and_count_nothing():
    xq, wq, xs, ws, b = _gemm_inputs(24, 64, 128, seed=8)
    args = (_t(xq), _t(wq), _t(xs), _t(ws), _t(b))
    tim.reset_launch_counts()
    torch.testing.assert_close(tim.int8_linear(*args), tim.int8_linear_reference(*args),
                               rtol=0, atol=0)
    gq, gs = tim.int8_linear_gelu_quant(*args, block_n=64)
    for got, want in zip((gq, gs), tim.int8_linear_gelu_quant_reference(*args, block_n=64)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for got, want in zip(tim.int8_linear_gelu_quant_mma(*args, block_n=64), (gq, gs)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for kw in ({}, {"activation": "gelu", "out_dtype": torch.float32}):
        torch.testing.assert_close(tim.int8_linear_mma(*args, **kw),
                                   tim.int8_linear_reference(*args, **kw), rtol=0, atol=0)
    _, w2q, _, w2s, b2 = (_t(a) for a in _gemm_inputs(8, 128, 32, seed=9))
    for kw in ({}, {"out_dtype": torch.float32}):
        want = tim.int8_linear_blockscale_reference(gq, w2q, gs, w2s, b2, **kw)
        torch.testing.assert_close(tim.int8_linear_blockscale(gq, w2q, gs, w2s, b2, **kw), want,
                                   rtol=0, atol=0)
        torch.testing.assert_close(tim.int8_linear_blockscale_mma(gq, w2q, gs, w2s, b2, **kw),
                                   want, rtol=0, atol=0)
    x = torch.randn(24, 64, generator=torch.Generator().manual_seed(0))
    for got, want in zip(tim.ln_quantize(x, args[4][:64], args[4][64:]),
                         tim.ln_quantize_reference(x, args[4][:64], args[4][64:])):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert all(fn.launches == 0 for fn in tim._COUNTED)


@pytest.mark.parametrize("call,exc", [
    (lambda: tim.int8_linear_blockscale(torch.zeros(4, 96, dtype=torch.int8),
                                        torch.zeros(96, 8, dtype=torch.int8), torch.ones(5, 4),
                                        torch.ones(1, 8)), ValueError),
    (lambda: tim.ln_quantize(torch.zeros(4, 8), torch.ones(7), torch.zeros(8)), ValueError),
    (lambda: tim.ln_quantize_static3(torch.zeros(4, 8), torch.ones(8), torch.zeros(8),
                                     torch.ones(1, 8)), ValueError),
], ids=["blockscale-blocks-do-not-divide-k", "ln_quantize-gamma-width", "static3-needs-3d"])
def test_wrappers_reject_bad_input(call, exc):
    with pytest.raises(exc):
        call()


# -- the tiers through the tower ---------------------------------------------

@pytest.fixture(scope="module")
def setup():
    """The JAX init, its dynamic payload (jitted, as in team_tpu's runtime) and
    both carried across."""
    jp = jax_init(jax.random.PRNGKey(0), JCFG)
    jdyn = jax.jit(jq.quantize_vision_tower)(jp)
    return {"tp": params_from_numpy(_np(jp)), "jdyn": jdyn, "tdyn": params_from_numpy(_np(jdyn))}


def _u8_images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, SZ, SZ, 3)).astype(np.uint8)


@pytest.mark.parametrize("ingest", ["float", "u8", "patch"])
@pytest.mark.parametrize("tier", TIERS)
def test_tier_features_match_jax(setup, tier, ingest, monkeypatch):
    monkeypatch.setattr(jq, "quantize_rows", jax.jit(jim.quantize_rows))
    kw_j = dict(attn_impl="xla", interpret=True, gemm_impl=tier)
    kw_t = dict(attn_impl="xla", gemm_impl=tier)
    if ingest == "float":
        x = np.random.default_rng(5).standard_normal((6, SZ, SZ, 3)).astype(np.float32)
        encode_j, encode_t = jq.encode_image_int8, tq.encode_image_int8
    elif ingest == "u8":
        x = _u8_images(6, 5)
        encode_j, encode_t = jq.encode_image_int8_u8, tq.encode_image_int8_u8
    else:
        x = np.array(jax_patch_pixels(jnp.asarray(_u8_images(6, 5)), JCFG, compute_dtype=jnp.uint8))
        encode_j, encode_t = jq.encode_image_int8_patches, tq.encode_image_int8_patches
    want = np.asarray(encode_j(setup["jdyn"], jnp.asarray(x), JCFG, **kw_j), np.float64)
    got = encode_t(setup["tdyn"], torch.from_numpy(x), CFG, **kw_t).double().numpy()
    assert got.shape == want.shape == (6, CFG.embed_dim)
    cos = (want * got).sum(-1) / (np.linalg.norm(want, axis=-1) * np.linalg.norm(got, axis=-1))
    assert cos.min() >= 0.9999, cos
    assert np.abs(got - want).max() <= 5e-3 * np.sqrt((want ** 2).mean()) + 1e-6


# each wrapper's calls per block: ln_quantize, int8_linear, int8_linear_gelu_quant,
# int8_linear_blockscale, int8_linear_xla, quantize_rows
PER_BLOCK = {"hybrid": (2, 0, 1, 1, 2, 1), "pallas": (2, 2, 1, 1, 0, 1)}
COUNTED = ("ln_quantize", "int8_linear", "int8_linear_gelu_quant", "int8_linear_blockscale",
           "int8_linear_xla", "quantize_rows")


@pytest.mark.parametrize("tier", TIERS)
def test_tier_calls_its_kernels_in_every_block(setup, tier, monkeypatch):
    """The block structure, counted by wrapping the functions ``quant`` calls
    (on the CPU nothing launches); the attention takes ``attn_impl``."""
    calls = dict.fromkeys(COUNTED, 0)
    seen = []

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in COUNTED:
        monkeypatch.setattr(tq, name, counting(name, getattr(tq, name)))
    attention = tq.attention_core
    monkeypatch.setattr(tq, "attention_core", lambda *a, **k: seen.append(k["impl"]) or
                        attention(*a, **k))
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, SZ, SZ, 3)).astype(np.float32))
    tim.reset_launch_counts()
    tq.encode_image_int8(setup["tdyn"], x, CFG, gemm_impl=tier, attn_impl="xla")
    assert [calls[n] for n in COUNTED] == [LAYERS * c for c in PER_BLOCK[tier]]
    assert seen == ["xla"] * LAYERS
    assert all(fn.launches == 0 for fn in tim._COUNTED)


# -- the runtime: the gate on the static payload -------------------------------

@pytest.fixture
def jax_tier_interpret(monkeypatch):
    """team_tpu's kernels of the two tiers in interpret mode (the CPU takes no
    compiled Pallas), under the names its blocks call them by."""
    for name in JAX_TIER_KERNELS:
        fn = getattr(jq, name)
        monkeypatch.setattr(jq, name, lambda *a, _fn=fn, interpret=False, **k:
                            _fn(*a, interpret=True, **k))


@pytest.mark.parametrize("tier", TIERS)
def test_runtime_gate_on_the_static_payload_matches_team_tpu(setup, tier, caplog,
                                                             jax_tier_interpret):
    """As team_tpu's runtime, the port's builds the static payload, encodes
    the held-out batch through the tier's blocks and gates it: the min cosine
    within 2e-3 of team_tpu's, and the same decision (both fail and serve
    bf16)."""
    from team_tpu.config import Config as JConfig
    from team_tpu.learners.backbone_runtime import BackboneRuntime as JaxRuntime

    extras = {"tiny_backbone": True, "int8_gemm_impl": tier}
    batches = [_u8_images(8, seed) for seed in (50, 51)]
    jrt = JaxRuntime(JConfig(convnet_type="clip", compute_dtype="bfloat16", attention_impl="xla",
                             encoder_quant="int8_static", extras=extras))
    rt = BackboneRuntime(Config(convnet_type="clip", device=["cpu"], compute_dtype="bfloat16",
                                attention_impl="xla", encoder_quant="int8_static", extras=extras),
                         params=setup["tp"])
    with caplog.at_level(logging.INFO):
        for b in batches:
            jrt.encode_image(jnp.asarray(b))
            feats = rt.encode_image(torch.from_numpy(b))
    jax_cos = [float(c) for c in re.findall(r"gate FAILED \(min ([0-9.]+)\) —", caplog.text)]
    assert len(jax_cos) == 1 and jrt.encoder_quant == "bf16" and jrt._qvision is None
    assert rt.encoder_quant == "bf16" and not rt.int8_committed and rt.int8_impl == tier
    assert rt.gate_cosine < 0.999 and abs(rt.gate_cosine - jax_cos[0]) <= 2e-3, (rt.gate_cosine,
                                                                                 jax_cos)
    torch.testing.assert_close(feats, rt._calib_forward(torch.from_numpy(batches[1]))[1],
                               rtol=0, atol=0)
