"""The int8 tier's other static-W8A8 routes (``int8_gemm_impl`` = ``static``,
``static_qa``, ``static3d``, ``static3d_qa``, ``static3d_qaf``) and their
kernels' plain versions, against team_tpu on the CPU.

The JAX side runs as tests/test_int8.py runs it (its Pallas kernels in
interpret mode); both sides get the same tiny CLIP init, the same payload
and the same inputs, made with numpy and carried across by the bridge. The
CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py. Tolerances:
- ``row_quant_static``: bit for bit (one float32 product, then rint);
- ``ln_quantize_static``: at most one int8 step, on under 1 % of the
  outputs (the f32 sums of the mean and variance are taken in another
  order, which can move a value across a rounding edge);
- ``fused_mha_packed_q`` and ``fused_mha_packed_q3``: the same (the QKᵀ and
  PV sums in f32 in another order, exp in another library);
- the static tower's epilogues (``static_requant``, ``static_residual``,
  ``ln_quant_folded``) on the CPU: the bytes of the composition they
  replace; ``_static_linear3(..., residual=x)`` bit for bit
  ``x + _static_linear3(...)``;
- tower features on the same payload: cosine >= 0.9999 and max |Δ| <=
  5e-3·rms, the bound of tests/test_torch_int8.py;
- the runtime: the held-out gate >= 0.999 commits the tower on each route."""

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
from team_tpu_torch.ops import mha_short as tms
from team_tpu_torch.ops.preprocess import preprocess_batch

JCFG, CFG = JCLIPConfig.tiny(), CLIPConfig.tiny()
SZ = CFG.vision.image_size
ROUTES = ["static", "static_qa", "static3d", "static3d_qa", "static3d_qaf"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_within_one_step(got, want):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.01, (diff > 0).mean()


@pytest.fixture(scope="module")
def setup():
    """The JAX init and calibration on a float batch, the JAX payload, and
    both carried across."""
    rng = np.random.default_rng(0)
    jp = jax_init(jax.random.PRNGKey(0), JCFG)
    imgs = rng.standard_normal((8, SZ, SZ, 3)).astype(np.float32)
    jstats = jq.calibrate_vision_tower(jp, jnp.asarray(imgs), JCFG, attn_impl="xla")
    jqv = jq.quantize_vision_tower_static(jp, jstats, heads=JCFG.vision.heads)
    return {"tp": params_from_numpy(_np(jp)), "jqv": jqv, "tqv": params_from_numpy(_np(jqv)),
            "jqv_dyn": jq.quantize_vision_tower(jp),
            "tqv_dyn": tq.quantize_vision_tower(params_from_numpy(_np(jp)))}


# -- the quantize producers -------------------------------------------------

def _activations(m, d, seed):
    """bf16 activations [M, D] with a mean and spread per row, the layer norm's
    affine and a per-channel inv_a in the ranges of a calibrated tower."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, d)) * rng.uniform(0.5, 4, (m, 1))
         + rng.uniform(-1, 1, (m, 1))).astype(np.float32)
    xb = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    gamma = rng.uniform(0.5, 1.5, d).astype(np.float32)
    beta = rng.uniform(-0.2, 0.2, d).astype(np.float32)
    inv_a = rng.uniform(10, 60, (1, d)).astype(np.float32)
    return xb, gamma, beta, inv_a


# (M, D): rows that fill no 512-row TPU block, the tiny tower's width, ViT-B/16's
SHAPES = [pytest.param(37, 64, id="tiny-ragged"), pytest.param(394, 768, id="vitb16-2x197")]


@pytest.mark.parametrize("m,d", SHAPES)
def test_row_quant_static_is_bit_equal_to_jax(m, d):
    xb, _, _, inv_a = _activations(m, d, seed=1)
    want = jim.row_quant_static(jnp.asarray(xb).astype(jnp.bfloat16), jnp.asarray(inv_a),
                                interpret=True)
    got = tim.row_quant_static(torch.from_numpy(xb).to(torch.bfloat16), torch.from_numpy(inv_a))
    assert got.dtype == torch.int8 and got.shape == (m, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,d", SHAPES)
def test_ln_quantize_static_matches_jax(m, d):
    xb, gamma, beta, inv_a = _activations(m, d, seed=2)
    want = jim.ln_quantize_static(jnp.asarray(xb).astype(jnp.bfloat16), jnp.asarray(gamma),
                                  jnp.asarray(beta), jnp.asarray(inv_a), interpret=True)
    got = tim.ln_quantize_static(torch.from_numpy(xb).to(torch.bfloat16),
                                 torch.from_numpy(gamma), torch.from_numpy(beta),
                                 torch.from_numpy(inv_a))
    assert got.dtype == torch.int8 and got.shape == (m, d)
    assert_within_one_step(got.numpy(), np.asarray(want))


def test_producers_on_cpu_are_the_plain_versions_and_count_nothing():
    xb, gamma, beta, inv_a = (torch.from_numpy(a) for a in _activations(9, 64, seed=3))
    x = xb.to(torch.bfloat16)
    before = (tim.ln_quantize_static.launches, tim.row_quant_static.launches)
    torch.testing.assert_close(tim.ln_quantize_static(x, gamma, beta, inv_a),
                               tim.ln_quantize_static_reference(x, gamma, beta, inv_a),
                               rtol=0, atol=0)
    torch.testing.assert_close(tim.row_quant_static(x, inv_a),
                               tim.row_quant_static_reference(x, inv_a), rtol=0, atol=0)
    assert (tim.ln_quantize_static.launches, tim.row_quant_static.launches) == before


@pytest.mark.parametrize("call,exc", [
    pytest.param(lambda x, g, b, a: tim.row_quant_static(x[None], a), ValueError, id="row-3d"),
    pytest.param(lambda x, g, b, a: tim.row_quant_static(x, a[:, :-1]), ValueError,
                 id="row-inv_a-size"),
    pytest.param(lambda x, g, b, a: tim.row_quant_static(x.to(torch.int8), a), TypeError,
                 id="row-int-input"),
    pytest.param(lambda x, g, b, a: tim.ln_quantize_static(x, g[:-1], b, a), ValueError,
                 id="ln-gamma-size"),
    pytest.param(lambda x, g, b, a: tim.ln_quantize_static(x.to("meta"), g.to("meta"),
                                                           b.to("meta"), a.to("meta")),
                 ValueError, id="ln-meta-device"),
    pytest.param(lambda x, g, b, a: tim.ln_quantize_static(x, g, b, a.to("meta")), ValueError,
                 id="ln-inv_a-elsewhere"),
])
def test_producers_reject_bad_input(call, exc):
    x, g, b, a = (torch.from_numpy(t) for t in _activations(8, 64, seed=4))
    with pytest.raises(exc):
        call(x.to(torch.bfloat16), g, b, a)


# -- the static tower's epilogues (one kernel each on the card) -------------

def _epilogue_inputs(lead, n, seed=5):
    """int32 GEMM sums of a K=768 int8 product, the site's per-column vectors
    in a calibrated tower's ranges, and a bf16 residual of the same shape."""
    g = torch.Generator().manual_seed(seed)
    acc = torch.randint(-400_000, 400_000, (*lead, n), generator=g, dtype=torch.int32)
    scale = torch.rand((1, n), generator=g) * 2e-5 + 1e-6
    bias = torch.randn(n, generator=g) * 0.1
    inv_a = torch.rand((1, n), generator=g) * 40 + 10
    return acc, scale, bias, inv_a, torch.randn((*lead, n), generator=g).to(torch.bfloat16)


def _composed_dequant(acc, scale, bias, gelu):
    """The composition the epilogues replace, pass by pass."""
    out = acc.float() * scale.reshape(-1) + bias.reshape(-1)
    if gelu == "sigmoid":
        out = out * torch.sigmoid(1.702 * out)
    elif gelu == "tanh":
        out = torch.nn.functional.gelu(out, approximate="tanh")
    return out


@pytest.mark.parametrize("gelu", [None, "tanh", "sigmoid"])
def test_static_requant_on_cpu_is_the_composition_and_counts_nothing(gelu):
    acc, scale, bias, inv_a, _ = _epilogue_inputs((2, 9), 64)
    before = tim.static_requant.launches
    got = tim.static_requant(acc, scale, bias, inv_a, activation=gelu)
    want = torch.clamp(torch.round(_composed_dequant(acc, scale, bias, gelu) * inv_a.reshape(-1)),
                       -127, 127).to(torch.int8)
    assert got.dtype == torch.int8 and got.shape == acc.shape
    assert torch.equal(got, want)
    assert tim.static_requant.launches == before


@pytest.mark.parametrize("with_residual", [True, False], ids=["residual", "bf16-out"])
def test_static_residual_on_cpu_is_the_composition_and_counts_nothing(with_residual):
    acc, scale, bias, _, x = _epilogue_inputs((3, 5), 48)
    before = tim.static_residual.launches
    got = tim.static_residual(acc, scale, bias, x if with_residual else None)
    want = _composed_dequant(acc, scale, bias, None).to(torch.bfloat16)
    want = x + want if with_residual else want
    assert got.dtype == torch.bfloat16 and got.shape == acc.shape
    assert torch.equal(got, want)
    assert tim.static_residual.launches == before


@pytest.mark.parametrize("mode", ["1pass", "2pass"])
def test_ln_quant_static3_on_cpu_is_the_composition_and_counts_nothing(mode):
    xb, gamma, beta, inv_a = (torch.from_numpy(a) for a in _activations(18, 64, seed=6))
    x = xb.to(torch.bfloat16).reshape(2, 9, 64)
    before = tim.ln_quant_folded.launches
    got = tim.ln_quant_folded(x, gamma, beta, inv_a, two_pass=mode == "2pass")
    x32 = x.float()
    if mode == "1pass":
        mean = x32.sum(dim=-1, keepdim=True) / 64
        var = torch.clamp(x32.mul(x32).sum(dim=-1, keepdim=True) / 64 - mean * mean, min=0.0)
    else:
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + 1e-5)
    inv = inv_a.reshape(-1)
    want = torch.clamp(torch.round(y * (gamma * inv) + beta * inv), -127, 127).to(torch.int8)
    assert got.dtype == torch.int8 and got.shape == x.shape
    assert torch.equal(got, want)
    assert tim.ln_quant_folded.launches == before


@pytest.mark.parametrize("call,exc", [
    pytest.param(lambda acc, s, b, a, x: tim.static_requant(acc.float(), s, b, a), TypeError,
                 id="requant-float-sums"),
    pytest.param(lambda acc, s, b, a, x: tim.static_requant(acc[0, 0], s, b, a), ValueError,
                 id="requant-1d"),
    pytest.param(lambda acc, s, b, a, x: tim.static_requant(acc[..., :60], s[:, :60], b[:60],
                                                            a[:, :60]), ValueError,
                 id="requant-width-not-8"),
    pytest.param(lambda acc, s, b, a, x: tim.static_requant(acc, s, b[:-8], a), ValueError,
                 id="requant-bias-size"),
    pytest.param(lambda acc, s, b, a, x: tim.static_requant(acc, s, b, a.to("meta")), ValueError,
                 id="requant-inv_a-elsewhere"),
    pytest.param(lambda acc, s, b, a, x: tim.static_requant(acc, s, b, a, activation="erf"),
                 ValueError, id="requant-unknown-activation"),
    pytest.param(lambda acc, s, b, a, x: tim.static_residual(acc, s, b, x.float()), TypeError,
                 id="residual-f32-residual"),
    pytest.param(lambda acc, s, b, a, x: tim.static_residual(acc.to(torch.int8), s, b, x),
                 TypeError, id="residual-int8-sums"),
    pytest.param(lambda acc, s, b, a, x: tim.static_residual(acc, s, b, x[:, :1]), ValueError,
                 id="residual-other-shape"),
    pytest.param(lambda acc, s, b, a, x: tim.static_residual(acc, s[:, :-1], b, x), ValueError,
                 id="residual-scale-size"),
    pytest.param(lambda acc, s, b, a, x: tim.static_residual(acc, s.to("meta"), b, x), ValueError,
                 id="residual-scale-elsewhere"),
    pytest.param(lambda acc, s, b, a, x: tim.static_residual(acc.to("meta"), s.to("meta"),
                                                             b.to("meta"), None), ValueError,
                 id="residual-meta-device"),
    pytest.param(lambda acc, s, b, a, x: tim.ln_quant_folded(acc, s, b, a), TypeError,
                 id="ln3-int-input"),
    pytest.param(lambda acc, s, b, a, x: tim.ln_quant_folded(x[0, 0], s, b, a), ValueError,
                 id="ln3-1d"),
    pytest.param(lambda acc, s, b, a, x: tim.ln_quant_folded(x[..., :60], s[:, :60], b[:60],
                                                             a[:, :60]), ValueError,
                 id="ln3-width-not-8"),
    pytest.param(lambda acc, s, b, a, x: tim.ln_quant_folded(x, s, b, a[:, :8]), ValueError,
                 id="ln3-inv_a-size"),
    pytest.param(lambda acc, s, b, a, x: tim.ln_quant_folded(x, s.to("meta"), b, a), ValueError,
                 id="ln3-gamma-elsewhere"),
])
def test_epilogues_reject_bad_input(call, exc):
    with pytest.raises(exc):
        call(*_epilogue_inputs((2, 3), 64))


@pytest.mark.parametrize("site,lead", [("out", (2, 5)), ("proj", (2, 5)), ("out", (10,)),
                                       ("out", "cls-view")])
def test_static_linear3_with_a_residual_is_the_sum(setup, site, lead):
    """``_static_linear3(..., residual=x)`` is ``x + _static_linear3(...)`` bit
    for bit, the CLS form's row-strided ``x[:, :1]`` too."""
    s = setup["tqv"]["blocks"][0][site]
    k, n = s["w_q"].shape
    g = torch.Generator().manual_seed(7)
    if lead == "cls-view":
        x = torch.randn((2, 5, n), generator=g).to(torch.bfloat16)[:, :1]
        q = torch.randint(-127, 128, (2, 1, k), generator=g, dtype=torch.int8)
    else:
        x = torch.randn((*lead, n), generator=g).to(torch.bfloat16)
        q = torch.randint(-127, 128, (*lead, k), generator=g, dtype=torch.int8)
    got = tq._static_linear3(q, s, residual=x)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got, x + tq._static_linear3(q, s))
    with pytest.raises(ValueError, match="residual"):
        tq._static_linear3(q, s, quant_inv_a=torch.ones((1, n)), residual=x)


def _site(k, n, seed):
    """A static site of any width: int8 weight [K, N], scale and bias."""
    rng = np.random.default_rng(seed)
    return {"w_q": rng.integers(-127, 128, (k, n)).astype(np.int8),
            "scale": (rng.random((1, n)) * 2e-3 + 1e-4).astype(np.float32),
            "b": (rng.standard_normal(n) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("form", ["gelu-to-bf16", "width-12-requant", "width-12-bf16",
                                  "f32-residual", "ln-width-12", "ln-f32-input"])
def test_static_forms_on_cpu_take_what_team_tpu_takes(form):
    """On the CPU ``_static_linear3`` and ``_ln_quant3`` run the composition,
    pass by pass, and take every form team_tpu's take: a GELU to bf16, any
    width, any float input; the card's kernels take widths divisible by 8, a
    bf16 residual and a GELU only before a requantize
    (tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(8)
    if form.startswith("ln-"):
        d = 12 if form == "ln-width-12" else 64
        x = (rng.standard_normal((2, 3, d)) * 3 + 0.5).astype(np.float32)
        ln = {"scale": rng.standard_normal(d).astype(np.float32),
              "bias": rng.standard_normal(d).astype(np.float32)}
        inv_a = np.full((1, d), 11.7, np.float32)
        xt = torch.from_numpy(x)
        xj = jnp.asarray(x)
        if form == "ln-width-12":
            xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
        got = tq._ln_quant3(xt, params_from_numpy(ln), torch.from_numpy(inv_a))
        assert got.dtype == torch.int8 and torch.equal(got, tim.ln_quant_folded_reference(
            xt, torch.from_numpy(ln["scale"]), torch.from_numpy(ln["bias"]),
            torch.from_numpy(inv_a)))
        assert_within_one_step(got, jq._ln_quant3(xj, jax.tree_util.tree_map(jnp.asarray, ln),
                                                  jnp.asarray(inv_a)))
        return
    site = _site(64, 48 if form in ("gelu-to-bf16", "f32-residual") else 12, seed=9)
    n = site["w_q"].shape[1]
    q3 = rng.integers(-127, 128, (2, 5, 64)).astype(np.int8)
    ts, tq3 = params_from_numpy(site), torch.from_numpy(q3)
    acc = tim.int8_matmul(tq3, ts["w_q"])
    activation = "gelu" if form == "gelu-to-bf16" else None
    inv = np.full((1, n), 9.5, np.float32) if form == "width-12-requant" else None
    if form == "f32-residual":
        x = torch.from_numpy(rng.standard_normal((2, 5, n)).astype(np.float32))
        got = tq._static_linear3(tq3, ts, residual=x)
        assert got.dtype == torch.float32
        assert torch.equal(got, x + _composed_dequant(acc, ts["scale"], ts["b"], None)
                           .to(torch.bfloat16))
        return
    got = tq._static_linear3(tq3, ts, activation=activation,
                             quant_inv_a=None if inv is None else torch.from_numpy(inv))
    want = np.asarray(jq._static_linear3(jnp.asarray(q3), jax.tree_util.tree_map(jnp.asarray, site),
                                         activation=activation,
                                         quant_inv_a=None if inv is None else jnp.asarray(inv)
                                         ).astype(jnp.float32))
    composed = _composed_dequant(acc, ts["scale"], ts["b"], "tanh" if activation else None)
    if inv is not None:
        assert torch.equal(got, torch.clamp(torch.round(composed * torch.from_numpy(inv)),
                                            -127, 127).to(torch.int8))
        assert_within_one_step(got.numpy(), want)
    else:
        assert torch.equal(got, composed.to(torch.bfloat16))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=1e-6)


# -- the int8-I/O attention -------------------------------------------------

def _qkv_inputs(b, s, heads, dh, seed=0):
    """int8 qkv and per-channel scales in the ranges of tests/test_int8.py."""
    rng = np.random.default_rng(seed)
    d = heads * dh
    qkv = rng.integers(-127, 128, (b, s, 3 * d)).astype(np.int8)
    deq = rng.uniform(0.01, 0.03, (1, 3 * d)).astype(np.float32)
    oinv = rng.uniform(20, 60, (1, d)).astype(np.float32)
    return qkv, deq, oinv


# (batch, seq, heads, head width, causal, kv_len)
ATTN_CASES = [
    pytest.param(2, 24, 4, 16, False, None, id="small"),
    pytest.param(2, 21, 2, 16, True, None, id="causal"),
    pytest.param(2, 24, 4, 16, False, 17, id="kvlen"),
    pytest.param(2, 21, 2, 16, True, 15, id="causal-kvlen"),
    pytest.param(1, 197, 12, 64, False, None, id="vision-full-width"),
]


@pytest.mark.parametrize("form", ["q", "q3"])
@pytest.mark.parametrize("b,s,h,dh,causal,kv_len", ATTN_CASES)
def test_packed_q_reference_matches_jax_kernel(form, b, s, h, dh, causal, kv_len):
    qkv, deq, oinv = _qkv_inputs(b, s, h, dh)
    d = h * dh
    args = (jnp.asarray(deq), jnp.asarray(oinv), h)
    if form == "q":
        want = jmha.fused_mha_packed_q(jnp.asarray(qkv.reshape(b * s, 3 * d)), *args, seq=s,
                                       causal=causal, kv_len=kv_len, interpret=True)
        got = tms.fused_mha_packed_q(torch.from_numpy(qkv.reshape(b * s, 3 * d)),
                                     torch.from_numpy(deq), torch.from_numpy(oinv), h, seq=s,
                                     causal=causal, kv_len=kv_len)
        assert got.shape == (b * s, d)
    else:
        want = jmha.fused_mha_packed_q3(jnp.asarray(qkv), *args, causal=causal, kv_len=kv_len,
                                        interpret=True)
        got = tms.fused_mha_packed_q3(torch.from_numpy(qkv), torch.from_numpy(deq),
                                      torch.from_numpy(oinv), h, causal=causal, kv_len=kv_len)
        assert got.shape == (b, s, d)
    assert got.dtype == torch.int8
    assert_within_one_step(got.numpy(), np.asarray(want))


def test_the_two_dequants_differ_and_the_forms_share_the_rest():
    """The 2-D wrapper is the 3-D plain version over the same rows with the f32
    dequant; the bf16 dequant gives other outputs on some elements."""
    qkv, deq, oinv = (torch.from_numpy(a) for a in _qkv_inputs(2, 24, 4, 16, seed=5))
    before = (tms.fused_mha_packed_q.launches, tms.fused_mha_packed_q3.launches)
    q2 = tms.fused_mha_packed_q(qkv.reshape(48, -1), deq, oinv, 4, seq=24)
    f32 = tms.mha_packed_q_reference(qkv, deq, oinv, 4)
    bf16 = tms.mha_packed_q_reference(qkv, deq, oinv, 4, bf16_deq=True)
    torch.testing.assert_close(q2.reshape(2, 24, -1), f32, rtol=0, atol=0)
    torch.testing.assert_close(tms.fused_mha_packed_q3(qkv, deq, oinv, 4), bf16, rtol=0, atol=0)
    assert (f32 != bf16).any()
    assert (tms.fused_mha_packed_q.launches, tms.fused_mha_packed_q3.launches) == before


@pytest.mark.parametrize("mutate,kw,exc", [
    pytest.param(lambda a: [a[0].float()] + a[1:], {}, TypeError, id="not-int8"),
    pytest.param(lambda a: [a[0][..., :-1]] + a[1:], {}, ValueError, id="not-packed"),
    pytest.param(lambda a: [a[0], a[1][:, :-1], a[2]], {}, ValueError, id="deq-size"),
    pytest.param(lambda a: [a[0], a[1], a[2][:, :-1]], {}, ValueError, id="o_inv-size"),
    pytest.param(lambda a: a, {"kv_len": 0}, ValueError, id="kv_len-zero"),
    pytest.param(lambda a: a, {"kv_len": 9}, ValueError, id="kv_len-past-seq"),
    pytest.param(lambda a: a, {"heads": 3}, ValueError, id="heads"),
    pytest.param(lambda a: [a[0].to("meta")] + a[1:], {}, ValueError, id="meta-device"),
])
@pytest.mark.parametrize("form", ["q", "q3"])
def test_packed_q_wrappers_reject_bad_input(form, mutate, kw, exc):
    qkv, deq, oinv = mutate([torch.from_numpy(a) for a in _qkv_inputs(2, 8, 2, 16, seed=6)])
    kw = {"heads": 2, **kw}
    with pytest.raises(exc):
        if form == "q":
            tms.fused_mha_packed_q(qkv.reshape(-1, qkv.shape[-1]), deq, oinv, seq=8, **kw)
        else:
            tms.fused_mha_packed_q3(qkv, deq, oinv, **kw)


def test_packed_q_rejects_rows_that_are_not_whole_samples():
    qkv, deq, oinv = (torch.from_numpy(a) for a in _qkv_inputs(2, 8, 2, 16, seed=7))
    with pytest.raises(ValueError):
        tms.fused_mha_packed_q(qkv.reshape(16, -1), deq, oinv, 2, seq=5)
    with pytest.raises(ValueError):
        tms.fused_mha_packed_q(qkv, deq, oinv, 2, seq=8)  # 3-D input to the 2-D form


# -- the routes through the tower -------------------------------------------

def _u8_images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, SZ, SZ, 3)).astype(np.uint8)


def _features(route, ingest, qv_j, qv_t, seed=5):
    """(JAX, port) tower features of one route on held-out data."""
    kw_j = dict(attn_impl="xla", gemm_impl=route, interpret=True)
    kw_t = dict(attn_impl="xla", gemm_impl=route)
    if ingest == "float":
        x = np.random.default_rng(seed).standard_normal((6, SZ, SZ, 3)).astype(np.float32)
        want = jq.encode_image_int8(qv_j, jnp.asarray(x), JCFG, **kw_j)
        got = tq.encode_image_int8(qv_t, torch.from_numpy(x), CFG, **kw_t)
    elif ingest == "u8":
        x = _u8_images(6, seed)
        want = jq.encode_image_int8_u8(qv_j, jnp.asarray(x), JCFG, **kw_j)
        got = tq.encode_image_int8_u8(qv_t, torch.from_numpy(x), CFG, **kw_t)
    else:
        x = np.array(jax_patch_pixels(jnp.asarray(_u8_images(6, seed)), JCFG,
                                      compute_dtype=jnp.uint8))
        want = jq.encode_image_int8_patches(qv_j, jnp.asarray(x), JCFG, patch_dot="int8", **kw_j)
        got = tq.encode_image_int8_patches(qv_t, torch.from_numpy(x), CFG, patch_dot="int8",
                                           **kw_t)
    return np.asarray(want, np.float64), got.double().numpy()


@pytest.mark.parametrize("route,ingest", [(r, "float") for r in ROUTES]
                         + [("static_qa", "u8"), ("static3d_qaf", "u8"),
                            ("static", "patch"), ("static3d_qa", "patch")])
def test_route_features_match_jax(setup, route, ingest):
    want, got = _features(route, ingest, setup["jqv"], setup["tqv"])
    assert got.shape == (6, CFG.embed_dim)
    cos = (want * got).sum(-1) / (np.linalg.norm(want, axis=-1) * np.linalg.norm(got, axis=-1))
    assert cos.min() >= 0.9999, cos
    rms = np.sqrt((want ** 2).mean())
    assert np.abs(got - want).max() <= 5e-3 * rms + 1e-6


def test_bf16_attention_routes_take_attn_impl(setup):
    """``static`` and ``static3d`` reach attention through attention_core with
    the caller's attn_impl; the int8-I/O routes ignore it."""
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, SZ, SZ, 3))
                         .astype(np.float32))
    seen = []
    orig = tq.attention_core

    def spy(*a, **k):
        seen.append(k["impl"])
        return orig(*a, **k)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tq, "attention_core", spy)
        for route in ROUTES:
            tq.encode_image_int8(setup["tqv"], x, CFG, gemm_impl=route, attn_impl="xla")
    assert seen == ["xla"] * (2 * CFG.vision.layers)
    # a block-level route name reaches the bf16 attention as the plain route,
    # as team_tpu's _attn_core sends it (the fused kernels need the whole block)
    torch.testing.assert_close(
        tq.encode_image_int8(setup["tqv"], x, CFG, gemm_impl="static", attn_impl="attn_block"),
        tq.encode_image_int8(setup["tqv"], x, CFG, gemm_impl="static", attn_impl="xla"),
        rtol=0, atol=0)


# calls per block on each route: ln_quantize_static, row_quant_static,
# fused_mha_packed_q, fused_mha_packed_q3, attention_core (the packed kernel)
PER_BLOCK = {
    "static": (2, 1, 0, 0, 1),
    "static_qa": (2, 0, 1, 0, 0),
    "static3d": (0, 0, 0, 0, 1),
    "static3d_qa": (0, 0, 0, 1, 0),
    "static3d_qaf": (0, 0, 0, 1, 0),
}
COUNTED = ("ln_quantize_static", "row_quant_static", "fused_mha_packed_q", "fused_mha_packed_q3",
           "attention_core")


@pytest.mark.parametrize("route", ROUTES)
def test_route_calls_its_kernels_in_every_block(setup, route):
    """On the CPU nothing is launched; the calls are counted by wrapping the
    wrappers that ``quant`` calls. Every block runs in full: no CLS-last form."""
    calls = dict.fromkeys(COUNTED + ("fused_mha_packed_q3i_tp", "fused_mha_packed_q3i_cls"), 0)

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, SZ, SZ, 3))
                         .astype(np.float32))
    launches = (tim.ln_quantize_static.launches, tim.row_quant_static.launches,
                tms.fused_mha_packed_q.launches, tms.fused_mha_packed_q3.launches,
                tms.fused_mha_packed.launches)
    with pytest.MonkeyPatch.context() as m:
        for name in calls:
            m.setattr(tq, name, counting(name, getattr(tq, name)))
        tq.encode_image_int8(setup["tqv"], x, CFG, gemm_impl=route, cls_last="kq")
    layers = CFG.vision.layers
    assert [calls[n] for n in COUNTED] == [layers * c for c in PER_BLOCK[route]]
    assert calls["fused_mha_packed_q3i_tp"] == calls["fused_mha_packed_q3i_cls"] == 0
    assert (tim.ln_quantize_static.launches, tim.row_quant_static.launches,
            tms.fused_mha_packed_q.launches, tms.fused_mha_packed_q3.launches,
            tms.fused_mha_packed.launches) == launches


@pytest.mark.parametrize("route", ["xla", "hybrid", "pallas", "static3d_qi2", "static3d_qis",
                                   "static3d_qib"])
def test_unported_routes_still_raise(setup, route, monkeypatch):
    """Every route here is ported and held against team_tpu: the dynamic
    tiers ``xla``, ``hybrid`` and ``pallas`` on the dynamic payload of
    ``quantize_vision_tower``, the others on the static payload. team_tpu's
    ``quantize_rows`` runs jitted, as in its runtime (XLA then multiplies by
    f32(1/127), as the port does)."""
    monkeypatch.setattr(jq, "quantize_rows", jax.jit(jim.quantize_rows))
    qv = ("jqv_dyn", "tqv_dyn") if route in ("xla", "hybrid", "pallas") else ("jqv", "tqv")
    _assert_tower_close(*_features(route, "float", setup[qv[0]], setup[qv[1]]))


def _assert_tower_close(want, got):
    assert got.shape == (6, CFG.embed_dim)
    cos = (want * got).sum(-1) / (np.linalg.norm(want, axis=-1) * np.linalg.norm(got, axis=-1))
    assert cos.min() >= 0.9999, cos
    assert np.abs(got - want).max() <= 5e-3 * np.sqrt((want ** 2).mean()) + 1e-6


@pytest.mark.parametrize("knob,value", [("TEAM_GELU", "sigmoid"), ("TEAM_LN_MODE", "2pass")])
def test_unported_knobs_raise_on_every_route(setup, monkeypatch, knob, value):
    """The knobs are ported: every route follows team_tpu under each
    (``TEAM_LN_MODE`` moves the routes with the one-pass producer, here
    ``static3d_qaf``; team_tpu reads it into a module global when imported)."""
    monkeypatch.setenv(knob, value)
    if knob == "TEAM_LN_MODE":
        monkeypatch.setattr(jq, "_LN_MODE", value)
    for route in ROUTES:
        _assert_tower_close(*_features(route, "float", setup["jqv"], setup["tqv"]))


# -- the runtime through int8_gemm_impl -------------------------------------

def _runtime(tp, **extras):
    cfg = Config(convnet_type="clip", device=["cpu"], compute_dtype="bfloat16",
                 encoder_quant="int8_static", extras={"tiny_backbone": True, **extras})
    return BackboneRuntime(cfg, params=tp)


@pytest.mark.parametrize("route", ROUTES)
def test_runtime_commits_each_route(setup, route):
    batches = [torch.from_numpy(_u8_images(8, seed)) for seed in (30, 31, 32)]
    rt = _runtime(setup["tp"], int8_gemm_impl=route)
    rt.encode_image(batches[0])
    assert rt._qvision_pending is not None and not rt.int8_committed
    second = rt.encode_image(batches[1])
    assert rt.int8_committed and rt.gate_cosine >= 0.999 and rt.encoder_quant == "int8_static"
    # the runtime's u8 images are preprocessed to the model size, then encoded on its route
    want = tq.encode_image_int8(rt._qvision, preprocess_batch(batches[1], SZ), CFG,
                                gemm_impl=route)
    torch.testing.assert_close(second, want, rtol=0, atol=0)
    third = rt.encode_image(batches[2])
    assert third.shape == (8, CFG.embed_dim) and bool(torch.isfinite(third).all())


@pytest.mark.parametrize("saved_by,served_to", [("static_qa", "static3d"),
                                                ("static3d_qi", "static"),
                                                ("static", "static3d_qaf"),
                                                ("static3d_qa", "static3d_qi")])
def test_a_saved_payload_serves_every_route(setup, tmp_path, saved_by, served_to):
    """A payload holds the keys of every static route (``out_inv_a``, ``deq``,
    ``inv_a``, ``deq_i``, ...), so one saved by any route is reused by any other."""
    batches = [torch.from_numpy(_u8_images(8, seed)) for seed in (40, 41, 42)]
    cache = str(tmp_path / "q")
    rt = _runtime(setup["tp"], int8_gemm_impl=saved_by, int8_cache_dir=cache)
    rt.encode_image(batches[0])
    rt.encode_image(batches[1])
    assert rt.int8_committed
    rt2 = _runtime(setup["tp"], int8_gemm_impl=served_to, int8_cache_dir=cache)
    got = rt2.encode_image(batches[2])
    assert rt2.int8_committed and rt2.gate_cosine is None
    torch.testing.assert_close(got, rt2._encode_int8(rt._qvision, batches[2]), rtol=0, atol=0)
    ref = rt2._calib_forward(batches[2])[1]
    cos = torch.nn.functional.cosine_similarity(got.double(), ref.double(), dim=-1)
    assert cos.min() >= 0.999


# -- the slice through the trainer and the CLI ------------------------------

def _tiny_protocol(config_cls, log_dir, route, **kw):
    """The 3-task tiny SimpleCIL protocol of tests/test_torch_slice.py on one int8 route."""
    return config_cls(
        prefix="t", dataset="synthetic_insects", model_name="simplecil", convnet_type="clip",
        init_cls=2, increment=2, memory_size=12, tuned_epoch=2, batch_size=8, init_lr=0.01,
        optimizer="adam", seed=[1], shuffle=True, log_dir=str(log_dir),
        encoder_quant="int8_static",
        extras={"tiny_backbone": True, "int8_gemm_impl": route,
                "dataset_kwargs": {"num_classes": 6, "img_size": 32}}, **kw)


# ``static`` is left out: team_tpu's runtime runs its Pallas producers without
# interpret mode, which the CPU does not take (the feature and runtime tests
# above hold the port's ``static`` route)
@pytest.mark.parametrize("route", ["static_qa", "static3d", "static3d_qaf"])
def test_trainer_curves_on_each_route_match_team_tpu(route, tmp_path, monkeypatch):
    """SimpleCIL through both trainers on the same route, from the same CLIP
    init: both commit the quantized tower, and the curves agree within one
    test image per task, as in tests/test_torch_slice.py (each side
    calibrates on its own bf16 tower, on ``auto`` the two round the scaled q
    differently at the tiny tower's dh=32, and team_tpu's jitted runtime
    keeps bf16 intermediates in float32 on the CPU: a borderline image may
    flip)."""
    from team_tpu.config import Config as JConfig
    from team_tpu.learners.backbone_runtime import BackboneRuntime as JaxRuntime
    from team_tpu.trainer import train as jax_train
    from team_tpu_torch.trainer import train as torch_train

    made = {"jax": [], "torch": []}
    for key, cls in (("jax", JaxRuntime), ("torch", BackboneRuntime)):
        init = cls.__init__

        def recording_init(self, *a, _init=init, _made=made[key], **k):
            _init(self, *a, **k)
            _made.append(self)

        monkeypatch.setattr(cls, "__init__", recording_init)
    jp = jax_init(jax.random.PRNGKey(0), JCFG)  # the JAX runtime's own init
    want = jax_train(_tiny_protocol(JConfig, tmp_path / "jax", route))
    got = torch_train(_tiny_protocol(Config, tmp_path / "torch", route, device=["cpu"]),
                      params_from_numpy(_np(jp)))
    (jrt,), (trt,) = made["jax"], made["torch"]
    assert jrt._qvision is not None and jrt.encoder_quant == "int8_static"
    assert trt.int8_committed and trt.gate_cosine >= 0.999 and trt.int8_impl == route
    # pp of one test image in tasks 1-3, as the trainer reports them (to 0.01 pp)
    one_image = [100 / n + 0.01 for n in (12, 24, 36)]
    for key in ("cnn_top1", "cnn_top5"):
        assert len(got[key]) == 3
        assert all(abs(g - w) <= tol + 1e-9 for g, w, tol in zip(got[key], want[key], one_image)), (
            key, got[key], want[key])


def test_cli_takes_the_route_from_the_config(tmp_path):
    """``python -m team_tpu_torch.main`` with ``int8_gemm_impl`` in the JSON
    config: the run commits the quantized tower on that route, and loads no
    jax and no team_tpu module."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    cfg = {"prefix": "t", "dataset": "synthetic_insects", "model_name": "simplecil",
           "init_cls": 2, "increment": 2, "batch_size": 8, "seed": [1], "log_dir": str(tmp_path),
           "tiny_backbone": True, "dataset_kwargs": {"num_classes": 6, "img_size": 32},
           "encoder_quant": "int8_static", "int8_gemm_impl": "static_qa"}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    code = ("import runpy, sys\n"
            "from team_tpu_torch.learners import backbone_runtime as br\n"
            "made, init = [], br.BackboneRuntime.__init__\n"
            "def recording_init(self, *a, **k):\n"
            "    init(self, *a, **k)\n"
            "    made.append(self)\n"
            "br.BackboneRuntime.__init__ = recording_init\n"
            f"sys.argv = ['main', '--config', {str(tmp_path / 'cfg.json')!r}, '--device', 'cpu']\n"
            "runpy.run_module('team_tpu_torch.main', run_name='__main__')\n"
            "print('RUNTIME', made[0].int8_impl, made[0].int8_committed, made[0].gate_cosine)\n"
            "print('REFERENCE_MODULES', sorted(m for m in sys.modules if m.split('.')[0] "
            "in ('jax', 'team_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    route, committed, cosine = [ln for ln in lines if ln.startswith("RUNTIME")][-1].split()[1:]
    assert route == "static_qa" and committed == "True" and float(cosine) >= 0.999
    assert [ln for ln in lines if ln.startswith("REFERENCE_MODULES")][-1] == "REFERENCE_MODULES []"
