"""The fused attention-block routes and the pre-split kernel: the port's
plain versions against the JAX Pallas kernels (interpret mode, patched in as
tests/test_backbone.py does), ``_block_forward`` on both fused routes against
team_tpu's, the attention biases that the fused routes keep in float32, and
the wrappers' checks. The CUDA kernels are held against the plain versions
on the card in tests/test_torch_cuda.py.

Inputs come from numpy with a seed; biases and layer-norm affines are
non-zero (the random CLIP init makes them 0 and 1, which hides their
roundings). Tolerances: float32 1e-5 (both sides accumulate in f32, in
another order); bfloat16 2e-2 absolute as tests/test_torch_mha_packed.py,
plus one bf16 step (2^-7) of the output's magnitude where a residual makes
outputs larger than 2."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import team_tpu.ops.mha_short as jms
from team_tpu.backbone import clip as jclip
from team_tpu_torch.backbone import clip as tclip
from team_tpu_torch.bridge import params_from_numpy
from team_tpu_torch.config import Config
from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
from team_tpu_torch.ops import mha_short as tms

DTYPES = [pytest.param(torch.float32, jnp.float32, id="f32"),
          pytest.param(torch.bfloat16, jnp.bfloat16, id="bf16")]
FUSED = ["attn_block", "mha_packed_proj"]


def assert_close(got: torch.Tensor, want, dtype, rel: float = 0.0):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=rel, atol=2e-2)


def block_inputs(b, s, h, dh, seed=0):
    """x, a layer norm's affine, the attention's weights and biases (numpy
    float32), and a packed qkv."""
    rng = np.random.default_rng(seed)
    d = h * dh

    def normal(*shape, std=1.0, mean=0.0):
        return (rng.standard_normal(shape) * std + mean).astype(np.float32)

    return {"x": normal(b, s, d), "ln_scale": normal(d, std=0.3, mean=1.0),
            "ln_bias": normal(d, std=0.2), "qkv_w": normal(d, 3 * d, std=d ** -0.5),
            "qkv_b": normal(3 * d, std=0.5), "out_w": normal(d, d, std=d ** -0.5),
            "out_b": normal(d, std=0.5), "qkv": normal(b, s, 3 * d)}


# (batch, seq, heads, head width, causal)
SHAPES = [pytest.param(2, 37, 2, 32, False, id="dh32"),
          pytest.param(2, 21, 2, 32, True, id="dh32-causal"),
          pytest.param(2, 29, 2, 64, False, id="dh64"),
          pytest.param(2, 21, 2, 64, True, id="dh64-causal")]


@pytest.mark.parametrize("tdt,jdt", DTYPES)
@pytest.mark.parametrize("b,s,h,dh,causal", SHAPES)
def test_attn_block_reference_matches_jax_kernel(tdt, jdt, b, s, h, dh, causal):
    a = block_inputs(b, s, h, dh)
    names = ("ln_scale", "ln_bias", "qkv_w", "qkv_b", "out_w", "out_b")
    want = jms.fused_attn_block(jnp.asarray(a["x"]).astype(jdt), *(jnp.asarray(a[n]) for n in names),
                                h, causal=causal, interpret=True)
    got = tms.attn_block_reference(torch.from_numpy(a["x"]).to(tdt),
                                   *(torch.from_numpy(a[n]) for n in names), h, causal)
    assert_close(got, want, tdt, rel=2 ** -7)


@pytest.mark.parametrize("tdt,jdt", DTYPES)
@pytest.mark.parametrize("b,s,h,dh,causal", SHAPES)
def test_mha_packed_proj_reference_matches_jax_kernel(tdt, jdt, b, s, h, dh, causal):
    a = block_inputs(b, s, h, dh, seed=1)
    want = jms.fused_mha_packed_proj(jnp.asarray(a["qkv"]).astype(jdt), jnp.asarray(a["out_w"]),
                                     jnp.asarray(a["out_b"]), jnp.asarray(a["x"]).astype(jdt), h,
                                     causal=causal, interpret=True)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = tms.mha_packed_proj_reference(t["qkv"].to(tdt), t["out_w"], t["out_b"], t["x"].to(tdt),
                                        h, causal)
    assert_close(got, want, tdt, rel=2 ** -7)


@pytest.mark.parametrize("tdt,jdt", DTYPES)
@pytest.mark.parametrize("b,h,s,dh,kv_len", [
    pytest.param(2, 3, 37, 32, None, id="dh32"), pytest.param(2, 3, 37, 32, 30, id="dh32-kvlen"),
    pytest.param(1, 4, 50, 64, None, id="dh64"), pytest.param(1, 4, 50, 64, 7, id="dh64-kvlen")])
def test_mha_short_reference_matches_jax_kernel(tdt, jdt, b, h, s, dh, kv_len):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32) for _ in range(3))
    want = jms.fused_mha_short(*(jnp.asarray(t).astype(jdt) for t in (q, k, v)), kv_len,
                               interpret=True)
    got = tms.mha_short_reference(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)), kv_len)
    assert_close(got, want, tdt)  # every query row, the ones past kv_len too


def test_wrappers_on_cpu_are_the_plain_versions_and_count_nothing():
    a = {k: torch.from_numpy(v) for k, v in block_inputs(2, 21, 2, 32).items()}
    counters = (tms.fused_mha_short, tms.fused_mha_packed_proj, tms.fused_attn_block)
    before = [c.launches for c in counters]
    q, k, v = (torch.from_numpy(t) for t in np.random.default_rng(3).standard_normal(
        (3, 2, 2, 21, 32)).astype(np.float32))
    torch.testing.assert_close(tms.fused_mha_short(q, k, v, 15),
                               tms.mha_short_reference(q, k, v, 15), rtol=0, atol=0)
    torch.testing.assert_close(
        tms.fused_mha_packed_proj(a["qkv"], a["out_w"], a["out_b"], a["x"], 2, causal=True),
        tms.mha_packed_proj_reference(a["qkv"], a["out_w"], a["out_b"], a["x"], 2, True),
        rtol=0, atol=0)
    names = ("x", "ln_scale", "ln_bias", "qkv_w", "qkv_b", "out_w", "out_b")
    torch.testing.assert_close(tms.fused_attn_block(*(a[n] for n in names), 2, causal=True),
                               tms.attn_block_reference(*(a[n] for n in names), 2, True),
                               rtol=0, atol=0)
    assert [c.launches for c in counters] == before


def _bad(name):
    a = {k: torch.from_numpy(v) for k, v in block_inputs(1, 5, 2, 32).items()}
    q = torch.zeros((1, 2, 5, 32))
    calls = {
        "short-shapes": lambda: tms.fused_mha_short(q, q, q[:, :, :4]),
        "short-kv_len": lambda: tms.fused_mha_short(q, q, q, 6),
        "short-dtype": lambda: tms.fused_mha_short(q.half(), q.half(), q.half()),
        "short-device": lambda: tms.fused_mha_short(q.to("meta"), q.to("meta"), q.to("meta")),
        "proj-not-packed": lambda: tms.fused_mha_packed_proj(a["x"], a["out_w"], a["out_b"],
                                                             a["x"], 2),
        "proj-heads": lambda: tms.fused_mha_packed_proj(a["qkv"], a["out_w"], a["out_b"], a["x"], 3),
        "proj-resid": lambda: tms.fused_mha_packed_proj(a["qkv"], a["out_w"], a["out_b"],
                                                        a["x"][:, :4], 2),
        "proj-dtype": lambda: tms.fused_mha_packed_proj(a["qkv"], a["out_w"], a["out_b"],
                                                        a["x"].to(torch.bfloat16), 2),
        "block-weights": lambda: tms.fused_attn_block(a["x"], a["ln_scale"], a["ln_bias"],
                                                      a["out_w"], a["qkv_b"], a["out_w"],
                                                      a["out_b"], 2),
        "block-device": lambda: tms.fused_attn_block(
            a["x"].to("meta"), a["ln_scale"], a["ln_bias"], a["qkv_w"], a["qkv_b"], a["out_w"],
            a["out_b"], 2),
    }
    return calls[name]


@pytest.mark.parametrize("name,exc", [
    ("short-shapes", ValueError), ("short-kv_len", ValueError), ("short-dtype", TypeError),
    ("short-device", ValueError), ("proj-not-packed", ValueError), ("proj-heads", ValueError),
    ("proj-resid", ValueError), ("proj-dtype", TypeError), ("block-weights", ValueError),
    ("block-device", ValueError)])
def test_wrappers_reject_bad_input(name, exc):
    with pytest.raises(exc):
        _bad(name)()


# -- the blocks and the runtime ---------------------------------------------

@pytest.fixture
def jax_interpret(monkeypatch):
    """team_tpu's fused kernels in interpret mode, as tests/test_backbone.py runs them."""
    for name in ("fused_attn_block", "fused_mha_packed_proj", "fused_mha_short"):
        monkeypatch.setattr(jms, name, functools.partial(getattr(jms, name), interpret=True))


def nonzero_block(seed=4):
    """Block 0 of the tiny vision tower (JAX init) with every bias and
    layer-norm affine made non-zero; numpy float32."""
    jp = jclip.init_clip_params(jax.random.PRNGKey(2), jclip.CLIPConfig.tiny())
    blk = jax.tree_util.tree_map(np.asarray, jp["vision"]["blocks"][0])
    rng = np.random.default_rng(seed)
    for group, key in (("attn", "qkv_b"), ("attn", "out_b"), ("mlp", "fc_b"), ("mlp", "proj_b")):
        blk[group][key] = (rng.standard_normal(blk[group][key].shape) * 0.5).astype(np.float32)
    for ln in ("ln_1", "ln_2"):
        width = blk[ln]["scale"].shape[0]
        blk[ln]["scale"] = (rng.standard_normal(width) * 0.3 + 1).astype(np.float32)
        blk[ln]["bias"] = (rng.standard_normal(width) * 0.2).astype(np.float32)
    return blk


@pytest.mark.parametrize("tdt,jdt", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", FUSED)
def test_block_forward_matches_team_tpu(jax_interpret, impl, causal, tdt, jdt):
    """One block on a fused route, the port's (weights cast once, as the
    runtime does) against team_tpu's (float32 weights cast at each use)."""
    blk = nonzero_block()
    x = np.random.default_rng(5).standard_normal((3, 41, 64)).astype(np.float32)
    want = jclip._block_forward(jax.tree_util.tree_map(jnp.asarray, blk),
                                jnp.asarray(x).astype(jdt), 2, causal=causal, kv_len=41, impl=impl)
    tblk = tclip.cast_frozen_params({"b": params_from_numpy(blk)}, tdt, torch.device("cpu"),
                                    impl)["b"]
    got = tclip._block_forward(tblk, torch.from_numpy(x).to(tdt), 2, causal=causal, kv_len=41,
                               impl=impl)
    assert_close(got, want, tdt, rel=2 ** -7)


def test_block_forward_adds_the_bias_after_the_residual():
    """team_tpu writes ``x + o @ W + b``: the product joins the residual, then
    the bias (two bf16 roundings). With non-zero biases in bf16 the port's
    block differs from team_tpu's on few outputs (the MLP GEMMs' roundings);
    adding the bias to the product first, as the port once did, moves far
    more."""
    blk = nonzero_block(seed=10)
    x = np.random.default_rng(11).standard_normal((4, 50, 64)).astype(np.float32) * 2
    want = np.asarray(jclip._block_forward(
        jax.tree_util.tree_map(jnp.asarray, blk), jnp.asarray(x).astype(jnp.bfloat16), 2,
        causal=False, kv_len=50, impl="xla").astype(jnp.float32))
    tblk = tclip.cast_frozen_params({"b": params_from_numpy(blk)}, torch.bfloat16,
                                    torch.device("cpu"))["b"]
    tx = torch.from_numpy(x).to(torch.bfloat16)

    def differing(residual):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(tclip, "_residual", residual)
            got = tclip._block_forward(tblk, tx, 2, causal=False, kv_len=50, impl="xla")
        return float((got.float().numpy() != want).mean())

    ours = differing(tclip._residual)
    bias_first = differing(lambda x, h, w, b: x + (h @ w.to(x.dtype) + b.to(x.dtype)))
    assert ours < 0.15 < bias_first, (ours, bias_first)


def _runtime(impl: str, params) -> BackboneRuntime:
    cfg = Config(prefix="t", dataset="synthetic_insects", model_name="simplecil",
                 convnet_type="clip", device=["cpu"], compute_dtype="bfloat16",
                 attention_impl=impl, extras={"tiny_backbone": True})
    return BackboneRuntime(cfg, params=params)


@pytest.mark.parametrize("impl", FUSED)
def test_fused_routes_keep_the_attention_biases_float32(jax_interpret, impl):
    """The fused kernels add qkv_b and out_b in float32 (team_tpu casts them so
    at each call). The bf16 runtime on a fused route keeps them float32, and
    its fused call then matches team_tpu's kernel bit for bit on all but a
    few outputs; rounded to bf16 once, as the other leaves are, they move
    about a quarter of the outputs by a bf16 step."""
    blk = nonzero_block(seed=6)
    jp = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0),
                                                                   jclip.CLIPConfig.tiny()))
    jp["vision"]["blocks"][0] = blk
    rt = _runtime(impl, params_from_numpy(jp))
    tb = rt.params["vision"]["blocks"][0]
    assert tb["attn"]["qkv_b"].dtype == tb["attn"]["out_b"].dtype == torch.float32
    assert tb["attn"]["qkv_w"].dtype == tb["mlp"]["fc_b"].dtype == torch.bfloat16
    assert _runtime("auto", params_from_numpy(jp)).params["vision"]["blocks"][0]["attn"][
        "qkv_b"].dtype == torch.bfloat16
    x = np.random.default_rng(7).standard_normal((2, 17, 64)).astype(np.float32)
    jb = jax.tree_util.tree_map(jnp.asarray, blk)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    a, ja = tb["attn"], jb["attn"]
    if impl == "attn_block":
        want = jms.fused_attn_block(jx, jb["ln_1"]["scale"], jb["ln_1"]["bias"], ja["qkv_w"],
                                    ja["qkv_b"], ja["out_w"], ja["out_b"], 2)
        got = tms.fused_attn_block(tx, tb["ln_1"]["scale"], tb["ln_1"]["bias"], a["qkv_w"],
                                   a["qkv_b"], a["out_w"], a["out_b"], 2)
    else:
        qkv = np.random.default_rng(8).standard_normal((2, 17, 192)).astype(np.float32)
        want = jms.fused_mha_packed_proj(jnp.asarray(qkv).astype(jnp.bfloat16), ja["out_w"],
                                         ja["out_b"], jx, 2)
        got = tms.fused_mha_packed_proj(torch.from_numpy(qkv).to(torch.bfloat16), a["out_w"],
                                        a["out_b"], tx, 2)
    diff = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert (diff > 0).mean() < 0.01, (diff > 0).mean()


def test_image_tower_on_mha_short_matches_team_tpu(jax_interpret):
    """``encode_image(attn_impl="mha_short")``: the image tower through the
    pre-split kernel (its plain version here), float32, against team_tpu's
    through its interpret-mode kernel."""
    jcfg, tcfg = jclip.CLIPConfig.tiny(), tclip.CLIPConfig.tiny()
    jp = jclip.init_clip_params(jax.random.PRNGKey(1), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    images = np.random.default_rng(9).standard_normal((3, 32, 32, 3)).astype(np.float32)
    want = jclip.encode_image(jp, jnp.asarray(images), jcfg, attn_impl="mha_short")
    got = tclip.encode_image(tp, torch.from_numpy(images), tcfg, attn_impl="mha_short")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="non-causal"):
        tclip.encode_text(tp, torch.ones((1, 77), dtype=torch.long), tcfg, attn_impl="mha_short")
