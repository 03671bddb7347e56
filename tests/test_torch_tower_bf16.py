"""The bf16 towers' elementwise kernels (``team_tpu_torch/ops/tower_bf16.py``)
on the CPU: each entry's plain version against the composition it replaces,
what the wrappers refuse, where the towers' dispatch takes them
(``clip._tower_kernels``), and the towers' features unchanged.

On the CPU every wrapper computes its plain version and the towers never
call them, so everything here is held bit for bit: the entries against the
eager ops of ``backbone/clip.py`` (``_layer_norm``, ``_linear``,
``_residual``, ``F.gelu``), the tiny ViT-B/16, SigLIP and text towers in
bf16 against their forward as written before the kernels (spelled out
below). The kernels themselves run only on a card
(``tests/test_torch_cuda.py``, ``tests/test_torch_siglip_cuda.py``)."""

import inspect

import pytest
import torch
import torch.nn.functional as F

from team_tpu_torch.backbone import clip
from team_tpu_torch.backbone import quant
from team_tpu_torch.ops import tower_bf16
from team_tpu_torch.ops.flash_attention import flash_attention

BF16 = torch.bfloat16
WIDTHS = [512, 768, 1152]
ROWS = 37  # ragged: no multiple of a warp's or a block's rows


def _inputs(rows, d, seed=0, dtype=BF16):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((rows, d), generator=g) * 2).to(dtype)
    y = torch.randn((rows, d), generator=g).to(dtype)
    b = (torch.randn((d,), generator=g) * 0.1).to(dtype)
    ln = {"scale": 1 + 0.1 * torch.randn((d,), generator=g),
          "bias": 0.05 * torch.randn((d,), generator=g)}
    return x, y, b, ln


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("gelu", [None, "none", "tanh"], ids=["bias", "erf-gelu", "tanh-gelu"])
def test_bias_act_is_the_composition(d, gelu):
    _, y, b, _ = _inputs(ROWS, d)
    want = y + b.to(y.dtype)
    if gelu is not None:
        want = F.gelu(want, approximate=gelu)
    _same(tower_bf16.bias_act(y, b, gelu), want)
    w = torch.randn((64, d), generator=torch.Generator().manual_seed(1)).to(BF16)
    h = torch.randn((3, ROWS, 64), generator=torch.Generator().manual_seed(2)).to(BF16)
    _same(clip._linear(h, w, b, gelu=gelu, kernels=True), clip._linear(h, w, b, gelu=gelu))


def test_bias_act_takes_a_float32_bias_as_the_composition_rounds_it():
    _, y, _, _ = _inputs(ROWS, 768)
    b32 = torch.randn((768,), generator=torch.Generator().manual_seed(3)) * 0.1
    _same(tower_bf16.bias_act(y, b32), y + b32.to(BF16))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("with_ln", [True, False], ids=["ln", "residual"])
def test_residual_ln_is_the_composition(d, eps, with_ln):
    x, y, b, ln = _inputs(ROWS, d, seed=d)
    affine = (ln["scale"], ln["bias"]) if with_ln else ()
    out, h = tower_bf16.residual_ln(x, y, b, *affine, eps=eps)
    want = x + y + b.to(x.dtype)
    _same(out, want)
    if with_ln:
        _same(h, clip._layer_norm(ln, want, eps))
    else:
        assert h is None
    w = torch.eye(d, dtype=BF16)[: 2 * 8]
    hh = y[:, : 2 * 8]
    got, got_h = clip._residual_ln(x, hh, w, b, ln if with_ln else None, eps, kernels=True)
    _same(got, clip._residual(x, hh, w, b))
    if with_ln:
        _same(got_h, clip._layer_norm(ln, got, eps))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layer_norm_is_the_composition(d, eps):
    x, _, _, ln = _inputs(ROWS, d, seed=3 * d)
    _same(tower_bf16.layer_norm(x, ln["scale"], ln["bias"], eps), clip._layer_norm(ln, x, eps))
    _same(clip._norm(ln, x, eps, kernels=True), clip._layer_norm(ln, x, eps))


@pytest.mark.parametrize("d", WIDTHS)
def test_layer_norm_of_a_strided_cls_view(d):
    g = torch.Generator().manual_seed(d)
    x = torch.randn((5, 11, d), generator=g).to(BF16)
    ln = {"scale": 1 + 0.1 * torch.randn((d,), generator=g), "bias": torch.randn((d,), generator=g)}
    cls = x[:, 0]
    assert not cls.is_contiguous()
    _same(tower_bf16.layer_norm(cls, ln["scale"], ln["bias"]), clip._layer_norm(ln, cls))


def test_the_plain_layer_norm_is_the_towers_own():
    """The wrappers' plain layer norm is ``clip._layer_norm`` on any float
    input, float32 too, and ``_layer_norm`` stays the composition."""
    x, _, _, ln = _inputs(ROWS, 1152, seed=5, dtype=torch.float32)
    _same(tower_bf16.layer_norm_reference(x, ln["scale"], ln["bias"], 1e-6),
          clip._layer_norm(ln, x, 1e-6))
    assert "tower_bf16" not in inspect.getsource(clip._layer_norm)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, y, b, ln = _inputs(8, 64)
    with pytest.raises(TypeError, match="float"):
        tower_bf16.bias_act(y.to(torch.int32), b)
    with pytest.raises(ValueError, match="divisible by 8"):
        tower_bf16.bias_act(y[:, :60], b[:60])
    with pytest.raises(ValueError, match="divisible by 8"):
        tower_bf16.layer_norm(x[:, :60], ln["scale"][:60], ln["bias"][:60])
    with pytest.raises(ValueError, match="bias must hold 64"):
        tower_bf16.bias_act(y, b[:56])
    with pytest.raises(ValueError, match="bias must hold 64"):
        tower_bf16.residual_ln(x, y, b[:56])
    with pytest.raises(ValueError, match="gamma must hold 64"):
        tower_bf16.residual_ln(x, y, b, ln["scale"][:56], ln["bias"])
    with pytest.raises(ValueError, match="beta must hold 64"):
        tower_bf16.layer_norm(x, ln["scale"], ln["bias"][:8])
    with pytest.raises(ValueError, match="both gamma and beta"):
        tower_bf16.residual_ln(x, y, b, ln["scale"])
    with pytest.raises(ValueError, match="must match"):
        tower_bf16.residual_ln(x, y[:4], b)
    with pytest.raises(ValueError, match="gelu must be one of"):
        tower_bf16.bias_act(y, b, "erf")
    with pytest.raises(ValueError, match="wider"):
        tower_bf16.layer_norm(torch.zeros((2, 2056)), torch.ones(2056), torch.zeros(2056))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tower_bf16.layer_norm(x.to("meta"), ln["scale"].to("meta"), ln["bias"].to("meta"))
    with pytest.raises(ValueError, match="lies on"):
        tower_bf16.bias_act(y, b.to("meta"))
    with pytest.raises(ValueError, match="wider"):
        tower_bf16.residual_ln(*(torch.zeros((2, tower_bf16.MAX_WIDTH + 8)),) * 2,
                               torch.zeros(tower_bf16.MAX_WIDTH + 8))


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports itself on CUDA, for the dispatch's predicate."""

    @property
    def is_cuda(self):
        return True


def _cuda_like(shape, dtype=BF16, requires_grad=False):
    return torch.Tensor._make_subclass(_CudaLike, torch.zeros(shape, dtype=dtype), requires_grad)


def test_dispatch_takes_bf16_on_a_card_without_a_gradient():
    assert clip._tower_kernels(_cuda_like((2, 5, 768)))
    assert clip._tower_kernels(_cuda_like((2, 5, 1152)))
    grad = _cuda_like((2, 5, 768), requires_grad=True)
    assert not clip._tower_kernels(grad)
    with torch.no_grad():
        assert clip._tower_kernels(grad)
    assert not clip._tower_kernels(_cuda_like((2, 5, 768), dtype=torch.float32))
    assert not clip._tower_kernels(_cuda_like((2, 5, 768)), shard=(0, 2))
    assert not clip._tower_kernels(torch.zeros((2, 5, 768), dtype=BF16))
    # a width the kernels do not take is theirs too: the wrappers raise, and
    # the tower never falls back to the composition on a card
    assert clip._tower_kernels(_cuda_like((2, 5, 60)))
    assert clip._tower_kernels(_cuda_like((2, 5, tower_bf16.MAX_WIDTH + 8)))


@pytest.mark.parametrize("n", [60, 4])
def test_the_kernels_path_raises_for_a_width_it_does_not_take(n):
    """``clip._linear`` with ``kernels`` hands every width to
    :func:`tower_bf16.bias_act`, which refuses one that is no multiple of 8,
    on the CPU as on a card, instead of computing the composition."""
    x, _, _, _ = _inputs(4, 64)
    w, b = torch.zeros((64, n), dtype=BF16), torch.zeros(n, dtype=BF16)
    _same(clip._linear(x, w, b), x @ w + b)
    with pytest.raises(ValueError, match="divisible by 8"):
        clip._linear(x, w, b, kernels=True)


def _refuse_calls(monkeypatch):
    """Every wrapper raises if the towers call it."""
    def refuse(*args, **kwargs):
        raise AssertionError("the composition's path called a tower_bf16 kernel")

    for name in ("bias_act", "residual_ln", "layer_norm"):
        monkeypatch.setattr(tower_bf16, name, refuse)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("grad", [False, True], ids=["no-grad", "grad"])
def test_the_cpu_and_a_gradient_keep_the_composition(monkeypatch, dtype, grad):
    """On the CPU, in either dtype and with tokens that need a gradient
    (Grad-CAM's), the towers call no kernel wrapper."""
    cfg = clip.CLIPConfig.tiny()
    params = clip.cast_frozen_params(clip.init_clip_params(torch.Generator().manual_seed(0), cfg),
                                     dtype, torch.device("cpu"))
    counters = (tower_bf16.bias_act, tower_bf16.residual_ln, tower_bf16.layer_norm)
    before = [fn.launches for fn in counters]
    _refuse_calls(monkeypatch)
    tokens = torch.randn((2, cfg.vision.grid ** 2, cfg.vision.width), dtype=dtype)
    tokens.requires_grad_(grad)
    out = clip.encode_from_patches(params, tokens, cfg, compute_dtype=dtype)
    if grad:
        out.sum().backward()
        assert tokens.grad is not None
    tokens = torch.randint(1, 1000, (2, 77), generator=torch.Generator().manual_seed(1))
    clip.encode_text(params, tokens, cfg, compute_dtype=dtype)
    assert [fn.launches for fn in counters] == before


def test_the_int8_tower_keeps_the_plain_layer_norm():
    """``backbone/quant.py`` (calibration, ``ln_pre``, ``ln_post``, the
    ``_ln_quant3`` producers) calls ``clip._layer_norm`` itself, the
    composition, and nothing of ``tower_bf16``."""
    assert quant._layer_norm is clip._layer_norm
    assert "tower_bf16" not in inspect.getsource(quant)
    assert "_tower_kernels" not in inspect.getsource(quant)


# -- the towers' bf16 features, against their forward before the kernels -----

def _ln(p, x, eps=1e-5):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    return (((x32 - mean) * torch.rsqrt(var + eps)) * p["scale"] + p["bias"]).to(x.dtype)


def _lin(x, w, b):
    return x @ w.to(x.dtype) + b.to(x.dtype)


def _parent_blocks(blocks, x, heads, *, causal, kv_len, eps, gelu):
    for blk in blocks:
        a, m = blk["attn"], blk["mlp"]
        qkv = _lin(_ln(blk["ln_1"], x, eps), a["qkv_w"], a["qkv_b"])
        o = clip.attention_core(qkv, heads, causal=causal, kv_len=kv_len, impl="auto")
        x = x + o @ a["out_w"].to(x.dtype) + a["out_b"].to(x.dtype)
        h = F.gelu(_lin(_ln(blk["ln_2"], x, eps), m["fc_w"], m["fc_b"]), approximate=gelu)
        x = x + h @ m["proj_w"].to(x.dtype) + m["proj_b"].to(x.dtype)
    return x


def _parent_image_features(params, tokens, cfg, dtype):
    v, p = cfg.vision, params["vision"]
    x = tokens.to(dtype)
    if v.patch_bias:
        x = x + p["patch_b"].to(dtype)
    if v.class_token:
        x = torch.cat([p["cls"].to(dtype).expand(x.shape[0], 1, v.width), x], dim=1)
    x = x + p["pos"].to(dtype)
    if v.ln_pre:
        x = _ln(p["ln_pre"], x, v.ln_eps)
    x = _parent_blocks(p["blocks"], x, v.heads, causal=False, kv_len=v.seq_len, eps=v.ln_eps,
                       gelu=v.gelu)
    if v.pool != "map":
        return (_ln(p["ln_post"], x[:, 0], v.ln_eps) @ p["proj"].to(dtype)).float()
    x = _ln(p["ln_post"], x, v.ln_eps)
    hd, a = p["head"], p["head"]["attn"]
    b, _, d = x.shape

    def heads(t):
        return t.reshape(t.shape[0], -1, v.heads, v.head_dim).permute(0, 2, 1, 3)

    q = _lin(hd["probe"].to(dtype)[None], a["q_w"], a["q_b"])
    kv = _lin(x, a["kv_w"], a["kv_b"])
    o = flash_attention(heads(q).expand(b, v.heads, 1, v.head_dim), *map(heads, kv.split(d, -1)))
    o = _lin(o.reshape(b, d), a["out_w"], a["out_b"])
    m = hd["mlp"]
    h = F.gelu(_lin(_ln(hd["ln"], o, v.ln_eps), m["fc_w"], m["fc_b"]), approximate=v.gelu)
    return (o + h @ m["proj_w"].to(dtype) + m["proj_b"].to(dtype)).float()


def _siglip_tiny():
    full = clip.CLIPConfig.siglip_so400m14_384()
    v = clip.VisionConfig(image_size=42, patch_size=14, width=144, layers=2, heads=2,
                          embed_dim=144, gelu="tanh", ln_eps=1e-6, mlp_width=576, pool="map",
                          pixel_mean=full.vision.pixel_mean, pixel_std=full.vision.pixel_std)
    return clip.CLIPConfig(vision=v, text=full.text, embed_dim=144, text_tower=False)


def _drawn(cfg, seed):
    """The init with biases and affines drawn, so that each shows in the features."""
    g = torch.Generator().manual_seed(seed + 1)

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, key) for v in tree]
        if key == "scale":
            return tree + 0.05 * torch.randn(tree.shape, generator=g)
        if key == "bias" or key.endswith("_b"):
            return tree + 0.02 * torch.randn(tree.shape, generator=g)
        return tree

    return walk(clip.init_clip_params(torch.Generator().manual_seed(seed), cfg))


@pytest.mark.parametrize("tower", ["vitb16", "siglip"])
def test_tiny_towers_in_bf16_are_the_parents_formula(tower):
    cfg = clip.CLIPConfig.tiny() if tower == "vitb16" else _siglip_tiny()
    params = clip.cast_frozen_params(_drawn(cfg, 4), BF16, torch.device("cpu"))
    v = cfg.vision
    tokens = torch.randn((3, v.grid ** 2, v.width), generator=torch.Generator().manual_seed(5))
    got = clip.encode_from_patches(params, tokens.to(BF16), cfg, compute_dtype=BF16)
    _same(got, _parent_image_features(params, tokens.to(BF16), cfg, BF16))


def test_tiny_text_tower_in_bf16_is_the_parents_formula():
    cfg = clip.CLIPConfig.tiny()
    params = clip.cast_frozen_params(_drawn(cfg, 6), BF16, torch.device("cpu"))
    tokens = torch.randint(1, 1000, (3, 77), generator=torch.Generator().manual_seed(7))
    t, p = cfg.text, params["text"]
    x = p["token_embedding"][tokens].to(BF16) + p["pos"].to(BF16)
    x = _ln(p["ln_final"], _parent_blocks(p["blocks"], x, t.heads, causal=True,
                                          kv_len=t.context_length, eps=1e-5, gelu="none"))
    x = x[torch.arange(3), tokens.argmax(dim=-1)]
    _same(clip.encode_text(params, tokens, cfg, compute_dtype=BF16),
          (x @ p["proj"].to(BF16)).float())
