"""SigLIP So400m/14-384's image tower in the port, on the CPU.

A tiny tower of SigLIP's kind (head width 72: 2 heads, width 144, 2 layers,
MLP 538 = 144 · 4304/1152 rounded, patch 14 at 46 px, so that 4 trailing
pixel rows and columns fall outside every patch) against the benchmark's
plain reference (``teambench/reference/siglip.py``), the attention-pool head
against ``torch.nn.MultiheadAttention``, the packing of 384 px at patch 14
against a stride-14 ``conv2d``, the runtime's choice and refusals, and
ViT-B/16's tiny tower unchanged.

Tolerances: float32, max |Δ| ≤ 1e-5 of the largest |reference| (the two
sum the same products in another order: the port's layer norm by mean and
variance, the reference's ``F.layer_norm``; the flash route's softmax
normalised after PV; about 1e-6 measured); bf16 by the benchmark
configuration's own limit on the largest 1 − cosine over the rows (the same
roundings to bf16 at the same points, but for the flash route's p kept in
float32); the attention-pool head against ``nn.MultiheadAttention`` and the
patch GEMM against ``conv2d`` 1e-5 (float32, other summation orders);
ViT-B/16 bit for bit.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from team_tpu_torch.backbone import clip
from team_tpu_torch.config import Config
from team_tpu_torch.data.loader import _np_patch_pixels
from team_tpu_torch.learners import backbone_runtime as br
from team_tpu_torch.ops.preprocess import preprocess_batch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from teambench.reference import siglip as reference  # noqa: E402

CONFIG = json.loads((ROOT / "teambench/configs/siglip-so400m14-384-bf16.json").read_text())
TINY = dict(image_size=46, hidden_size=144, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=538)


def tiny_cfg(layers: int = 2) -> clip.CLIPConfig:
    full = clip.CLIPConfig.siglip_so400m14_384()
    v = dataclasses.replace(full.vision, image_size=46, width=144, layers=layers, heads=2,
                            embed_dim=144, mlp_width=538)
    return dataclasses.replace(full, vision=v, embed_dim=144)


def reference_cfg() -> dict:
    cfg = json.loads(json.dumps(CONFIG))
    cfg["vision_config"].update(TINY)
    return cfg


def random_params(cfg: clip.CLIPConfig, seed: int = 0):
    """The init, with biases and layer-norm affines drawn too, so that every
    parameter shows in the features."""
    params = clip.init_clip_params(torch.Generator().manual_seed(seed), cfg)
    g = torch.Generator().manual_seed(seed + 1)

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, key) for v in tree]
        if key in ("scale",):
            return tree + 0.05 * torch.randn(tree.shape, generator=g)
        if key in ("bias",) or key.endswith("_b"):
            return tree + 0.02 * torch.randn(tree.shape, generator=g)
        return tree

    return walk(params)


def patches(n: int, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, 9, 588), generator=g, dtype=torch.uint8)


def test_tiny_tower_at_float32_matches_the_reference():
    cfg = tiny_cfg()
    params = random_params(cfg)
    u8 = patches(5)
    out = clip.encode_image_patches_u8(clip.cast_frozen_params(params, torch.float32,
                                                               torch.device("cpu")), u8, cfg)
    ref = reference.features(reference_cfg(), params, [u8], kind="f32")[0]
    assert out.shape == (5, 144) and out.dtype == torch.float32
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_tiny_tower_in_bf16_matches_the_reference_by_the_cosine_gap():
    cfg = tiny_cfg()
    params = random_params(cfg, 3)
    u8 = patches(6, 3)
    out = clip.encode_image_patches_u8(
        clip.cast_frozen_params(params, torch.bfloat16, torch.device("cpu")), u8, cfg,
        compute_dtype=torch.bfloat16)
    ref = reference.features(reference_cfg(), params, [u8], kind="bf16")[0]
    gap = 1.0 - F.cosine_similarity(out.double(), ref.double(), dim=-1)
    assert out.dtype == torch.float32
    assert float(gap.max()) <= CONFIG["check"]["limit"]


def test_attention_pool_matches_multihead_attention():
    """The head as ``SiglipMultiheadAttentionPoolingHead`` writes it: the
    probe repeated over the batch into ``nn.MultiheadAttention(probe, x, x)``,
    then ``h + MLP(LayerNorm(h))``, the first row."""
    cfg = tiny_cfg()
    v = cfg.vision
    hd = random_params(cfg, 5)["vision"]["head"]
    g = torch.Generator().manual_seed(7)
    x = torch.randn((4, 9, v.width), generator=g)
    out = clip._attention_pool(hd, x, v, attn_impl="auto")

    a = hd["attn"]
    mha = torch.nn.MultiheadAttention(v.width, v.heads, batch_first=True)
    ln = torch.nn.LayerNorm(v.width, eps=v.ln_eps)
    fc, proj = torch.nn.Linear(v.width, v.mlp), torch.nn.Linear(v.mlp, v.width)
    with torch.no_grad():
        mha.in_proj_weight.copy_(torch.cat([a["q_w"], a["kv_w"]], dim=1).T)
        mha.in_proj_bias.copy_(torch.cat([a["q_b"], a["kv_b"]]))
        mha.out_proj.weight.copy_(a["out_w"].T)
        mha.out_proj.bias.copy_(a["out_b"])
        ln.weight.copy_(hd["ln"]["scale"])
        ln.bias.copy_(hd["ln"]["bias"])
        fc.weight.copy_(hd["mlp"]["fc_w"].T)
        fc.bias.copy_(hd["mlp"]["fc_b"])
        proj.weight.copy_(hd["mlp"]["proj_w"].T)
        proj.bias.copy_(hd["mlp"]["proj_b"])
        probe = hd["probe"][None, None].repeat(x.shape[0], 1, 1)
        h = mha(probe, x, x, need_weights=False)[0]
        want = (h + proj(F.gelu(fc(ln(h)), approximate="tanh")))[:, 0]
    assert out.shape == (4, v.width)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="attention-pool head"):
        clip._attention_pool(hd, x, v, attn_impl="mha_packed")


def test_384_px_at_patch_14_packs_as_a_stride_14_conv():
    """``patch_pixels`` and the loader's host packing drop the last 6 pixel
    rows and columns; the patch GEMM over them is the convolution."""
    cfg = clip.CLIPConfig.siglip_so400m14_384()
    g = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (2, 384, 384, 3), generator=g, dtype=torch.uint8)
    packed = clip.patch_pixels(images, cfg)
    assert packed.shape == (2, 729, 588)
    assert np.array_equal(_np_patch_pixels(images.numpy(), 14), packed.to(torch.uint8).numpy())
    weight = torch.randn((8, 3, 14, 14), generator=g)
    conv = F.conv2d(images.permute(0, 3, 1, 2).float(), weight, stride=14)  # [2, 8, 27, 27]
    gemm = packed @ weight.reshape(8, -1).T
    torch.testing.assert_close(gemm, conv.flatten(2).transpose(1, 2), rtol=0, atol=1e-5 * 255 * 588)


def test_hwc_and_patch_major_inputs_agree_at_384_px(monkeypatch):
    """The learners' two uint8 forms through ``BackboneRuntime.encode_image``
    on the tiny tower of SigLIP's kind: ``[B, H, W, 3]`` (normalized on the
    device with SigLIP's 0.5/0.5) and patch-major; the runtime's features
    are ``out_dim`` wide."""
    cfg = tiny_cfg()
    monkeypatch.setattr(br, "clip_config_for", lambda c: cfg)
    runtime = br.BackboneRuntime(Config(convnet_type=br.SIGLIP, device=["cpu"]), seed=0)
    g = torch.Generator().manual_seed(2)
    images = torch.randint(0, 256, (3, 46, 46, 3), generator=g, dtype=torch.uint8)
    hwc = runtime.encode_image(images)
    pm = runtime.encode_image(torch.from_numpy(_np_patch_pixels(images.numpy(), 14)))
    assert hwc.shape == (3, runtime.out_dim) == (3, 144)
    torch.testing.assert_close(hwc, pm, rtol=0, atol=1e-5)
    x = preprocess_batch(images, 46, mean=(0.5,) * 3, std=(0.5,) * 3)
    torch.testing.assert_close(x, images.float() / 127.5 - 1.0, rtol=0, atol=1e-6)


def test_runtime_builds_siglip_for_its_convnet_type():
    cfg = Config(convnet_type=br.SIGLIP, device=["cpu"])
    c = br.clip_config_for(cfg)
    assert (c.vision.width, c.vision.layers, c.vision.heads, c.vision.head_dim, c.vision.mlp,
            c.vision.seq_len, c.vision.grid, c.embed_dim) == (1152, 27, 16, 72, 4304, 729, 27, 1152)
    assert not c.text_tower and c.vision.pool == "map" and c.vision.gelu == "tanh"
    assert (c.vision.class_token, c.vision.ln_pre, c.vision.patch_bias) == (False, False, True)
    assert br.clip_config_for(Config(convnet_type=br.SIGLIP, extras={"tiny_backbone": True})) \
        == clip.CLIPConfig.tiny()
    assert br.clip_config_for(Config(convnet_type="clip")) == clip.CLIPConfig.vit_b16()


@pytest.mark.parametrize("key,value,match", [
    ("encoder_quant", "int8_static", "encoder_quant"),
    ("attention_impl", "attn_block", "attention_impl")])
def test_runtime_refuses_what_siglip_does_not_take(monkeypatch, key, value, match):
    monkeypatch.setattr(br, "clip_config_for", lambda c: tiny_cfg())
    with pytest.raises(NotImplementedError, match=match):
        br.BackboneRuntime(Config.from_dict({"convnet_type": br.SIGLIP, "device": ["cpu"],
                                             key: value}), seed=0)


def test_siglip_text_side_raises_naming_the_vocabulary(monkeypatch):
    monkeypatch.setattr(br, "clip_config_for", lambda c: tiny_cfg())
    runtime = br.BackboneRuntime(Config(convnet_type=br.SIGLIP, device=["cpu"]), seed=0)
    assert "text" not in runtime.params
    with pytest.raises(NotImplementedError, match="SentencePiece"):
        runtime.encode_texts(["a photo of a moth"])
    with pytest.raises(NotImplementedError, match="SentencePiece"):
        runtime.encode_text_tokens(torch.zeros((1, 64), dtype=torch.long))


def _vitb16_parent(p, u8, cfg, dtype):
    """ViT-B/16's image tower over patch-major uint8 as the port computed it
    before the tower's kind became configuration: CLIP's normalize, the CLS
    token, ``ln_pre``, exact-GELU blocks with layer norms at eps 1e-5 and the
    plain attention route, ``ln_post`` on the CLS row and the projection."""
    def ln(q, x):
        x32 = x.float()
        y = (x32 - x32.mean(-1, keepdim=True)) * torch.rsqrt(
            x32.var(-1, keepdim=True, correction=0) + 1e-5)
        return (y * q["scale"] + q["bias"]).to(x.dtype)

    v = cfg.vision
    ps2 = v.patch_size ** 2
    mean = torch.tensor((0.48145466, 0.4578275, 0.40821073)).repeat_interleave(ps2)
    std = torch.tensor((0.26862954, 0.26130258, 0.27577711)).repeat_interleave(ps2)
    px = (u8.float() * (1.0 / (255.0 * std)) + (-mean / std)).to(dtype)
    tokens = px @ p["patch_w"].to(dtype)
    x = torch.cat([p["cls"].to(dtype).expand(u8.shape[0], 1, v.width), tokens], dim=1)
    x = ln(p["ln_pre"], x + p["pos"].to(dtype))
    b, s, d = x.shape
    for blk in p["blocks"]:
        a, m = blk["attn"], blk["mlp"]
        qkv = ln(blk["ln_1"], x) @ a["qkv_w"].to(dtype) + a["qkv_b"].to(dtype)
        q, k, vv = (t.reshape(b, s, v.heads, d // v.heads).permute(0, 2, 1, 3)
                    for t in qkv.split(d, -1))
        logits = (q.float() @ k.float().transpose(-1, -2)) * (d // v.heads) ** -0.5
        o = (torch.softmax(logits, -1).to(vv.dtype) @ vv).permute(0, 2, 1, 3).reshape(b, s, d)
        x = x + o @ a["out_w"].to(dtype) + a["out_b"].to(dtype)
        h = F.gelu(ln(blk["ln_2"], x) @ m["fc_w"].to(dtype) + m["fc_b"].to(dtype),
                   approximate="none")
        x = x + h @ m["proj_w"].to(dtype) + m["proj_b"].to(dtype)
    return (ln(p["ln_post"], x[:, 0]) @ p["proj"].to(dtype)).float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vitb16_tiny_tower_is_unchanged(dtype):
    cfg = clip.CLIPConfig.tiny()
    params = clip.cast_frozen_params(random_params(cfg, 9), dtype, torch.device("cpu"))
    g = torch.Generator().manual_seed(4)
    u8 = torch.randint(0, 256, (3, cfg.vision.grid ** 2, 3 * 16 * 16), generator=g,
                       dtype=torch.uint8)
    out = clip.encode_image_patches_u8(params, u8, cfg, compute_dtype=dtype, attn_impl="xla")
    assert torch.equal(out, _vitb16_parent(params["vision"], u8, cfg, dtype))
    assert cfg.vision.seq_len == 5 and cfg.vision.mlp == 4 * 64 and math.isclose(
        cfg.vision.ln_eps, 1e-5)
