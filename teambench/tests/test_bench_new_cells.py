"""The ``encode_siglip`` driver on the CPU: the SigLIP tree the benchmark
draws is the program's tree, and its packing is the stride-14
convolution's."""

import copy
import dataclasses
import json

import torch
import torch.nn.functional as F

from teambench.drivers import encode_siglip
from teambench.manifest import ROOT

CPU = torch.device("cpu")
SIGLIP = json.loads((ROOT / "teambench/configs/siglip-so400m14-384-bf16.json").read_text())


def test_siglip_shape_counts_729_tokens_and_the_published_mlp():
    s = encode_siglip.SiglipShape.from_config(SIGLIP)
    v = SIGLIP["vision_config"]
    assert (s.seq, s.tokens, s.mlp_width, s.heads, s.head_dim, s.embed_dim) == (
        729, 729, v["intermediate_size"], v["num_attention_heads"], 72, v["hidden_size"])


def test_the_benchmark_draws_the_programs_tree():
    """Every leaf of ``init_clip_params``' SigLIP tree, at a tiny width, and
    no other, with its shape."""
    from team_tpu_torch.backbone import clip

    cfg = copy.deepcopy(SIGLIP)
    cfg["vision_config"].update(image_size=46, hidden_size=144, num_hidden_layers=2,
                                num_attention_heads=2, intermediate_size=538)
    full = clip.CLIPConfig.siglip_so400m14_384()
    v = dataclasses.replace(full.vision, image_size=46, width=144, layers=2, heads=2,
                            embed_dim=144, mlp_width=538)
    program = clip.init_clip_params(torch.Generator().manual_seed(0),
                                    dataclasses.replace(full, vision=v, embed_dim=144))
    assert _shapes(encode_siglip.siglip_params(cfg, 3, CPU)) == _shapes(program)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(x) for k, x in tree.items()}
    if isinstance(tree, list):
        return [_shapes(x) for x in tree]
    return tuple(tree.shape)


def test_the_pool_is_packed_as_the_stride_14_convolution_sees_it():
    shape = encode_siglip.SiglipShape.from_config(SIGLIP)
    traffic = {"pool_batches": 1, "batch": 2, "images": {"grid": 4, "noise": 24}}
    pool = encode_siglip.image_pool(traffic, shape, 2 ** 31 + 5, CPU)
    assert len(pool) == 1 and pool[0].shape == (2, 729, 588) and pool[0].dtype == torch.uint8
    w = torch.randn((4, 3, 14, 14), generator=torch.Generator().manual_seed(1))
    # the same draws as traffic.image_pool, at 384 px, before the packing
    g = torch.Generator().manual_seed(encode_siglip.sub_seed(2 ** 31 + 5, encode_siglip.IMAGES))
    low = torch.rand((2, 3, 4, 4), generator=g) * 255.0
    field = F.interpolate(low, size=(384, 384), mode="bilinear", align_corners=False)
    noise = (torch.rand((2, 3, 384, 384), generator=g) - 0.5) * 48.0
    u8 = (field + noise).round_().clamp_(0, 255).to(torch.uint8)
    conv = F.conv2d(u8.float(), w, stride=14).flatten(2).transpose(1, 2)
    torch.testing.assert_close(pool[0].float() @ w.reshape(4, -1).T, conv, rtol=0, atol=0.5)
