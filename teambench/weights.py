"""Random CLIP weights drawn on the device from the seed.

One ``torch.randn`` call on the card draws every number; each leaf is a
slice of it times its standard deviation. The tree is the one
``team_tpu_torch.backbone.clip.init_clip_params`` builds (float32, weights
``[in, out]``), with its standard deviations; biases and layer-norm affines
are drawn too (the configuration's ``init``), so that the output check sees
every parameter.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from teambench.traffic import WEIGHTS, sub_seed

Spec = Tuple[Tuple[Any, ...], Tuple[int, ...], str, float]


def _ln(path, width: int) -> List[Spec]:
    return [(path + ("scale",), (width,), "ln_scale", 0.0), (path + ("bias",), (width,), "ln_bias", 0.0)]


def _block(path, width: int, layers: int, mlp: int) -> List[Spec]:
    attn_std, proj_std, fc_std = width ** -0.5, width ** -0.5 * (2 * layers) ** -0.5, (2 * width) ** -0.5
    return (_ln(path + ("ln_1",), width) + [
        (path + ("attn", "qkv_w"), (width, 3 * width), "w", attn_std),
        (path + ("attn", "qkv_b"), (3 * width,), "b", 0.0),
        (path + ("attn", "out_w"), (width, width), "w", proj_std),
        (path + ("attn", "out_b"), (width,), "b", 0.0)]
        + _ln(path + ("ln_2",), width) + [
        (path + ("mlp", "fc_w"), (width, mlp), "w", fc_std),
        (path + ("mlp", "fc_b"), (mlp,), "b", 0.0),
        (path + ("mlp", "proj_w"), (mlp, width), "w", proj_std),
        (path + ("mlp", "proj_b"), (width,), "b", 0.0)])


def leaf_specs(cfg: Dict) -> List[Spec]:
    """``(path, shape, kind, std)`` of every leaf of the CLIP tree of open_clip's
    ``vision_cfg``/``text_cfg``/``embed_dim``."""
    v, t, e = cfg["vision_cfg"], cfg["text_cfg"], cfg["embed_dim"]
    vw, tw = v["width"], t["width"]
    seq = (v["image_size"] // v["patch_size"]) ** 2 + 1
    vmlp, tmlp = int(vw * v.get("mlp_ratio", 4.0)), int(tw * t.get("mlp_ratio", 4.0))
    specs = [(("vision", "patch_w"), (3 * v["patch_size"] ** 2, vw), "w", vw ** -0.5),
             (("vision", "cls"), (vw,), "w", vw ** -0.5),
             (("vision", "pos"), (seq, vw), "w", vw ** -0.5)]
    specs += _ln(("vision", "ln_pre"), vw)
    for i in range(v["layers"]):
        specs += _block(("vision", "blocks", i), vw, v["layers"], vmlp)
    specs += _ln(("vision", "ln_post"), vw) + [(("vision", "proj"), (vw, e), "w", vw ** -0.5)]
    specs += [(("text", "token_embedding"), (t["vocab_size"], tw), "w", 0.02),
              (("text", "pos"), (t["context_length"], tw), "w", 0.01)]
    for i in range(t["layers"]):
        specs += _block(("text", "blocks", i), tw, t["layers"], tmlp)
    specs += _ln(("text", "ln_final"), tw) + [(("text", "proj"), (tw, e), "w", tw ** -0.5)]
    return specs


def _put(tree: Dict, path, leaf: torch.Tensor) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append([] if isinstance(nxt, int) else {})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = leaf


def clip_params(cfg: Dict, seed: int, device) -> Dict[str, Any]:
    """The float32 CLIP tree on ``device``, drawn from the seed.

    ``cfg["init"]``: ``bias_std``, ``ln_scale_std`` (the scales are 1 plus
    that noise) and ``ln_bias_std``; the weights take the tower init's
    standard deviations."""
    init = cfg["init"]
    std = {"b": init["bias_std"], "ln_scale": init["ln_scale_std"], "ln_bias": init["ln_bias_std"]}
    specs = leaf_specs(cfg)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    flat = torch.randn(sum(math.prod(s) for _, s, _, _ in specs), generator=g, device=device)
    tree: Dict[str, Any] = {}
    offset = 0
    for path, shape, kind, s in specs:
        n = math.prod(shape)
        leaf = flat[offset:offset + n].view(shape) * (s if kind == "w" else std[kind])
        if kind == "ln_scale":
            leaf += 1.0
        _put(tree, path, leaf)
        offset += n
    tree["logit_scale"] = torch.tensor(math.log(1.0 / 0.07), dtype=torch.float32, device=device)
    return tree
