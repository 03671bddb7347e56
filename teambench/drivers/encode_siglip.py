"""The ``encode_siglip`` driver: B-image batches of 384 px through SigLIP
So400m/14's image tower, ``BackboneRuntime.encode_image``.

The ``encode`` driver's contract and loop (:mod:`teambench.drivers.encode`)
on another tower. Set-up draws the SigLIP tree on the device in one
``torch.randn`` call from the seed (:func:`siglip_params`) and its own image
pool (:func:`image_pool`: colour fields at 384 px as :mod:`teambench.traffic`
draws them, packed patch-major as the stride-14 convolution sees them, the
last 6 pixel rows and columns outside every patch), builds the runtime from
the configuration's ``runtime`` keys and checks that it built the tower the
file states. A step is one ``encode_image`` call on the next pool batch; its
output is the ``[B, 1152]`` features.

The check compares sampled outputs with the plain reference
(:mod:`teambench.reference.siglip`) in the configuration's precision by
``check.number``, and on a card the share of the tower's math in kernels of
another precision, as the ``encode`` driver does. The control
(``reference_fp8``) is the same reference with every GEMM's operands in
float8 e4m3. The fault ``mean_pool`` replaces the attention-pool head by the
mean of the tokens.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from teambench import weights, work
from teambench.drivers.encode import System as EncodeSystem, _synced, program_runtime, worst_gap
from teambench.reference import siglip as reference
from teambench.traffic import IMAGES, WEIGHTS, sub_seed


class SiglipShape(work.VisionShape):
    """The tower's sizes for :mod:`teambench.work`, from the configuration's
    ``vision_cfg`` (open_clip's keys): no class token, so the blocks'
    sequence is the 729 patch tokens; the MLP width 4304 as published.
    ``embed_dim`` is the width: the work functions' final projection stands
    for the attention-pool head's out-projection. They count the last block
    for one row and leave out the head's kv GEMM and attention, so the
    rooflines of this tower read a few percent low, never high."""

    @property
    def seq(self) -> int:
        return self.tokens

    @property
    def mlp_width(self) -> int:
        return round(self.width * self.mlp_ratio)


def leaf_specs(cfg: Dict) -> List[weights.Spec]:
    """``(path, shape, kind, std)`` of every leaf of the image tower's tree:
    the patch GEMM and its bias, the positions, the blocks (open_clip's
    standard deviations at this depth), ``ln_post`` and the attention-pool
    head; no text tower."""
    v = cfg["vision_config"]
    d, f, n = v["hidden_size"], v["intermediate_size"], v["num_hidden_layers"]
    patch_dim = 3 * v["patch_size"] ** 2
    seq = (v["image_size"] // v["patch_size"]) ** 2
    vis = ("vision",)
    specs = [(vis + ("patch_w",), (patch_dim, d), "w", patch_dim ** -0.5),
             (vis + ("patch_b",), (d,), "b", 0.0),
             (vis + ("pos",), (seq, d), "w", d ** -0.5)]
    for i in range(n):
        specs += weights._block(vis + ("blocks", i), d, n, f)
    specs += weights._ln(vis + ("ln_post",), d)
    head = vis + ("head",)
    specs += [(head + ("probe",), (d,), "w", d ** -0.5),
              (head + ("attn", "q_w"), (d, d), "w", d ** -0.5),
              (head + ("attn", "q_b"), (d,), "b", 0.0),
              (head + ("attn", "kv_w"), (d, 2 * d), "w", d ** -0.5),
              (head + ("attn", "kv_b"), (2 * d,), "b", 0.0),
              (head + ("attn", "out_w"), (d, d), "w", d ** -0.5),
              (head + ("attn", "out_b"), (d,), "b", 0.0)]
    specs += weights._ln(head + ("ln",), d)
    specs += [(head + ("mlp", "fc_w"), (d, f), "w", (2 * d) ** -0.5),
              (head + ("mlp", "fc_b"), (f,), "b", 0.0),
              (head + ("mlp", "proj_w"), (f, d), "w", d ** -0.5 * (2 * n) ** -0.5),
              (head + ("mlp", "proj_b"), (d,), "b", 0.0)]
    return specs


def siglip_params(cfg: Dict, seed: int, device) -> Dict[str, Any]:
    """The float32 tree on ``device``, every number from one ``torch.randn``
    call (the configuration's ``init`` for biases and layer-norm affines, as
    :func:`teambench.weights.clip_params` draws them)."""
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
        weights._put(tree, path, leaf)
        offset += n
    tree["logit_scale"] = torch.tensor(math.log(1.0 / 0.07), dtype=torch.float32, device=device)
    return tree


def image_pool(traffic: Dict, shape: work.VisionShape, seed: int, device) -> List[torch.Tensor]:
    """``pool_batches`` contiguous uint8 batches ``[batch, g*g, 3*ps*ps]``:
    the colour fields and noise of :func:`teambench.traffic.image_pool` at
    ``image_size`` px, drawn in the same calls, then packed patch-major over
    the ``g*ps`` pixels the patches cover."""
    spec = traffic["images"]
    n = traffic["pool_batches"] * traffic["batch"]
    size, ps, grid = shape.image_size, shape.patch_size, spec["grid"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, IMAGES))
    low = torch.rand((n, 3, grid, grid), generator=g, device=device) * 255.0
    field = F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)
    noise = (torch.rand((n, 3, size, size), generator=g, device=device) - 0.5) * (2.0 * spec["noise"])
    u8 = (field + noise).round_().clamp_(0, 255).to(torch.uint8)
    del low, field, noise
    g_n = size // ps
    u8 = u8[:, :, :g_n * ps, :g_n * ps]
    # [N, C, gh, ph, gw, pw] -> [N, gh, gw, C, ph, pw]: channel-major inside a patch
    patches = u8.reshape(n, 3, g_n, ps, g_n, ps).permute(0, 2, 4, 1, 3, 5)
    patches = patches.reshape(n, g_n * g_n, 3 * ps * ps).contiguous()
    return [b.clone() for b in patches.split(traffic["batch"])]


def _mean_pool(params, x, v, *, attn_impl):
    """A fault: the attention-pool head replaced by the mean of the tokens."""
    return x.mean(dim=1)


def plant(fault: str, monkeypatch) -> None:
    """Plant a named fault in the program (for the control tool and tests):
    ``mean_pool``, the attention-pool head replaced by a token mean."""
    if fault != "mean_pool":
        raise ValueError(f"unknown fault {fault!r}")
    from team_tpu_torch.backbone import clip

    monkeypatch.setattr(clip, "_attention_pool", _mean_pool)


class System(EncodeSystem):
    """The runtime and its inputs for one run of an ``encode_siglip`` cell."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: torch.device,
                 families: List[Dict]):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.families = families
        self.shape = SiglipShape.from_config(cfg)
        self.items_per_step = traffic["batch"]
        self.int8 = False
        stamps = [time.perf_counter()]
        params = siglip_params(cfg, seed, device)
        self.pool = image_pool(traffic, self.shape, seed, device)
        _synced(device, stamps)
        self.runtime = program_runtime(cfg["runtime"], params, device)
        del params
        self._check_shape()
        _synced(device, stamps)
        self.phases = dict(zip(("weights_and_pool", "runtime"),
                               (b - a for a, b in zip(stamps, stamps[1:]))))
        self.committed: Optional[bool] = None
        self.gate_cosine: Optional[float] = None
        self.off_precision: Optional[float] = None
        self.refs: Dict[int, torch.Tensor] = {}

    def _check_shape(self) -> None:
        """The tower the runtime built has the configuration file's sizes and kind."""
        v, c = self.runtime.clip_cfg.vision, self.cfg["vision_config"]
        built = (v.image_size, v.patch_size, v.width, v.layers, v.heads, v.mlp, v.ln_eps, v.gelu,
                 v.class_token, v.ln_pre, v.pool, tuple(v.pixel_mean), tuple(v.pixel_std),
                 self.runtime.out_dim)
        stated = (c["image_size"], c["patch_size"], c["hidden_size"], c["num_hidden_layers"],
                  c["num_attention_heads"], c["intermediate_size"], c["layer_norm_eps"],
                  {"gelu_pytorch_tanh": "tanh"}.get(c["hidden_act"]), False, False,
                  "map" if c["vision_use_head"] else None, tuple(self.cfg["pixels"]["mean"]),
                  tuple(self.cfg["pixels"]["std"]), c["hidden_size"])
        s = self.shape
        counted = (s.image_size, s.patch_size, s.width, s.layers, s.heads, s.mlp_width, s.embed_dim)
        if built != stated or counted != tuple(stated[i] for i in (0, 1, 2, 3, 4, 5, 13)):
            raise ValueError(f"the runtime built a tower of {built}, the configuration states "
                             f"{stated} and its vision_cfg {counted}")

    def reference_features(self, indices: List[int], kind: Optional[str] = None):
        """The reference's features of the pool batches the window's steps
        ``indices`` sent, from the benchmark's weights drawn again from the seed."""
        params = siglip_params(self.cfg, self.seed, self.device)
        feats = reference.features(self.cfg, params, [self.pool[i % len(self.pool)] for i in indices],
                                   kind=kind)
        del params
        return feats

    def control(self, indices: List[int]) -> Dict[str, Any]:
        """``reference_fp8``: the reference with float8 e4m3 GEMM operands in
        the program's place, its largest row gap against :meth:`check`'s references."""
        kind, number = self.cfg["check"]["control"], self.cfg["check"]["number"]
        if kind != "reference_fp8":
            raise ValueError(f"unknown control {kind!r}")
        feats = self.reference_features(indices, kind="fp8")
        return {"control": max(worst_gap(number, f, self.refs[i]) for f, i in zip(feats, indices))}
