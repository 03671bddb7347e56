"""Device-side image preprocessing.

Counterpart of ``team_tpu/ops/preprocess.py:preprocess_batch`` and
``patch_norm_consts``. Only the target size is ported: ``jax.image.resize``
is Keys cubic (a=-0.5) with antialiasing and torch's bicubic is not, so a
resize raises until it is held against JAX (ROADMAP, fault 3.2). The loader
already emits images at the tower's size.
"""

from __future__ import annotations

from typing import Tuple

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_batch(images_u8: torch.Tensor, image_size: int = 224,
                     flip: bool = False) -> torch.Tensor:
    """``[B, H, W, 3] uint8`` -> normalized ``[B, S, S, 3] float32``:
    /255, optional horizontal flip, CLIP mean/std."""
    _, h, w, _ = images_u8.shape
    if (h, w) != (image_size, image_size):
        raise NotImplementedError(
            f"resize {h}x{w} -> {image_size}x{image_size} is not ported: torch's "
            "bicubic differs from jax.image.resize (ROADMAP, fault 3.2)")
    # the arithmetic XLA compiles preprocess_batch to, so that the two agree
    # bit for bit: divisions by constants become products with float32
    # reciprocals, and u8 * (1/255) - mean is one fused multiply-add (exact
    # in float64, then rounded once to float32)
    dev = images_u8.device
    inv255 = torch.tensor(1.0, dtype=torch.float32) / 255.0
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32)
    inv_std = 1.0 / torch.tensor(CLIP_STD, dtype=torch.float32)
    x = (images_u8.double() * inv255.double().to(dev) - mean.double().to(dev)).float()
    x = x * inv_std.to(dev)
    return x.flip(2) if flip else x


def patch_norm_consts(patch_size: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column ``(scale, bias)`` of length ``3*ps*ps`` with
    ``u8 * scale + bias == (u8/255 - CLIP_MEAN)/CLIP_STD`` in the patch-pixel
    column order (channel-major) of ``team_tpu_torch.backbone.clip.patch_pixels``."""
    ps2 = patch_size * patch_size
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=device).repeat_interleave(ps2)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=device).repeat_interleave(ps2)
    return 1.0 / (255.0 * std), -mean / std
