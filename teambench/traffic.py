"""The one generator of the benchmark's inputs, driven by a traffic file.

A traffic file (``traffic/<name>.json``) holds only parameters:

- ``batch``: images per ``encode_image`` call; ``pool_batches``: distinct
  batches kept on the device, sent in turn (their bytes outgrow the L2 cache);
- ``images``: ``grid`` (a random ``grid x grid`` colour field per image,
  bilinearly upsampled to the model's size) and ``noise`` (uniform pixel
  noise of that amplitude on top), as uint8 in the patch-major layout
  ``[B, g*g, 3*ps*ps]`` that the learners' loader ships (``patch_major_io``);
- ``calibration_batch``, ``gate_batch``: the pool batches an int8 tower
  calibrates on and gates on during set-up; ``warmup_batches``;
- ``check``: ``batches`` compared with the reference, drawn from the seed
  among the window's first ``from_first``;
- ``trace``: ``host_batches`` (each dispatched on an idle device, for the
  host's time per call) and ``batches`` (the profiled window).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from teambench.work import VisionShape

# streams of random numbers drawn from one seed
WEIGHTS, IMAGES, CHECK = 1, 2, 3


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number)."""
    return (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % (1 << 63)


def image_pool(traffic: Dict, shape: VisionShape, seed: int, device) -> List[torch.Tensor]:
    """``pool_batches`` contiguous uint8 batches ``[batch, g*g, 3*ps*ps]``,
    drawn on ``device`` from the seed in a few large calls."""
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
    # [N, C, gh, ph, gw, pw] -> [N, gh, gw, C, ph, pw]: channel-major inside a patch
    patches = u8.reshape(n, 3, g_n, ps, g_n, ps).permute(0, 2, 4, 1, 3, 5)
    patches = patches.reshape(n, g_n * g_n, 3 * ps * ps).contiguous()
    return [b.clone() for b in patches.split(traffic["batch"])]


def check_sample(traffic: Dict, seed: int, n_batches: int) -> List[int]:
    """The window's batches compared with the reference, drawn from the seed
    among its first ``check.from_first`` (all ``n_batches`` if fewer ran)."""
    spec = traffic["check"]
    span = min(spec["from_first"], n_batches)
    g = torch.Generator().manual_seed(sub_seed(seed, CHECK))
    return sorted(torch.randperm(span, generator=g)[:spec["batches"]].tolist())
