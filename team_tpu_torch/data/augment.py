"""Augmentation op library.

Counterpart of reference ``utils/ops.py:5-121`` (Cutout + the AutoAugment-style
PIL op set; note the reference never wires these into any transform pipeline —
they are provided here as a usable library, selectable via config
``extras['augment_ops']`` on the train pipeline).

PIL ops (host-side, per-sample) matching the reference op semantics, and
``cutout_batch``, Cutout over a float batch on its device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image, ImageEnhance, ImageOps


FILL = (128, 128, 128)  # the reference's gray fillcolor (utils/ops.py:34 etc.)


def cutout(img: Image.Image, length: int, rng: np.random.Generator) -> Image.Image:
    """Zero a random length² square around a uniform center, clamped at borders
    (reference ``Cutout.__call__``: side = 2·(length//2), utils/ops.py:10-30)."""
    arr = np.asarray(img).copy()
    h, w = arr.shape[:2]
    y, x = int(rng.integers(h)), int(rng.integers(w))
    y1, y2 = np.clip(y - length // 2, 0, h), np.clip(y + length // 2, 0, h)
    x1, x2 = np.clip(x - length // 2, 0, w), np.clip(x + length // 2, 0, w)
    arr[y1:y2, x1:x2] = 0
    return Image.fromarray(arr)


def shear_x(img, v):  # v in [-0.3, 0.3] (signed; ref randomizes the sign)
    return img.transform(img.size, Image.AFFINE, (1, v, 0, 0, 1, 0),
                         Image.BICUBIC, fillcolor=FILL)


def shear_y(img, v):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, v, 1, 0),
                         Image.BICUBIC, fillcolor=FILL)


def translate_x(img, v):  # v: signed fraction of width
    return img.transform(img.size, Image.AFFINE, (1, 0, v * img.size[0], 0, 1, 0),
                         fillcolor=FILL)


def translate_y(img, v):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, v * img.size[1]),
                         fillcolor=FILL)


def rotate(img, v):  # degrees; composite onto gray like the reference (:73-76)
    rot = img.convert("RGBA").rotate(v)
    return Image.composite(rot, Image.new("RGBA", rot.size, (128,) * 4), rot).convert(img.mode)


def color(img, v):
    return ImageEnhance.Color(img).enhance(v)


def posterize(img, v):
    return ImageOps.posterize(img, max(1, int(v)))


def solarize(img, v):
    return ImageOps.solarize(img, int(v))


def contrast(img, v):
    return ImageEnhance.Contrast(img).enhance(v)


def sharpness(img, v):
    return ImageEnhance.Sharpness(img).enhance(v)


def brightness(img, v):
    return ImageEnhance.Brightness(img).enhance(v)


def auto_contrast(img, _v=None):
    return ImageOps.autocontrast(img)


def equalize(img, _v=None):
    return ImageOps.equalize(img)


def invert(img, _v=None):
    return ImageOps.invert(img)


# op name -> (fn, value range)
AUGMENT_OPS: Dict[str, Tuple[Callable, Optional[Tuple[float, float]]]] = {
    "shear_x": (shear_x, (-0.3, 0.3)),
    "shear_y": (shear_y, (-0.3, 0.3)),
    "translate_x": (translate_x, (-0.45, 0.45)),
    "translate_y": (translate_y, (-0.45, 0.45)),
    "rotate": (rotate, (-30.0, 30.0)),
    "color": (color, (0.1, 1.9)),
    "posterize": (posterize, (4, 8)),
    "solarize": (solarize, (0, 256)),
    "contrast": (contrast, (0.1, 1.9)),
    "sharpness": (sharpness, (0.1, 1.9)),
    "brightness": (brightness, (0.1, 1.9)),
    "auto_contrast": (auto_contrast, None),
    "equalize": (equalize, None),
    "invert": (invert, None),
}


def random_augment(img: Image.Image, rng: np.random.Generator,
                   ops: Optional[Sequence[str]] = None, n: int = 2) -> Image.Image:
    """Apply ``n`` randomly chosen ops with random magnitudes, RandAugment-style,
    over the reference op set."""
    names: List[str] = list(ops or AUGMENT_OPS.keys())
    for name in rng.choice(names, size=n, replace=False):
        fn, rng_range = AUGMENT_OPS[name]
        if rng_range is None:
            img = fn(img)
        else:
            lo, hi = rng_range
            img = fn(img, float(rng.uniform(lo, hi)))
    return img



def cutout_mask(height: int, width: int, ys: torch.Tensor, xs: torch.Tensor,
                lengths) -> torch.Tensor:
    """``[B, H, W]`` bool: for each image b the square of side
    ``2·(lengths[b] // 2)`` centred on ``(ys[b], xs[b])``, clipped at the
    borders (``cutout_batch``'s geometry, for given centres)."""
    half = torch.as_tensor(lengths, device=ys.device).reshape(-1, 1, 1) // 2
    row = torch.arange(height, device=ys.device)[None, :, None]
    col = torch.arange(width, device=ys.device)[None, None, :]
    y, x = ys.reshape(-1, 1, 1), xs.reshape(-1, 1, 1)
    return (row >= y - half) & (row < y + half) & (col >= x - half) & (col < x + half)


def cutout_batch(images: torch.Tensor, lengths, seed: int = 0) -> torch.Tensor:
    """Cutout on a ``[B, H, W, C]`` float batch, on its device: each image's
    square (:func:`cutout_mask`) set to 0, its centre uniform over the image.
    The centres come from a ``torch.Generator`` seeded by ``seed`` (team_tpu
    draws them with ``jax.random``, whose bits torch cannot reproduce)."""
    b, h, w, _ = images.shape
    gen = torch.Generator().manual_seed(int(seed))
    ys = torch.randint(0, h, (b,), generator=gen).to(images.device)
    xs = torch.randint(0, w, (b,), generator=gen).to(images.device)
    mask = cutout_mask(h, w, ys, xs, lengths)
    return torch.where(mask[..., None], torch.zeros((), dtype=images.dtype, device=images.device),
                       images)
