"""Host-side image transforms (PIL-based, torchvision-free).

Counterpart of the reference transform builders (``utils/data.py:70-102``):

* :func:`clip_transform` — the deterministic CLIP pipeline used by IIMinsects202
  for BOTH train and test (``build_transform`` ignores ``is_train``): Resize to
  (224, 224) bicubic → CenterCrop(224) (no-op after exact resize) → scale to
  [0, 1] → normalize with the CLIP mean/std. Determinism is what makes frozen-
  backbone feature caching across epochs numerically exact on TPU.
* :func:`vit_train_transform` — RandomResizedCrop(scale 0.05–1, ratio ¾–4/3) +
  horizontal flip, the ``build_transform_vit`` train pipeline (``:70-82``).

Outputs are NHWC float32 numpy arrays, ready for device upload. A fused
device-side variant of normalize lives in :mod:`team_tpu_torch.ops.preprocess`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
from PIL import Image

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def _to_float(img: Image.Image) -> np.ndarray:
    return np.asarray(img, dtype=np.float32) / 255.0


def _normalize(x: np.ndarray, mean=CLIP_MEAN, std=CLIP_STD) -> np.ndarray:
    return (x - mean) / std


def center_crop(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def clip_transform(img: Image.Image, image_size: int = 224, normalize: bool = True,
                   mean=CLIP_MEAN, std=CLIP_STD) -> np.ndarray:
    """Deterministic CLIP preprocess (reference ``utils/data.py:94-102``);
    ``mean``/``std``: the tower's pixel statistics (CLIP's by default)."""
    img = img.convert("RGB").resize((image_size, image_size), Image.BICUBIC)
    img = center_crop(img, image_size)
    x = _to_float(img)
    return _normalize(x, mean, std) if normalize else x


def flip_transform(img: Image.Image, image_size: int = 224, mean=CLIP_MEAN,
                   std=CLIP_STD) -> np.ndarray:
    """Test pipeline + forced horizontal flip (reference ``data_manager.py:64-71``)."""
    img = img.convert("RGB").resize((image_size, image_size), Image.BICUBIC)
    img = center_crop(img, image_size).transpose(Image.FLIP_LEFT_RIGHT)
    return _normalize(_to_float(img), mean, std)


def random_resized_crop(
    img: Image.Image,
    size: int,
    rng: np.random.Generator,
    scale: Tuple[float, float] = (0.05, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> Image.Image:
    """torchvision-equivalent RandomResizedCrop sampling (10 tries then fallback)."""
    w, h = img.size
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            return img.crop((left, top, left + cw, top + ch)).resize((size, size), Image.BILINEAR)
    # fallback: center crop at clamped aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    left, top = (w - cw) // 2, (h - ch) // 2
    return img.crop((left, top, left + cw, top + ch)).resize((size, size), Image.BILINEAR)


def vit_train_transform(img: Image.Image, image_size: int = 224,
                        rng: Optional[np.random.Generator] = None,
                        normalize: bool = False, mean=CLIP_MEAN, std=CLIP_STD) -> np.ndarray:
    """RandomResizedCrop + HFlip train pipeline (reference ``utils/data.py:70-82``;
    no Normalize there, hence ``normalize=False`` default)."""
    rng = rng or np.random.default_rng()
    img = img.convert("RGB")
    img = random_resized_crop(img, image_size, rng)
    if rng.uniform() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    x = _to_float(img)
    return _normalize(x, mean, std) if normalize else x


def get_transform(mode: str, deterministic_train: bool = True) -> Callable[..., np.ndarray]:
    """mode: train | test | flip. IIMinsects202 uses the deterministic CLIP
    pipeline for train as well (reference ``utils/data.py:477-479``)."""
    if mode == "flip":
        return flip_transform
    if mode == "train" and not deterministic_train:
        return lambda img, rng=None: vit_train_transform(img, rng=rng, normalize=True)
    return clip_transform
