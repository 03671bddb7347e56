"""Device-side image preprocessing.

Counterpart of ``team_tpu/ops/preprocess.py``:
- ``preprocess_batch``: /255, a bicubic resize when the input is not at the
  target size, the optional flip, the tower's mean/std (CLIP's by default;
  SigLIP's 0.5/0.5). The resize is
  ``jax.image.resize(..., "bicubic")``'s: Keys cubic (a = -0.5) with
  antialiasing, as two separable float32 contractions with the weight
  matrices that ``jax/_src/image/scale.py:compute_weight_mat`` builds.
  torch's ``F.interpolate(mode="bicubic")`` is another filter (a = -0.75, no
  antialias) and is not used.
- ``patch_norm_consts``: the per-column constants of the patch-major route.
- ``normalize_uint8_kernel`` (TPU kernel ``_normalize_kernel``): u8 to the
  normalised float32 in one pass over device memory, hand-written CUDA kernel
  ``csrc/preprocess.cu``; its plain version ``normalize_uint8_plain``.
  Library API only, as in team_tpu: no runtime path calls it.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Tuple

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
_SOURCE = "preprocess.cu"


@contextlib.contextmanager
def _full_f32_matmul():
    """Float32 products in full float32 on the card (no TF32) for the block,
    whatever the caller set: ``jax.image.resize`` contracts at HIGHEST."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 at distances ``x >= 0``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(in_size: int, out_size: int) -> torch.Tensor:
    """The ``[in_size, out_size]`` float32 weights of a bicubic resize along
    one axis, step by step as ``compute_weight_mat`` (scale out/in, no
    translation, antialias): sample positions ``(i + 0.5)/scale - 0.5``, the
    kernel widened by 1/scale when downsampling, each column divided by its
    sum, and columns whose sample lies outside ``[-0.5, in - 0.5]`` zeroed."""
    f32 = torch.float32
    scale = torch.tensor(out_size / in_size, dtype=f32)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.0 * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs() / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``[B, H, W, C]`` float32 -> ``[B, out_h, out_w, C]``: the axes whose
    size changes are contracted with :func:`resize_weights` in float32 (H
    first, then W), as ``jax.image.resize(..., "bicubic")``."""
    _, h, w, _ = x.shape
    with _full_f32_matmul():
        if h != out_h:
            x = torch.einsum("bhwc,hs->bswc", x, resize_weights(h, out_h).to(x.device))
        if w != out_w:
            x = torch.einsum("bhwc,wt->bhtc", x, resize_weights(w, out_w).to(x.device))
    return x


def preprocess_batch(images_u8: torch.Tensor, image_size: int = 224,
                     flip: bool = False, mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """``[B, H, W, 3] uint8`` -> normalized ``[B, S, S, 3] float32``:
    /255, a bicubic resize to ``S x S`` when the input is another size,
    optional horizontal flip, the per-channel ``mean``/``std`` (CLIP's by
    default). The tower's patch GEMM drops what its patches do not cover."""
    _, h, w, _ = images_u8.shape
    dev = images_u8.device
    if (h, w) != (image_size, image_size):
        # team_tpu's steps in order: /255, resize, flip, (x - mean)/std
        x = resize_bicubic(images_u8.float() / 255.0, image_size, image_size)
        if flip:
            x = x.flip(2)
        mean_t = torch.tensor(mean, dtype=torch.float32, device=dev)
        std_t = torch.tensor(std, dtype=torch.float32, device=dev)
        return (x - mean_t) / std_t
    # at the target size, the arithmetic XLA compiles preprocess_batch to, so
    # that the two agree bit for bit: divisions by constants become products
    # with float32 reciprocals, and u8 * (1/255) - mean is one fused
    # multiply-add (exact in float64, then rounded once to float32)
    inv255 = torch.tensor(1.0, dtype=torch.float32) / 255.0
    mean = torch.tensor(mean, dtype=torch.float32)
    inv_std = 1.0 / torch.tensor(std, dtype=torch.float32)
    x = (images_u8.double() * inv255.double().to(dev) - mean.double().to(dev)).float()
    x = x * inv_std.to(dev)
    return x.flip(2) if flip else x


def patch_norm_consts(patch_size: int, device=None, mean=CLIP_MEAN,
                      std=CLIP_STD) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column ``(scale, bias)`` of length ``3*ps*ps`` with
    ``u8 * scale + bias == (u8/255 - mean)/std`` (CLIP's by default) in the
    patch-pixel column order (channel-major) of
    ``team_tpu_torch.backbone.clip.patch_pixels``."""
    ps2 = patch_size * patch_size
    mean = torch.tensor(mean, dtype=torch.float32, device=device).repeat_interleave(ps2)
    std = torch.tensor(std, dtype=torch.float32, device=device).repeat_interleave(ps2)
    return 1.0 / (255.0 * std), -mean / std


# ---------------------------------------------------------------------------
# the one-pass u8 normalize (TPU kernel _normalize_kernel)
# ---------------------------------------------------------------------------

def normalize_constants() -> Tuple[float, Tuple[float, ...], Tuple[float, ...]]:
    """The float32 constants of ``_normalize_kernel`` as XLA compiles it:
    ``f32(1/255)``, ``f32(mean_c)`` and ``f32(1/std_c)`` with the reciprocal
    taken in float64 (the kernel's Python-float ``1.0 / CLIP_STD[c]``)."""
    inv255 = float(np.float32(1.0 / 255.0))
    mean = tuple(float(np.float32(m)) for m in CLIP_MEAN)
    inv_std = tuple(float(np.float32(1.0 / s)) for s in CLIP_STD)
    return inv255, mean, inv_std


def normalize_uint8_plain(images_u8: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``_normalize_kernel``:
    ``f32(fma(u, f32(1/255), -f32(mean_c))) * f32(1/std_c)``, the multiply-add
    rounded once (exact in float64, then to float32), as XLA contracts it."""
    inv255, mean, inv_std = normalize_constants()
    dev = images_u8.device
    mean_t = torch.tensor(mean, dtype=torch.float64, device=dev)
    inv_std_t = torch.tensor(inv_std, dtype=torch.float32, device=dev)
    x = (images_u8.double() * inv255 - mean_t).float()
    return x * inv_std_t


def _library() -> ctypes.CDLL:
    from team_tpu_torch.ops._build import load_library

    lib = load_library(_SOURCE)
    # in, out; elements; 1/255, mean[3], 1/std[3]; stream
    lib.team_normalize_u8_fwd.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                                          + [ctypes.c_float] * 7 + [ctypes.c_void_p])
    lib.team_normalize_u8_fwd.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load this module's kernel now (set-up)."""
    _library()


def normalize_uint8_kernel(images_u8: torch.Tensor) -> torch.Tensor:
    """``[B, S, S, 3]`` uint8 -> ``(u8/255 - CLIP_MEAN) / CLIP_STD`` float32
    in one pass, with ``_normalize_kernel``'s roundings
    (:func:`normalize_uint8_plain`). Each kernel launch adds one to
    ``normalize_uint8_kernel.launches``."""
    if images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"images must be [B, S, S, 3], got {tuple(images_u8.shape)}")
    if images_u8.dtype != torch.uint8:
        raise TypeError(f"images must be uint8, got {images_u8.dtype}")
    if images_u8.device.type == "cpu":
        return normalize_uint8_plain(images_u8)
    if images_u8.device.type != "cuda":
        raise ValueError(f"normalize_uint8_kernel runs on CPU or CUDA tensors, got "
                         f"{images_u8.device}")
    if not images_u8.is_contiguous() or images_u8.data_ptr() % 4:
        raise ValueError("images must be contiguous and 4-byte aligned")
    lib = _library()
    inv255, mean, inv_std = normalize_constants()
    out = torch.empty(images_u8.shape, dtype=torch.float32, device=images_u8.device)
    with torch.cuda.device(images_u8.device):
        err = lib.team_normalize_u8_fwd(images_u8.data_ptr(), out.data_ptr(), images_u8.numel(),
                                        inv255, *mean, *inv_std,
                                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"normalize_u8 kernel launch failed: cudaError {err}")
    normalize_uint8_kernel.launches += 1
    return out


normalize_uint8_kernel.launches = 0
