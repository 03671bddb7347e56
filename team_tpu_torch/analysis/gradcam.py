"""Grad-CAM-style saliency for the CLIP image tower (counterpart of
``team_tpu/analysis/gradcam.py``).

``cam[p] = ReLU(Σ_c dscore/dA[p, c] · A[p, c])`` over the g×g patch grid,
where A are the patch tokens (the output of the patch embedding) and
``score`` is the summed cosine of the image embeddings with a target
direction (a class text feature, say). One ``torch.autograd.grad`` against
the patch tokens gives it, as ``jax.grad`` does in team_tpu.

On a kernel route the gradient goes through the kernels' backwards
(:mod:`team_tpu_torch.ops._grad`): ``auto`` and ``mha_packed`` through
#1's, ``mha_short`` through #3's, ``attn_block`` through #13's and
``pallas`` through #14's, each recomputing the plain attention.
"""

from __future__ import annotations

import torch

from team_tpu_torch.backbone.clip import CLIPConfig, Params, embed_patches, encode_from_patches
from team_tpu_torch.utils.jmath import l2_normalize


def grad_cam(params: Params, images: torch.Tensor, target: torch.Tensor, cfg: CLIPConfig, *,
             attn_impl: str = "xla") -> torch.Tensor:
    """``images [B, H, W, 3]`` (normalized), ``target [D]`` or ``[B, D]``
    direction(s) -> saliency maps ``[B, g, g]`` normalized to [0, 1]
    (float32, on the images' device)."""
    with torch.enable_grad():
        tokens = embed_patches(params, images, cfg).detach().requires_grad_(True)
        tgt = target if target.dim() == 2 else target.expand(images.shape[0], -1)
        tgt = l2_normalize(tgt.float())
        feats = l2_normalize(encode_from_patches(params, tokens, cfg, attn_impl=attn_impl))
        (grads,) = torch.autograd.grad((feats * tgt).sum(), tokens)  # [B, g*g, width]
    cam = torch.relu((grads * tokens.detach()).sum(dim=-1))
    g = cfg.vision.grid
    cam = cam.reshape(-1, g, g)
    lo = cam.amin(dim=(1, 2), keepdim=True)
    hi = cam.amax(dim=(1, 2), keepdim=True)
    return (cam - lo) / torch.clamp(hi - lo, min=1e-12)
