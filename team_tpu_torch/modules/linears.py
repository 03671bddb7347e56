"""Cosine-similarity classifier head with preallocated class slots.

Counterpart of ``team_tpu/modules/linears.py``: ``logits = sigma *
normalize(x) @ normalize(W)ᵀ`` over a ``[max_classes, D]`` weight bank whose
inactive rows are masked to ``NEG_INF``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-24) -> torch.Tensor:
    """``x / sqrt(max(sum(x^2), eps))`` (``team_tpu/utils/jmath.py:l2_normalize``):
    ``eps`` clamps the squared norm, which keeps the gradient finite at 0."""
    sq = (x * x).sum(dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps))


def init_cosine_linear(gen: torch.Generator, max_classes: int, in_features: int,
                       device: torch.device):
    """Uniform(-stdv, stdv) with stdv = 1/sqrt(in), sigma = 1 (the reference init)."""
    stdv = 1.0 / in_features ** 0.5
    weight = (torch.rand((max_classes, in_features), generator=gen) * 2 - 1) * stdv
    return {"weight": weight.to(device), "sigma": torch.ones((), device=device)}


def cosine_linear_forward(params, x: torch.Tensor, class_mask: torch.Tensor) -> torch.Tensor:
    """``x: [B, D]`` -> masked logits ``[B, max_classes]``."""
    logits = params["sigma"] * (l2_normalize(x) @ l2_normalize(params["weight"]).T)
    return torch.where(class_mask[None, :] > 0, logits, torch.full_like(logits, NEG_INF))


def set_class_weights(params, class_means: torch.Tensor, class_ids: torch.Tensor):
    """SimpleCIL prototype replacement: write class-mean embeddings into the
    rows of ``class_ids`` (a new bank; ``params`` is left as it was)."""
    weight = params["weight"].clone()
    weight[class_ids] = class_means.to(weight.dtype)
    return {**params, "weight": weight}
