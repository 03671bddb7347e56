"""Multi-head attention front end over ``[B, H, S, Dh]``.

Counterpart of ``team_tpu/ops/attention.py:multi_head_attention`` and
``team_tpu/ops/flash_attention.py:xla_attention``: the plain route
(``impl="xla"``), the flash kernel (``impl="pallas"``,
:mod:`team_tpu_torch.ops.flash_attention`) and the pre-split kernel
(``impl="mha_short"``, :func:`team_tpu_torch.ops.mha_short.fused_mha_short`).
The towers reach the packed and fused kernels at the block level
(``team_tpu_torch.backbone.clip``).
"""

from __future__ import annotations

from typing import Optional

import torch

from team_tpu_torch.ops.flash_attention import flash_attention
from team_tpu_torch.ops.mha_short import fused_mha_short

NEG_INF = -1e30


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_len: Optional[int] = None, *, causal: bool = False) -> torch.Tensor:
    """Plain attention with an f32 softmax (``xla_attention``'s numerics:
    logits in f32, scaled after QKᵀ, probabilities cast to v's dtype)."""
    dh = q.shape[-1]
    s = q.shape[2]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dh ** -0.5)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask.tril()
    if kv_len is not None:
        mask = mask & (torch.arange(s, device=q.device) < kv_len)[None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: Optional[int] = None, *, causal: bool = False,
                         impl: str = "auto") -> torch.Tensor:
    """Scaled-dot-product attention over ``[B, H, S, Dh]``.

    ``pallas`` takes the flash kernel on the card and its plain version on the
    CPU; ``auto`` takes the flash kernel on the card from S >= 512 on, as on
    the TPU, and the plain route otherwise; ``mha_short`` takes the pre-split
    kernel (its plain version on the CPU), non-causal only; every other name
    takes the plain route, as in team_tpu (the block-level routes
    ``attn_block`` and ``mha_packed_proj`` reach here from the int8 tier)."""
    if impl == "auto":
        impl = "pallas" if (q.device.type == "cuda" and q.shape[2] >= 512) else "xla"
    if impl == "pallas":
        return flash_attention(q, k, v, kv_len, causal=causal)
    if impl == "mha_short":
        if causal:
            raise ValueError("the mha_short kernel is non-causal (the image tower only)")
        return fused_mha_short(q, k, v, kv_len)
    return xla_attention(q, k, v, kv_len, causal=causal)
