"""Multi-head attention front end over ``[B, H, S, Dh]``.

Counterpart of ``team_tpu/ops/attention.py:multi_head_attention`` and
``team_tpu/ops/flash_attention.py:xla_attention``. Only the plain route
(``impl="xla"``) is ported; the towers reach the packed kernel at the block
level (``team_tpu_torch.backbone.clip._block_forward``).
"""

from __future__ import annotations

from typing import Optional

import torch

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

    ``auto`` takes the plain route on the CPU. On the card it would take the
    flash kernel from S >= 512 on, as on the TPU, and that kernel is not ported
    yet, so it raises there, as ``pallas`` and ``mha_short`` do everywhere."""
    if impl == "auto":
        if q.device.type == "cpu" or q.shape[2] < 512:
            impl = "xla"
        else:
            impl = "pallas"
    if impl == "pallas":
        raise NotImplementedError(
            "the flash attention kernel (team_tpu/ops/flash_attention.py) is not "
            "ported yet: ROADMAP queue 2 item 4")
    if impl == "mha_short":
        raise NotImplementedError(
            "the fused_mha_short kernel is not ported yet: ROADMAP queue 2 item 5")
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    return xla_attention(q, k, v, kv_len, causal=causal)
