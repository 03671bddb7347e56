"""Multi-head attention front end over ``[B, H, S, Dh]``.

Counterpart of ``team_tpu/ops/attention.py:multi_head_attention``: the plain
route (``impl="xla"``, :func:`team_tpu_torch.ops.flash_attention.xla_attention`,
beside the flash kernel as in team_tpu), the flash kernel (``impl="pallas"``,
:mod:`team_tpu_torch.ops.flash_attention`) and the pre-split kernel
(``impl="mha_short"``, :func:`team_tpu_torch.ops.mha_short.fused_mha_short`).
The towers reach the packed and fused kernels at the block level
(``team_tpu_torch.backbone.clip``).
"""

from __future__ import annotations

from typing import Optional

import torch

from team_tpu_torch.ops.flash_attention import NEG_INF, flash_attention, xla_attention  # noqa: F401
from team_tpu_torch.ops.mha_short import fused_mha_short


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
