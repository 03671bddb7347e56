"""Cross-modal self-attention fusion layer (counterpart of
``team_tpu/modules/fusion.py``).

q/k/v maps without bias, scaled-dot-product attention with dropout on the
probabilities, an output projection with dropout, then residual + LayerNorm.
The token sequence holds padded prototype and context slots, so attention
takes a key mask: padded keys get a -1e30 logit.

Dropout keeps are drawn from an explicit ``torch.Generator``, or the caller
passes them in (``keep_masks``): torch cannot draw the bits of ``jax.random``,
so a parity run hands the JAX learner's masks to the port.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

NEG_INF = -1e30
KeepMasks = Tuple[torch.Tensor, torch.Tensor]  # [B, H, S, S] probabilities, [B, S, D] output


def init_fusion(gen: torch.Generator, n_head: int, d_model: int, d_k: int, d_v: int) -> Dict:
    """Normal q/k/v maps and a xavier-normal output projection, with the JAX
    init's standard deviations."""
    std_qk = math.sqrt(2.0 / (d_model + d_k))
    std_v = math.sqrt(2.0 / (d_model + d_v))
    std_fc = math.sqrt(2.0 / (n_head * d_v + d_model))
    return {
        "w_qs": torch.randn((d_model, n_head * d_k), generator=gen) * std_qk,
        "w_ks": torch.randn((d_model, n_head * d_k), generator=gen) * std_qk,
        "w_vs": torch.randn((d_model, n_head * d_v), generator=gen) * std_v,
        "fc_w": torch.randn((n_head * d_v, d_model), generator=gen) * std_fc,
        "fc_b": torch.zeros(d_model),
        "ln": {"scale": torch.ones(d_model), "bias": torch.zeros(d_model)},
    }


def draw_keep_masks(batch: int, seq: int, d_model: int, n_head: int, rate: float,
                    generator: Optional[torch.Generator], device) -> KeepMasks:
    """Bernoulli(1 - rate) keeps for the two dropouts."""
    def keep(shape):
        return torch.rand(shape, generator=generator, device=device) < (1.0 - rate)

    return keep((batch, n_head, seq, seq)), keep((batch, seq, d_model))


def _dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def fusion_attention(params: Dict, x: torch.Tensor, key_mask: torch.Tensor, *, n_head: int = 1,
                     dropout_rate: float = 0.1, deterministic: bool = True,
                     keep_masks: Optional[KeepMasks] = None,
                     generator: Optional[torch.Generator] = None,
                     keep_shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Self-attention over ``x: [B, S, D]`` with ``key_mask: [S]`` (1 = real
    token). Returns ``[B, S, D]``; positions whose key mask is 0 carry garbage
    that callers exclude. Training (``deterministic=False``) applies both
    dropouts with ``keep_masks`` when given, else with keeps drawn from
    ``generator``. ``keep_shard=(rank, size)``: ``x`` is block ``rank`` of
    ``size`` equal blocks of a global batch, so the keeps are drawn for the
    global batch and this block's rows taken (the same draw however the
    batch is split)."""
    d_k = params["w_qs"].shape[1] // n_head
    d_v = params["w_vs"].shape[1] // n_head
    b, s, d_model = x.shape
    residual = x

    def heads(t, dh):
        return t.reshape(b, s, n_head, dh).permute(0, 2, 1, 3)

    q = heads(x @ params["w_qs"], d_k)
    k = heads(x @ params["w_ks"], d_k)
    v = heads(x @ params["w_vs"], d_v)
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d_k)
    logits = torch.where(key_mask[None, None, None, :] > 0, logits,
                         torch.full((), NEG_INF, dtype=logits.dtype, device=logits.device))
    attn = torch.softmax(logits, dim=-1)
    train = not deterministic and dropout_rate > 0.0
    if train and keep_masks is None:
        rank, size = keep_shard or (0, 1)
        keep_masks = tuple(m[rank * b:(rank + 1) * b] for m in draw_keep_masks(
            b * size, s, d_model, n_head, dropout_rate, generator, x.device))
    if train:
        attn = _dropout(attn, keep_masks[0], dropout_rate)
    out = torch.matmul(attn.to(v.dtype), v)
    out = out.permute(0, 2, 1, 3).reshape(b, s, n_head * d_v)
    out = out @ params["fc_w"] + params["fc_b"]
    if train:
        out = _dropout(out, keep_masks[1], dropout_rate)
    out = out + residual
    mean = out.mean(dim=-1, keepdim=True)
    var = out.var(dim=-1, keepdim=True, correction=0)
    out = (out - mean) * torch.rsqrt(var + 1e-5)
    return out * params["ln"]["scale"] + params["ln"]["bias"]
