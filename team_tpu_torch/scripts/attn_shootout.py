"""Attention shoot-out at the CLIP shape (B=256, H=12, S=197, Dh=64, bf16).

Counterpart of ``scripts/attn_shootout.py``: each implementation runs
LAYERS layers chained as ``x = tanh(attn(x, x, x))`` over four inputs, and
its best round is printed per layer. ``MODE=all`` (the default; ``--mode``
overrides) times the port's plain attention
(:func:`team_tpu_torch.ops.attention.xla_attention`), the pre-split kernel
v1 (:func:`~team_tpu_torch.ops.mha_short.fused_mha_short`) and v2
(:func:`~team_tpu_torch.ops.mha_short.fused_mha_short_v2`) with a float32
and a bfloat16 exponential; any other mode times v2 with ``q_pad=128``
(the TPU's row alignment, which changes nothing on the card), both exps.

    python -m team_tpu_torch.scripts.attn_shootout                  # on the card
    python -m team_tpu_torch.scripts.attn_shootout --device cpu --batch 2 --layers 2

The inputs come from ``np.random.default_rng(0)`` and are uploaded before
the timing; times come from CUDA events on the card (the host clock on the
CPU, where the plain versions run).
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from team_tpu_torch.ops.attention import xla_attention
from team_tpu_torch.ops.mha_short import fused_mha_short, fused_mha_short_v2
from team_tpu_torch.parallel.layout import resolve_device
from team_tpu_torch.scripts._timing import best_seconds, device_name

B, H, S, D = 256, 12, 197, 64
LAYERS = 12
BF16 = torch.bfloat16


def implementations(mode: str) -> Dict[str, Callable]:
    """label -> attention over ``(q, k, v)``, the script's labels and order."""
    if mode == "all":
        return {
            "plain (xla_attention)": lambda q, k, v: xla_attention(q, k, v, S),
            "mha_short v1": lambda q, k, v: fused_mha_short(q, k, v, S),
            "mha_short v2 f32exp": lambda q, k, v: fused_mha_short_v2(q, k, v, S),
            "mha_short v2 bf16exp": lambda q, k, v: fused_mha_short_v2(q, k, v, S, exp_dtype=BF16),
        }
    return {
        "v2 qpad=128 (deferred norm)": lambda q, k, v: fused_mha_short_v2(q, k, v, S, q_pad=128),
        "v2 qpad=128 bf16exp": lambda q, k, v: fused_mha_short_v2(q, k, v, S, q_pad=128,
                                                                  exp_dtype=BF16),
    }


def make_inputs(batch: int, device: torch.device, n: int = 4, seed: int = 0) -> List[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal((batch, H, S, D)) * 0.3).astype(np.float32))
            .to(device=device, dtype=BF16) for _ in range(n)]


def chain(attn: Callable, x: torch.Tensor, layers: int) -> torch.Tensor:
    for _ in range(layers):
        x = torch.tanh(attn(x, x, x))  # re-mixes, so no two layers see one input
    return x


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N, or cpu")
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--layers", type=int, default=LAYERS)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--mode", default=os.environ.get("MODE", "all"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    xs = make_inputs(args.batch, device)
    print(f"# device: {device_name(device)}; B={args.batch} H={H} S={S} Dh={D} bf16", flush=True)
    ms = {}
    for label, attn in implementations(args.mode).items():
        best = best_seconds(lambda: [chain(attn, x, args.layers) for x in xs], device, args.rounds)
        ms[label] = best / len(xs) / args.layers * 1e3
        print(f"{label}: {ms[label]:.2f} ms/layer", flush=True)
    return ms


if __name__ == "__main__":
    main()
