"""Decompose the q3i attention kernel's time on the card.

Counterpart of ``scripts/r4_attn_decomp.py``: the packed q3i kernel's static
softmax, ones-column route cut into variants
(:func:`team_tpu_torch.ops.mha_short.fused_mha_q3i_variant`,
``csrc/mha_packed_q3i.cu``), each timed over LAYERS chained calls with an
int8 mixer between layers (the output tiled back to the qkv width with a
shift, so no two layer inputs are alike):

  copy    the q segment copied: the floor of reading q and writing out
  full    the production kernel (static softmax, ones-column row sum)
  noexp   full with exp2 removed (bounds the exp2 cost)
  qkonly  q.k alone, its first Dh keys written per head (no softmax, no PV)
  nopv    the softmax, its first Dh keys written (no PV)

    python -m team_tpu_torch.scripts.r4_attn_decomp                 # on the card
    python -m team_tpu_torch.scripts.r4_attn_decomp --device cpu --batch 2 --layers 2

The inputs are the script's, from ``np.random.default_rng(0)``, uploaded
before the timing. Times come from CUDA events on the card (the host clock
on the CPU, where the plain versions run).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from team_tpu_torch.ops.mha_short import fused_mha_q3i_variant
from team_tpu_torch.parallel.layout import resolve_device
from team_tpu_torch.scripts._timing import best_seconds, device_name

B, S, H, DH = 256, 197, 12, 64
D = H * DH
D3 = 3 * D
LAYERS = 12
VARIANTS = ("copy", "full", "noexp", "qkonly", "nopv")


def make_inputs(batch: int, device: torch.device, seed: int = 0):
    """The script's inputs: int8 qkv ``[batch, S, 3D]`` in [-80, 80], qks
    ``[1, H]`` in [1e-4, 2e-4], qkm2 ``[1, H]`` in [4, 7], oinv ``[1, D]`` in
    [20, 60], drawn in that order."""
    rng = np.random.default_rng(seed)
    qkv = rng.integers(-80, 81, (batch, S, D3), dtype=np.int8)
    qks = rng.uniform(1e-4, 2e-4, (1, H)).astype(np.float32)
    qkm2 = rng.uniform(4, 7, (1, H)).astype(np.float32)
    oinv = rng.uniform(20, 60, (1, D)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (qkv, qks, qkm2, oinv))


def chain(variant: str, qkv: torch.Tensor, qks: torch.Tensor, qkm2: torch.Tensor,
          oinv: torch.Tensor, layers: int) -> torch.Tensor:
    """``layers`` calls of the variant; between them the output ``[B, S, D]``
    becomes the next qkv as ``[o, roll(o, i+1), roll(o, -(i+1))]`` along the
    feature axis, rolled along the sequence."""
    x = qkv
    o = qkv
    for i in range(layers):
        o = fused_mha_q3i_variant(x, qks, qkm2, oinv, H, variant)
        x = torch.cat([o, torch.roll(o, i + 1, dims=1), torch.roll(o, -(i + 1), dims=1)], dim=-1)
    return o


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N, or cpu")
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--layers", type=int, default=LAYERS)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    inputs = make_inputs(args.batch, device)
    print(f"# device: {device_name(device)}; B={args.batch} S={S} H={H} Dh={DH}", flush=True)
    ms = {}
    for variant in VARIANTS:
        best = best_seconds(lambda: chain(variant, *inputs, args.layers), device, args.rounds)
        ms[variant] = best * 1e3 / args.layers
        print(f"{variant:8s} {ms[variant]:7.3f} ms/layer "
              f"({best * 1e3:.1f} ms / {args.layers} layers)", flush=True)
    return ms


if __name__ == "__main__":
    main()
