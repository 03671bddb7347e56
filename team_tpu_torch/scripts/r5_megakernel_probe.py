"""The int8 MLP pair as one megakernel against its torch composition.

Counterpart of ``scripts/r5_megakernel_probe.py``: the MLP pair of the int8
tower (fc -> tanh GELU -> static requantize -> proj) at B=256, S=197,
K=768, N=3072, over LAYERS=12 chained pairs (a requantize between pairs,
the same for every variant) on N_INPUTS=4 independent inputs:

  xla     the torch composition, the script's XLA form: torch._int_mm -> ·s1
          -> gelu (tanh) -> requantize -> torch._int_mm -> ·s2 -> bf16, the
          int8 intermediate through device memory (the baseline)
  mk2d*   :func:`team_tpu_torch.ops.gemm_probe.mlp_mega_2d` on the [B·S, K] rows
  mk3d*   :func:`team_tpu_torch.ops.gemm_probe.mlp_mega_3d` on [B, S, K]

Every ``mk*`` name runs the one kernel (``csrc/gemm_probe.cu``: 64 rows a
CTA, the intermediate in shared memory); the TPU's block_m (``mk2d256``) and
block_b (``mk3d8``) are kept as names and change nothing on the card.

    python -m team_tpu_torch.scripts.r5_megakernel_probe            # on the card
    python -m team_tpu_torch.scripts.r5_megakernel_probe --device cpu --batch 2 --layers 1 --inputs 1

The inputs are the script's, from ``np.random.default_rng(0)``: w1, w2, then
the inputs, int8 in [-127, 127]; s1 = s2 = 2e-4, qi = 30. They are uploaded,
and the weights laid out column-major, before the timing. Reports ms/pair,
TOPS over the pair's 2·B·S·K·N·2 operations and maxerr against the first
variant (its first input's first 4096 outputs). Times come from CUDA events
on the card (the host clock on the CPU, where the plain versions run).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from team_tpu_torch.ops.gemm_probe import column_major, mlp_mega_2d, mlp_mega_3d
from team_tpu_torch.ops.int8_matmul import int8_matmul
from team_tpu_torch.parallel.layout import resolve_device
from team_tpu_torch.scripts._timing import best_seconds, device_name

B, S, K, N = 256, 197, 768, 3072
LAYERS = 12
N_INPUTS = 4
VARIANTS = "xla,mk2d256,mk2d512,mk2d1024,mk3d8,mk3d16"


def make_inputs(batch: int, n_inputs: int, device: torch.device, seed: int = 0):
    """(w1 [K, N], s1, w2 [N, K], s2, qi) and the int8 inputs [batch, S, K];
    w1 and w2 column-major."""
    rng = np.random.default_rng(seed)
    w1 = rng.integers(-127, 128, (K, N), dtype=np.int8)
    w2 = rng.integers(-127, 128, (N, K), dtype=np.int8)
    inputs = [rng.integers(-127, 128, (batch, S, K), dtype=np.int8) for _ in range(n_inputs)]
    params = (column_major(torch.from_numpy(w1).to(device)),
              torch.full((1, N), 2e-4, dtype=torch.float32, device=device),
              column_major(torch.from_numpy(w2).to(device)),
              torch.full((1, K), 2e-4, dtype=torch.float32, device=device),
              torch.full((1, N), 30.0, dtype=torch.float32, device=device))
    w1_, s1, w2_, s2, qi = params
    return (w1_, s1, w2_, s2, qi), [torch.from_numpy(x).to(device) for x in inputs]


def xla_pair(x_q, w1, s1, w2, s2, qi) -> torch.Tensor:
    """The script's ``xla_pair`` as a torch composition (plain PyTorch, as it
    is XLA in the script)."""
    lead = x_q.shape[:-1]
    acc1 = int8_matmul(x_q.reshape(-1, x_q.shape[-1]), w1)
    h = F.gelu(acc1.float() * s1.reshape(1, -1), approximate="tanh")
    hq = torch.clamp(torch.round(h * qi.reshape(1, -1)), -127, 127).to(torch.int8)
    acc2 = int8_matmul(hq, w2)
    return (acc2.float() * s2.reshape(1, -1)).to(torch.bfloat16).reshape(*lead, -1)


def make_chain(pair_fn, three_d: bool, layers: int):
    def f(x8, w1, s1, w2, s2, qi):
        q = x8 if three_d else x8.reshape(-1, K)
        for _ in range(layers):
            y = pair_fn(q, w1, s1, w2, s2, qi)
            # the requantize between pairs (defeats folding; the same for every variant)
            q = torch.clamp(torch.round(y.float() * 0.25), -127, 127).to(torch.int8)
        return y

    return f


def variant_fn(v: str, layers: int):
    if v == "xla":
        return make_chain(xla_pair, True, layers)
    if v.startswith("mk2d"):
        bm = int(v[4:] or "512")
        return make_chain(lambda *a: mlp_mega_2d(*a, block_m=bm), False, layers)
    if v.startswith("mk3d"):
        bb = int(v[4:] or "8")
        return make_chain(lambda *a: mlp_mega_3d(*a, block_b=bb), True, layers)
    raise SystemExit(f"unknown variant {v}")


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N, or cpu")
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--layers", type=int, default=LAYERS)
    ap.add_argument("--inputs", type=int, default=N_INPUTS)
    ap.add_argument("--variants", default=VARIANTS)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    params, inputs = make_inputs(args.batch, args.inputs, device)
    pair_ops = 2 * args.batch * S * K * N * 2
    print(f"# device: {device_name(device)}; B={args.batch} S={S} K={K} N={N}, {args.layers} "
          f"pairs, {args.inputs} inputs; every mk* variant runs the one kernel (mlp_mega_2d on "
          "[B*S, K], mlp_mega_3d on [B, S, K]); block_m/block_b change nothing", flush=True)
    res = {}
    ref = None
    for v in args.variants.split(","):
        fn = variant_fn(v, args.layers)
        got = fn(inputs[0], *params).float().reshape(-1)[:4096]
        err = 0.0 if ref is None else float((got - ref).abs().max())
        ref = got if ref is None else ref
        best = best_seconds(lambda: [fn(x, *params) for x in inputs], device, args.rounds)
        per = best / (args.inputs * args.layers)
        res[v] = {"ms": per * 1e3, "tops": pair_ops / per / 1e12, "maxerr": err}
        print(f"{v}: {per * 1e3:.3f} ms/pair  {pair_ops / per / 1e12:.1f} TOPS  maxerr={err:.4f}",
              flush=True)
    return res


if __name__ == "__main__":
    main()
