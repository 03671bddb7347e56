"""Probe the tensor cores' GEMM rates on a large square product, int8 and bf16.

Counterpart of ``scripts/int8_probe.py``: the hand-written product
:func:`team_tpu_torch.ops.gemm_probe.probe_mm` (``csrc/gemm_probe.cu``,
``mma.sync`` s8 and bf16) on M = N = K = 4096, against PyTorch's own calls
(``torch._int_mm`` for int8 -> int32; ``torch.matmul`` on the bf16 operands,
which writes bf16, for bf16), each timed over the independent inputs:

    python -m team_tpu_torch.scripts.int8_probe                  # on the card
    python -m team_tpu_torch.scripts.int8_probe --device cpu --size 64

The inputs are the script's, from ``np.random.default_rng(0)``: the int8 x's
first, then w, all in [-127, 127]; the bf16 inputs are the first half of the
x's and w cast. They are uploaded, and w laid out column-major once (the
kernel's operand, a view), before the timing. Times come from CUDA events on
the card (the host clock on the CPU, where the plain version runs). The int8
product is checked exact over the whole output against the float64 product.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from team_tpu_torch.ops.gemm_probe import column_major, probe_mm, probe_mm_reference
from team_tpu_torch.parallel.layout import resolve_device
from team_tpu_torch.scripts._timing import best_seconds, device_name

SIZE = 4096  # M = N = K


def n_inputs(size: int) -> int:
    """The script's count: device bytes (int8 inputs, int32 outputs, bf16
    copies) capped near 6 GB, between 4 and 32 inputs."""
    return max(4, min(32, 6 * 2 ** 30 // (size * size * (1 + 4 + 2))))


def make_inputs(size: int, device: torch.device, seed: int = 0):
    """``n_inputs(size)`` int8 x's ``[size, size]``, then w, in [-127, 127];
    w column-major."""
    rng = np.random.default_rng(seed)
    xs = [rng.integers(-127, 128, (size, size), dtype=np.int8) for _ in range(n_inputs(size))]
    w = rng.integers(-127, 128, (size, size), dtype=np.int8)
    return [torch.from_numpy(x).to(device) for x in xs], column_major(torch.from_numpy(w).to(device))


def bench(fn, xs, w, label: str, device: torch.device, rounds: int) -> Dict[str, float]:
    """The best time of one pass over the inputs, per call, and its rate."""
    size = xs[0].shape[0]
    best = best_seconds(lambda: [fn(x, w) for x in xs], device, rounds)
    tops = 2 * size ** 3 * len(xs) / best / 1e12
    print(f"{label}: {best * 1e3 / len(xs):.2f} ms/call  {tops:.1f} TOPS", flush=True)
    return {"ms": best * 1e3 / len(xs), "tops": tops}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N, or cpu")
    ap.add_argument("--size", type=int, default=SIZE, help="M = N = K")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    xs, w = make_inputs(args.size, device)
    print(f"# device: {device_name(device)}; M=N=K={args.size}, {len(xs)} inputs", flush=True)

    got, want = probe_mm(xs[0], w), probe_mm_reference(xs[0], w)
    if not torch.equal(got, want):
        raise AssertionError("probe_mm int8 matmul differs from the exact product")
    print("probe_mm int8 matmul exact vs the float64 product (every output): OK", flush=True)

    res = {"probe_mm int8->int32": bench(probe_mm, xs, w, "probe_mm int8->int32", device,
                                         args.rounds),
           "torch._int_mm int8->int32": bench(torch._int_mm, xs, w, "torch._int_mm int8->int32",
                                              device, args.rounds)}
    xs_bf = [x.to(torch.bfloat16) for x in xs[:max(2, len(xs) // 2)]]
    w_bf = column_major(w.to(torch.bfloat16))
    res["probe_mm bf16->f32"] = bench(lambda x, w_: probe_mm(x, w_, torch.float32), xs_bf, w_bf,
                                      "probe_mm bf16->f32", device, args.rounds)
    res["torch.matmul bf16->bf16"] = bench(torch.matmul, xs_bf, w_bf, "torch.matmul bf16->bf16",
                                           device, args.rounds)
    return res


if __name__ == "__main__":
    main()
