"""The tensor cores' wgmma ceiling: REPS products of sliding windows of an x
and a w that stay in L2, int8 and bf16.

Counterpart of ``scripts/int8_mxu_ceiling.py``:
:func:`team_tpu_torch.ops.gemm_probe.mxu_ceiling` (``csrc/gemm_probe.cu``)
computes ``Σ_{i<REPS} x[8(i mod 64) : 8(i mod 64) + M, :] @ w`` with
M = 512, K = 768, REPS = 2000. Every one of the REPS products is issued on
the tensor cores (``wgmma``, each window's products back to back from one
pair of boxes staged in shared memory); the rate is ``2·M·K·K·REPS`` over
the time:

    python -m team_tpu_torch.scripts.int8_mxu_ceiling             # on the card
    python -m team_tpu_torch.scripts.int8_mxu_ceiling --device cpu --m 16 --k 32 --reps 5

The inputs are the script's, from ``np.random.default_rng(0)`` anew for each
type, x then w: int8 x in [-127, 127] and w in [-3, 3]; bf16 both from
N(0, 0.1²). They are uploaded, and w laid out column-major, before the
timing. Times come from CUDA events on the card (the host clock on the CPU,
where the plain version runs).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from team_tpu_torch.ops.gemm_probe import WINDOW_STRIDE, WINDOWS, column_major, mxu_ceiling
from team_tpu_torch.parallel.layout import resolve_device
from team_tpu_torch.scripts._timing import best_seconds, device_name

REPS = 2000
M, K = 512, 768
PEAK_TOPS = {torch.int8: 1979.0, torch.bfloat16: 989.0}  # the H100's dense tensor-core rates


def make_inputs(dtype: torch.dtype, m: int, k: int, device: torch.device, seed: int = 0):
    """x ``[m + 512, k]`` then w ``[k, k]`` (w column-major)."""
    rng = np.random.default_rng(seed)
    rows = m + WINDOW_STRIDE * WINDOWS
    if dtype == torch.int8:
        x = torch.from_numpy(rng.integers(-127, 128, (rows, k), dtype=np.int8))
        w = torch.from_numpy(rng.integers(-3, 4, (k, k), dtype=np.int8))
    else:
        x = torch.from_numpy((rng.standard_normal((rows, k)) * 0.1).astype(np.float32)).to(dtype)
        w = torch.from_numpy((rng.standard_normal((k, k)) * 0.1).astype(np.float32)).to(dtype)
    return x.to(device), column_major(w.to(device))


def run(dtype: torch.dtype, label: str, m: int, k: int, reps: int, device: torch.device,
        rounds: int) -> Dict[str, float]:
    x, w = make_inputs(dtype, m, k, device)
    best = best_seconds(lambda: mxu_ceiling(x, w, reps, m), device, rounds)
    tops = 2 * m * k * k * reps / best / 1e12
    peak = (f", {100 * tops / PEAK_TOPS[dtype]:.1f} % of the dense peak "
            f"{PEAK_TOPS[dtype]:,.0f}") if device.type == "cuda" else ""
    print(f"{label}: {best * 1e3:.2f} ms for {reps} dots -> {tops:.1f} TOPS "
          f"(wgmma ceiling{peak}; operands staged in shared memory, independent windows)",
          flush=True)
    return {"ms": best * 1e3, "tops": tops}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N, or cpu")
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--k", type=int, default=K)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"# device: {device_name(device)}; M={args.m} K=N={args.k} REPS={args.reps}", flush=True)
    shape = f"[{args.m},{args.k}]@[{args.k},{args.k}]"
    return {"int8": run(torch.int8, f"int8 {shape}", args.m, args.k, args.reps, device,
                        args.rounds),
            "bf16": run(torch.bfloat16, f"bf16 {shape}", args.m, args.k, args.reps, device,
                        args.rounds)}


if __name__ == "__main__":
    main()
