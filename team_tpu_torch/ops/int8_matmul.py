"""int8 weight quantization and the plain int8 matrix product.

Counterpart of ``team_tpu/ops/int8_matmul.py:quantize_weight`` and of the
XLA ``dot_general`` (int8 x int8 -> int32) that the static-W8A8 tower's
GEMMs ride (``team_tpu/backbone/quant.py:_static_linear3``). The Pallas GEMMs
and quantize producers of that file serve other tiers and are not ported
yet (ROADMAP queue 2 items 12-13).
"""

from __future__ import annotations

from typing import Tuple

import torch

_INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows
# 1/127 as a float32: XLA compiles ``x / 127.0`` in a jitted graph to a
# product with this reciprocal, and the payloads must match the jitted
# quantization bit for bit
INV127 = torch.tensor(1.0, dtype=torch.float32) / 127.0


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 for a ``[K, N]`` weight:
    ``(q int8 [K, N], scale float32 [1, N])``; all-zero columns get scale 1.
    The arithmetic of the jitted JAX function (scale = amax·f32(1/127)).
    ``q`` is laid out column-major, as :func:`int8_matmul` takes it."""
    w32 = w.float()
    amax = w32.abs().amax(dim=0, keepdim=True)
    scale = torch.where(amax > 0, amax * INV127.to(amax.device), torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return _column_major(q), scale


def _column_major(w: torch.Tensor) -> torch.Tensor:
    """The same ``[K, N]`` values with strides ``(1, K)``."""
    return w.t().contiguous().t()


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[..., K] int8 @ [K, N] int8 -> [..., N] int32``, exact.

    On the card this is ``torch._int_mm`` (cuBLASLt's int8 GEMM); it takes
    more than 16 rows, K and N divisible by 8, and ``w`` column-major (the
    layout :func:`quantize_weight` gives; another layout is copied into it
    first), so short inputs (the CLS rows of the last block, a small last
    batch) are padded with zero rows. On the CPU it is an int32
    ``torch.matmul``."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {x.dtype} and {w.dtype}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        out = torch.matmul(x2.int(), w.int())
    else:
        k, n = w.shape
        if k % 8 or n % 8:
            raise ValueError(f"torch._int_mm needs K and N divisible by 8, got {k}x{n}")
        m = x2.shape[0]
        if m < _INT_MM_MIN_ROWS:
            x2 = torch.cat([x2, x2.new_zeros((_INT_MM_MIN_ROWS - m, k))])
        if w.stride(0) != 1:
            w = _column_major(w)
        out = torch._int_mm(x2.contiguous(), w)[:m]
    return out.reshape(*lead, w.shape[1])
