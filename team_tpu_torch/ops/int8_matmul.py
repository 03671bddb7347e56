"""int8 weight quantization, the plain int8 matrix product, and the static
quantize producers.

Counterparts of ``team_tpu/ops/int8_matmul.py``:
- ``quantize_weight`` and the XLA ``dot_general`` (int8 x int8 -> int32) that
  the static-W8A8 tower's GEMMs ride (``team_tpu/backbone/quant.py:
  _static_linear3``);
- ``quantize_rows`` and ``int8_linear_xla``, the dynamic ``xla`` tier's
  per-row quantize and GEMM (plain PyTorch, as XLA ops in team_tpu);
- ``ln_quantize_static`` (TPU kernel ``_ln_quant_static_kernel``) and
  ``row_quant_static`` (``_row_quant_static_kernel``): bf16 ``[M, D]`` to
  int8 ``[M, D]`` with a calibrated per-channel scale, in one read and one
  write; CUDA kernels ``csrc/int8_quant.cu``, compiled with ``nvcc`` on
  first use and bound with ``ctypes``. On a CPU tensor each wrapper computes
  its plain version; on a CUDA tensor it launches its kernel or raises.

The Pallas GEMMs and the dynamic ``ln_quantize`` serve the ``hybrid`` and
``pallas`` tiers and are not ported yet (ROADMAP queue 2 items 12-13).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 for ``x [M, K]``: ``(q int8 [M, K], scale
    float32 [M, 1])``, ``x ≈ q·scale`` with scale = amax·f32(1/127) (the
    jitted JAX function's arithmetic); zero rows get scale 1."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax * INV127.to(amax.device), torch.ones_like(amax))
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8), scale


def int8_linear_xla(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                    w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                    activation: Optional[str] = None,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The dynamic tier's GEMM (``int8_matmul.py:int8_linear_xla``):
    ``[M, K] int8 @ [K, N] int8`` -> int32 (:func:`int8_matmul`), times the
    per-row ``x_scale`` and the per-column ``w_scale`` in float32, plus
    ``bias``, then the exact (erf) GELU when ``activation="gelu"``, cast to
    ``out_dtype``."""
    out = int8_matmul(x_q, w_q).float() * x_scale.reshape(-1, 1).float() \
        * w_scale.reshape(1, -1).float()
    if bias is not None:
        out = out + bias.reshape(1, -1).float()
    if activation == "gelu":
        out = F.gelu(out, approximate="none")
    return out.to(out_dtype)


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


# ---------------------------------------------------------------------------
# the static quantize producers of the int8 static-W8A8 tier
# ---------------------------------------------------------------------------

_QUANT_SOURCE = "int8_quant.cu"


def _quantize_static(y: torch.Tensor) -> torch.Tensor:
    """clip(round(y), ±127) to int8, rounding half to even as ``jnp.round``."""
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def ln_quantize_static_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                                 inv_a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel (``int8_matmul.py:371``): mean
    and variance in float32 in two passes, ``(x−mean)·rsqrt(var+1e-5)``, then
    ``·γ + β``, then ``·inv_a`` as a multiply of its own, rounded and clipped."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + 1e-5)
    y = y * gamma.reshape(-1).float() + beta.reshape(-1).float()
    return _quantize_static(y * inv_a.reshape(-1).float())


def row_quant_static_reference(x: torch.Tensor, inv_a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``int8_matmul.py:458``): ``x.f32·inv_a``, rounded and clipped."""
    return _quantize_static(x.float() * inv_a.reshape(-1).float())


def _quant_library() -> ctypes.CDLL:
    from team_tpu_torch.ops._build import load_library

    lib = load_library(_QUANT_SOURCE)
    lib.team_ln_quantize_static.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                                                    ctypes.c_void_p]
    lib.team_row_quant_static.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                                                  ctypes.c_void_p]
    lib.team_ln_quantize_static.restype = ctypes.c_int
    lib.team_row_quant_static.restype = ctypes.c_int
    lib.team_ln_quantize_static_max_width.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load this module's kernels now (set-up), instead of at
    their first call."""
    _quant_library()


def _quant_operands(name: str, x: torch.Tensor, vectors) -> list:
    """Check ``x [M, D]`` and the per-channel vectors; returns the vectors as
    flat float32 on x's device."""
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [M, D], got {tuple(x.shape)}")
    if not x.dtype.is_floating_point:
        raise TypeError(f"{name}: x must be a float tensor, got {x.dtype}")
    d = x.shape[1]
    out = []
    for vname, t in vectors:
        if t.numel() != d:
            raise ValueError(f"{name}: {vname} must hold D={d} values, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name}: {vname} lies on {t.device}, x on {x.device}")
        t = t.reshape(-1).float().contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return out


def _check_kernel_input(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16 x, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous and 16-byte aligned")
    if x.shape[1] % 8:
        raise ValueError(f"{name}: the kernel takes widths divisible by 8, got D={x.shape[1]}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def ln_quantize_static(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       inv_a: torch.Tensor) -> torch.Tensor:
    """Layer norm then static per-channel int8 quantize in one pass:
    ``x [M, D]`` (bfloat16 on the card), ``gamma``, ``beta`` ``[D]``,
    ``inv_a [1, D]`` -> int8 ``[M, D]``. Each kernel launch adds one to
    ``ln_quantize_static.launches``."""
    g, b, a = _quant_operands("ln_quantize_static", x, (("gamma", gamma), ("beta", beta),
                                                        ("inv_a", inv_a)))
    if x.device.type == "cpu":
        return ln_quantize_static_reference(x, g, b, a)
    _check_kernel_input("ln_quantize_static", x)
    lib = _quant_library()
    if x.shape[1] > lib.team_ln_quantize_static_max_width():
        raise ValueError(f"ln_quantize_static: D={x.shape[1]} is wider than the kernel's "
                         f"{lib.team_ln_quantize_static_max_width()}")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.team_ln_quantize_static(x.data_ptr(), g.data_ptr(), b.data_ptr(), a.data_ptr(),
                                          out.data_ptr(), x.shape[0], x.shape[1],
                                          torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "ln_quantize_static")
    ln_quantize_static.launches += 1
    return out


def row_quant_static(x: torch.Tensor, inv_a: torch.Tensor) -> torch.Tensor:
    """Static per-channel int8 quantize: ``x [M, D]`` (bfloat16 on the card),
    ``inv_a [1, D]`` -> int8 ``[M, D]``. Each kernel launch adds one to
    ``row_quant_static.launches``."""
    (a,) = _quant_operands("row_quant_static", x, (("inv_a", inv_a),))
    if x.device.type == "cpu":
        return row_quant_static_reference(x, a)
    _check_kernel_input("row_quant_static", x)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        err = _quant_library().team_row_quant_static(x.data_ptr(), a.data_ptr(), out.data_ptr(),
                                                     x.shape[0], x.shape[1],
                                                     torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "row_quant_static")
    row_quant_static.launches += 1
    return out


ln_quantize_static.launches = 0
row_quant_static.launches = 0


def reset_launch_counts() -> None:
    ln_quantize_static.launches = 0
    row_quant_static.launches = 0
