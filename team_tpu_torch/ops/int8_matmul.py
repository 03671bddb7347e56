"""int8 weight quantization, the int8 matrix products, and the quantize
producers of the int8 tiers.

Counterparts of ``team_tpu/ops/int8_matmul.py``:
- ``quantize_weight`` and the XLA ``dot_general`` (int8 x int8 -> int32) that
  the static-W8A8 tower's GEMMs ride (``team_tpu/backbone/quant.py:
  _static_linear3``);
- ``quantize_rows`` and ``int8_linear_xla``, the dynamic ``xla`` tier's
  per-row quantize and GEMM (plain PyTorch, as XLA ops in team_tpu);
- ``ln_quantize_static`` (TPU kernel ``_ln_quant_static_kernel``),
  ``ln_quantize_static3`` (its 3-D form) and ``row_quant_static``
  (``_row_quant_static_kernel``): bf16 ``[M, D]`` to int8 ``[M, D]`` with a
  calibrated per-channel scale, in one read and one write; ``ln_quantize``
  (``_ln_quant_kernel``): the layer norm to int8 with a dynamic per-row
  scale; CUDA kernels ``csrc/int8_quant.cu``;
- the static tower's epilogues, which team_tpu's XLA fuses into its dots:
  ``static_requant`` (int32 GEMM sums to int8: dequant, bias, GELU,
  requantize), ``static_residual`` (to bf16, plus the residual) and
  ``ln_quant_folded`` (``_ln_quant3``'s layer norm to int8); one kernel
  each in ``csrc/int8_quant.cu``;
- the GEMMs of the ``hybrid`` and ``pallas`` tiers: ``int8_linear`` and its
  TPU tilings ``int8_linear_nk``, ``_kgrid``, ``_wres`` and ``_dma`` (one
  kernel), ``int8_linear_gelu_quant`` (GEMM, GELU and a requantize with one
  scale per row and column block) and ``int8_linear_blockscale`` (its
  consumer, one activation scale per row and K block); CUDA kernels
  ``csrc/int8_gemm.cu`` on the tensor cores: ``wgmma`` fed by TMA
  (``csrc/wgmma_gemm.cuh``) for ``int8_linear`` at every shape, for
  ``blockscale`` where ``bk`` is a multiple of 128 and for the GELU form at
  ``bn`` 256 and 512; ``mma.sync`` s8 for the other shapes and for the
  ``*_mma`` entries, the yardsticks that no path calls;
  ``quantized_linear`` quantizes rows and calls ``int8_linear``.

The CUDA sources are compiled with ``nvcc`` on first use and bound with
``ctypes``. On a CPU tensor each wrapper computes its plain version (the
``*_reference`` function beside it); on a CUDA tensor it launches its
kernel or raises. The TPU wrappers' tiling arguments (``block_m``,
``block_k``, ``n_split``, ``interpret``) are accepted and change nothing,
except ``block_n`` of ``int8_linear_gelu_quant``, which sets the width of
its scale blocks, as in team_tpu.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from team_tpu_torch.ops._grad import refuse_grad

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
    return column_major(q), scale


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
    out = _dequant(int8_matmul(x_q, w_q), x_scale, w_scale, bias)
    if activation == "gelu":
        out = F.gelu(out, approximate="none")
    return out.to(out_dtype)


def column_major(w: torch.Tensor) -> torch.Tensor:
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
            w = column_major(w)
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


_QUANT_LIB: Optional[ctypes.CDLL] = None


def _quant_library() -> ctypes.CDLL:
    """The quantize source's library, built and bound once."""
    global _QUANT_LIB
    if _QUANT_LIB is not None:
        return _QUANT_LIB
    from team_tpu_torch.ops._build import load_library

    lib = load_library(_QUANT_SOURCE)
    lib.team_ln_quantize_static.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                                                    ctypes.c_void_p]
    lib.team_row_quant_static.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                                                  ctypes.c_void_p]
    lib.team_ln_quantize.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                                             ctypes.c_void_p]
    lib.team_static_requant.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.team_static_residual.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                                                 ctypes.c_void_p, ctypes.c_int,
                                                                 ctypes.c_int, ctypes.c_void_p]
    lib.team_ln_quant_folded.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    for entry in (lib.team_ln_quantize_static, lib.team_ln_quantize, lib.team_row_quant_static,
                  lib.team_static_requant, lib.team_static_residual, lib.team_ln_quant_folded,
                  lib.team_ln_quantize_static_max_width):
        entry.restype = ctypes.c_int
    _QUANT_LIB = lib
    return lib


def build() -> None:
    """Compile and load this module's kernels now (set-up), instead of at
    their first call."""
    _quant_library()
    _gemm_library()


def _quant_operands(name: str, x: torch.Tensor, vectors) -> list:
    """Check ``x [M, D]`` and the per-channel vectors; returns the vectors as
    flat float32 on x's device."""
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [M, D], got {tuple(x.shape)}")
    if not x.dtype.is_floating_point:
        raise TypeError(f"{name}: x must be a float tensor, got {x.dtype}")
    return _flat_vectors(name, vectors, "D", x.shape[1], x.device, "x")


def _flat_vectors(name: str, vectors, dim: str, n: int, device: torch.device, what: str) -> list:
    """Each ``(name, vector)`` of ``vectors`` checked to hold ``n`` values on
    ``device``, as flat float32, 16-byte aligned."""
    out = []
    for vname, t in vectors:
        if t.numel() != n:
            raise ValueError(f"{name}: {vname} must hold {dim}={n} values, got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name}: {vname} lies on {t.device}, {what} on {device}")
        t = t.reshape(-1).float().contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return out


def _check_kernel_input(name: str, x: torch.Tensor, *vectors: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {x.device}")
    refuse_grad(name, x, *vectors)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16 x, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous and 16-byte aligned")
    if x.shape[1] % 8:
        raise ValueError(f"{name}: the kernel takes widths divisible by 8, got D={x.shape[1]}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _launch_ln_quantize_static(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                               a: torch.Tensor, name: str) -> torch.Tensor:
    _check_kernel_input(name, x, g, b, a)
    lib = _quant_library()
    _check_width(name, x.shape[1], lib)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.team_ln_quantize_static(x.data_ptr(), g.data_ptr(), b.data_ptr(), a.data_ptr(),
                                          out.data_ptr(), x.shape[0], x.shape[1],
                                          torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    return out


def _check_width(name: str, d: int, lib: ctypes.CDLL) -> None:
    if d > lib.team_ln_quantize_static_max_width():
        raise ValueError(f"{name}: D={d} is wider than the kernel's "
                         f"{lib.team_ln_quantize_static_max_width()}")


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
    out = _launch_ln_quantize_static(x, g, b, a, "ln_quantize_static")
    ln_quantize_static.launches += 1
    return out


def ln_quantize_static3(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        inv_a: torch.Tensor, *, group: int = 8,
                        interpret: bool = False) -> torch.Tensor:
    """:func:`ln_quantize_static` over ``x [B, S, D]`` -> int8 ``[B, S, D]``
    (TPU kernel ``_ln_quant_static3_kernel``, ``int8_matmul.py:427``): the
    same kernel on the contiguous ``[B*S, D]`` view; ``group`` (the TPU's
    samples per grid step) changes nothing. No route calls it, as in
    team_tpu. Each kernel launch adds one to ``ln_quantize_static3.launches``."""
    if x.dim() != 3:
        raise ValueError(f"ln_quantize_static3: x must be [B, S, D], got {tuple(x.shape)}")
    bsz, s, d = x.shape
    x2 = x.reshape(bsz * s, d)
    g, b, a = _quant_operands("ln_quantize_static3", x2, (("gamma", gamma), ("beta", beta),
                                                          ("inv_a", inv_a)))
    if x.device.type == "cpu":
        return ln_quantize_static_reference(x2, g, b, a).reshape(bsz, s, d)
    out = _launch_ln_quantize_static(x2, g, b, a, "ln_quantize_static3")
    ln_quantize_static3.launches += 1
    return out.reshape(bsz, s, d)


def ln_quantize_reference(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the TPU kernel (``int8_matmul.py:324``): the
    layer norm of :func:`ln_quantize_static_reference` without ``inv_a``,
    then the row's amax, ``s = amax·f32(1/127)`` (1 where amax = 0) and
    ``clip(round(y / s), ±127)``: ``(q int8 [M, D], s float32 [1, M])``."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + 1e-5)
    y = y * gamma.reshape(-1).float() + beta.reshape(-1).float()
    amax = y.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax * INV127.to(amax.device), torch.ones_like(amax))
    return _quantize_static(y / s), s.reshape(1, -1)


def ln_quantize(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                block_m: int = 512, interpret: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer norm then dynamic per-row int8 quantize in one pass (the
    ``hybrid`` and ``pallas`` tiers' producer): ``x [M, D]`` (bfloat16 on the
    card), ``gamma``, ``beta`` ``[D]`` -> ``(q int8 [M, D], s float32 [1, M])``.
    Each kernel launch adds one to ``ln_quantize.launches``."""
    g, b = _quant_operands("ln_quantize", x, (("gamma", gamma), ("beta", beta)))
    if x.device.type == "cpu":
        return ln_quantize_reference(x, g, b)
    _check_kernel_input("ln_quantize", x, g, b)
    lib = _quant_library()
    _check_width("ln_quantize", x.shape[1], lib)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((1, x.shape[0]), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.team_ln_quantize(x.data_ptr(), g.data_ptr(), b.data_ptr(), q.data_ptr(),
                                   s.data_ptr(), x.shape[0], x.shape[1],
                                   torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "ln_quantize")
    ln_quantize.launches += 1
    return q, s


def row_quant_static(x: torch.Tensor, inv_a: torch.Tensor) -> torch.Tensor:
    """Static per-channel int8 quantize: ``x [M, D]`` (bfloat16 on the card),
    ``inv_a [1, D]`` -> int8 ``[M, D]``. Each kernel launch adds one to
    ``row_quant_static.launches``."""
    (a,) = _quant_operands("row_quant_static", x, (("inv_a", inv_a),))
    if x.device.type == "cpu":
        return row_quant_static_reference(x, a)
    _check_kernel_input("row_quant_static", x, a)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        err = _quant_library().team_row_quant_static(x.data_ptr(), a.data_ptr(), out.data_ptr(),
                                                     x.shape[0], x.shape[1],
                                                     torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "row_quant_static")
    row_quant_static.launches += 1
    return out


# ---------------------------------------------------------------------------
# the static tower's epilogues: int32 GEMM sums to int8 or to bf16 (plus the
# residual), and its layer norm to int8, each one kernel on the card
# ---------------------------------------------------------------------------

# the activations of the static requantize, as its kernel numbers them
STATIC_ACTIVATIONS = {None: 0, "tanh": 1, "sigmoid": 2}


def static_dequant_reference(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                             activation: Optional[str] = None) -> torch.Tensor:
    """``f32(acc)·scale + bias`` (two roundings), then ``activation``: None;
    ``"tanh"``, PyTorch's tanh GELU; ``"sigmoid"``, ``x·σ(1.702x)``."""
    out = acc.float() * scale.reshape(-1) + bias.reshape(-1)
    if activation == "sigmoid":
        return out * torch.sigmoid(1.702 * out)
    if activation == "tanh":
        return F.gelu(out, approximate="tanh")
    return out


def static_requant_reference(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                             inv_a: torch.Tensor, activation: Optional[str] = None) -> torch.Tensor:
    """:func:`static_dequant_reference`, then ``clip(round(v·inv_a), ±127)`` to int8."""
    return _quantize_static(static_dequant_reference(acc, scale, bias, activation)
                            * inv_a.reshape(-1))


def static_residual_reference(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``bf16(f32(acc)·scale + bias)``, added to ``residual`` where one is given."""
    out = static_dequant_reference(acc, scale, bias).to(torch.bfloat16)
    return out if residual is None else residual + out


def ln_quant_folded_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                              inv_a: torch.Tensor, two_pass: bool = False) -> torch.Tensor:
    """The layer norm to static int8 over ``[..., D]`` with the affine folded
    into the quantize constants: the variance max(E[x²]−E[x]², 0) in one pass
    (the JAX tier's form, not ``torch.var``), or with ``two_pass`` the
    two-pass mean and variance; ``clip(round(y·(γ·inv_a) + β·inv_a), ±127)``."""
    x32 = x.float()
    n = x.shape[-1]
    if two_pass:
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, correction=0)
    else:
        mean = x32.sum(dim=-1, keepdim=True) / n
        var = torch.clamp(x32.mul(x32).sum(dim=-1, keepdim=True) / n - mean * mean, min=0.0)
    y = (x32 - mean) * torch.rsqrt(var + 1e-5)
    inv = inv_a.reshape(-1)
    return _quantize_static(y * (gamma.reshape(-1).float() * inv) + beta.reshape(-1).float() * inv)


def _epilogue_vectors(name: str, t: torch.Tensor, vectors) -> list:
    """Check the width of ``t [..., N]`` and the per-column vectors; returns
    the vectors as flat float32 on t's device, 16-byte aligned."""
    if t.dim() < 2:
        raise ValueError(f"{name}: the input must be [..., M, N], got {tuple(t.shape)}")
    n = t.shape[-1]
    if n % 8:
        raise ValueError(f"{name}: the kernel takes widths divisible by 8, got N={n}")
    return _flat_vectors(name, vectors, "N", n, t.device, "the input")


def _int32_sums(name: str, acc: torch.Tensor, vectors) -> list:
    if acc.dtype != torch.int32:
        raise TypeError(f"{name}: acc must be the int32 GEMM sums, got {acc.dtype}")
    vecs = _epilogue_vectors(name, acc, vectors)
    if acc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {acc.device}")
    return vecs


def _kernel_rows(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous, 16-byte-aligned ``[M, N]`` for a kernel."""
    refuse_grad(name, t)
    t2 = t.reshape(-1, t.shape[-1])
    return t2 if t2.is_contiguous() and t2.data_ptr() % 16 == 0 else t2.contiguous()


def static_requant(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   inv_a: torch.Tensor, activation: Optional[str] = None) -> torch.Tensor:
    """The static requantize epilogue: int32 ``acc [..., N]`` -> int8 ``[..., N]``
    (:func:`static_requant_reference`); ``scale``, ``bias``, ``inv_a`` hold N
    values, ``activation`` is a key of ``STATIC_ACTIVATIONS``. One kernel on
    the card; each launch adds one to ``static_requant.launches``."""
    if activation not in STATIC_ACTIVATIONS:
        raise ValueError(f"static_requant: activation must be one of "
                         f"{sorted(STATIC_ACTIVATIONS, key=str)}, got {activation!r}")
    s, b, a = _int32_sums("static_requant", acc, (("scale", scale), ("bias", bias),
                                                  ("inv_a", inv_a)))
    if acc.device.type == "cpu":
        return static_requant_reference(acc, s, b, a, activation)
    acc2 = _kernel_rows("static_requant", acc)
    out = torch.empty(acc.shape, dtype=torch.int8, device=acc.device)
    with torch.cuda.device(acc.device):
        err = _quant_library().team_static_requant(
            acc2.data_ptr(), s.data_ptr(), b.data_ptr(), a.data_ptr(), out.data_ptr(),
            acc2.shape[0], acc2.shape[1], STATIC_ACTIVATIONS[activation],
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "static_requant")
    static_requant.launches += 1
    return out


def static_residual(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The bf16 epilogue: int32 ``acc [..., N]`` -> ``bf16(f32(acc)·scale +
    bias)``, added to the bf16 ``residual`` of the same shape where one is
    given (:func:`static_residual_reference`). The residual's rows may lie
    apart (a ``x[:, :1]`` view); another layout is copied. One kernel on the
    card; each launch adds one to ``static_residual.launches``."""
    s, b = _int32_sums("static_residual", acc, (("scale", scale), ("bias", bias)))
    if residual is not None:
        if residual.dtype != torch.bfloat16:
            raise TypeError(f"static_residual: the residual must be bfloat16, got "
                            f"{residual.dtype}")
        if residual.shape != acc.shape or residual.device != acc.device:
            raise ValueError(f"static_residual: the residual {tuple(residual.shape)} on "
                             f"{residual.device} must match acc {tuple(acc.shape)} on {acc.device}")
    if acc.device.type == "cpu":
        return static_residual_reference(acc, s, b, residual)
    acc2 = _kernel_rows("static_residual", acc)
    n = acc2.shape[1]
    x_ptr, ldx = None, 0
    if residual is not None:
        refuse_grad("static_residual", residual)
        x2 = residual.reshape(-1, n)
        if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16 or x2.stride(0) < n:
            x2 = x2.contiguous()
        x_ptr, ldx = x2.data_ptr(), x2.stride(0)
    out = torch.empty(acc.shape, dtype=torch.bfloat16, device=acc.device)
    with torch.cuda.device(acc.device):
        err = _quant_library().team_static_residual(
            acc2.data_ptr(), s.data_ptr(), b.data_ptr(), x_ptr, ldx, out.data_ptr(),
            acc2.shape[0], n, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "static_residual")
    static_residual.launches += 1
    return out


def ln_quant_folded(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    inv_a: torch.Tensor, two_pass: bool = False) -> torch.Tensor:
    """The static tower's layer norm to int8 over ``x [..., D]`` (bfloat16 on
    the card) -> int8 ``[..., D]`` (:func:`ln_quant_folded_reference`, not
    the arithmetic of :func:`ln_quantize_static`). One kernel on the card;
    each launch adds one to ``ln_quant_folded.launches``."""
    if not x.dtype.is_floating_point:
        raise TypeError(f"ln_quant_folded: x must be a float tensor, got {x.dtype}")
    g, b, a = _epilogue_vectors("ln_quant_folded", x, (("gamma", gamma), ("beta", beta),
                                                       ("inv_a", inv_a)))
    if x.device.type == "cpu":
        return ln_quant_folded_reference(x, g, b, a, two_pass)
    x2 = _kernel_rows("ln_quant_folded", x)
    _check_kernel_input("ln_quant_folded", x2, g, b, a)
    lib = _quant_library()
    _check_width("ln_quant_folded", x2.shape[1], lib)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.team_ln_quant_folded(x2.data_ptr(), g.data_ptr(), b.data_ptr(), a.data_ptr(),
                                       out.data_ptr(), x2.shape[0], x2.shape[1], int(two_pass),
                                       torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "ln_quant_folded")
    ln_quant_folded.launches += 1
    return out




# ---------------------------------------------------------------------------
# the int8 GEMMs of the hybrid and pallas tiers
# ---------------------------------------------------------------------------

_GEMM_SOURCE = "int8_gemm.cu"


def _pick_block_n(n: int, target: int) -> int:
    """team_tpu's N block (``int8_matmul.py:86``): the largest multiple of 128
    up to ``target`` that divides ``n``, else the largest divisor up to
    ``target``. It sets :func:`int8_linear_gelu_quant`'s scale blocks (512 at
    N=3072), and so the K blocks of :func:`int8_linear_blockscale`."""
    for cand in range(min(target, n) // 128 * 128, 0, -128):
        if n % cand == 0:
            return cand
    for cand in range(min(target, n), 0, -1):
        if n % cand == 0:
            return cand
    return n


def _dequant(acc: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``f32(acc)·x_scale[m]·w_scale[n] + bias[n]``, in the TPU kernel's order."""
    out = acc.float() * x_scale.reshape(-1, 1).float() * w_scale.reshape(1, -1).float()
    return out if bias is None else out + bias.reshape(1, -1).float()


def int8_linear_reference(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                          w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                          activation: Optional[str] = None,
                          out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel (``int8_matmul.py:54``):
    ``[M, K] @ [K, N]`` int8 -> int32 (:func:`int8_matmul`, exact), the
    dequant of :func:`_dequant`, then the tanh GELU when
    ``activation="gelu"``, cast to ``out_dtype``."""
    out = _dequant(int8_matmul(x_q, w_q), x_scale, w_scale, bias)
    if activation == "gelu":
        out = F.gelu(out, approximate="tanh")
    return out.to(out_dtype)


def int8_linear_gelu_quant_reference(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                                     w_scale: torch.Tensor, bias: torch.Tensor, *,
                                     block_n: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the TPU kernel (``int8_matmul.py:490``):
    ``y = gelu_tanh(dequant(x_q @ w_q))``; for each row and block of ``bn =
    _pick_block_n(N, block_n)`` columns ``s = amax|y|·f32(1/127)`` (1 where
    amax = 0) and ``q = clip(round(y / s), ±127)``: ``(q int8 [M, N], s
    float32 [N/bn, M])``."""
    y = F.gelu(_dequant(int8_matmul(x_q, w_q), x_scale, w_scale, bias), approximate="tanh")
    m, n = y.shape
    bn = _pick_block_n(n, block_n)
    yb = y.reshape(m, n // bn, bn)
    amax = yb.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax * INV127.to(amax.device), torch.ones_like(amax))
    return _quantize_static(yb / s).reshape(m, n), s.reshape(m, n // bn).t().contiguous()


def int8_linear_blockscale_reference(x_q: torch.Tensor, w_q: torch.Tensor, x_scales: torch.Tensor,
                                     w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                                     *, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel (``int8_matmul.py:565``): K
    in ``n_kb = x_scales.shape[0]`` blocks of ``bk = K/n_kb``; ``acc += f32(
    x_q[:, block] @ w_q[block]) · x_scales[kb]`` in block order from 0, then
    ``acc·w_scale + bias``, cast to ``out_dtype``."""
    k = x_q.shape[1]
    n_kb = x_scales.shape[0]
    if k % n_kb:
        raise ValueError(f"int8_linear_blockscale: {n_kb} scale blocks do not divide K={k}")
    bk = k // n_kb
    acc = None
    for kb in range(n_kb):
        part = int8_matmul(x_q[:, kb * bk:(kb + 1) * bk].contiguous(),
                           column_major(w_q[kb * bk:(kb + 1) * bk]))
        term = part.float() * x_scales[kb].reshape(-1, 1).float()
        acc = term if acc is None else acc + term
    out = acc * w_scale.reshape(1, -1).float()
    if bias is not None:
        out = out + bias.reshape(1, -1).float()
    return out.to(out_dtype)


def _gemm_library() -> ctypes.CDLL:
    from team_tpu_torch.ops._build import load_library

    lib = load_library(_GEMM_SOURCE)
    ptrs, i = ctypes.c_void_p, ctypes.c_int
    linear = (lib.team_int8_linear, lib.team_int8_linear_mma, lib.team_int8_linear_blockscale,
              lib.team_int8_linear_blockscale_mma)
    gelu_quant = (lib.team_int8_linear_gelu_quant, lib.team_int8_linear_gelu_quant_mma)
    for fn in linear:
        fn.argtypes = [ptrs] * 6 + [i] * 5 + [ptrs]
    for fn in gelu_quant:
        fn.argtypes = [ptrs] * 7 + [i] * 4 + [ptrs]
    for fn in (*linear, *gelu_quant, lib.team_int8_gemm_max_block_n):
        fn.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _gemm_operands(name: str, x_q: torch.Tensor, wt_q: torch.Tensor, x_scale: torch.Tensor,
                   w_scale: torch.Tensor, bias: Optional[torch.Tensor], x_scale_rows: int):
    """Check the operands of a GEMM kernel: ``x_q [M, K]`` and ``wt_q [N, K]``
    int8 on one CUDA device, K a multiple of 32 and N of 8; returns them
    contiguous and 16-byte aligned with the scales and bias as flat float32
    (bias zeros when absent)."""
    if x_q.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {x_q.device}")
    refuse_grad(name, x_scale, w_scale, bias)
    if x_q.dtype != torch.int8 or wt_q.dtype != torch.int8:
        raise TypeError(f"{name} takes int8 operands, got {x_q.dtype} and {wt_q.dtype}")
    if x_q.dim() != 2 or wt_q.dim() != 2 or x_q.shape[1] != wt_q.shape[1]:
        raise ValueError(f"{name}: x [M, K] and the weight must share K, got {tuple(x_q.shape)} "
                         f"and [N, K] = {tuple(wt_q.shape)}")
    m, k = x_q.shape
    n = wt_q.shape[0]
    if k % 32 or n % 8:
        raise ValueError(f"{name}: the kernel takes K divisible by 32 and N by 8 (the mma "
                         f"shape), got K={k}, N={n}")
    if bias is None:
        bias = torch.zeros(n, dtype=torch.float32, device=x_q.device)
    vectors = []
    for vname, t, size in (("x_scale", x_scale, x_scale_rows * m), ("w_scale", w_scale, n),
                           ("bias", bias, n)):
        if t.numel() != size:
            raise ValueError(f"{name}: {vname} must hold {size} values, got {tuple(t.shape)}")
        if t.device != x_q.device:
            raise ValueError(f"{name}: {vname} lies on {t.device}, x on {x_q.device}")
        vectors.append(_aligned(t.reshape(-1).float()))
    return (_aligned(x_q), _aligned(wt_q), *vectors)


def _out_f32(name: str, out_dtype: torch.dtype) -> int:
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the kernel writes bfloat16 or float32, not {out_dtype}")
    return int(out_dtype == torch.float32)


def _linear_kernel(name: str, entry: str, x_q, wt_q, x_scale, w_scale, bias, activation,
                   out_dtype) -> torch.Tensor:
    """Launch K1 (C entry ``entry``) on ``wt_q [N, K]``: a ``[K, N]`` weight's
    transpose, which is a view of :func:`quantize_weight`'s column-major
    layout (any other layout is copied by :func:`_gemm_operands`)."""
    if activation not in (None, "gelu"):
        raise ValueError(f"{name}: activation must be None or 'gelu', got {activation!r}")
    f32 = _out_f32(name, out_dtype)
    x_q, wt_q, xs, ws, b = _gemm_operands(name, x_q, wt_q, x_scale, w_scale, bias, 1)
    m, k = x_q.shape
    n = wt_q.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    with torch.cuda.device(x_q.device):
        err = getattr(_gemm_library(), entry)(
            x_q.data_ptr(), wt_q.data_ptr(), xs.data_ptr(), ws.data_ptr(), b.data_ptr(),
            out.data_ptr(), m, n, k, int(activation == "gelu"), f32,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    return out


def _linear_entry(fn, x_q, wt_q, x_scale, w_scale, bias, activation, out_dtype) -> torch.Tensor:
    """The body of the K1 wrappers ``fn`` (``wt_q`` the ``[N, K]`` weight): the
    plain version on the CPU, else the kernel, counted on ``fn.launches``."""
    if x_q.device.type == "cpu":
        return int8_linear_reference(x_q, wt_q.t(), x_scale, w_scale, bias,
                                     activation=activation, out_dtype=out_dtype)
    out = _linear_kernel(fn.__name__, "team_int8_linear", x_q, wt_q, x_scale, w_scale, bias,
                         activation, out_dtype)
    fn.launches += 1
    return out


def int8_linear(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                activation: Optional[str] = None, out_dtype: torch.dtype = torch.bfloat16,
                block_m: int = 512, block_n: int = 512, interpret: bool = False) -> torch.Tensor:
    """``dequant(x_q @ w_q) + bias`` with an optional tanh GELU -> ``[M, N]``
    (``int8_matmul.py:233``): ``x_q [M, K]`` int8, ``w_q [K, N]`` int8,
    ``x_scale`` ``[M, 1]`` or ``[1, M]``, ``w_scale [1, N]``. On the card the
    ``wgmma`` kernel at every shape. Each kernel launch adds one to
    ``int8_linear.launches``."""
    return _linear_entry(int8_linear, x_q, w_q.t(), x_scale, w_scale, bias, activation, out_dtype)


def int8_linear_mma(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                    w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                    activation: Optional[str] = None,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`int8_linear` on the ``mma.sync`` kernel: the kernel that the
    ``wgmma`` one replaced, callable so that the two can be held against each
    other bit for bit (the card tests, ``chip_smoke.py``). No path of the
    port calls it, and it counts no launch. On a CPU tensor: the plain
    version."""
    if x_q.device.type == "cpu":
        return int8_linear_reference(x_q, w_q, x_scale, w_scale, bias, activation=activation,
                                     out_dtype=out_dtype)
    return _linear_kernel("int8_linear_mma", "team_int8_linear_mma", x_q, w_q.t(), x_scale,
                          w_scale, bias, activation, out_dtype)


def int8_linear_nk(x_q: torch.Tensor, wt_q: torch.Tensor, x_scale: torch.Tensor,
                   w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                   activation: Optional[str] = None, out_dtype: torch.dtype = torch.bfloat16,
                   block_m: int = 512, block_n: int = 512, interpret: bool = False) -> torch.Tensor:
    """:func:`int8_linear` with the weight stored ``[N, K]``
    (``int8_matmul.py:116``), which is the kernel's own operand. Each kernel
    launch adds one to ``int8_linear_nk.launches``."""
    return _linear_entry(int8_linear_nk, x_q, wt_q, x_scale, w_scale, bias, activation, out_dtype)


def int8_linear_kgrid(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                      w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                      activation: Optional[str] = None, out_dtype: torch.dtype = torch.bfloat16,
                      block_m: int = 512, block_n: int = 512, block_k: int = 256,
                      interpret: bool = False) -> torch.Tensor:
    """:func:`int8_linear` (``int8_matmul.py:186``, the TPU's K-gridded
    tiling). Each kernel launch adds one to ``int8_linear_kgrid.launches``."""
    return _linear_entry(int8_linear_kgrid, x_q, w_q.t(), x_scale, w_scale, bias, activation,
                         out_dtype)


def int8_linear_wres(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                     w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                     activation: Optional[str] = None, out_dtype: torch.dtype = torch.bfloat16,
                     block_m: int = 512, n_split: int = 1,
                     interpret: bool = False) -> torch.Tensor:
    """:func:`int8_linear` (``int8_matmul.py:659``, the TPU's
    weight-stationary tiling). Each kernel launch adds one to
    ``int8_linear_wres.launches``."""
    return _linear_entry(int8_linear_wres, x_q, w_q.t(), x_scale, w_scale, bias, activation,
                         out_dtype)


def int8_linear_dma(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                    w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                    activation: Optional[str] = None, out_dtype: torch.dtype = torch.bfloat16,
                    block_m: int = 512, n_split: int = 1,
                    interpret: bool = False) -> torch.Tensor:
    """:func:`int8_linear` (``int8_matmul.py:797``, the TPU's hand-pipelined
    DMA tiling). Each kernel launch adds one to ``int8_linear_dma.launches``."""
    return _linear_entry(int8_linear_dma, x_q, w_q.t(), x_scale, w_scale, bias, activation,
                         out_dtype)


def _gelu_quant_kernel(name: str, entry: str, x_q, w_q, x_scale, w_scale, bias,
                       block_n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    x_q, wt_q, xs, ws, b = _gemm_operands(name, x_q, w_q.t(), x_scale, w_scale, bias, 1)
    m, k = x_q.shape
    n = wt_q.shape[0]
    bn = _pick_block_n(n, block_n)
    lib = _gemm_library()
    if bn > lib.team_int8_gemm_max_block_n():
        raise ValueError(f"{name}: column block {bn} is wider than the kernel's "
                         f"{lib.team_int8_gemm_max_block_n()}")
    q = torch.empty((m, n), dtype=torch.int8, device=x_q.device)
    scales = torch.empty((n // bn, m), dtype=torch.float32, device=x_q.device)
    with torch.cuda.device(x_q.device):
        err = getattr(lib, entry)(
            x_q.data_ptr(), wt_q.data_ptr(), xs.data_ptr(), ws.data_ptr(), b.data_ptr(),
            q.data_ptr(), scales.data_ptr(), m, n, k, bn, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    return q, scales


def int8_linear_gelu_quant(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                           w_scale: torch.Tensor, bias: torch.Tensor, *, block_m: int = 512,
                           block_n: int = 512,
                           interpret: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize(gelu_tanh(dequant(x_q @ w_q) + bias))`` with one scale per
    row and block of ``bn = _pick_block_n(N, block_n)`` columns
    (``int8_matmul.py:506``): ``(q int8 [M, N], scales float32 [N/bn, M])``,
    the input of :func:`int8_linear_blockscale`. The f32 activation stays on
    chip. On the card ``bn`` 256 and 512 run the ``wgmma`` kernel, any other
    the ``mma.sync`` one (:func:`int8_linear_gelu_quant_mma`); the C entry
    chooses by ``bn``. Each kernel launch adds one to
    ``int8_linear_gelu_quant.launches``."""
    if x_q.device.type == "cpu":
        return int8_linear_gelu_quant_reference(x_q, w_q, x_scale, w_scale, bias, block_n=block_n)
    out = _gelu_quant_kernel("int8_linear_gelu_quant", "team_int8_linear_gelu_quant", x_q, w_q,
                             x_scale, w_scale, bias, block_n)
    int8_linear_gelu_quant.launches += 1
    return out


def int8_linear_gelu_quant_mma(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                               w_scale: torch.Tensor, bias: torch.Tensor, *,
                               block_n: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`int8_linear_gelu_quant` on the ``mma.sync`` kernel at every
    ``bn``: the kernel that the ``wgmma`` one replaced at ``bn`` 256 and 512,
    callable so that the two can be held against each other bit for bit (the
    card tests, ``chip_smoke.py``). No path of the port calls it, and it
    counts no launch. On a CPU tensor: the plain version."""
    if x_q.device.type == "cpu":
        return int8_linear_gelu_quant_reference(x_q, w_q, x_scale, w_scale, bias, block_n=block_n)
    return _gelu_quant_kernel("int8_linear_gelu_quant_mma", "team_int8_linear_gelu_quant_mma",
                              x_q, w_q, x_scale, w_scale, bias, block_n)


def _blockscale_kernel(name: str, entry: str, x_q, w_q, x_scales, w_scale, bias,
                       out_dtype) -> torch.Tensor:
    f32 = _out_f32(name, out_dtype)
    n_kb = x_scales.shape[0]
    x_q, wt_q, xs, ws, b = _gemm_operands(name, x_q, w_q.t(), x_scales, w_scale, bias, n_kb)
    m, k = x_q.shape
    n = wt_q.shape[0]
    if k % n_kb or (k // n_kb) % 32:
        raise ValueError(f"{name}: {n_kb} scale blocks must cut K={k} into blocks that are "
                         "multiples of 32")
    out = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    with torch.cuda.device(x_q.device):
        err = getattr(_gemm_library(), entry)(
            x_q.data_ptr(), wt_q.data_ptr(), xs.data_ptr(), ws.data_ptr(), b.data_ptr(),
            out.data_ptr(), m, n, k, k // n_kb, f32, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    return out


def int8_linear_blockscale(x_q: torch.Tensor, w_q: torch.Tensor, x_scales: torch.Tensor,
                           w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                           out_dtype: torch.dtype = torch.bfloat16, block_m: int = 512,
                           block_n: int = 512, interpret: bool = False) -> torch.Tensor:
    """The product over activations with one scale per row and K block
    (``int8_matmul.py:585``): ``x_scales [n_kb, M]``, K blocks of ``bk =
    K/n_kb`` columns (the producer's ``bn``); each block's int32 sum is
    dequantized with its row scale into an f32 accumulator, in block order.
    On the card ``bk`` a multiple of 128 runs the ``wgmma`` kernel, any other
    the ``mma.sync`` one (:func:`int8_linear_blockscale_mma`); the C entry
    chooses by ``bk``. Each kernel launch adds one to
    ``int8_linear_blockscale.launches``."""
    if x_q.device.type == "cpu":
        return int8_linear_blockscale_reference(x_q, w_q, x_scales, w_scale, bias,
                                                out_dtype=out_dtype)
    out = _blockscale_kernel("int8_linear_blockscale", "team_int8_linear_blockscale", x_q, w_q,
                             x_scales, w_scale, bias, out_dtype)
    int8_linear_blockscale.launches += 1
    return out


def int8_linear_blockscale_mma(x_q: torch.Tensor, w_q: torch.Tensor, x_scales: torch.Tensor,
                               w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`int8_linear_blockscale` on the ``mma.sync`` kernel at every
    ``bk``: the yardstick of the ``wgmma`` kernel, as
    :func:`int8_linear_mma`. No path of the port calls it, and it counts no
    launch. On a CPU tensor: the plain version."""
    if x_q.device.type == "cpu":
        return int8_linear_blockscale_reference(x_q, w_q, x_scales, w_scale, bias,
                                                out_dtype=out_dtype)
    return _blockscale_kernel("int8_linear_blockscale_mma", "team_int8_linear_blockscale_mma",
                              x_q, w_q, x_scales, w_scale, bias, out_dtype)


def quantized_linear(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *, activation: Optional[str] = None,
                     out_dtype: torch.dtype = torch.bfloat16,
                     interpret: bool = False) -> torch.Tensor:
    """Quantize the rows of ``x`` (:func:`quantize_rows`), then
    :func:`int8_linear` (``int8_matmul.py:850``)."""
    x_q, x_scale = quantize_rows(x)
    return int8_linear(x_q, w_q, x_scale, w_scale, bias, activation=activation,
                       out_dtype=out_dtype)


_COUNTED = (ln_quantize_static, ln_quantize_static3, row_quant_static, ln_quantize,
            static_requant, static_residual, ln_quant_folded, int8_linear, int8_linear_nk,
            int8_linear_kgrid, int8_linear_wres, int8_linear_dma, int8_linear_gelu_quant,
            int8_linear_blockscale)


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0


reset_launch_counts()
