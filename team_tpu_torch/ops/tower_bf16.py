"""The bf16 towers' elementwise work around their GEMMs, as three CUDA kernels.

No TPU kernel is replaced: team_tpu leaves this work to XLA, which fuses it
into its dots and layer-norm fusions. The towers' plain composition
(``backbone/clip.py``: ``_layer_norm``, ``_linear``, ``_residual``,
``F.gelu``) runs about 35 PyTorch launches a block, most of them over float32
copies of the residual stream. On a CUDA tensor the towers' bf16 blocks call
these instead (``clip._tower_kernels`` says where), one kernel each
(``csrc/tower_bf16.cu``), reading their inputs once and writing their bf16
outputs once:

- :func:`bias_act`: ``gelu(y + b)`` over a GEMM's bf16 output, in place (the
  qkv bias without a GELU; the fc bias with the erf or the tanh GELU);
- :func:`residual_ln`: ``x + y + b`` in ``clip._residual``'s order, written
  over y, and in the same pass, where given, the layer norm of the result
  (a block's LN2, the next block's LN1);
- :func:`layer_norm`: the layer norm alone, over rows that may lie apart
  (``ln_pre``, a first LN1, ``ln_post`` on ``x[:, 0]``, the heads').

On a CPU tensor each wrapper computes its plain version (the
``*_reference`` function beside it, the composition it replaces) and
returns a new tensor. Bias, GELU and residual are the composition's bits on
the card too; the layer norm sums in another order, so its output may sit one
bf16 step off the composition's on a few outputs. Each launch adds one to
the wrapper's ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from team_tpu_torch.ops._grad import refuse_grad

_SOURCE = "tower_bf16.cu"
MAX_WIDTH = 2048  # team_tower_bf16_max_width(): the widest row the row kernels take
# the kernel's activations, by F.gelu's ``approximate`` (None: no activation)
GELUS = {None: 0, "none": 1, "tanh": 2}

_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The source's library, built and bound once."""
    global _LIB
    if _LIB is not None:
        return _LIB
    from team_tpu_torch.ops._build import load_library

    lib = load_library(_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.team_bias_act.argtypes = [ptr, ptr, i32, i32, i32, ptr]
    lib.team_residual_ln.argtypes = [ptr] * 6 + [i32, i32, ctypes.c_float, ptr]
    lib.team_layer_norm.argtypes = [ptr, ctypes.c_longlong, ptr, ptr, ptr, i32, i32,
                                    ctypes.c_float, ptr]
    for entry in (lib.team_bias_act, lib.team_residual_ln, lib.team_layer_norm,
                  lib.team_tower_bf16_max_width):
        entry.restype = ctypes.c_int
    _LIB = lib
    return lib


def build() -> None:
    """Compile and load the kernels now (set-up), instead of at their first call."""
    _library()


# ---------------------------------------------------------------------------
# the plain versions: the compositions the kernels replace
# ---------------------------------------------------------------------------

def bias_act_reference(y: torch.Tensor, bias: torch.Tensor, gelu: Optional[str] = None) -> torch.Tensor:
    """``y + b`` in y's dtype, then ``F.gelu(approximate=gelu)`` where
    ``gelu`` is not None (``clip._linear``'s bias and the MLP's GELU)."""
    y = y + bias.to(y.dtype)
    return y if gelu is None else F.gelu(y, approximate=gelu)


def layer_norm_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """``clip._layer_norm``: float32 statistics (population variance),
    ``(x - mean) * rsqrt(var + eps) * gamma + beta``, back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(x.dtype)


def residual_ln_reference(x: torch.Tensor, y: torch.Tensor, bias: torch.Tensor,
                          gamma: Optional[torch.Tensor] = None, beta: Optional[torch.Tensor] = None,
                          eps: float = 1e-5) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``x + y + b`` (two roundings in x's dtype, ``clip._residual``'s order)
    and its layer norm where ``gamma`` is given, else None."""
    out = x + y + bias.to(x.dtype)
    return out, None if gamma is None else layer_norm_reference(out, gamma, beta, eps)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check(name: str, x: torch.Tensor, width_limit: bool = True) -> None:
    """x must be a float tensor on the CPU, or bf16 on a card, a width the
    kernel takes; on the card it must need no gradient."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {x.device}")
    if not x.dtype.is_floating_point:
        raise TypeError(f"{name}: the input must be a float tensor, got {x.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if d % 8 or d == 0:
        raise ValueError(f"{name}: the kernel takes widths divisible by 8, got {d}")
    if width_limit and d > MAX_WIDTH:
        raise ValueError(f"{name}: width {d} is wider than the kernel's {MAX_WIDTH}")
    if x.device.type == "cuda":
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got {x.dtype}")
        refuse_grad(name, x)


def _vector(name: str, vname: str, t: torch.Tensor, d: int, x: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """A per-column vector of ``d`` values on x's device, as a flat
    contiguous ``dtype`` tensor, 16-byte aligned (``bias.to(x.dtype)`` in the
    composition rounds a float32 bias to bf16; gamma and beta stay float32)."""
    if t.numel() != d:
        raise ValueError(f"{name}: {vname} must hold {d} values, got {tuple(t.shape)}")
    if t.device != x.device:
        raise ValueError(f"{name}: {vname} lies on {t.device}, the input on {x.device}")
    if x.device.type == "cuda":
        refuse_grad(name, t)
    t = t.reshape(-1).to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous, 16-byte-aligned ``[M, D]``."""
    t2 = t.reshape(-1, t.shape[-1])
    return t2 if t2.is_contiguous() and t2.data_ptr() % 16 == 0 else t2.contiguous()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def bias_act(y: torch.Tensor, bias: torch.Tensor, gelu: Optional[str] = None) -> torch.Tensor:
    """``gelu(y + b)`` over ``y [..., N]``: the bias ``[N]`` added in y's
    dtype, then, where ``gelu`` is not None, ``F.gelu(approximate=gelu)``
    (``"none"``: the erf GELU; ``"tanh"``). On the card the result is written
    over y (a copy of y where it is not contiguous and 16-byte aligned) and
    returned, the composition's bits (:func:`bias_act_reference`, which the
    CPU returns). Each launch adds one to ``bias_act.launches``."""
    if gelu not in GELUS:
        raise ValueError(f"bias_act: gelu must be one of {sorted(GELUS, key=str)}, got {gelu!r}")
    _check("bias_act", y, width_limit=False)
    n = y.shape[-1]
    if y.device.type == "cpu":
        _vector("bias_act", "bias", bias, n, y, bias.dtype)
        return bias_act_reference(y, bias, gelu)
    b = _vector("bias_act", "bias", bias, n, y, torch.bfloat16)
    y2 = _rows(y)
    with torch.cuda.device(y.device):
        err = _library().team_bias_act(y2.data_ptr(), b.data_ptr(), y2.shape[0], n, GELUS[gelu],
                                       torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "bias_act")
    bias_act.launches += 1
    return y2.view(y.shape)


def residual_ln(x: torch.Tensor, y: torch.Tensor, bias: torch.Tensor,
                gamma: Optional[torch.Tensor] = None, beta: Optional[torch.Tensor] = None,
                eps: float = 1e-5) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``x' = x + y + b`` over ``[..., D]`` (``(x + y) + b``, each sum rounded
    to x's dtype) and, where ``gamma`` and ``beta`` are given, its layer norm
    ``h`` with ``eps``: ``(x', h)``, h None without them. On the card x' is
    written over y (a copy of y where it is not contiguous and 16-byte
    aligned), bias and residual the composition's bits, h within one bf16
    step of it on a few outputs; on the CPU :func:`residual_ln_reference`.
    Each launch adds one to ``residual_ln.launches``."""
    if (gamma is None) != (beta is None):
        raise ValueError("residual_ln: give both gamma and beta, or neither")
    _check("residual_ln", x)
    if y.shape != x.shape or y.dtype != x.dtype or y.device != x.device:
        raise ValueError(f"residual_ln: y {tuple(y.shape)} {y.dtype} on {y.device} must match "
                         f"x {tuple(x.shape)} {x.dtype} on {x.device}")
    d = x.shape[-1]
    if x.device.type == "cpu":
        for vname, t in (("bias", bias), ("gamma", gamma), ("beta", beta)):
            if t is not None:
                _vector("residual_ln", vname, t, d, x, t.dtype)
        return residual_ln_reference(x, y, bias, gamma, beta, eps)
    refuse_grad("residual_ln", y)
    b = _vector("residual_ln", "bias", bias, d, x, torch.bfloat16)
    g = be = h = None
    if gamma is not None:
        g = _vector("residual_ln", "gamma", gamma, d, x, torch.float32)
        be = _vector("residual_ln", "beta", beta, d, x, torch.float32)
        h = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    x2, y2 = _rows(x), _rows(y)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        err = _library().team_residual_ln(x2.data_ptr(), y2.data_ptr(), b.data_ptr(), ptr(g),
                                          ptr(be), ptr(h), x2.shape[0], d, eps,
                                          torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "residual_ln")
    residual_ln.launches += 1
    return y2.view(x.shape), h


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """The layer norm of ``x [..., D]`` with ``eps`` and the affine ``gamma``,
    ``beta`` ``[D]``, in x's dtype (:func:`layer_norm_reference`, which the
    CPU returns). On the card x's rows may lie a fixed stride apart (a
    ``x[:, 0]`` view of ``[B, S, D]``: its rows S·D apart); another layout is
    copied. The output is contiguous, within one bf16 step of the
    composition on a few outputs. Each launch adds one to
    ``layer_norm.launches``."""
    _check("layer_norm", x)
    d = x.shape[-1]
    if x.device.type == "cpu":
        for vname, t in (("gamma", gamma), ("beta", beta)):
            _vector("layer_norm", vname, t, d, x, t.dtype)
        return layer_norm_reference(x, gamma, beta, eps)
    g = _vector("layer_norm", "gamma", gamma, d, x, torch.float32)
    be = _vector("layer_norm", "beta", beta, d, x, torch.float32)
    x2 = x.reshape(-1, d)
    if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.stride(0) < d or x2.data_ptr() % 16:
        x2 = x2.contiguous()
    h = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().team_layer_norm(x2.data_ptr(), x2.stride(0), g.data_ptr(), be.data_ptr(),
                                         h.data_ptr(), x2.shape[0], d, eps,
                                         torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "layer_norm")
    layer_norm.launches += 1
    return h


def reset_launch_counts() -> None:
    for fn in (bias_act, residual_ln, layer_norm):
        fn.launches = 0


reset_launch_counts()
