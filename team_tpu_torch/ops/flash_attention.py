"""Blockwise (flash) attention: the hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of ``team_tpu/ops/flash_attention.py``: ``flash_attention``
(TPU kernel ``_flash_kernel``, reached from ``_flash_forward``) computes
``softmax(q kᵀ · dh^-0.5) v`` over ``[B, H, S, Dh]`` with a key mask
(``kv_len``) and an optional causal mask. Its numerics differ from the packed
kernel and from ``xla_attention``: q is scaled in f32 before the dot, K and V
are upcast to f32, p stays f32 in the PV product, and the output is
``acc / max(l, 1e-30)`` cast to the input dtype. The port follows the TPU
kernel as it runs in interpret mode on the CPU (full f32 dots), which is what
the JAX tests pin.

The CUDA kernels (``csrc/flash_attention.cu``) are compiled with ``nvcc`` on
first use and bound with ``ctypes``: bfloat16 runs on the tensor cores
(``mma.sync``, p kept to about 2^-17 by a split PV), float32 on the CUDA
cores (an explicit dispatch on the dtype). The kernel computes the forward
only. As in team_tpu (``jax.custom_vjp``, ``_flash_vjp``), ``flash_attention``
is differentiable all the same: where autograd records and an input requires
grad it goes through a ``torch.autograd.Function`` whose backward recomputes
:func:`xla_attention` and differentiates that (no backward kernel; Grad-CAM
on the ``pallas`` route is its user, the frozen towers' encodes never take
it). On a CPU tensor ``flash_attention`` computes the plain version; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from team_tpu_torch.ops._grad import recompute_vjp, wants_grad

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)  # the kernel's compiled head widths
_SOURCE = "flash_attention.cu"


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_len: Optional[int] = None, *, causal: bool = False) -> torch.Tensor:
    """Plain attention with an f32 softmax over ``[B, H, S, Dh]``
    (``team_tpu/ops/flash_attention.py:xla_attention``'s numerics: logits in
    f32, scaled after QKᵀ, masked to -1e30, probabilities cast to v's dtype).
    The plain route of the towers, and what the backwards of the
    differentiable kernels recompute."""
    dh = q.shape[-1]
    s = q.shape[2]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dh ** -0.5)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask.tril()
    if kv_len is not None:
        mask = mask & (torch.arange(s, device=q.device) < kv_len)[None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              kv_len: Optional[int] = None, *,
                              causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version, whole rows at once: q·dh^-0.5 in f32 against f32
    K, masked, p = exp(s − max) kept in f32, out = (p·v) / max(Σp, 1e-30) in
    the input dtype (the kernel's deferred normalisation)."""
    s = q.shape[2]
    dh = q.shape[-1]
    logits = torch.matmul(q.float() * dh ** -0.5, k.float().transpose(-1, -2))
    cols = torch.arange(s, device=q.device)
    mask = (cols < (s if kv_len is None else kv_len))[None, :].expand(s, s)
    if causal:
        mask = mask & (cols[None, :] <= cols[:, None])
    logits = torch.where(mask, logits, torch.full_like(logits, float("-inf")))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = torch.matmul(p, v.float()) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.to(q.dtype)


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether every row of ``t`` starts on 16 bytes (its data and each stride
    but the last): the bfloat16 tensor-core kernels copy K and V 16 bytes at
    a time with ``cp.async``."""
    return t.data_ptr() % 16 == 0 and all(
        st * t.element_size() % 16 == 0 for st in t.stride()[:-1])


def aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where :func:`rows_aligned`, else a contiguous copy that
    starts on 16 bytes (the same values)."""
    if rows_aligned(t):
        return t
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _library() -> ctypes.CDLL:
    from team_tpu_torch.ops._build import load_library

    lib = load_library(_SOURCE)
    lib.team_flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    lib.team_flash_attention_fwd.restype = ctypes.c_int
    return lib


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int,
                   causal: bool) -> torch.Tensor:
    """Launch the CUDA kernel. The output is a ``[B, H, S, Dh]`` view of a
    ``[B, S, H, Dh]`` tensor, so merging the heads back is free."""
    b, h, s, dh = q.shape
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head width {dh} not compiled (supported: {_HEAD_DIMS})")
    if q.dtype == torch.bfloat16:
        q, k, v = (aligned_rows(t) for t in (q, k, v))
    lib = _library()
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = lib.team_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ctypes.addressof(strides),
            _DTYPE_CODES[q.dtype], b, h, s, dh, kv_len, int(causal), dh ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[int] = None, *, causal: bool = False) -> torch.Tensor:
    """Flash attention over ``[B, H, S, Dh]`` float32 or bfloat16 inputs.

    ``kv_len`` masks keys ``>= kv_len``; ``causal`` the keys after each query.
    Any strides are taken for B, H and S; Dh must be contiguous (a bfloat16
    input whose rows do not start on 16 bytes is copied first,
    :func:`aligned_rows`). Differentiable in q, k and v (the backward
    recomputes :func:`xla_attention`). Each kernel launch adds one to
    ``flash_attention.launches`` (and to ``causal_launches`` when causal)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must share one [B, H, S, Dh] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    s = q.shape[2]
    kv_len = s if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= s:
        raise ValueError(f"kv_len={kv_len} outside [1, S={s}]")
    if q.device.type != "cpu" and (
            q.device.type != "cuda" or k.device != q.device or v.device != q.device):
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors on one device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.device.type == "cuda" and any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dimension of q, k and v must be contiguous")
    if wants_grad(q, k, v):
        return _FlashFn.apply(q, k, v, kv_len, causal)
    return _flash_call(q, k, v, kv_len, causal)


def _flash_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int,
                causal: bool) -> torch.Tensor:
    """The plain version on a CPU tensor, else one counted kernel launch."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_len, causal=causal)
    out = _flash_forward(q, k, v, kv_len, causal)
    flash_attention.launches += 1
    if causal:
        flash_attention.causal_launches += 1
    return out


class _FlashFn(torch.autograd.Function):
    """#14 with ``_flash_vjp``'s rule: the kernel forward; the backward
    differentiates :func:`xla_attention` at the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal):
        ctx.save_for_backward(q, k, v)
        ctx.kv_len, ctx.causal = kv_len, causal
        return _flash_call(q, k, v, kv_len, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        grads = recompute_vjp(lambda a, b, c: xla_attention(a, b, c, ctx.kv_len, causal=ctx.causal),
                              (q, k, v), ctx.needs_input_grad[:3], g)
        return (*grads, None, None)


flash_attention.launches = 0
flash_attention.causal_launches = 0


def build() -> None:
    """Compile and load the kernel now (set-up), instead of at its first call."""
    _library()


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    flash_attention.causal_launches = 0
