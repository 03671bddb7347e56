"""Autograd around the hand-written kernels.

The CUDA kernels compute forwards only, as the TPU kernels do. Four of them,
#1 ``fused_mha_packed``, #3 ``fused_mha_short``, #13 ``fused_attn_block``
and #14 ``flash_attention``, are differentiable as in ``team_tpu``
(``jax.custom_vjp``): the forward launches the kernel (its plain version on a
CPU tensor) and the backward recomputes the plain attention
(:func:`team_tpu_torch.ops.flash_attention.xla_attention`) in the kernel's
layout and differentiates that. Every other kernel wrapper refuses, on a
CUDA tensor, an input that needs a gradient, instead of returning an output
cut from the graph.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def wants_grad(*tensors) -> bool:
    """Whether autograd is recording and any of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(route: str, *tensors) -> None:
    """Raise where :func:`wants_grad`: the route's kernel has no backward."""
    if wants_grad(*tensors):
        raise RuntimeError(
            f"{route}: the CUDA kernel is forward only and has no backward; call it under "
            "torch.no_grad() or on inputs that do not require grad (the differentiable "
            "routes are fused_mha_packed, fused_mha_short, fused_attn_block and "
            "flash_attention)")


def recompute_vjp(reference: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor],
                  needs: Sequence[bool], grad_out: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
    """The vector-Jacobian product of ``reference`` at ``inputs``: the
    reference is recomputed under ``enable_grad`` and differentiated against
    ``grad_out`` cast to the first input's dtype (``g.astype(x.dtype)`` in
    team_tpu's backwards). ``None`` for each input where ``needs`` is false."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = reference(*leaves)
        wanted = [t for t, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, grad_out.to(inputs[0].dtype)))
    return tuple(next(grads) if n else None for n in needs)
