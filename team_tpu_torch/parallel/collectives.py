"""The collectives of the parallel port: ``all_gather``, ``all_reduce``
(sum, max, min) and ``broadcast`` over a ``torch.distributed`` process group.

The backend comes from the layout when the process group is made
(:func:`team_tpu_torch.parallel.layout.backend_for`): NCCL when each rank
has a card of its own, gloo when ranks share a card or run on the CPU (NCCL
refuses two ranks on one card).
gloo reduces and gathers host tensors, so under gloo a CUDA tensor goes
through host memory, and under NCCL a host tensor through the rank's card;
this is the rule, written in the log line that describes the devices
(:func:`describe`), never a recovery from a failure. bfloat16 crosses gloo
as its bytes (gather, broadcast) or as float32 (reductions, one rounding
back to bfloat16): gloo takes neither bfloat16 nor int16. With no process group joined every collective
is the identity over a world of one.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
_LAYOUT: dict = {}  # what init chose: backend, transport, device


def transport_of(backend: str, device: torch.device) -> str:
    if backend == "nccl":
        return "device (NCCL)"
    return "host staging of CUDA tensors (gloo)" if device.type == "cuda" else "host (gloo)"


def record_layout(backend: str, device: torch.device) -> None:
    _LAYOUT.update(backend=backend, transport=transport_of(backend, device), device=device)


def joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def describe() -> str:
    """The world, this rank, the backend and the transport; empty when no
    process group is joined."""
    if not joined():
        return ""
    return (f"world {dist.get_world_size()}, rank {dist.get_rank()}, backend "
            f"{dist.get_backend()}, transport {_LAYOUT.get('transport', 'unknown')}")


def group_size(group=None) -> int:
    return dist.get_world_size(group) if joined() else 1


def group_rank(group=None) -> int:
    return dist.get_rank(group) if joined() else 0


def _wire(t: torch.Tensor, group, reduce: bool) -> torch.Tensor:
    """``t`` as the group's backend takes it: on the host under gloo, on this
    rank's card under NCCL; bfloat16 as float32 (reductions) or int16 bits."""
    if dist.get_backend(group) == "nccl":
        x = t if t.device.type == "cuda" else t.to(_LAYOUT.get("device", "cuda"))
        return x.contiguous()
    x = t.detach().to("cpu").contiguous()
    if x.dtype == torch.bfloat16:
        x = x.float() if reduce else x.view(torch.uint8)
    return x


def _back(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if x.dtype != like.dtype:
        x = x.view(like.dtype) if x.dtype == torch.uint8 else x.to(like.dtype)
    return x.to(like.device)


def all_gather_list(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on every rank), in rank order; no gradient."""
    if group_size(group) == 1:
        return [t.detach()]
    x = _wire(t.detach(), group, reduce=False)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return [_back(p, t) for p in parts]


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order (JAX's
    ``all_gather(..., tiled=True)``); no gradient."""
    parts = all_gather_list(t, group)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' rows of ``t`` concatenated in rank order, this rank's rows
    the live tensor (its gradient flows) and the others' detached. A loss
    over the result is the group's global loss on every rank, and each
    rank's backward reaches its own rows only, so summing the ranks'
    gradients gives the global loss's gradient."""
    if group_size(group) == 1:
        return t
    parts = all_gather_list(t, group)
    parts[dist.get_rank(group)] = t
    return torch.cat(parts, dim=0)


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """The elementwise ``op`` (``sum``, ``max`` or ``min``) of the ranks'
    ``t``, as a new tensor on ``t``'s device; no gradient."""
    if group_size(group) == 1:
        return t.detach().clone()
    x = _wire(t.detach(), group, reduce=True)
    if x.data_ptr() == t.data_ptr():
        x = x.clone()
    dist.all_reduce(x, op=_OPS[op], group=group)
    return _back(x, t)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` (a global rank) on every rank, as a new tensor on
    ``t``'s device."""
    if group_size(group) == 1:
        return t.detach().clone()
    x = _wire(t.detach(), group, reduce=False)
    if x.data_ptr() == t.data_ptr():
        x = x.clone()
    dist.broadcast(x, src=src, group=group)
    return _back(x, t)


def barrier(group=None) -> None:
    if group_size(group) > 1:
        dist.barrier(group=group)
