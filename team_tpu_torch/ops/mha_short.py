"""Packed multi-head attention: the hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of ``team_tpu/ops/mha_short.py:fused_mha_packed`` (TPU kernel
``_mha_packed_kernel``). Attention runs straight from the packed qkv
projection ``[B, S, 3*D]`` to ``[B, S, D]``, without head-split copies. The
CUDA kernel is ``team_tpu_torch/csrc/mha_packed.cu``; it is compiled with
``nvcc`` on first use and bound with ``ctypes``. Forward only: the towers that
call it are frozen.

On a CPU tensor the wrapper computes :func:`mha_packed_reference`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)  # the kernel's compiled head widths
_SMEM_LIMIT = 232448  # dynamic shared memory one block may opt into on sm_90
_SOURCE = "mha_packed.cu"


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, d = t.shape
    return t.reshape(b, s, heads, d // heads).permute(0, 2, 1, 3)


def mha_packed_reference(qkv: torch.Tensor, heads: int, causal: bool = False,
                         kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's casts: q is scaled in f32
    and rounded back to the input dtype, QKᵀ and PV accumulate in f32, the
    softmax is normalised before PV, and p is rounded to the input dtype."""
    b, s, d3 = qkv.shape
    d = d3 // 3
    dh = d // heads
    dtype = qkv.dtype
    q, k, v = (_split_heads(t, heads) for t in qkv.split(d, dim=-1))
    q = (q.float() * dh ** -0.5).to(dtype)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    mask = None
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=qkv.device).tril()
    if kv_len is not None and kv_len < s:
        kv_mask = (torch.arange(s, device=qkv.device) < kv_len)[None, :].expand(s, s)
        mask = kv_mask if mask is None else mask & kv_mask
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(dtype).float(), v.float()).to(dtype)
    return out.permute(0, 2, 1, 3).reshape(b, s, d)


def _library() -> ctypes.CDLL:
    from team_tpu_torch.ops._build import load_library

    lib = load_library(_SOURCE)
    lib.team_mha_packed_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
    lib.team_mha_packed_fwd.restype = ctypes.c_int
    lib.team_mha_packed_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.team_mha_packed_smem_bytes.restype = ctypes.c_size_t
    return lib


def build() -> None:
    """Compile and load the kernel now (set-up), instead of at its first call."""
    _library()


def fused_mha_packed(qkv: torch.Tensor, heads: int, *, causal: bool = False,
                     kv_len: Optional[int] = None) -> torch.Tensor:
    """MHA straight from the packed qkv projection.

    ``qkv: [B, S, 3*D]`` -> ``[B, S, D]`` in the input dtype (float32 or
    bfloat16). ``kv_len`` masks key columns ``>= kv_len``; ``causal`` applies
    the autoregressive mask (the text tower). Each kernel launch adds one to
    ``fused_mha_packed.launches`` (and to ``causal_launches`` when causal)."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, S, 3*D], got {tuple(qkv.shape)}")
    b, s, d3 = qkv.shape
    d = d3 // 3
    if d % heads:
        raise ValueError(f"D={d} is not divisible by heads={heads}")
    if kv_len is not None and not 1 <= kv_len <= s:
        raise ValueError(f"kv_len={kv_len} outside [1, S={s}]")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"qkv dtype {qkv.dtype} not supported (float32, bfloat16)")
    if qkv.device.type == "cpu":
        return mha_packed_reference(qkv, heads, causal, kv_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_mha_packed runs on CPU or CUDA tensors, got {qkv.device}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    dh = d // heads
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head width {dh} not compiled (supported: {_HEAD_DIMS})")
    lib = _library()
    code = _DTYPE_CODES[qkv.dtype]
    smem = lib.team_mha_packed_smem_bytes(code, s, dh)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S={s} needs {smem} bytes of shared memory for K/V "
                         f"(limit {_SMEM_LIMIT})")
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = lib.team_mha_packed_fwd(
            qkv.data_ptr(), out.data_ptr(), code, b, s, heads, dh,
            s if kv_len is None else kv_len, int(causal), dh ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mha_packed kernel launch failed: cudaError {err}")
    fused_mha_packed.launches += 1
    if causal:
        fused_mha_packed.causal_launches += 1
    return out


fused_mha_packed.launches = 0
fused_mha_packed.causal_launches = 0


def reset_launch_counts() -> None:
    fused_mha_packed.launches = 0
    fused_mha_packed.causal_launches = 0
