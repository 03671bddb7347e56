"""Packed multi-head attention: the hand-written Hopper kernels and their
plain PyTorch versions.

Counterparts of ``team_tpu/ops/mha_short.py``:
- ``fused_mha_packed`` (TPU kernel ``_mha_packed_kernel``): attention
  straight from the packed qkv projection ``[B, S, 3*D]`` to ``[B, S, D]``,
  without head-split copies; CUDA kernel ``csrc/mha_packed.cu`` (bfloat16 on
  the tensor cores through the attention tile of ``csrc/mma_attention.cuh``,
  float32 on the CUDA cores).
- ``fused_mha_short`` (TPU kernel ``_mha_kernel``): non-causal attention over
  pre-split ``[B, H, S, Dh]`` with a key mask; the same CUDA kernel over the
  tensors' own strides.
- ``fused_mha_short_v2`` (TPU kernel ``_mha_kernel_v2``): the same with
  the softmax normalisation deferred to the output and an optional bf16
  exponential; in bfloat16 a kernel of the same source that sums each logit
  on the CUDA cores in head-dimension order (its plain version pins p to
  such sums) and runs PV on the tensor cores, in float32 the CUDA-core
  kernel with those two switches.
- ``fused_mha_packed_proj`` and ``fused_attn_block`` (TPU kernels
  ``_mha_packed_proj_kernel`` and ``_attn_block_kernel``): packed attention
  with the out-projection GEMM, its bias and the residual fused in, and the
  whole attention sub-block (layer norm, qkv GEMM, attention, out-projection,
  residual); CUDA kernels ``csrc/attn_block.cu`` (the sub-block in two
  launches, through a ``[B, S, 3*D]`` workspace; bfloat16 on the tensor
  cores, float32 on the CUDA cores).
- ``fused_mha_packed_q3i``, ``fused_mha_packed_q3i_cls``,
  ``fused_mha_packed_q3i_cls_split`` and ``fused_mha_packed_q3i_sb`` (TPU
  kernels ``_mha_packed_q3i_kernel``, ``_mha_packed_q3i_cls_kernel``,
  ``_mha_packed_q3i_cls_split_kernel`` and ``_mha_packed_q3i_sb_kernel``):
  the int8 static-W8A8 tier's integer-QKᵀ attention, int8 ``[B, S, 3*D]``
  to int8 ``[B, S, D]`` with the TPU kernel's softmax and normalisation
  modes, the CLS row only (``[B, 1, D]``, from the packed tensor or from a
  split q ``[B, 1, D]`` and kv ``[B, S, 2*D]``), and sequence-major
  ``[S, B, 3*D]`` to ``[S, B, D]``; CUDA kernels over strides,
  ``csrc/mha_packed_q3i.cu``: q·k on the int8 tensor cores and p·v on the
  bf16 ones for every entry with more than one query row; for the CLS row,
  bound by its bytes, a block per (head, sample) that streams K and V into
  shared memory by ``cp.async`` with every warp computing. The CLS entries
  take S up to :func:`q3i_cls_max_seq` and raise past it on any device.
- ``fused_mha_packed_tp`` and ``fused_mha_packed_q3i_tp`` (``shard_map``
  head splits of ``_mha_packed_kernel`` and ``_mha_packed_q3i_kernel``):
  under a registered tensor-parallel layout (:func:`set_tp_mesh`) rank r of
  nm computes heads ``[r·H/nm, (r+1)·H/nm)`` of the full packed qkv and
  returns its ``[B, S, D/nm]`` slice; entries of ``csrc/mha_packed.cu`` and
  ``csrc/mha_packed_q3i.cu`` that read the rank's heads in place.
- ``fused_mha_packed_q`` and ``fused_mha_packed_q3`` (TPU kernels
  ``_mha_packed_q_kernel`` and ``_mha_packed_q3_kernel``): the same tier's
  int8-in, int8-out attention with per-channel dequant (in float32 and in
  bfloat16 respectively) and bf16 products, ``[B*S, 3*D]`` to ``[B*S, D]``
  and ``[B, S, 3*D]`` to ``[B, S, D]``; CUDA kernels ``csrc/mha_packed_q.cu``
  (K and V dequantized into the attention tile of ``csrc/mma_attention.cuh``,
  on the bf16 tensor cores).

The kernels are compiled with ``nvcc`` on first use and bound with
``ctypes``, and compute forwards only. ``fused_mha_packed``,
``fused_mha_short`` and ``fused_attn_block`` are differentiable as in
team_tpu (``jax.custom_vjp``): where autograd records and an input requires
grad they go through a ``torch.autograd.Function`` whose backward recomputes
the plain attention (:mod:`team_tpu_torch.ops._grad`); Grad-CAM is their
user, the frozen towers' encodes never take it. Every other wrapper raises
on such an input on the card. On a CPU tensor each wrapper computes its
plain version; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from team_tpu_torch.ops._grad import recompute_vjp, refuse_grad, wants_grad
from team_tpu_torch.ops.flash_attention import aligned_rows, rows_aligned, xla_attention
from team_tpu_torch.ops.int8_matmul import INV127

NEG_INF = -1e30
LOG2E = 1.4426950408889634

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PACKED_HEAD_DIMS = (32, 64, 128)  # the packed kernel's compiled head widths
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
    out = _softmax_pv(q, k, v, causal, kv_len, dtype).to(dtype)
    return out.permute(0, 2, 1, 3).reshape(b, s, d)


def _softmax_pv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                kv_len: Optional[int], p_dtype: torch.dtype) -> torch.Tensor:
    """The packed kernels' attention over head-split ``[B, H, S, dh]``: QKᵀ
    accumulated in f32, masked logits set to -1e30, the f32 row-max softmax
    normalised before PV, p rounded to ``p_dtype``, PV accumulated in f32."""
    s = q.shape[2]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    mask = None
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    if kv_len is not None and kv_len < s:
        kv_mask = (torch.arange(s, device=q.device) < kv_len)[None, :].expand(s, s)
        mask = kv_mask if mask is None else mask & kv_mask
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p.to(p_dtype).float(), v.float())


def _library() -> ctypes.CDLL:
    from team_tpu_torch.ops._build import load_library

    lib = load_library(_SOURCE)
    lib.team_mha_packed_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
    lib.team_mha_packed_fwd.restype = ctypes.c_int
    # q, k, v, out; dtype, batch, heads, seq, dh; strides of q/k/v; kv_len, scale; stream
    lib.team_mha_short_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
        + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    lib.team_mha_short_fwd.restype = ctypes.c_int
    # team_mha_short_fwd's arguments, then bf16_exp before the stream
    lib.team_mha_short_v2_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.team_mha_short_v2_fwd.restype = ctypes.c_int
    # qkv, out; dtype, batch, seq, heads_local, dh, rank, nm, kv_len, causal; scale; stream
    lib.team_mha_packed_tp_fwd.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                                           + [ctypes.c_float, ctypes.c_void_p])
    lib.team_mha_packed_tp_fwd.restype = ctypes.c_int
    # dtype, seq, dh, v2 (1 for team_mha_short_v2_fwd)
    lib.team_mha_packed_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.team_mha_packed_smem_bytes.restype = ctypes.c_size_t
    return lib


def build() -> None:
    """Compile and load every kernel of this module now (set-up), instead of
    at its first call: one ``nvcc`` for each source, started together."""
    from team_tpu_torch.ops._build import build_all

    build_all([_SOURCE, _BLOCK_SOURCE, _Q3I_SOURCE, _Q_SOURCE])
    _library()
    _block_library()
    _q3i_library()
    _q_library()


def fused_mha_packed(qkv: torch.Tensor, heads: int, *, causal: bool = False,
                     kv_len: Optional[int] = None) -> torch.Tensor:
    """MHA straight from the packed qkv projection.

    ``qkv: [B, S, 3*D]`` -> ``[B, S, D]`` in the input dtype (float32 or
    bfloat16). ``kv_len`` masks key columns ``>= kv_len``; ``causal`` applies
    the autoregressive mask (the text tower). Differentiable in ``qkv`` (the
    backward recomputes :func:`mha_packed_backward_reference`). Each kernel
    launch adds one to ``fused_mha_packed.launches`` (and to
    ``causal_launches`` when causal)."""
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
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mha_packed runs on CPU or CUDA tensors, got {qkv.device}")
    if wants_grad(qkv):
        return _MhaPackedFn.apply(qkv, heads, causal, kv_len)
    return _mha_packed_call(qkv, heads, causal, kv_len)


def _mha_packed_call(qkv: torch.Tensor, heads: int, causal: bool,
                     kv_len: Optional[int]) -> torch.Tensor:
    """#1's plain version on a CPU tensor, else one counted kernel launch."""
    if qkv.device.type == "cpu":
        return mha_packed_reference(qkv, heads, causal, kv_len)
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    b, s, d3 = qkv.shape
    d = d3 // 3
    dh = d // heads
    if dh not in PACKED_HEAD_DIMS:
        raise ValueError(f"head width {dh} not compiled (supported: {PACKED_HEAD_DIMS})")
    lib = _library()
    code = _DTYPE_CODES[qkv.dtype]
    smem = lib.team_mha_packed_smem_bytes(code, s, dh, 0)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S={s} needs {smem} bytes of shared memory for K/V "
                         f"(limit {_SMEM_LIMIT})")
    if qkv.dtype == torch.bfloat16:
        qkv = aligned_rows(qkv)
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


def mha_packed_backward_reference(qkv: torch.Tensor, heads: int, causal: bool = False,
                                  kv_len: Optional[int] = None) -> torch.Tensor:
    """What #1's backward differentiates (``_xla_packed_reference``): the
    packed layout around :func:`xla_attention`, ``kv_len`` dropped where it
    masks nothing."""
    b, s, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (_split_heads(t, heads) for t in qkv.split(d, dim=-1))
    o = xla_attention(q, k, v, kv_len if (kv_len is not None and kv_len < s) else None,
                      causal=causal)
    return o.permute(0, 2, 1, 3).reshape(b, s, d)


class _MhaPackedFn(torch.autograd.Function):
    """#1 with ``_mha_packed_vjp``'s rule: the kernel forward; the backward
    differentiates :func:`mha_packed_backward_reference` at the saved qkv."""

    @staticmethod
    def forward(ctx, qkv, heads, causal, kv_len):
        ctx.save_for_backward(qkv)
        ctx.args = (heads, causal, kv_len)
        return _mha_packed_call(qkv, heads, causal, kv_len)

    @staticmethod
    def backward(ctx, g):
        heads, causal, kv_len = ctx.args
        (dqkv,) = recompute_vjp(lambda t: mha_packed_backward_reference(t, heads, causal, kv_len),
                                ctx.saved_tensors, ctx.needs_input_grad[:1], g)
        return dqkv, None, None, None


fused_mha_packed.launches = 0
fused_mha_packed.causal_launches = 0


# ---------------------------------------------------------------------------
# pre-split attention, and the fused attention sub-block
# ---------------------------------------------------------------------------

_BLOCK_SOURCE = "attn_block.cu"
_BLOCK_HEAD_DIMS = (32, 64)  # the fused kernels' compiled head widths


def mha_short_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of ``_mha_kernel`` over ``[B, H, S, Dh]``: the
    packed kernels' casts (:func:`mha_packed_reference`), non-causal, keys
    ``>= kv_len`` masked; every query row is returned."""
    dtype = q.dtype
    qs = (q.float() * q.shape[-1] ** -0.5).to(dtype)
    return _softmax_pv(qs, k, v, False, kv_len, dtype).to(dtype)


def mha_short_v2_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: Optional[int] = None,
                           exp_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of ``_mha_kernel_v2`` over ``[B, H, S, Dh]``:
    ``q = round(q·dh^-0.5)``; f32 logits with keys ``>= kv_len`` at -1e30;
    ``p = exp((logits - rowmax).astype(exp_dtype))``; ``den = Σ f32(p)``;
    ``out = (Σ_j round(p_j)·v_j) / den`` in f32, stored in the input dtype
    (round: to the input dtype). Every query row is returned. With a
    bfloat16 ``exp_dtype`` the argument is rounded to bf16 and the
    exponential kept in f32, as XLA computes it on the CPU (its excess
    precision elides the rounding of ``exp``'s bf16 result before the f32
    row sum)."""
    dtype = q.dtype
    s = q.shape[2]
    qs = (q.float() * q.shape[-1] ** -0.5).to(dtype)
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if kv_len is not None and kv_len < s:
        keep = (torch.arange(s, device=q.device) < kv_len)[None, :].expand(s, s)
        logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    p = torch.exp((logits - logits.amax(dim=-1, keepdim=True)).to(exp_dtype).float())
    den = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(dtype).float(), v.float())
    return (out / den).to(dtype)


def mha_packed_proj_reference(qkv: torch.Tensor, out_w: torch.Tensor, out_b: torch.Tensor,
                              x_resid: torch.Tensor, heads: int,
                              causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``_mha_packed_proj_kernel``: each head's
    attention output rounded to the input dtype (:func:`mha_packed_reference`),
    then ``round(x + (o @ W_out + b_out))`` with the product accumulated in
    f32 (an f32 matmul of the input-dtype operands), the float32 bias added
    to it, and one rounding after the f32 residual."""
    dtype = qkv.dtype
    o = mha_packed_reference(qkv, heads, causal)
    proj = torch.matmul(o.float(), out_w.to(dtype).float()) + out_b.float().reshape(-1)
    return (x_resid.float() + proj).to(dtype)


def attn_block_reference(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                         qkv_w: torch.Tensor, qkv_b: torch.Tensor, out_w: torch.Tensor,
                         out_b: torch.Tensor, heads: int, causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``_attn_block_kernel``: the f32 layer norm
    (population variance, eps 1e-5) rounded to the input dtype, then
    ``qkv = round(h @ W_qkv + b_qkv)`` accumulated in f32 with the float32
    bias (one rounding), then :func:`mha_packed_proj_reference` with ``x`` as
    the residual."""
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    h = (x32 - mean) * torch.rsqrt(var + 1e-5)
    h = (h * ln_scale.float().reshape(-1) + ln_bias.float().reshape(-1)).to(dtype)
    qkv = (torch.matmul(h.float(), qkv_w.to(dtype).float()) + qkv_b.float().reshape(-1)).to(dtype)
    return mha_packed_proj_reference(qkv, out_w, out_b, x, heads, causal)


def _block_library() -> ctypes.CDLL:
    from team_tpu_torch.ops._build import load_library

    lib = load_library(_BLOCK_SOURCE)
    # qkv, w_out, b_out, x, out; dtype, batch, seq, heads, dh, causal; scale; stream
    lib.team_mha_packed_proj_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    lib.team_mha_packed_proj_fwd.restype = ctypes.c_int
    # x, ln_g, ln_b, w_qkv, b_qkv, qkv; dtype, rows, d_model; stream
    lib.team_ln_qkv_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.team_ln_qkv_fwd.restype = ctypes.c_int
    lib.team_attn_block_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.team_attn_block_smem_bytes.restype = ctypes.c_size_t
    return lib


def _on_card(name: str, main: torch.Tensor, others: dict) -> None:
    """Raise unless ``main`` lies on the CPU or a CUDA card with every tensor
    of ``others`` (name -> tensor) beside it."""
    if main.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {main.device}")
    for other, t in others.items():
        if t.device != main.device:
            raise ValueError(f"{other} lies on {t.device}, the input on {main.device}")


def _check_short(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: Optional[int]) -> None:
    """Check pre-split ``[B, H, S, Dh]`` inputs of the short-attention entries."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one [B, H, S, Dh] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    s = q.shape[2]
    if kv_len is not None and not 1 <= kv_len <= s:
        raise ValueError(f"kv_len={kv_len} outside [1, S={s}]")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    _on_card(name, q, {"k": k, "v": v})


def _short_operands(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k and v as the pre-split entries pass them: the tensors themselves
    where they share one set of strides with a unit stride along Dh (and, for
    bfloat16, every row starts on 16 bytes, :func:`rows_aligned`), else
    contiguous copies of all three that start on 16 bytes."""
    ts = (q, k, v)
    if (q.stride() == k.stride() == v.stride() and q.stride(-1) == 1
            and (q.dtype != torch.bfloat16 or all(rows_aligned(t) for t in ts))):
        return ts
    return tuple(aligned_rows(t.contiguous()) for t in ts)


def _launch_short(entry: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_len: Optional[int], *extra, v2: int = 0) -> torch.Tensor:
    """Launch ``entry`` of ``csrc/mha_packed.cu`` on checked CUDA inputs
    (``extra``: the entry's arguments after the scale; ``v2``: the entry's
    code for ``team_mha_packed_smem_bytes``)."""
    b, h, s, dh = q.shape
    if dh not in PACKED_HEAD_DIMS:
        raise ValueError(f"head width {dh} not compiled (supported: {PACKED_HEAD_DIMS})")
    lib = _library()
    code = _DTYPE_CODES[q.dtype]
    smem = lib.team_mha_packed_smem_bytes(code, s, dh, v2)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S={s} needs {smem} bytes of shared memory for K/V (limit {_SMEM_LIMIT})")
    q, k, v = _short_operands(q, k, v)
    out = torch.empty((b, h, s, dh), dtype=q.dtype, device=q.device)
    sb, sh, sr, _ = q.stride()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code, b, h, s, dh,
            sb, sh, sr, s if kv_len is None else kv_len, dh ** -0.5, *extra,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return out


def fused_mha_short(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Non-causal attention over pre-split ``[B, H, S, Dh]`` (float32 or
    bfloat16) with keys ``>= kv_len`` masked; returns ``[B, H, S, Dh]``
    contiguous, every query row. Any strides with a unit stride along Dh
    (shared by q, k and v) go to the kernel as they are. Differentiable in q,
    k and v (the backward recomputes :func:`xla_attention`, non-causal). Each
    kernel launch adds one to ``fused_mha_short.launches``."""
    _check_short("fused_mha_short", q, k, v, kv_len)
    kv_len = q.shape[2] if kv_len is None else int(kv_len)
    if wants_grad(q, k, v):
        return _MhaShortFn.apply(q, k, v, kv_len)
    return _mha_short_call(q, k, v, kv_len)


def _mha_short_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: int) -> torch.Tensor:
    """#3's plain version on a CPU tensor, else one counted kernel launch."""
    if q.device.type == "cpu":
        return mha_short_reference(q, k, v, kv_len)
    out = _launch_short("team_mha_short_fwd", q, k, v, kv_len)
    fused_mha_short.launches += 1
    return out


class _MhaShortFn(torch.autograd.Function):
    """#3 with ``_mha_short_vjp``'s rule: the kernel forward; the backward
    differentiates :func:`xla_attention` (non-causal) at the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.kv_len = kv_len
        return _mha_short_call(q, k, v, kv_len)

    @staticmethod
    def backward(ctx, g):
        grads = recompute_vjp(lambda a, b, c: xla_attention(a, b, c, ctx.kv_len, causal=False),
                              ctx.saved_tensors, ctx.needs_input_grad[:3], g)
        return (*grads, None)


_EXP_DTYPES = (torch.float32, torch.bfloat16)


def fused_mha_short_v2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_len: Optional[int] = None, *, exp_dtype: torch.dtype = torch.float32,
                       q_pad: int = 16) -> torch.Tensor:
    """:func:`fused_mha_short` with ``_mha_kernel_v2``'s softmax: the
    normalisation deferred to the ``[S, Dh]`` output and the exponential in
    ``exp_dtype`` (float32 or bfloat16); see :func:`mha_short_v2_reference`.
    ``q_pad`` is the TPU kernel's query-row alignment (a positive int): padded
    rows are sliced off and padded keys masked there, so every value gives
    the same result, and the kernel computes the S rows alone. bfloat16 runs
    the kernel with CUDA-core logits and a tensor-core PV, float32 the
    CUDA-core kernel. Each kernel launch adds one to
    ``fused_mha_short_v2.launches``."""
    if isinstance(q_pad, bool) or not isinstance(q_pad, int) or q_pad < 1:
        raise ValueError(f"q_pad must be a positive int, got {q_pad!r}")
    if exp_dtype not in _EXP_DTYPES:
        raise TypeError(f"exp_dtype must be float32 or bfloat16, got {exp_dtype}")
    _check_short("fused_mha_short_v2", q, k, v, kv_len)
    if q.device.type == "cpu":
        return mha_short_v2_reference(q, k, v, kv_len, exp_dtype)
    refuse_grad("fused_mha_short_v2 (#4)", q, k, v)
    out = _launch_short("team_mha_short_v2_fwd", q, k, v, kv_len,
                        int(exp_dtype == torch.bfloat16), v2=1)
    fused_mha_short_v2.launches += 1
    return out


def _check_proj_smem(lib: ctypes.CDLL, code: int, s: int, d: int, dh: int) -> None:
    """Raise unless one block of the attention + out-projection kernel fits."""
    smem = lib.team_attn_block_smem_bytes(0, code, s, d, dh)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S={s}, D={d} need {smem} bytes of shared memory (limit {_SMEM_LIMIT})")


def _launch_packed_proj(qkv: torch.Tensor, out_w: torch.Tensor, out_b: torch.Tensor,
                        x: torch.Tensor, heads: int, causal: bool) -> torch.Tensor:
    """Launch the attention + out-projection kernel on checked CUDA inputs."""
    b, s, d3 = qkv.shape
    d = d3 // 3
    dh = d // heads
    if dh not in _BLOCK_HEAD_DIMS:
        raise ValueError(f"head width {dh} not compiled (supported: {_BLOCK_HEAD_DIMS})")
    if not (qkv.is_contiguous() and x.is_contiguous()):
        raise ValueError("qkv and x_resid must be contiguous")
    lib = _block_library()
    code = _DTYPE_CODES[qkv.dtype]
    _check_proj_smem(lib, code, s, d, dh)
    qkv, x = aligned_rows(qkv), aligned_rows(x)
    w = aligned_rows(out_w.to(qkv.dtype).contiguous())
    bias = out_b.reshape(-1).float().contiguous()
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = lib.team_mha_packed_proj_fwd(
            qkv.data_ptr(), w.data_ptr(), bias.data_ptr(), x.data_ptr(), out.data_ptr(), code, b,
            s, heads, dh, int(causal), dh ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mha_packed_proj kernel launch failed: cudaError {err}")
    return out


def fused_mha_packed_proj(qkv: torch.Tensor, out_w: torch.Tensor, out_b: torch.Tensor,
                          x_resid: torch.Tensor, heads: int, *,
                          causal: bool = False) -> torch.Tensor:
    """``x_resid + attention(qkv) @ out_w + out_b`` in one kernel.

    ``qkv: [B, S, 3*D]`` packed, ``x_resid: [B, S, D]`` (both float32 or
    bfloat16), ``out_w: [D, D]`` (cast to that dtype), ``out_b: [D]`` (added
    in float32). Returns ``[B, S, D]``. Each kernel launch adds one to
    ``fused_mha_packed_proj.launches`` (and to ``causal_launches`` when
    causal)."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, S, 3*D], got {tuple(qkv.shape)}")
    b, s, d3 = qkv.shape
    d = d3 // 3
    if d % heads:
        raise ValueError(f"D={d} is not divisible by heads={heads}")
    if tuple(x_resid.shape) != (b, s, d) or tuple(out_w.shape) != (d, d) or out_b.numel() != d:
        raise ValueError(f"x_resid {tuple(x_resid.shape)}, out_w {tuple(out_w.shape)} and out_b "
                         f"{tuple(out_b.shape)} do not fit qkv {tuple(qkv.shape)}")
    if qkv.dtype not in _DTYPE_CODES or x_resid.dtype != qkv.dtype:
        raise TypeError(f"qkv and x_resid must share float32 or bfloat16, got {qkv.dtype}, "
                        f"{x_resid.dtype}")
    _on_card("fused_mha_packed_proj", qkv, {"out_w": out_w, "out_b": out_b, "x_resid": x_resid})
    if qkv.device.type == "cpu":
        return mha_packed_proj_reference(qkv, out_w, out_b, x_resid, heads, causal)
    refuse_grad("fused_mha_packed_proj (#12)", qkv, out_w, out_b, x_resid)
    out = _launch_packed_proj(qkv, out_w, out_b, x_resid, heads, causal)
    fused_mha_packed_proj.launches += 1
    if causal:
        fused_mha_packed_proj.causal_launches += 1
    return out


def fused_attn_block(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                     qkv_w: torch.Tensor, qkv_b: torch.Tensor, out_w: torch.Tensor,
                     out_b: torch.Tensor, heads: int, *, causal: bool = False) -> torch.Tensor:
    """``x + out_proj(attention(qkv(LN(x))))`` over ``[B, S, D]`` (float32 or
    bfloat16). ``ln_scale``, ``ln_bias``, ``qkv_b`` and ``out_b`` are used in
    float32, ``qkv_w: [D, 3D]`` and ``out_w: [D, D]`` in x's dtype.

    On the card two kernels run: the layer norm and the qkv GEMM into a
    ``[B, S, 3*D]`` workspace (each launch adds one to
    ``fused_attn_block.launches``, and to ``causal_launches`` when causal),
    then the attention + out-projection kernel of
    :func:`fused_mha_packed_proj` (one to ``fused_attn_block.proj_launches``).
    Differentiable in x, the layer-norm affine, both weights and both biases
    (the backward recomputes :func:`attn_block_backward_reference`)."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, D], got {tuple(x.shape)}")
    b, s, d = x.shape
    if d % heads:
        raise ValueError(f"D={d} is not divisible by heads={heads}")
    if (tuple(qkv_w.shape) != (d, 3 * d) or tuple(out_w.shape) != (d, d) or ln_scale.numel() != d
            or ln_bias.numel() != d or qkv_b.numel() != 3 * d or out_b.numel() != d):
        raise ValueError(f"the weights ({tuple(qkv_w.shape)}, {tuple(out_w.shape)}), biases or "
                         f"layer-norm affine do not fit x {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype} not supported (float32, bfloat16)")
    _on_card("fused_attn_block", x, {"ln_scale": ln_scale, "ln_bias": ln_bias, "qkv_w": qkv_w,
                                     "qkv_b": qkv_b, "out_w": out_w, "out_b": out_b})
    args = (x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b)
    if wants_grad(*args):
        return _AttnBlockFn.apply(*args, heads, causal)
    return _attn_block_call(*args, heads, causal)


def _attn_block_call(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                     qkv_w: torch.Tensor, qkv_b: torch.Tensor, out_w: torch.Tensor,
                     out_b: torch.Tensor, heads: int, causal: bool) -> torch.Tensor:
    """#13's plain version on a CPU tensor, else its two counted launches."""
    if x.device.type == "cpu":
        return attn_block_reference(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b, heads,
                                    causal)
    b, s, d = x.shape
    dh = d // heads
    if dh not in _BLOCK_HEAD_DIMS:  # which also makes D a multiple of the 32-deep k-slice
        raise ValueError(f"head width {dh} not compiled (supported: {_BLOCK_HEAD_DIMS})")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    x = aligned_rows(x)
    lib = _block_library()
    code = _DTYPE_CODES[x.dtype]
    _check_proj_smem(lib, code, s, d, dh)  # before the first of the two launches
    qkv = torch.empty((b, s, 3 * d), dtype=x.dtype, device=x.device)
    w = aligned_rows(qkv_w.to(x.dtype).contiguous())
    vecs = [t.reshape(-1).float().contiguous() for t in (ln_scale, ln_bias, qkv_b)]
    with torch.cuda.device(x.device):
        err = lib.team_ln_qkv_fwd(x.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
                                  w.data_ptr(), vecs[2].data_ptr(), qkv.data_ptr(), code, b * s, d,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ln_qkv kernel launch failed: cudaError {err}")
    fused_attn_block.launches += 1
    if causal:
        fused_attn_block.causal_launches += 1
    out = _launch_packed_proj(qkv, out_w, out_b, x, heads, causal)
    fused_attn_block.proj_launches += 1
    return out


def attn_block_backward_reference(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                                  qkv_w: torch.Tensor, qkv_b: torch.Tensor, out_w: torch.Tensor,
                                  out_b: torch.Tensor, heads: int,
                                  causal: bool = False) -> torch.Tensor:
    """What #13's backward differentiates (``_xla_attn_block_reference``):
    the f32 layer norm rounded to x's dtype, the qkv GEMM accumulated in f32
    with its bias (one rounding), :func:`mha_packed_backward_reference`, the
    out-projection in f32 with its bias and the f32 residual, one rounding."""
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    h = (x32 - mean) * torch.rsqrt(var + 1e-5)
    h = (h * ln_scale.float().reshape(-1) + ln_bias.float().reshape(-1)).to(dtype)
    qkv = (torch.matmul(h.float(), qkv_w.to(dtype).float()) + qkv_b.float().reshape(-1)).to(dtype)
    o = mha_packed_backward_reference(qkv, heads, causal)
    proj = torch.matmul(o.float(), out_w.to(dtype).float()) + out_b.float().reshape(-1)
    return (x32 + proj).to(dtype)


class _AttnBlockFn(torch.autograd.Function):
    """#13 with ``_attn_block_vjp``'s rule: the kernels' forward; the
    backward differentiates :func:`attn_block_backward_reference` at the
    saved x, layer-norm affine, weights and biases, and returns a gradient
    to each of them."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b, heads, causal):
        ctx.save_for_backward(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b)
        ctx.args = (heads, causal)
        return _attn_block_call(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b, heads, causal)

    @staticmethod
    def backward(ctx, g):
        heads, causal = ctx.args
        grads = recompute_vjp(
            lambda *ops: attn_block_backward_reference(*ops, heads, causal),
            ctx.saved_tensors, ctx.needs_input_grad[:7], g)
        return (*grads, None, None)


fused_mha_short.launches = 0
fused_mha_short_v2.launches = 0
fused_mha_packed_proj.launches = 0
fused_mha_packed_proj.causal_launches = 0
fused_attn_block.launches = 0
fused_attn_block.causal_launches = 0
fused_attn_block.proj_launches = 0


# ---------------------------------------------------------------------------
# integer-QKᵀ attention of the int8 static-W8A8 tier
# ---------------------------------------------------------------------------

_Q3I_SOURCE = "mha_packed_q3i.cu"
_Q3I_HEAD_DIMS = (32, 64, 128)
# the kernel's normalisations (``csrc/mha_packed_q3i.cu``, enum Norm)
_NORM_MXU, _NORM_REDUCE, _NORM_PV8 = 0, 1, 3
# what an entry returns, launching nothing, when S does not fit its kernel's
# shared memory (``kErrTooLong``)
_Q3I_TOO_LONG = -1
# threads of the CLS kernel's block (``kClsThreads``)
_Q3I_CLS_THREADS = 256


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def q3i_cls_smem_bytes(seq: int, dh: int) -> int:
    """The CLS kernel's shared memory (``csrc/mha_packed_q3i.cu``,
    ``smem_bytes_cls``): K and V int8 ``[S, dh]``, p float32 ``[S]``, the
    warps' p·v sums float32 ``[8, dh]`` and a max and a row sum a warp."""
    warps = _Q3I_CLS_THREADS // 32
    return 2 * _align16(seq * dh) + _align16(4 * seq) + warps * dh * 4 + 2 * warps * 4


def q3i_cls_max_seq(dh: int) -> int:
    """The longest S the CLS entries take at head width ``dh``: the largest
    whose :func:`q3i_cls_smem_bytes` fits a block (3402, 1744 and 878 at dh
    32, 64 and 128)."""
    s = (_SMEM_LIMIT - (_Q3I_CLS_THREADS // 32) * (dh + 2) * 4) // (2 * dh + 4)
    while q3i_cls_smem_bytes(s + 1, dh) <= _SMEM_LIMIT:
        s += 1
    while q3i_cls_smem_bytes(s, dh) > _SMEM_LIMIT:
        s -= 1
    return s


def _check_cls_seq(s: int, d: int, heads: int) -> None:
    """Raise, on any device, where the CLS kernel would not take S (the
    plain version on the CPU takes what the kernel takes)."""
    dh = d // heads
    if dh in _Q3I_HEAD_DIMS and s > q3i_cls_max_seq(dh):
        raise ValueError(f"S={s} at head width {dh}: the CLS kernel's K/V need more shared "
                         f"memory than a block may take ({_SMEM_LIMIT} bytes; longest S "
                         f"{q3i_cls_max_seq(dh)})")


def mha_packed_q3i_reference(qkv_q: torch.Tensor, deq: torch.Tensor, qk_scale: torch.Tensor,
                             o_inv: torch.Tensor, heads: int, causal: bool = False,
                             kv_len: Optional[int] = None, qk_m2: Optional[torch.Tensor] = None,
                             rows: Optional[int] = None, *, exp2i: bool = False,
                             rowsum: str = "mxu", pv_int8: bool = False,
                             defer_norm: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel (``mha_short.py:493-592``).

    q·kᵀ is an exact integer sum (in float64 here, which holds it exactly
    and runs on both devices). The softmax: ``qk_m2`` given, p =
    exp2(acc·(qks·log2e) − m2); ``exp2i`` (unmasked only), p =
    exp2((acc − max acc)·(qks·log2e)); else the f32 row-max softmax over the
    masked logits. Then, with ``rowsum="mxu"`` and no ``pv_int8`` (the
    default route), p is rounded to bf16, the numerator p·v (raw int8 v) and
    the denominator Σp accumulate in f32, and out = num·(deq_v·o_inv)/den.
    Otherwise den = Σp over the unrounded f32 p, p /= den unless
    ``defer_norm``, and the PV is bf16(p)·v in f32 times deq_v·o_inv, or with
    ``pv_int8`` the exact integer sum of clip(rint(p·127), 0, 127)·v times
    (deq_v·o_inv)·f32(1/127); ``defer_norm`` then divides by den. out is
    rounded half to even and clipped to ±127. ``rows`` computes only the
    first query rows (1: the CLS kernels)."""
    b, s, d3 = qkv_q.shape
    d = d3 // 3
    dh = d // heads
    q, k, v = (_split_heads(t, heads) for t in qkv_q.split(d, dim=-1))
    if rows is not None:
        q = q[:, :, :rows]
    r = q.shape[2]
    acc = torch.matmul(q.double(), k.double().transpose(-1, -2)).float()
    qks = qk_scale.reshape(1, heads, 1, 1).float()
    if qk_m2 is not None:
        p = torch.exp2(acc * (qks * LOG2E) - qk_m2.reshape(1, heads, 1, 1).float())
    elif exp2i:
        p = torch.exp2((acc - acc.amax(dim=-1, keepdim=True)) * (qks * LOG2E))
    else:
        logits = acc * qks
        rows_i = torch.arange(r, device=qkv_q.device)[:, None]
        cols = torch.arange(s, device=qkv_q.device)[None, :]
        mask = cols < (s if kv_len is None else kv_len)
        if causal:
            mask = mask & (cols <= rows_i)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    pv_scale = (deq.reshape(-1)[2 * d:].float() * o_inv.reshape(-1).float()).reshape(1, heads, 1, dh)
    if rowsum == "mxu" and not pv_int8:
        pb = p.to(torch.bfloat16).float()
        out = torch.matmul(pb, v.float()) * pv_scale / pb.sum(dim=-1, keepdim=True)
    else:
        den = p.sum(dim=-1, keepdim=True)
        if not defer_norm:
            p = p / den
        if pv_int8:
            p8 = torch.clamp(torch.round(p * 127.0), 0, 127)
            out = torch.matmul(p8.double(), v.double()).float() * (pv_scale * INV127)
        else:
            out = torch.matmul(p.to(torch.bfloat16).float(), v.float()) * pv_scale
        if defer_norm:
            out = out / den
    out = torch.clamp(torch.round(out), -127, 127).to(torch.int8)
    return out.permute(0, 2, 1, 3).reshape(b, r, d)


def mha_packed_q3i_cls_split_reference(q_q: torch.Tensor, kv_q: torch.Tensor, deq: torch.Tensor,
                                       qk_scale: torch.Tensor, o_inv: torch.Tensor, heads: int,
                                       qk_m2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``_mha_packed_q3i_cls_split_kernel``: the CLS
    plain version on the packed tensor that q ``[B, 1, D]`` and kv
    ``[B, S, 2D]`` make (q's row 0 is all the CLS query reads)."""
    b, s, _ = kv_q.shape
    qkv = torch.cat([q_q.expand(b, s, q_q.shape[-1]), kv_q], dim=-1)
    return mha_packed_q3i_reference(qkv, deq, qk_scale, o_inv, heads, qk_m2=qk_m2, rows=1)


def mha_packed_q3i_sb_reference(qkv_q: torch.Tensor, deq: torch.Tensor, qk_scale: torch.Tensor,
                                o_inv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version of ``_mha_packed_q3i_sb_kernel`` over
    sequence-major ``[S, B, 3D]``: the f32 row-max softmax, p normalised in
    f32, then a bf16 PV with no ones column (``rowsum="reduce"``)."""
    out = mha_packed_q3i_reference(qkv_q.transpose(0, 1), deq, qk_scale, o_inv, heads,
                                   rowsum="reduce")
    return out.transpose(0, 1).contiguous()


def _q3i_library() -> ctypes.CDLL:
    from team_tpu_torch.ops._build import load_library

    lib = load_library(_Q3I_SOURCE)
    vecs = [ctypes.c_void_p] * 4  # deq, qk_scale, o_inv, qk_m2 (or NULL)
    ints = [ctypes.c_int] * 4     # batch, seq, heads, dh
    # qkv, vecs, out; ints; kv_len, causal, exp2i, norm; stream
    lib.team_mha_packed_q3i_fwd.argtypes = ([ctypes.c_void_p] + vecs + [ctypes.c_void_p] + ints
                                            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.team_mha_packed_q3i_cls_fwd.argtypes = ([ctypes.c_void_p] + vecs + [ctypes.c_void_p]
                                                + ints + [ctypes.c_void_p])
    # q, kv, vecs, out; ints; stream
    lib.team_mha_packed_q3i_cls_split_fwd.argtypes = ([ctypes.c_void_p] * 2 + vecs
                                                      + [ctypes.c_void_p] + ints + [ctypes.c_void_p])
    # qkv, deq, qk_scale, o_inv, out; ints; stream
    lib.team_mha_packed_q3i_sb_fwd.argtypes = [ctypes.c_void_p] * 5 + ints + [ctypes.c_void_p]
    # qkv, vecs, out; batch, seq, heads_local, dh; rank, nm, kv_len, causal, exp2i, norm; stream
    lib.team_mha_packed_q3i_tp_fwd.argtypes = ([ctypes.c_void_p] + vecs + [ctypes.c_void_p] + ints
                                               + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    # qkv, vecs (deq all ones), out; ints; variant; stream
    lib.team_mha_q3i_variant_fwd.argtypes = ([ctypes.c_void_p] + vecs + [ctypes.c_void_p] + ints
                                             + [ctypes.c_int, ctypes.c_void_p])
    for entry in ("team_mha_packed_q3i_fwd", "team_mha_packed_q3i_cls_fwd",
                  "team_mha_packed_q3i_cls_split_fwd", "team_mha_packed_q3i_sb_fwd",
                  "team_mha_packed_q3i_tp_fwd", "team_mha_q3i_variant_fwd"):
        getattr(lib, entry).restype = ctypes.c_int
    return lib


def _q3i_softmax(qk_m2, masked: bool) -> str:
    """The TPU wrapper's softmax choice (``mha_short.py:623-636``), read from
    ``TEAM_QI_SOFTMAX`` at each call: ``"static"`` (the default) when
    ``qk_m2`` is given and nothing is masked, ``"exp2i"`` when asked for and
    nothing is masked, the f32 row-max form (``"f32"``) otherwise."""
    mode = os.environ.get("TEAM_QI_SOFTMAX", "static")
    if mode == "static" and qk_m2 is not None and not masked:
        return "static"
    if mode == "exp2i" and not masked:
        return "exp2i"
    return "f32"


def _q3i_rowsum() -> str:
    """``TEAM_QI_ROWSUM`` as the TPU wrapper reads it: ``mxu``, else ``reduce``."""
    return "mxu" if os.environ.get("TEAM_QI_ROWSUM", "mxu") == "mxu" else "reduce"


def _q3i_cls_static(qk_m2) -> bool:
    """The CLS kernels' softmax (``mha_short.py:731-733``): static only under
    ``TEAM_QI_SOFTMAX=static`` with ``qk_m2``; every other value takes the f32
    row-max form. They always use the ones-column row sum."""
    return os.environ.get("TEAM_QI_SOFTMAX", "static") == "static" and qk_m2 is not None


def mha_packed_q3i_plain(qkv_q: torch.Tensor, deq: torch.Tensor, qk_scale: torch.Tensor,
                         o_inv: torch.Tensor, heads: int, *, causal: bool = False,
                         kv_len: Optional[int] = None, qk_m2: Optional[torch.Tensor] = None,
                         pv_int8: bool = False, defer_norm: bool = False) -> torch.Tensor:
    """What :func:`fused_mha_packed_q3i` computes, in plain PyTorch on the
    inputs' device: the knobs read and the mode chosen as the wrapper does,
    then :func:`mha_packed_q3i_reference`."""
    s = qkv_q.shape[1]
    if kv_len == s:
        kv_len = None
    softmax = _q3i_softmax(qk_m2, causal or kv_len is not None)
    return mha_packed_q3i_reference(qkv_q, deq, qk_scale, o_inv, heads, causal, kv_len,
                                    qk_m2 if softmax == "static" else None,
                                    exp2i=softmax == "exp2i", rowsum=_q3i_rowsum(),
                                    pv_int8=pv_int8, defer_norm=defer_norm)


def mha_packed_q3i_cls_plain(qkv_q: torch.Tensor, deq: torch.Tensor, qk_scale: torch.Tensor,
                             o_inv: torch.Tensor, heads: int, *,
                             qk_m2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """What :func:`fused_mha_packed_q3i_cls` computes, in plain PyTorch on the
    inputs' device (the CLS kernels' softmax choice, then the reference's row 0)."""
    return mha_packed_q3i_reference(qkv_q, deq, qk_scale, o_inv, heads,
                                    qk_m2=qk_m2 if _q3i_cls_static(qk_m2) else None, rows=1)


def mha_packed_q3i_cls_split_plain(q_q: torch.Tensor, kv_q: torch.Tensor, deq: torch.Tensor,
                                   qk_scale: torch.Tensor, o_inv: torch.Tensor, heads: int, *,
                                   qk_m2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """What :func:`fused_mha_packed_q3i_cls_split` computes, in plain PyTorch
    on the inputs' device."""
    return mha_packed_q3i_cls_split_reference(q_q, kv_q, deq, qk_scale, o_inv, heads,
                                              qk_m2=qk_m2 if _q3i_cls_static(qk_m2) else None)


def _q3i_vectors(device, d: int, heads: int, deq, qk_scale, o_inv, qk_m2):
    """Check the per-channel and per-head vectors; returns them as flat float32."""
    vecs = []
    for name, t, n in (("deq", deq, 3 * d), ("qk_scale", qk_scale, heads), ("o_inv", o_inv, d),
                       ("qk_m2", qk_m2, heads)):
        if t is None:
            vecs.append(None)
            continue
        if t.numel() != n:
            raise ValueError(f"{name} must hold {n} values, got shape {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} lies on {t.device}, the int8 input on {device}")
        vecs.append(t.reshape(-1).float().contiguous())
    return vecs


def _q3i_operands(qkv_q, deq, qk_scale, o_inv, qk_m2, heads: int):
    """Check packed q3i inputs ``[., ., 3D]``; returns the vectors as flat float32."""
    if qkv_q.dim() != 3 or qkv_q.shape[-1] % 3:
        raise ValueError(f"qkv_q must be [B, S, 3*D], got {tuple(qkv_q.shape)}")
    if qkv_q.dtype != torch.int8:
        raise TypeError(f"qkv_q must be int8, got {qkv_q.dtype}")
    d = qkv_q.shape[-1] // 3
    if d % heads:
        raise ValueError(f"D={d} is not divisible by heads={heads}")
    return _q3i_vectors(qkv_q.device, d, heads, deq, qk_scale, o_inv, qk_m2)


def _q3i_launch(entry: str, inputs, vecs, out, batch: int, seq: int, heads: int,
                *extra) -> None:
    """Launch ``entry`` on the int8 ``inputs`` (checked CUDA tensors), the
    vectors (``qk_m2`` dropped when the entry takes none) and ``out``."""
    dh = out.shape[-1] // heads
    for t in inputs:
        if t.device.type != "cuda":
            raise ValueError(f"the q3i kernels run on CPU or CUDA tensors, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the int8 inputs must be contiguous and 16-byte aligned")
    if dh not in _Q3I_HEAD_DIMS:
        raise ValueError(f"head width {dh} not compiled (supported: {_Q3I_HEAD_DIMS})")
    lib = _q3i_library()
    ptrs = [None if t is None else t.data_ptr() for t in vecs]
    with torch.cuda.device(out.device):
        err = getattr(lib, entry)(*(t.data_ptr() for t in inputs), *ptrs, out.data_ptr(), batch,
                                  seq, heads, dh, *extra, torch.cuda.current_stream().cuda_stream)
    if err == _Q3I_TOO_LONG:
        raise ValueError(f"S={seq} at head width {dh}: {entry}'s K/V need more shared memory "
                         f"than a block may take ({_SMEM_LIMIT} bytes)")
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def _q3i_norm(pv_int8: bool, defer_norm: bool) -> int:
    """The kernel's normalisation (enum Norm) for the wrapper's arguments and
    ``TEAM_QI_ROWSUM``."""
    if _q3i_rowsum() == "mxu" and not pv_int8:
        return _NORM_MXU
    return (_NORM_PV8 if pv_int8 else _NORM_REDUCE) + int(defer_norm)


def fused_mha_packed_q3i(qkv_q: torch.Tensor, deq: torch.Tensor, qk_scale: torch.Tensor,
                         o_inv: torch.Tensor, heads: int, *, causal: bool = False,
                         kv_len: Optional[int] = None, qk_m2: Optional[torch.Tensor] = None,
                         pv_int8: bool = False, defer_norm: bool = False) -> torch.Tensor:
    """Integer-QKᵀ static-W8A8 attention: ``[B, S, 3D]`` int8 qkv (q and k
    quantized with per-head-uniform scales) -> ``[B, S, D]`` int8.

    ``deq: [1, 3D]`` dequant scales, ``qk_scale: [1, H]`` the per-head logit
    scale s_q·s_k·dh^-0.5, ``o_inv: [1, D]`` the out-projection's static
    quantize scales, ``qk_m2: [1, H]`` the calibrated max logit in exp2 units.
    ``pv_int8`` runs PV as an int8 product of p requantized to rint(p·127);
    ``defer_norm`` divides the output by the softmax denominator instead of
    p. The knobs ``TEAM_QI_SOFTMAX`` (``static``, ``exp2i``, else ``f32``)
    and ``TEAM_QI_ROWSUM`` (``mxu``, else ``reduce``; ``pv_int8`` forces
    ``reduce``) are read at each call. Each kernel launch adds one to
    ``fused_mha_packed_q3i.launches``."""
    s = qkv_q.shape[1] if qkv_q.dim() == 3 else 0
    if kv_len is not None and not 1 <= kv_len <= s:
        raise ValueError(f"kv_len={kv_len} outside [1, S={s}]")
    if kv_len == s:
        kv_len = None
    softmax = _q3i_softmax(qk_m2, causal or kv_len is not None)
    vecs = _q3i_operands(qkv_q, deq, qk_scale, o_inv, qk_m2 if softmax == "static" else None,
                         heads)
    if qkv_q.device.type == "cpu":
        return mha_packed_q3i_plain(qkv_q, *vecs[:3], heads, causal=causal, kv_len=kv_len,
                                    qk_m2=vecs[3], pv_int8=pv_int8, defer_norm=defer_norm)
    refuse_grad("fused_mha_packed_q3i (#7)", *vecs)
    norm = _q3i_norm(pv_int8, defer_norm)
    b, s, d3 = qkv_q.shape
    out = torch.empty((b, s, d3 // 3), dtype=torch.int8, device=qkv_q.device)
    _q3i_launch("team_mha_packed_q3i_fwd", [qkv_q], vecs, out, b, s, heads,
                s if kv_len is None else kv_len, int(causal), int(softmax == "exp2i"), norm)
    fused_mha_packed_q3i.launches += 1
    return out


def fused_mha_packed_q3i_cls(qkv_q: torch.Tensor, deq: torch.Tensor, qk_scale: torch.Tensor,
                             o_inv: torch.Tensor, heads: int, *,
                             qk_m2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Integer-QKᵀ attention for the CLS query only: ``[B, S, 3D]`` int8 ->
    ``[B, 1, D]`` int8, row 0 of what :func:`fused_mha_packed_q3i` returns
    with the ones-column row sum (non-causal, every key). Each kernel launch
    adds one to ``fused_mha_packed_q3i_cls.launches``."""
    static = _q3i_cls_static(qk_m2)
    vecs = _q3i_operands(qkv_q, deq, qk_scale, o_inv, qk_m2 if static else None, heads)
    b, s, d3 = qkv_q.shape
    _check_cls_seq(s, d3 // 3, heads)
    if qkv_q.device.type == "cpu":
        return mha_packed_q3i_cls_plain(qkv_q, *vecs[:3], heads, qk_m2=vecs[3])
    refuse_grad("fused_mha_packed_q3i_cls (#8)", *vecs)
    out = torch.empty((b, 1, d3 // 3), dtype=torch.int8, device=qkv_q.device)
    _q3i_launch("team_mha_packed_q3i_cls_fwd", [qkv_q], vecs, out, b, s, heads)
    fused_mha_packed_q3i_cls.launches += 1
    return out


def fused_mha_packed_q3i_cls_split(q_q: torch.Tensor, kv_q: torch.Tensor, deq: torch.Tensor,
                                   qk_scale: torch.Tensor, o_inv: torch.Tensor, heads: int, *,
                                   qk_m2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`fused_mha_packed_q3i_cls` over split inputs: the CLS row's q
    ``[B, 1, D]`` int8 and k, v ``[B, S, 2D]`` int8 -> ``[B, 1, D]`` int8;
    ``deq`` keeps its ``[1, 3D]`` layout. Equal to the CLS kernel on the
    packed tensor they make. Each kernel launch adds one to
    ``fused_mha_packed_q3i_cls_split.launches``."""
    if q_q.dim() != 3 or kv_q.dim() != 3 or q_q.shape[1] != 1 or kv_q.shape[0] != q_q.shape[0] \
            or kv_q.shape[-1] != 2 * q_q.shape[-1]:
        raise ValueError(f"q_q must be [B, 1, D] and kv_q [B, S, 2*D], got {tuple(q_q.shape)} "
                         f"and {tuple(kv_q.shape)}")
    if q_q.dtype != torch.int8 or kv_q.dtype != torch.int8:
        raise TypeError(f"q_q and kv_q must be int8, got {q_q.dtype} and {kv_q.dtype}")
    if kv_q.device != q_q.device:
        raise ValueError(f"kv_q lies on {kv_q.device}, q_q on {q_q.device}")
    b, s, d2 = kv_q.shape
    d = d2 // 2
    if d % heads:
        raise ValueError(f"D={d} is not divisible by heads={heads}")
    _check_cls_seq(s, d, heads)
    static = _q3i_cls_static(qk_m2)
    vecs = _q3i_vectors(kv_q.device, d, heads, deq, qk_scale, o_inv, qk_m2 if static else None)
    if kv_q.device.type == "cpu":
        return mha_packed_q3i_cls_split_plain(q_q, kv_q, *vecs[:3], heads, qk_m2=vecs[3])
    refuse_grad("fused_mha_packed_q3i_cls_split (#9)", *vecs)
    out = torch.empty((b, 1, d), dtype=torch.int8, device=kv_q.device)
    _q3i_launch("team_mha_packed_q3i_cls_split_fwd", [q_q, kv_q], vecs, out, b, s, heads)
    fused_mha_packed_q3i_cls_split.launches += 1
    return out


def fused_mha_packed_q3i_sb(qkv_q: torch.Tensor, deq: torch.Tensor, qk_scale: torch.Tensor,
                            o_inv: torch.Tensor, heads: int) -> torch.Tensor:
    """Sequence-major integer-QKᵀ attention: ``[S, B, 3D]`` int8 ->
    ``[S, B, D]`` int8, non-causal over every key, the f32 row-max softmax
    normalised before a bf16 PV (no ``qk_m2``, no knobs, as on the TPU).
    Each kernel launch adds one to ``fused_mha_packed_q3i_sb.launches``."""
    vecs = _q3i_operands(qkv_q, deq, qk_scale, o_inv, None, heads)
    if qkv_q.device.type == "cpu":
        return mha_packed_q3i_sb_reference(qkv_q, *vecs[:3], heads)
    refuse_grad("fused_mha_packed_q3i_sb (#10)", *vecs)
    s, b, d3 = qkv_q.shape
    out = torch.empty((s, b, d3 // 3), dtype=torch.int8, device=qkv_q.device)
    _q3i_launch("team_mha_packed_q3i_sb_fwd", [qkv_q], vecs[:3], out, b, s, heads)
    fused_mha_packed_q3i_sb.launches += 1
    return out


fused_mha_packed_q3i.launches = 0
fused_mha_packed_q3i_cls.launches = 0
fused_mha_packed_q3i_cls_split.launches = 0
fused_mha_packed_q3i_sb.launches = 0


# the decomposition probe's variants of the q3i kernel
# (scripts/r4_attn_decomp.py:_variant_kernel), by their codes in
# ``csrc/mha_packed_q3i.cu``'s team_mha_q3i_variant_fwd
Q3I_VARIANTS = {"copy": 0, "full": 1, "noexp": 2, "qkonly": 3, "nopv": 4}
QKONLY_SCALE = 2e-5


def _round_int8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), -127, 127).to(torch.int8)


def mha_q3i_variant_float(qkv_q: torch.Tensor, qk_scale: torch.Tensor, qk_m2: torch.Tensor,
                          o_inv: torch.Tensor, heads: int, variant: str) -> torch.Tensor:
    """The float32 output of a decomposition variant before its int8
    rounding, ``[B, S, 3D]`` int8 -> ``[B, S, D]`` (not ``copy``): with
    ``acc = q8·k8`` exact and ``t = f32(acc)·(qks·log2e) − m2``,
    ``qkonly`` ``f32(acc)·2e-5`` and ``nopv`` ``exp2(t)·o_inv`` on the first
    Dh keys of each row (S >= Dh); ``full`` and ``noexp`` take ``p = exp2(t)``
    or ``t``, ``pb = bf16(p)`` and ``(Σ pb·v8)·o_inv / Σ pb`` in f32 (the
    ones column of the TPU kernel's PV dot)."""
    if variant not in Q3I_VARIANTS or variant == "copy":
        raise ValueError(f"variant {variant!r} has no float stage (variants: {list(Q3I_VARIANTS)})")
    b, s, d3 = qkv_q.shape
    d = d3 // 3
    dh = d // heads
    q, k, v = (_split_heads(t, heads) for t in qkv_q.split(d, dim=-1))
    acc = torch.matmul(q.double(), k.double().transpose(-1, -2)).float()
    oinv = o_inv.reshape(1, heads, 1, dh).float()
    if variant == "qkonly":
        out = acc[..., :dh] * QKONLY_SCALE
    else:
        t = (acc * (qk_scale.reshape(1, heads, 1, 1).float() * LOG2E)
             - qk_m2.reshape(1, heads, 1, 1).float())
        p = t if variant == "noexp" else torch.exp2(t)
        if variant == "nopv":
            out = p[..., :dh] * oinv
        else:
            pb = p.to(torch.bfloat16).float()
            out = torch.matmul(pb, v.float()) * oinv / pb.sum(dim=-1, keepdim=True)
    return out.permute(0, 2, 1, 3).reshape(b, s, d)


def mha_q3i_variant_reference(qkv_q: torch.Tensor, qk_scale: torch.Tensor, qk_m2: torch.Tensor,
                              o_inv: torch.Tensor, heads: int, variant: str) -> torch.Tensor:
    """Plain PyTorch version of the decomposition probe's ``variant``:
    ``copy`` the q segment; else :func:`mha_q3i_variant_float` rounded half
    to even and clipped to ±127."""
    if variant == "copy":
        return qkv_q[..., :qkv_q.shape[-1] // 3].contiguous()
    return _round_int8(mha_q3i_variant_float(qkv_q, qk_scale, qk_m2, o_inv, heads, variant))


def fused_mha_q3i_variant(qkv_q: torch.Tensor, qk_scale: torch.Tensor, qk_m2: torch.Tensor,
                          o_inv: torch.Tensor, heads: int, variant: str) -> torch.Tensor:
    """One variant of the q3i decomposition probe: ``[B, S, 3D]`` int8 ->
    ``[B, S, D]`` int8 (:func:`mha_q3i_variant_reference`). ``full`` is the
    packed q3i kernel's static-softmax, ones-column route with v's dequant
    scale 1; the others cut it short. ``TEAM_QI_GROUP`` is a TPU VMEM knob
    and is not read. Each kernel launch adds one to
    ``fused_mha_q3i_variant.launches[variant]``."""
    if variant not in Q3I_VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (variants: {list(Q3I_VARIANTS)})")
    vecs = _q3i_operands(qkv_q, None, qk_scale, o_inv, qk_m2, heads)
    if vecs[3] is None:
        raise ValueError("the variants take the static softmax: qk_m2 is required")
    b, s, d3 = qkv_q.shape
    d = d3 // 3
    dh = d // heads
    if variant in ("qkonly", "nopv") and s < dh:
        raise ValueError(f"variant {variant} writes the first Dh={dh} keys of a row: S={s} < Dh")
    if qkv_q.device.type == "cpu":
        return mha_q3i_variant_reference(qkv_q, vecs[1], vecs[3], vecs[2], heads, variant)
    refuse_grad("fused_mha_q3i_variant (#29)", *vecs)
    vecs[0] = torch.ones(3 * d, dtype=torch.float32, device=qkv_q.device)  # v's scale 1
    out = torch.empty((b, s, d), dtype=torch.int8, device=qkv_q.device)
    _q3i_launch("team_mha_q3i_variant_fwd", [qkv_q], vecs, out, b, s, heads, Q3I_VARIANTS[variant])
    fused_mha_q3i_variant.launches[variant] += 1
    return out


fused_mha_q3i_variant.launches = dict.fromkeys(Q3I_VARIANTS, 0)


# ---------------------------------------------------------------------------
# tensor-parallel head split (heads over the model axis of a registered layout)
# ---------------------------------------------------------------------------

_TP_MESH = None


def set_tp_mesh(mesh) -> None:
    """Register the tensor-parallel layout of :func:`fused_mha_packed_tp`,
    :func:`fused_mha_packed_q3i_tp` and the towers' ``mha_packed_tp`` route:
    an object with ``model_rank`` and ``n_model`` (this process's place on
    the model axis and the axis size), such as
    :class:`team_tpu_torch.parallel.mesh.MeshContext`. ``None`` clears it.
    The registry keeps the towers' signatures free of the layout, as in
    team_tpu (``mha_short.py:1230``)."""
    global _TP_MESH
    _TP_MESH = mesh


def tp_mesh():
    """The registered tensor-parallel layout, or ``None``."""
    return _TP_MESH


def tp_split(heads: int, d: int) -> Optional[Tuple[int, int]]:
    """``(rank, nm)`` of the registered layout's model axis when the heads
    split over it: a layout is registered, ``nm > 1`` and ``nm`` divides the
    heads and ``D``. ``None`` otherwise: team_tpu's wrappers then run the
    whole-head kernel (``mha_short.py:1258-1266``, ``:1314-1325``)."""
    if _TP_MESH is None:
        return None
    nm = int(_TP_MESH.n_model)
    if nm == 1 or heads % nm or d % nm:
        return None
    return int(_TP_MESH.model_rank), nm


def _rank_columns(t: torch.Tensor, rank: int, nm: int, segments: int) -> torch.Tensor:
    """The rank's columns of each of ``segments`` equal segments of the last
    dim, side by side (its heads' q, k and v of a packed qkv)."""
    seg = t.shape[-1] // segments
    dm = seg // nm
    return torch.cat([t[..., i * seg + rank * dm:i * seg + (rank + 1) * dm]
                      for i in range(segments)], dim=-1)


def mha_packed_tp_plain(qkv: torch.Tensor, heads: int, rank: int, nm: int, *,
                        causal: bool = False, kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of rank ``rank``'s share of
    :func:`fused_mha_packed_tp`: its heads' q, k and v sliced out of the full
    packed ``[B, S, 3D]`` (team_tpu's ``dynamic_slice`` + ``concatenate``),
    then :func:`mha_packed_reference` on ``heads/nm`` heads -> ``[B, S, D/nm]``."""
    return mha_packed_reference(_rank_columns(qkv, rank, nm, 3), heads // nm, causal, kv_len)


def fused_mha_packed_tp(qkv: torch.Tensor, heads: int, *, causal: bool = False,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Tensor-parallel :func:`fused_mha_packed`: ``qkv`` is the full packed
    ``[B, S, 3*D]``; rank r of the registered layout's nm model ranks
    returns ``[B, S, D/nm]``, its heads ``[r·H/nm, (r+1)·H/nm)`` (the
    ``P(data, None, model)`` shard, which the row-parallel out-projection
    takes). The kernel reads the rank's heads in place. With no layout
    registered, ``nm == 1`` or heads or D not divisible by nm, the
    whole-head kernel runs and returns ``[B, S, D]``, as in team_tpu. Each
    kernel launch adds one to ``fused_mha_packed_tp.launches``."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, S, 3*D], got {tuple(qkv.shape)}")
    b, s, d3 = qkv.shape
    kv = kv_len if (kv_len is not None and kv_len < s) else None
    shard = tp_split(heads, d3 // 3)
    if shard is None:
        return fused_mha_packed(qkv, heads, causal=causal, kv_len=kv)
    rank, nm = shard
    if kv is not None and kv < 1:
        raise ValueError(f"kv_len={kv_len} outside [1, S={s}]")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"qkv dtype {qkv.dtype} not supported (float32, bfloat16)")
    if qkv.device.type == "cpu":
        return mha_packed_tp_plain(qkv, heads, rank, nm, causal=causal, kv_len=kv)
    refuse_grad("fused_mha_packed_tp (#2)", qkv)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_mha_packed_tp runs on CPU or CUDA tensors, got {qkv.device}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    hm, dm = heads // nm, d3 // 3 // nm
    dh = dm // hm
    if dh not in PACKED_HEAD_DIMS:
        raise ValueError(f"head width {dh} not compiled (supported: {PACKED_HEAD_DIMS})")
    lib = _library()
    code = _DTYPE_CODES[qkv.dtype]
    smem = lib.team_mha_packed_smem_bytes(code, s, dh, 0)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S={s} needs {smem} bytes of shared memory for K/V "
                         f"(limit {_SMEM_LIMIT})")
    if qkv.dtype == torch.bfloat16:
        qkv = aligned_rows(qkv)
    out = torch.empty((b, s, dm), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = lib.team_mha_packed_tp_fwd(
            qkv.data_ptr(), out.data_ptr(), code, b, s, hm, dh, rank, nm,
            s if kv is None else kv, int(causal), dh ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mha_packed_tp kernel launch failed: cudaError {err}")
    fused_mha_packed_tp.launches += 1
    return out


def mha_packed_q3i_tp_plain(qkv_q: torch.Tensor, deq: torch.Tensor, qk_scale: torch.Tensor,
                            o_inv: torch.Tensor, heads: int, rank: int, nm: int, *,
                            causal: bool = False, kv_len: Optional[int] = None,
                            qk_m2: Optional[torch.Tensor] = None, pv_int8: bool = False,
                            defer_norm: bool = False) -> torch.Tensor:
    """Plain PyTorch version of rank ``rank``'s share of
    :func:`fused_mha_packed_q3i_tp`: its heads' int8 q, k and v and the
    matching slices of ``deq`` (its q, k and v segments), ``qk_scale``,
    ``o_inv`` and ``qk_m2``, then :func:`mha_packed_q3i_plain` on
    ``heads/nm`` heads -> int8 ``[B, S, D/nm]``."""
    hm = heads // nm
    m2 = None if qk_m2 is None else qk_m2.reshape(-1)[rank * hm:(rank + 1) * hm]
    return mha_packed_q3i_plain(
        _rank_columns(qkv_q, rank, nm, 3), _rank_columns(deq.reshape(-1), rank, nm, 3),
        qk_scale.reshape(-1)[rank * hm:(rank + 1) * hm], _rank_columns(o_inv.reshape(-1), rank, nm, 1),
        hm, causal=causal, kv_len=kv_len, qk_m2=m2, pv_int8=pv_int8, defer_norm=defer_norm)


def fused_mha_packed_q3i_tp(qkv_q: torch.Tensor, deq: torch.Tensor, qk_scale: torch.Tensor,
                            o_inv: torch.Tensor, heads: int, *, causal: bool = False,
                            kv_len: Optional[int] = None, pv_int8: bool = False,
                            defer_norm: bool = False,
                            qk_m2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tensor-parallel :func:`fused_mha_packed_q3i`: the full int8 packed
    ``[B, S, 3*D]`` and the full scale vectors in; rank r of the registered
    layout's nm model ranks returns int8 ``[B, S, D/nm]``, its heads with
    their slices of ``deq``, ``qk_scale``, ``o_inv`` and ``qk_m2`` (the
    kernel reads them through pointers offset to its heads). Every mode and
    knob of :func:`fused_mha_packed_q3i`. With no layout registered,
    ``nm == 1`` or heads or D not divisible by nm, the whole-head kernel runs
    and returns ``[B, S, D]``, as in team_tpu. Each kernel launch adds one to
    ``fused_mha_packed_q3i_tp.launches``."""
    s = qkv_q.shape[1] if qkv_q.dim() == 3 else 0
    kv = kv_len if (kv_len is not None and kv_len < s) else None
    shard = tp_split(heads, qkv_q.shape[-1] // 3) if qkv_q.dim() == 3 else None
    if shard is None:
        return fused_mha_packed_q3i(qkv_q, deq, qk_scale, o_inv, heads, causal=causal, kv_len=kv,
                                    qk_m2=qk_m2, pv_int8=pv_int8, defer_norm=defer_norm)
    rank, nm = shard
    if kv is not None and kv < 1:
        raise ValueError(f"kv_len={kv_len} outside [1, S={s}]")
    softmax = _q3i_softmax(qk_m2, causal or kv is not None)
    vecs = _q3i_operands(qkv_q, deq, qk_scale, o_inv, qk_m2 if softmax == "static" else None,
                         heads)
    if qkv_q.device.type == "cpu":
        return mha_packed_q3i_tp_plain(qkv_q, *vecs[:3], heads, rank, nm, causal=causal,
                                       kv_len=kv, qk_m2=vecs[3], pv_int8=pv_int8,
                                       defer_norm=defer_norm)
    refuse_grad("fused_mha_packed_q3i_tp (#11)", *vecs)
    b, s, d3 = qkv_q.shape
    hm = heads // nm
    out = torch.empty((b, s, d3 // 3 // nm), dtype=torch.int8, device=qkv_q.device)
    _q3i_launch("team_mha_packed_q3i_tp_fwd", [qkv_q], vecs, out, b, s, hm, rank, nm,
                s if kv is None else kv, int(causal), int(softmax == "exp2i"),
                _q3i_norm(pv_int8, defer_norm))
    fused_mha_packed_q3i_tp.launches += 1
    return out


fused_mha_packed_tp.launches = 0
fused_mha_packed_q3i_tp.launches = 0


# ---------------------------------------------------------------------------
# int8-in, int8-out attention with per-channel dequant (static_qa, static3d_qa/qaf)
# ---------------------------------------------------------------------------

_Q_SOURCE = "mha_packed_q.cu"
_Q_HEAD_DIM = 64  # the kernel's compiled head width (ViT-B/16)


def mha_packed_q_reference(qkv_q: torch.Tensor, deq: torch.Tensor, o_inv: torch.Tensor,
                           heads: int, causal: bool = False, kv_len: Optional[int] = None,
                           bf16_deq: bool = False) -> torch.Tensor:
    """Plain PyTorch version of both TPU kernels, ``[B, S, 3D]`` int8 ->
    ``[B, S, D]`` int8.

    ``bf16_deq=False`` (``_mha_packed_q_kernel``, ``mha_short.py:308``): q, k
    and v dequantize in f32 (``x8·deq``), q is then scaled by dh^-0.5 in f32,
    and all three are rounded to bf16. ``bf16_deq=True``
    (``_mha_packed_q3_kernel``, ``:395``): the scales are rounded to bf16
    first (q's as ``bf16(deq·dh^-0.5)``) and each bf16 product is rounded to
    bf16. Then the packed kernels' attention (:func:`_softmax_pv`) and
    ``out·o_inv``, rounded half to even and clipped to ±127."""
    b, s, d3 = qkv_q.shape
    d = d3 // 3
    dh = d // heads
    deq = deq.reshape(-1).float()
    x = qkv_q.float()
    if bf16_deq:
        q = (x[..., :d] * (deq[:d] * dh ** -0.5).to(torch.bfloat16).float()).to(torch.bfloat16)
        kv = (x[..., d:] * deq[d:].to(torch.bfloat16).float()).to(torch.bfloat16)
    else:
        q = (x[..., :d] * deq[:d] * dh ** -0.5).to(torch.bfloat16)
        kv = (x[..., d:] * deq[d:]).to(torch.bfloat16)
    k, v = (_split_heads(t, heads) for t in kv.split(d, dim=-1))
    out = _softmax_pv(_split_heads(q, heads), k, v, causal, kv_len, torch.bfloat16)
    out = out.permute(0, 2, 1, 3).reshape(b, s, d) * o_inv.reshape(-1).float()
    return torch.clamp(torch.round(out), -127, 127).to(torch.int8)


def _q_library() -> ctypes.CDLL:
    from team_tpu_torch.ops._build import load_library

    lib = load_library(_Q_SOURCE)
    for entry in ("team_mha_packed_q_fwd", "team_mha_packed_q3_fwd"):
        fn = getattr(lib, entry)
        # qkv, deq, o_inv, out; batch, seq, heads, dh, row stride, kv_len, causal; stream
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.team_mha_packed_q_smem_bytes.argtypes = [ctypes.c_int]
    lib.team_mha_packed_q_smem_bytes.restype = ctypes.c_size_t
    return lib


def _packed_q(wrapper, qkv_q: torch.Tensor, deq: torch.Tensor, o_inv: torch.Tensor, heads: int,
              causal: bool, kv_len: Optional[int], bf16_deq: bool) -> torch.Tensor:
    """Check the inputs of either wrapper over ``[B, S, 3D]`` and run its
    plain version (CPU) or its kernel (CUDA; one more ``wrapper.launches``)."""
    if qkv_q.dtype != torch.int8:
        raise TypeError(f"qkv_q must be int8, got {qkv_q.dtype}")
    b, s, d3 = qkv_q.shape
    if d3 % 3 or (d3 // 3) % heads:
        raise ValueError(f"qkv_q's last dim {d3} is not 3*D with D divisible by heads={heads}")
    d = d3 // 3
    if kv_len is not None and not 1 <= kv_len <= s:
        raise ValueError(f"kv_len={kv_len} outside [1, S={s}]")
    vecs = []
    for name, t, n in (("deq", deq, d3), ("o_inv", o_inv, d)):
        if t.numel() != n:
            raise ValueError(f"{name} must hold {n} values, got shape {tuple(t.shape)}")
        if t.device != qkv_q.device:
            raise ValueError(f"{name} lies on {t.device}, qkv_q on {qkv_q.device}")
        vecs.append(t.reshape(-1).float().contiguous())
    if qkv_q.device.type == "cpu":
        return mha_packed_q_reference(qkv_q, *vecs, heads, causal, kv_len, bf16_deq)
    refuse_grad(f"{wrapper.__name__} (#{6 if bf16_deq else 5})", *vecs)
    if qkv_q.device.type != "cuda":
        raise ValueError(f"the packed int8 kernels run on CPU or CUDA tensors, got {qkv_q.device}")
    if not qkv_q.is_contiguous() or qkv_q.data_ptr() % 16:
        raise ValueError("qkv_q must be contiguous and 16-byte aligned")
    dh = d // heads
    if dh != _Q_HEAD_DIM:
        raise ValueError(f"head width {dh} not compiled (the kernel takes {_Q_HEAD_DIM})")
    lib = _q_library()
    smem = lib.team_mha_packed_q_smem_bytes(s)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S={s} needs {smem} bytes of shared memory for K/V (limit {_SMEM_LIMIT})")
    out = torch.empty((b, s, d), dtype=torch.int8, device=qkv_q.device)
    entry = "team_mha_packed_q3_fwd" if bf16_deq else "team_mha_packed_q_fwd"
    with torch.cuda.device(qkv_q.device):
        err = getattr(lib, entry)(qkv_q.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
                                  out.data_ptr(), b, s, heads, dh, d3,
                                  s if kv_len is None else kv_len, int(causal),
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    wrapper.launches += 1
    return out


def fused_mha_packed_q(qkv_q: torch.Tensor, deq: torch.Tensor, o_inv: torch.Tensor, heads: int,
                       *, seq: int, causal: bool = False,
                       kv_len: Optional[int] = None) -> torch.Tensor:
    """Static-W8A8 attention, 2-D: ``[B*S, 3D]`` int8 qkv -> ``[B*S, D]`` int8,
    q/k/v dequantized in float32. ``deq: [1, 3D]`` the qkv GEMM output's
    dequant scales, ``o_inv: [1, D]`` the out-projection's static quantize
    scales. Each kernel launch adds one to ``fused_mha_packed_q.launches``."""
    if qkv_q.dim() != 2 or seq < 1 or qkv_q.shape[0] % seq:
        raise ValueError(f"qkv_q must be [B*S, 3*D] with S={seq}, got {tuple(qkv_q.shape)}")
    m, d3 = qkv_q.shape
    out = _packed_q(fused_mha_packed_q, qkv_q.reshape(m // seq, seq, d3), deq, o_inv, heads,
                    causal, kv_len, bf16_deq=False)
    return out.reshape(m, d3 // 3)


def fused_mha_packed_q3(qkv_q: torch.Tensor, deq: torch.Tensor, o_inv: torch.Tensor, heads: int,
                        *, causal: bool = False, kv_len: Optional[int] = None) -> torch.Tensor:
    """Static-W8A8 attention, 3-D: ``[B, S, 3D]`` int8 qkv -> ``[B, S, D]``
    int8, as :func:`fused_mha_packed_q` with the dequant in bfloat16. Each
    kernel launch adds one to ``fused_mha_packed_q3.launches``."""
    if qkv_q.dim() != 3:
        raise ValueError(f"qkv_q must be [B, S, 3*D], got {tuple(qkv_q.shape)}")
    return _packed_q(fused_mha_packed_q3, qkv_q, deq, o_inv, heads, causal, kv_len, bf16_deq=True)


fused_mha_packed_q.launches = 0
fused_mha_packed_q3.launches = 0


def reset_launch_counts() -> None:
    fused_mha_packed.launches = 0
    fused_mha_packed.causal_launches = 0
    fused_mha_short.launches = 0
    fused_mha_short_v2.launches = 0
    fused_mha_packed_proj.launches = 0
    fused_mha_packed_proj.causal_launches = 0
    fused_attn_block.launches = 0
    fused_attn_block.causal_launches = 0
    fused_attn_block.proj_launches = 0
    fused_mha_packed_q3i.launches = 0
    fused_mha_packed_q3i_cls.launches = 0
    fused_mha_packed_q3i_cls_split.launches = 0
    fused_mha_packed_q3i_sb.launches = 0
    fused_mha_q3i_variant.launches = dict.fromkeys(Q3I_VARIANTS, 0)
    fused_mha_packed_q.launches = 0
    fused_mha_packed_q3.launches = 0
    fused_mha_packed_tp.launches = 0
    fused_mha_packed_q3i_tp.launches = 0
