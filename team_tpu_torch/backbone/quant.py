"""The int8 static-W8A8 image tower (``encoder_quant="int8_static"``).

Counterpart of ``team_tpu/backbone/quant.py``, static routes. Activation
scales are calibrated once, per input channel, on a batch
(:func:`calibrate_vision_tower`) and folded into the int8 weights
(:func:`quantize_vision_tower_static`), so every quantize is elementwise:

- ``_static_linear3``: int8 x int8 -> int32 GEMM (``torch._int_mm`` on the
  card), then an f32 dequant and bias, tanh GELU, and a static requantize to
  int8 (:func:`team_tpu_torch.ops.int8_matmul.static_requant`) or a cast to
  bf16 with the block's residual added
  (:func:`team_tpu_torch.ops.int8_matmul.static_residual`); the card runs
  each epilogue in one kernel, as team_tpu's XLA fuses it into the dot;
- the layer norm before the qkv and fc GEMMs reaches int8 by one of three
  producers: ``_ln_quant3`` (one pass, E[x²]−E[x]², affine folded;
  :func:`team_tpu_torch.ops.int8_matmul.ln_quant_folded`, one kernel on the
  card), :func:`team_tpu_torch.ops.int8_matmul.ln_quantize_static` (two
  passes; a kernel), or the bf16 layer norm then ``_static_quant3``.

The routes (``gemm_impl``, the block table ``_BLOCKS`` of ``_tower_int8``):

- ``static3d_qi`` (default): ``_ln_quant3``, integer-QKᵀ attention
  (:func:`team_tpu_torch.ops.mha_short.fused_mha_packed_q3i`, q and k
  quantized with one scale per head; under a registered tensor-parallel
  layout :func:`team_tpu_torch.ops.mha_short.fused_mha_packed_q3i_tp`, the
  rank's heads, gathered over the model group before the replicated
  out-projection, as team_tpu's ``out_specs`` make XLA do), the last block
  in a CLS-only form
  (``TEAM_CLS_LAST``: ``"kq"``, the CLS-query kernel; ``"kqs"``, a split qkv
  GEMM and the split CLS-query kernel; ``"mlp"``, the full kernel and a
  CLS-only tail; ``"attn"``, the CLS attention in plain torch; ``"0"``: in
  full);
- ``static3d_qi2``: ``static3d_qi`` with the int8 PV (``pv_int8``), every
  block in full;
- ``static3d_qis``: ``static3d_qi`` sequence-major (``[S, B, D]``) through
  :func:`team_tpu_torch.ops.mha_short.fused_mha_packed_q3i_sb`;
- ``static3d_qib``: ``static3d_qi`` with the GEMMs and producers over
  ``[BF, (B/BF)*S, D]`` (``TEAM_FLAT_B``, a reshape) and the last block
  ``"kq"``;
- ``static``: ``ln_quantize_static``, bf16 qkv, bf16 attention
  (:func:`team_tpu_torch.backbone.clip.attention_core`), then
  :func:`team_tpu_torch.ops.int8_matmul.row_quant_static`;
- ``static3d``: as ``static`` with the bf16 layer norm and ``_static_quant3``;
- ``static_qa``: ``ln_quantize_static``, int8 qkv, int8-I/O attention with
  an f32 dequant (:func:`team_tpu_torch.ops.mha_short.fused_mha_packed_q`);
- ``static3d_qa``: the bf16 layer norm, int8-I/O attention with a bf16
  dequant (:func:`team_tpu_torch.ops.mha_short.fused_mha_packed_q3`);
- ``static3d_qaf``: as ``static3d_qa`` with ``_ln_quant3``.

The dynamic tiers (:func:`quantize_vision_tower`, per-row dynamic activation
scales) are ``xla`` (``_attn_xla``, ``_mlp_xla``: plain PyTorch), ``hybrid``
(``_attn_hybrid``, ``_mlp_blockscale``: the layer norm to int8 by the
:func:`team_tpu_torch.ops.int8_matmul.ln_quantize` kernel, the qkv and out
GEMMs ``int8_linear_xla``, the fc GEMM with its GELU and block requantize in
the ``int8_linear_gelu_quant`` kernel, proj in ``int8_linear_blockscale``)
and ``pallas`` (``_attn_pallas``: ``hybrid`` with the qkv and out
GEMMs in the ``int8_linear`` kernel); both take the tanh GELU, ``xla`` the
exact one. The int8 text tower (:func:`encode_text_int8`, causal, pooled at
the end-of-text token) runs the same block functions on every dynamic tier
and on every static route of one block function; its static payload is
calibrated on the prompt set (:func:`quantize_text_tower_for_prompts`). The knobs
that team_tpu reads are read here at each call: ``TEAM_QI_SOFTMAX``,
``TEAM_QI_ROWSUM`` and ``TEAM_QI_DEFER`` (the attention's modes),
``TEAM_LN_MODE`` (``1pass``, else the two-pass layer norm of ``_ln_quant3``),
``TEAM_GELU`` (``tanh``; ``sigmoid``; ``none``), ``TEAM_CLS_LAST`` and
``TEAM_FLAT_B``.

Payloads are the JAX package's trees, key for key, and are saved with
``torch.save`` in place of orbax, with the route family they were gated on;
one payload serves every static route.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from team_tpu_torch.backbone.clip import (CLIPConfig, Params, _layer_norm, attention_core,
                                          embed_patches, gather_heads, patch_pixels)
from team_tpu_torch.bridge import tree_to
from team_tpu_torch.ops.int8_matmul import (INV127, int8_linear, int8_linear_blockscale,
                                            int8_linear_gelu_quant, int8_linear_xla, int8_matmul,
                                            ln_quant_folded, ln_quant_folded_reference,
                                            ln_quantize, ln_quantize_static, quantize_rows,
                                            quantize_weight, row_quant_static,
                                            static_dequant_reference, static_requant,
                                            static_residual)
from team_tpu_torch.ops.mha_short import (fused_mha_packed_q, fused_mha_packed_q3,
                                          fused_mha_packed_q3i_cls, fused_mha_packed_q3i_cls_split,
                                          fused_mha_packed_q3i_sb, fused_mha_packed_q3i_tp, tp_mesh)
from team_tpu_torch.ops.preprocess import patch_norm_consts
from team_tpu_torch.utils import phase_timer
from team_tpu_torch.utils.phase_timer import phase

BF16 = torch.bfloat16
_LOG2E = 1.4426950408889634
PAYLOAD_FILE = "quantized_tower.pt"


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF16)


# ---------------------------------------------------------------------------
# calibration: the bf16 tower, recording per-channel abs-max activations
# ---------------------------------------------------------------------------

def _block_calib_forward(blk: Params, x: torch.Tensor, heads: int, kv_len, *,
                         attn_impl: str, causal: bool = False):
    """bf16 block forward (``clip._block_forward``'s numerics) that also
    returns the per-channel abs-max of the four GEMM inputs, of the qkv
    output, and the signed per-head max attention logit ``qk_lmax``."""
    b, s, d = x.shape
    dh = d // heads
    h = _layer_norm(blk["ln_1"], x).reshape(b * s, d)
    a_ln1 = h.float().abs().amax(dim=0)
    qkv = (h @ _bf16(blk["attn"]["qkv_w"]) + _bf16(blk["attn"]["qkv_b"])).reshape(b, s, 3 * d)
    a_qkv = qkv.float().abs().amax(dim=(0, 1))
    qh = qkv[..., :d].reshape(b, s, heads, dh).permute(0, 2, 1, 3).float()
    kh = qkv[..., d:2 * d].reshape(b, s, heads, dh).permute(0, 2, 1, 3).float()
    a_lmax = torch.matmul(qh, kh.transpose(-1, -2)).amax(dim=(0, 2, 3)) * dh ** -0.5
    o = attention_core(qkv, heads, causal=causal, kv_len=kv_len, impl=attn_impl).reshape(b * s, d)
    a_o = o.float().abs().amax(dim=0)
    x = x + (o @ _bf16(blk["attn"]["out_w"]) + _bf16(blk["attn"]["out_b"])).reshape(b, s, d)
    h = _layer_norm(blk["ln_2"], x).reshape(b * s, d)
    a_ln2 = h.float().abs().amax(dim=0)
    g = F.gelu(h @ _bf16(blk["mlp"]["fc_w"]) + _bf16(blk["mlp"]["fc_b"]), approximate="none")
    a_g = g.float().abs().amax(dim=0)
    x = x + (g @ _bf16(blk["mlp"]["proj_w"]) + _bf16(blk["mlp"]["proj_b"])).reshape(b, s, d)
    return x, {"ln1": a_ln1, "attn_o": a_o, "ln2": a_ln2, "gelu": a_g,
               "qkv_out": a_qkv, "qk_lmax": a_lmax}


def calibrate_vision_tower(params: Params, images: torch.Tensor, cfg: CLIPConfig, *,
                           attn_impl: str = "auto", return_features: bool = False):
    """Per-block, per-channel activation abs-max over a calibration batch of
    ``[B, H, W, 3]`` normalized images; with ``return_features`` also the
    bf16 tower's features of that batch (this forward is the bf16 tower)."""
    px = patch_pixels(images, cfg, compute_dtype=BF16)
    return _calibrate_from_px(params, px, cfg, attn_impl=attn_impl,
                              return_features=return_features)


def calibrate_vision_tower_patches(params: Params, patches_u8: torch.Tensor, cfg: CLIPConfig, *,
                                   attn_impl: str = "auto", return_features: bool = False):
    """:func:`calibrate_vision_tower` over patch-major uint8 ``[B, g*g, 3*ps*ps]``."""
    if patches_u8.dtype != torch.uint8:
        raise TypeError(f"patch-major input must be uint8, got {patches_u8.dtype}")
    scale, bias = patch_norm_consts(cfg.vision.patch_size, device=patches_u8.device)
    px = _bf16(patches_u8.float() * scale + bias)
    return _calibrate_from_px(params, px, cfg, attn_impl=attn_impl,
                              return_features=return_features)


def _calibrate_from_px(params: Params, px: torch.Tensor, cfg: CLIPConfig, *,
                       attn_impl: str, return_features: bool):
    v = cfg.vision
    vis = params["vision"]
    a_patch = px.float().abs().amax(dim=(0, 1))
    tokens = px @ _bf16(vis["patch_w"])
    cls = _bf16(vis["cls"]).expand(tokens.shape[0], 1, v.width)
    x = torch.cat([cls, tokens], dim=1) + _bf16(vis["pos"])
    x = _layer_norm(vis["ln_pre"], x)
    stats = []
    for blk in vis["blocks"]:
        x, st = _block_calib_forward(blk, x, v.heads, v.seq_len, attn_impl=attn_impl)
        stats.append(st)
    out = {"blocks": stats, "patch_in": a_patch}
    if not return_features:
        return out
    feats = _layer_norm(vis["ln_post"], x[:, 0])
    return out, (feats @ _bf16(vis["proj"])).float()


# ---------------------------------------------------------------------------
# quantization: fold the static activation scales into int8 weights
# ---------------------------------------------------------------------------

def _scale_of(amax: torch.Tensor, margin: float = 1.0) -> torch.Tensor:
    """where(amax·margin > 0, amax·margin/127, 1) as XLA compiles it in the
    jitted quantization: the two constants fold into one float32 factor."""
    amax = amax.float()
    factor = torch.tensor(margin, dtype=torch.float32) * INV127
    return torch.where(amax * margin > 0, amax * factor.to(amax.device), torch.ones_like(amax))


def _fold_site(w: torch.Tensor, bias: torch.Tensor, amax: torch.Tensor,
               margin: float) -> Dict[str, torch.Tensor]:
    s_a = _scale_of(amax, margin)  # [K]
    w_q, w_s = quantize_weight(w.float() * s_a[:, None])
    return {"w_q": w_q, "scale": w_s, "b": bias.float(), "inv_a": (1.0 / s_a)[None, :]}


def quantize_block_static(blk: Params, stats: Dict[str, torch.Tensor], *, margin: float = 1.5,
                          heads: Optional[int] = None) -> Dict[str, Any]:
    """One block's payload; ``heads`` adds the integer-QKᵀ attention's
    per-head-uniform q/k scales (``deq_i``, ``out_inv_a_i``, ``qk_scale``) and,
    from ``qk_lmax``, the static softmax constant ``qk_m2``."""
    qkv_site = _fold_site(blk["attn"]["qkv_w"], blk["attn"]["qkv_b"], stats["ln1"], margin)
    if "qkv_out" in stats:
        a = stats["qkv_out"].float() * margin
        s_qkv = _scale_of(stats["qkv_out"], margin)
        qkv_site["out_inv_a"] = (1.0 / s_qkv)[None, :]
        qkv_site["deq"] = s_qkv[None, :]
        if heads is not None:
            d = a.shape[0] // 3
            dh = d // heads
            aq = a[:d].reshape(heads, dh).amax(dim=1).repeat_interleave(dh)
            ak = a[d:2 * d].reshape(heads, dh).amax(dim=1).repeat_interleave(dh)
            s_u = _scale_of(torch.cat([aq, ak, a[2 * d:]]))
            qkv_site["deq_i"] = s_u[None, :]
            qkv_site["out_inv_a_i"] = (1.0 / s_u)[None, :]
            sq_h = s_u[:d].reshape(heads, dh)[:, 0]
            sk_h = s_u[d:2 * d].reshape(heads, dh)[:, 0]
            qkv_site["qk_scale"] = (sq_h * sk_h * dh ** -0.5)[None, :]
            if "qk_lmax" in stats:
                # calibrated max logit in exp2 units, with 2 nats of headroom
                qkv_site["qk_m2"] = ((stats["qk_lmax"].float() + 2.0) * _LOG2E)[None, :]
    return {
        "ln_1": blk["ln_1"], "ln_2": blk["ln_2"],
        "qkv": qkv_site,
        "out": _fold_site(blk["attn"]["out_w"], blk["attn"]["out_b"], stats["attn_o"], margin),
        "fc": _fold_site(blk["mlp"]["fc_w"], blk["mlp"]["fc_b"], stats["ln2"], margin),
        "proj": _fold_site(blk["mlp"]["proj_w"], blk["mlp"]["proj_b"], stats["gelu"], margin),
    }


def quantize_vision_tower_static(params: Params, calib_stats, *, margin: float = 1.5,
                                 heads: Optional[int] = None) -> Dict[str, Any]:
    """Static-W8A8 payload of the image tower from float32 ``params`` and the
    stats of :func:`calibrate_vision_tower` (or a bare per-block list)."""
    v = params["vision"]
    block_stats = calib_stats if isinstance(calib_stats, (list, tuple)) else calib_stats["blocks"]
    return {
        "patch_w": v["patch_w"], "cls": v["cls"], "pos": v["pos"], "ln_pre": v["ln_pre"],
        "blocks": [quantize_block_static(b, st, margin=margin, heads=heads)
                   for b, st in zip(v["blocks"], block_stats)],
        "ln_post": v["ln_post"], "proj": v["proj"],
        "patch_q": _quantize_patch_dot(v["patch_w"]),
    }


def quantize_block(blk: Params) -> Dict[str, Any]:
    """One block's dynamic-tier payload: the four GEMM weights per output
    channel (``quant.py:quantize_block``); the activations are quantized per
    row at run time."""
    out = {"ln_1": blk["ln_1"], "ln_2": blk["ln_2"]}
    for name, w, b in (("qkv", blk["attn"]["qkv_w"], blk["attn"]["qkv_b"]),
                       ("out", blk["attn"]["out_w"], blk["attn"]["out_b"]),
                       ("fc", blk["mlp"]["fc_w"], blk["mlp"]["fc_b"]),
                       ("proj", blk["mlp"]["proj_w"], blk["mlp"]["proj_b"])):
        w_q, w_s = quantize_weight(w)
        out[name] = {"w_q": w_q, "scale": w_s, "b": b.float()}
    return out


def quantize_vision_tower(params: Params) -> Dict[str, Any]:
    """The dynamic tier's payload of the image tower (``quant.py:
    quantize_vision_tower``): int8 GEMM weights; the rest passes through."""
    v = params["vision"]
    return {"patch_w": v["patch_w"], "cls": v["cls"], "pos": v["pos"], "ln_pre": v["ln_pre"],
            "blocks": [quantize_block(b) for b in v["blocks"]],
            "ln_post": v["ln_post"], "proj": v["proj"]}


def _quantize_patch_dot(patch_w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """u8-exact int8 patch embedding for patch-major uint8 input:
    ``(u8*scale + bias) @ W == (u8-128) @ (scale⊙W) + [128·colsum(scale⊙W) + bias@W]``,
    and the centred input is exact in int8."""
    ps = int(round((patch_w.shape[0] // 3) ** 0.5))
    scale, bias = patch_norm_consts(ps, device=patch_w.device)
    w32 = patch_w.float()
    a = w32 * scale[:, None]
    w_q, w_s = quantize_weight(a)
    const = 128.0 * a.sum(dim=0) + bias @ w32
    return {"w_q": w_q, "scale": w_s, "const": const[None, :]}


# ---------------------------------------------------------------------------
# the int8 forward
# ---------------------------------------------------------------------------

def _quant(x: torch.Tensor, inv_a: torch.Tensor) -> torch.Tensor:
    """Static quantize: clip(round(x·inv_a), ±127) to int8 (round half to even)."""
    return torch.clamp(torch.round(x * inv_a.reshape(-1)), -127, 127).to(torch.int8)


def _static_quant3(x3: torch.Tensor, inv_a: torch.Tensor) -> torch.Tensor:
    return _quant(x3.float(), inv_a)


def _gelu_mode(activation: Optional[str]) -> Optional[str]:
    """The activation of :func:`_static_linear3` as :func:`static_requant`
    takes it. ``activation="gelu"`` reads ``TEAM_GELU``: ``"tanh"`` (the
    default), ``"sigmoid"`` (x·σ(1.702x)), ``"none"`` (no activation: a
    diagnostic of team_tpu's, with wrong numerics); ``"gelu_tanh"`` always
    takes tanh."""
    if activation not in ("gelu", "gelu_tanh"):
        return None
    mode = os.environ.get("TEAM_GELU", "tanh") if activation == "gelu" else "tanh"
    if mode == "none":
        return None
    return "sigmoid" if mode == "sigmoid" else "tanh"


def _static_linear3(q3: torch.Tensor, site: Dict[str, torch.Tensor], activation: Optional[str] = None,
                    quant_inv_a: Optional[torch.Tensor] = None,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[..., K] int8 @ [K, N] int8`` -> int32, then f32 dequant and bias,
    optional tanh GELU, and a static requantize to int8 (``quant_inv_a``) or
    a cast to bf16 added to ``residual`` where one is given. Both of
    team_tpu's forms, the 2-D ``_static_linear`` of the ``static``/``static_qa``
    routes and the 3-D ``_static_linear3``: the arithmetic is the same, and
    ``int8_matmul`` takes any leading dims; only the 3-D form reads
    ``TEAM_GELU`` (``activation="gelu"``), the 2-D one always takes tanh
    (``activation="gelu_tanh"``). On the card each epilogue is one kernel
    (:func:`static_requant`, :func:`static_residual`), which takes widths
    divisible by 8 and a bf16 residual, and a GELU only before a requantize
    (the fc GEMM's): the forms no route takes raise there. On the CPU the
    composition runs and takes them all, as team_tpu's does."""
    if quant_inv_a is not None and residual is not None:
        raise ValueError("_static_linear3: a requantized output takes no residual")
    act = _gelu_mode(activation)
    on_card = q3.device.type != "cpu"
    if on_card and quant_inv_a is None and act is not None:
        raise ValueError("_static_linear3: on the card a GELU output is requantized (give "
                         "quant_inv_a)")
    acc = int8_matmul(q3, site["w_q"])
    if on_card:
        if quant_inv_a is not None:
            return static_requant(acc, site["scale"], site["b"], quant_inv_a, activation=act)
        return static_residual(acc, site["scale"], site["b"], residual)
    out = static_dequant_reference(acc, site["scale"], site["b"], act)
    if quant_inv_a is not None:
        return _quant(out, quant_inv_a)
    out = _bf16(out)
    return out if residual is None else residual + out


def _ln_quant3(x3: torch.Tensor, ln: Params, inv_a: torch.Tensor) -> torch.Tensor:
    """Layer norm -> static int8 over ``[..., D]``, the LN affine folded into
    the quantize constants: :func:`ln_quant_folded`, one kernel on the card
    (bf16, widths divisible by 8); its composition on the CPU, which takes
    any float width. ``TEAM_LN_MODE`` ``1pass`` (the default): the variance
    is max(E[x²]−E[x]², 0) in one pass (the JAX tier's form, not
    ``torch.var``); any other value: the two-pass mean and variance."""
    produce = ln_quant_folded_reference if x3.device.type == "cpu" else ln_quant_folded
    return produce(x3, ln["scale"], ln["bias"], inv_a,
                   two_pass=os.environ.get("TEAM_LN_MODE", "1pass") != "1pass")


def _ln_quant_kernel(x3: torch.Tensor, ln: Params, inv_a: torch.Tensor) -> torch.Tensor:
    """The two-pass layer norm -> static int8 producer over ``[B, S, D]``
    (:func:`ln_quantize_static`, a kernel on the card)."""
    b, s, d = x3.shape
    return ln_quantize_static(x3.reshape(b * s, d), ln["scale"], ln["bias"],
                              inv_a).reshape(b, s, d)


def _ln_then_quant(x3: torch.Tensor, ln: Params, inv_a: torch.Tensor) -> torch.Tensor:
    """The bf16 layer norm, then the elementwise static quantize."""
    return _static_quant3(_layer_norm(ln, x3), inv_a)


def _row_quant_kernel(o3: torch.Tensor, inv_a: torch.Tensor) -> torch.Tensor:
    """:func:`row_quant_static` over ``[B, S, D]`` (a kernel on the card)."""
    b, s, d = o3.shape
    return row_quant_static(o3.reshape(b * s, d), inv_a).reshape(b, s, d)


def _qkv_int8(qb: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    site = qb["qkv"]
    return _static_linear3(_ln_quant3(x, qb["ln_1"], site["inv_a"]), site,
                           quant_inv_a=site["out_inv_a_i"])


def _mlp_residual(qb: Dict[str, Any], x: torch.Tensor, produce=_ln_quant3,
                  gelu: str = "gelu") -> torch.Tensor:
    """The MLP half of the static blocks: LN2 -> int8 (``produce``) -> fc
    GEMM with the GELU (``gelu``, see :func:`_static_linear3`), requantized ->
    proj GEMM -> residual."""
    g = _static_linear3(produce(x, qb["ln_2"], qb["fc"]["inv_a"]), qb["fc"],
                        activation=gelu, quant_inv_a=qb["proj"]["inv_a"])
    return _static_linear3(g, qb["proj"], residual=x)


def _masked_kv_len(kv_len, s: int):
    return kv_len if (kv_len is not None and kv_len < s) else None


def _qi_defer() -> bool:
    """``TEAM_QI_DEFER=1``: the q3i blocks divide the attention output by the
    softmax denominator instead of p (it changes results only off the
    default ones-column row sum)."""
    return os.environ.get("TEAM_QI_DEFER", "0") == "1"


def _q3i_attention(qb: Dict[str, Any], qkvq: torch.Tensor, heads: int, **kw) -> torch.Tensor:
    """The integer-QKᵀ attention of a q3i block over the full int8 qkv, with
    the block's scales and ``TEAM_QI_DEFER``, routed as team_tpu's
    ``fused_mha_packed_q3i_tp``: under a registered tensor-parallel layout
    whose model axis splits the heads, the rank's heads
    (:func:`fused_mha_packed_q3i_tp`) gathered over the model group; else
    that wrapper's own fallback, the whole-head kernel."""
    site = qb["qkv"]
    args = (qkvq, site["deq_i"], site["qk_scale"], qb["out"]["inv_a"], heads)
    kw.update(qk_m2=site.get("qk_m2"), defer_norm=_qi_defer())
    return gather_heads(fused_mha_packed_q3i_tp(*args, **kw), qkvq.shape[-1] // 3)


# Each block is an attention half (LN1 to the attention's residual) and an MLP
# half (LN2 to the MLP's residual); the image tower runs each in its stage span.

def _attn_static3d_qi(qb: Dict[str, Any], x: torch.Tensor, heads: int, kv_len, *,
                      attn_impl: str = "auto", causal: bool = False,
                      pv_int8: bool = False) -> torch.Tensor:
    """Static-W8A8 attention with integer QKᵀ (``quant.py:
    _qblock_forward_static3d_qi``): one-pass LN -> int8 -> qkv GEMM
    requantized with per-head-uniform q/k scales -> :func:`_q3i_attention`
    (``pv_int8``: the int8 PV, ``static3d_qi2``) -> out-projection ->
    residual. ``attn_impl`` is ignored: the kernel is the attention."""
    oq = _q3i_attention(qb, _qkv_int8(qb, x), heads, causal=causal,
                        kv_len=_masked_kv_len(kv_len, x.shape[1]), pv_int8=pv_int8)
    return _static_linear3(oq, qb["out"], residual=x)


def _attn_bf16(qb: Dict[str, Any], x: torch.Tensor, heads: int, kv_len, *, produce, requant,
               attn_impl: str = "auto", causal: bool = False) -> torch.Tensor:
    """The static and static3d attention: LN -> int8 (``produce``) -> qkv
    GEMM to bf16 -> bf16 attention (:func:`attention_core`) -> int8
    (``requant``) -> out-projection -> residual."""
    site = qb["qkv"]
    qkv = _static_linear3(produce(x, qb["ln_1"], site["inv_a"]), site)
    o = attention_core(qkv, heads, causal=causal, kv_len=_masked_kv_len(kv_len, x.shape[1]),
                       impl=attn_impl)
    return _static_linear3(requant(o, qb["out"]["inv_a"]), qb["out"], residual=x)


def _attn_int8_io(qb: Dict[str, Any], x: torch.Tensor, heads: int, kv_len, *, produce,
                  two_d: bool, attn_impl: str = "auto", causal: bool = False) -> torch.Tensor:
    """The quantized-attention-I/O attention: LN -> int8 (``produce``) -> qkv
    GEMM requantized with the per-channel ``out_inv_a`` -> int8-in, int8-out
    attention (:func:`fused_mha_packed_q` over ``[B*S, 3D]`` when ``two_d``,
    else :func:`fused_mha_packed_q3`) -> out-projection -> residual;
    ``attn_impl`` is ignored."""
    b, s, d = x.shape
    site = qb["qkv"]
    qkvq = _static_linear3(produce(x, qb["ln_1"], site["inv_a"]), site,
                           quant_inv_a=site["out_inv_a"])
    kw = dict(causal=causal, kv_len=_masked_kv_len(kv_len, s))
    if two_d:
        oq = fused_mha_packed_q(qkvq.reshape(b * s, 3 * d), site["deq"], qb["out"]["inv_a"],
                                heads, seq=s, **kw).reshape(b, s, d)
    else:
        oq = fused_mha_packed_q3(qkvq, site["deq"], qb["out"]["inv_a"], heads, **kw)
    return _static_linear3(oq, qb["out"], residual=x)


def _attn_cls(qb: Dict[str, Any], x: torch.Tensor, heads: int, mode: str) -> torch.Tensor:
    """The last block's attention for the CLS row alone, ``[B, 1, D]``
    (``quant.py:_qblock_forward_static3d_qi_clsmlp`` and ``_cls``): the
    pooled feature is row 0. ``mode`` picks the attention: ``"kq"``, the
    CLS-query kernel on the full qkv GEMM (:func:`fused_mha_packed_q3i_cls`);
    ``"kqs"``, k and v projected for every row with ``w_q[:, D:]`` and q for
    row 0 only with ``w_q[:, :D]``, each requantized with its slice of
    ``out_inv_a_i``, then :func:`fused_mha_packed_q3i_cls_split`; ``"attn"``,
    the full qkv GEMM and :func:`_cls_attn_q3i` in plain torch; anything else
    (``"mlp"``), the full kernel (``TEAM_QI_DEFER`` read as in every block)
    and its row 0. Under a registered tensor-parallel layout the CLS kernels
    give way to the full head-split kernel (``quant.py:728-740``)."""
    site = qb["qkv"]
    if mode != "attn" and tp_mesh() is not None:
        mode = "mlp"
    if mode == "kqs":
        d = x.shape[-1]
        x8 = _ln_quant3(x, qb["ln_1"], site["inv_a"])
        kv_site = {"w_q": site["w_q"][:, d:], "scale": site["scale"][..., d:],
                   "b": site["b"][..., d:]}
        q_site = {"w_q": site["w_q"][:, :d], "scale": site["scale"][..., :d],
                  "b": site["b"][..., :d]}
        kvq = _static_linear3(x8, kv_site, quant_inv_a=site["out_inv_a_i"][..., d:])
        qq = _static_linear3(x8[:, :1], q_site, quant_inv_a=site["out_inv_a_i"][..., :d])
        oq = fused_mha_packed_q3i_cls_split(qq, kvq, site["deq_i"], site["qk_scale"],
                                            qb["out"]["inv_a"], heads, qk_m2=site.get("qk_m2"))
    elif mode == "kq":
        oq = fused_mha_packed_q3i_cls(_qkv_int8(qb, x), site["deq_i"], site["qk_scale"],
                                      qb["out"]["inv_a"], heads, qk_m2=site.get("qk_m2"))
    elif mode == "attn":
        oq = _cls_attn_q3i(_qkv_int8(qb, x), site["deq_i"], site["qk_scale"], qb["out"]["inv_a"],
                           heads, qk_m2=site.get("qk_m2"))
    else:
        oq = _q3i_attention(qb, _qkv_int8(qb, x), heads)[:, :1]
    return _static_linear3(oq, qb["out"], residual=x[:, :1])


def _cls_attn_q3i(qkvq: torch.Tensor, deq: torch.Tensor, qk_scale: torch.Tensor,
                  o_inv: torch.Tensor, heads: int,
                  qk_m2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The CLS query's integer attention in plain torch (``quant.py:
    _cls_attn_q3i``), on the CPU and on the card alike: ``[B, S, 3D]`` int8
    -> ``[B, 1, D]`` int8, the arithmetic of the CLS kernel. The products
    run in float64, which holds the int8 and bf16 operands' products and sums
    exactly and takes no TF32; ``qk_m2`` is used only under
    ``TEAM_QI_SOFTMAX=static``."""
    b, s, d3 = qkvq.shape
    d = d3 // 3
    dh = d // heads
    q8 = qkvq[:, 0, :d].reshape(b, heads, 1, dh)
    k8 = qkvq[:, :, d:2 * d].reshape(b, s, heads, dh).permute(0, 2, 1, 3)
    v8 = qkvq[:, :, 2 * d:].reshape(b, s, heads, dh).permute(0, 2, 1, 3)
    acc = torch.matmul(q8.double(), k8.double().transpose(-1, -2)).float()  # [B, H, 1, S]
    qks = qk_scale.reshape(1, heads, 1, 1).float()
    if os.environ.get("TEAM_QI_SOFTMAX", "static") != "static":
        qk_m2 = None
    if qk_m2 is not None:
        p = torch.exp2(acc * (qks * _LOG2E) - qk_m2.reshape(1, heads, 1, 1).float())
    else:
        logits = acc * qks
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    pb = p.to(BF16)
    num = torch.matmul(pb.double(), v8.double()).float()  # [B, H, 1, dh]
    den = pb.float().sum(dim=-1, keepdim=True)
    pv_scale = (deq.reshape(-1)[2 * d:].float() * o_inv.reshape(-1).float()).reshape(1, heads, 1, dh)
    out = (num * pv_scale / den).permute(0, 2, 1, 3).reshape(b, 1, d)
    return torch.clamp(torch.round(out), -127, 127).to(torch.int8)


def _attn_static3d_qis(qb: Dict[str, Any], x: torch.Tensor, heads: int) -> torch.Tensor:
    """The sequence-major attention (``quant.py:_qblock_forward_static3d_qis``):
    ``x [S, B, D]``, the arithmetic of :func:`_attn_static3d_qi` around
    :func:`fused_mha_packed_q3i_sb`. Non-causal, every key."""
    site = qb["qkv"]
    oq = fused_mha_packed_q3i_sb(_qkv_int8(qb, x), site["deq_i"], site["qk_scale"],
                                 qb["out"]["inv_a"], heads)
    return _static_linear3(oq, qb["out"], residual=x)


def _attn_static3d_qib(qb: Dict[str, Any], xf: torch.Tensor, heads: int, b_real: int,
                       s_real: int) -> torch.Tensor:
    """The flat-batch attention (``quant.py:_qblock_forward_static3d_qib``):
    the GEMMs and producers over ``xf [BF, (B/BF)*S, D]``, the same rows as
    ``[B, S, D]`` (every reshape is a view: the producers and the residual
    work by row), and :func:`_q3i_attention` at the real ``[B, S, 3D]``.
    Non-causal, every key."""
    bf, m, d = xf.shape
    oq = _q3i_attention(qb, _qkv_int8(qb, xf).reshape(b_real, s_real, 3 * d), heads)
    return _static_linear3(oq.reshape(bf, m, d), qb["out"], residual=xf)


def _ln_quant_rows(x2d: torch.Tensor, ln: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float32 layer norm (two-pass mean and variance), then the per-row
    dynamic int8 quantize (``quant.py:_ln_quant_jnp``)."""
    x32 = x2d.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + 1e-5)
    return quantize_rows(y * ln["scale"].float() + ln["bias"].float())


def _attn_xla(qb: Dict[str, Any], x: torch.Tensor, heads: int, kv_len, *,
              attn_impl: str = "auto", causal: bool = False) -> torch.Tensor:
    """The dynamic tier's attention (``quant.py:_qblock_forward_xla``): every
    GEMM input quantized per row at run time (:func:`quantize_rows`), the
    GEMMs :func:`int8_linear_xla`, the bf16 attention (:func:`attention_core`,
    with ``attn_impl``) between them."""
    b, s, d = x.shape
    hq, hs = _ln_quant_rows(x.reshape(b * s, d), qb["ln_1"])
    qkv = int8_linear_xla(hq, qb["qkv"]["w_q"], hs, qb["qkv"]["scale"], qb["qkv"]["b"])
    o = attention_core(qkv.reshape(b, s, 3 * d), heads, causal=causal,
                       kv_len=_masked_kv_len(kv_len, s), impl=attn_impl)
    oq, osc = quantize_rows(o.reshape(b * s, d))
    return x + int8_linear_xla(oq, qb["out"]["w_q"], osc, qb["out"]["scale"],
                               qb["out"]["b"]).reshape(b, s, d)


def _mlp_xla(qb: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The dynamic tier's MLP: per-row quantized GEMM inputs, the exact GELU."""
    b, s, d = x.shape
    hq, hs = _ln_quant_rows(x.reshape(b * s, d), qb["ln_2"])
    h = int8_linear_xla(hq, qb["fc"]["w_q"], hs, qb["fc"]["scale"], qb["fc"]["b"],
                        activation="gelu")
    gq, gs = quantize_rows(h)
    proj = int8_linear_xla(gq, qb["proj"]["w_q"], gs, qb["proj"]["scale"], qb["proj"]["b"])
    return x + proj.reshape(b, s, d)


def _qlinear(x2d: torch.Tensor, qp: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``quant.py:_qlinear``: per-row quantize (:func:`quantize_rows`), then
    the :func:`int8_linear` kernel."""
    x_q, x_scale = quantize_rows(x2d)
    return int8_linear(x_q, qp["w_q"], x_scale, qp["scale"], qp["b"])


def _mlp_blockscale(qb: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The MLP half of the ``hybrid`` and ``pallas`` blocks: :func:`ln_quantize`,
    the fc GEMM with the tanh GELU and the per-(row, column block) requantize
    (:func:`int8_linear_gelu_quant`), the proj GEMM over those block scales
    (:func:`int8_linear_blockscale`), the residual."""
    b, s, d = x.shape
    hq, hs = ln_quantize(x.reshape(b * s, d), qb["ln_2"]["scale"], qb["ln_2"]["bias"])
    gq, gs = int8_linear_gelu_quant(hq, qb["fc"]["w_q"], hs, qb["fc"]["scale"], qb["fc"]["b"])
    proj = int8_linear_blockscale(gq, qb["proj"]["w_q"], gs, qb["proj"]["scale"], qb["proj"]["b"])
    return x + proj.reshape(b, s, d)


def _attn_hybrid(qb: Dict[str, Any], x: torch.Tensor, heads: int, kv_len, *,
                 attn_impl: str = "auto", causal: bool = False) -> torch.Tensor:
    """The ``hybrid`` tier's attention (``quant.py:_qblock_forward_hybrid``):
    :func:`ln_quantize` -> the qkv GEMM :func:`int8_linear_xla` -> bf16
    attention (:func:`attention_core`, with ``attn_impl``) -> per-row
    quantize -> the out GEMM :func:`int8_linear_xla` -> residual."""
    b, s, d = x.shape
    hq, hs = ln_quantize(x.reshape(b * s, d), qb["ln_1"]["scale"], qb["ln_1"]["bias"])
    qkv = int8_linear_xla(hq, qb["qkv"]["w_q"], hs, qb["qkv"]["scale"], qb["qkv"]["b"])
    o = attention_core(qkv.reshape(b, s, 3 * d), heads, causal=causal,
                       kv_len=_masked_kv_len(kv_len, s), impl=attn_impl)
    oq, osc = quantize_rows(o.reshape(b * s, d))
    return x + int8_linear_xla(oq, qb["out"]["w_q"], osc, qb["out"]["scale"],
                               qb["out"]["b"]).reshape(b, s, d)


def _attn_pallas(qb: Dict[str, Any], x: torch.Tensor, heads: int, kv_len, *,
                 attn_impl: str = "auto", causal: bool = False) -> torch.Tensor:
    """The ``pallas`` tier's attention (``quant.py:_qblock_forward``): as
    :func:`_attn_hybrid` with the qkv GEMM in the :func:`int8_linear` kernel
    and the out GEMM :func:`_qlinear`."""
    b, s, d = x.shape
    hq, hs = ln_quantize(x.reshape(b * s, d), qb["ln_1"]["scale"], qb["ln_1"]["bias"])
    qkv = int8_linear(hq, qb["qkv"]["w_q"], hs, qb["qkv"]["scale"], qb["qkv"]["b"])
    o = attention_core(qkv.reshape(b, s, 3 * d), heads, causal=causal,
                       kv_len=_masked_kv_len(kv_len, s), impl=attn_impl)
    return x + _qlinear(o.reshape(b * s, d), qb["out"]).reshape(b, s, d)


_GEMM_IMPLS = ("xla", "hybrid", "static", "static_qa", "static3d", "static3d_qa", "static3d_qaf",
               "static3d_qi", "static3d_qis", "static3d_qib", "static3d_qi2", "pallas")
_DYNAMIC_TIERS = ("xla", "hybrid", "pallas")
# the (attention, MLP) halves of each route that runs one block function in
# every layer (``quant.py:1179-1190``); static3d_qis and static3d_qib have
# their own loops. It is also the text tower's table (``quant.py:1010-1019``).
# The static routes' 2-D forms (``static``, ``static_qa``) take the tanh GELU
# whatever ``TEAM_GELU`` says.
_BLOCKS = {
    "xla": (_attn_xla, _mlp_xla),
    "hybrid": (_attn_hybrid, _mlp_blockscale),
    "pallas": (_attn_pallas, _mlp_blockscale),
    "static": (partial(_attn_bf16, produce=_ln_quant_kernel, requant=_row_quant_kernel),
               partial(_mlp_residual, produce=_ln_quant_kernel, gelu="gelu_tanh")),
    "static3d": (partial(_attn_bf16, produce=_ln_then_quant, requant=_static_quant3),
                 partial(_mlp_residual, produce=_ln_then_quant)),
    "static_qa": (partial(_attn_int8_io, produce=_ln_quant_kernel, two_d=True),
                  partial(_mlp_residual, produce=_ln_quant_kernel, gelu="gelu_tanh")),
    "static3d_qa": (partial(_attn_int8_io, produce=_ln_then_quant, two_d=False),
                    partial(_mlp_residual, produce=_ln_then_quant)),
    "static3d_qaf": (partial(_attn_int8_io, produce=_ln_quant3, two_d=False), _mlp_residual),
    "static3d_qi": (_attn_static3d_qi, _mlp_residual),
    "static3d_qi2": (partial(_attn_static3d_qi, pv_int8=True), _mlp_residual),
}
_CLS_MODES = ("attn", "mlp", "kq", "kqs")


def route_family(gemm_impl: str) -> str:
    """``"dynamic"`` for the tiers with per-row activation scales, else
    ``"static"``: a payload gated on one family is not trusted on the other."""
    return "dynamic" if gemm_impl in _DYNAMIC_TIERS else "static"


def check_route(gemm_impl: str) -> None:
    """Raise on a name that is not an int8 route."""
    if gemm_impl not in _GEMM_IMPLS:
        raise ValueError(f"unknown int8 gemm_impl {gemm_impl!r}")


def _cls_mode(cls_last) -> str:
    """``cls_last`` as team_tpu reads it: True is ``"attn"``, False ``"0"``,
    None the env ``TEAM_CLS_LAST`` (default ``"kq"``); a name outside
    ``_CLS_MODES`` runs the last block in full."""
    if cls_last is True:
        return "attn"
    if cls_last is False:
        return "0"
    if cls_last is None:
        return os.environ.get("TEAM_CLS_LAST", "kq")
    return cls_last


def _staged_block(qb: Dict[str, Any], x: torch.Tensor, attn, mlp, *args, **kw) -> torch.Tensor:
    """One block of the image tower, ``attn(qb, x, *args, **kw)`` then
    ``mlp``, each half in its stage span."""
    with phase(phase_timer.ATTN_BLOCK):
        x = attn(qb, x, *args, **kw)
    with phase(phase_timer.MLP_BLOCK):
        return mlp(qb, x)


def _embed_int8(qvision: Dict[str, Any], tokens: torch.Tensor, cfg: CLIPConfig) -> torch.Tensor:
    """The CLS token and position embeddings over patch tokens, then ``ln_pre``."""
    cls = _bf16(qvision["cls"]).expand(tokens.shape[0], 1, cfg.vision.width)
    x = torch.cat([cls, _bf16(tokens)], dim=1) + _bf16(qvision["pos"])
    return _layer_norm(qvision["ln_pre"], x)


def _tower_int8(qvision: Dict[str, Any], patch_tokens, cfg: CLIPConfig, *,
                attn_impl: str, gemm_impl: str, cls_last) -> torch.Tensor:
    """The quantized tower -> ``[B, embed_dim]`` float32
    (``quant.py:_encode_tokens_int8``), each stage in its span: the embedding
    (``patch_tokens()``, the function that makes the bf16 patch tokens
    ``[B, g*g, width]``, then :func:`_embed_int8`; the tokens' intermediates
    are freed before the blocks run), the blocks' halves, the head.
    ``cls_last`` (:func:`_cls_mode`) picks the last block's CLS-only form on
    ``static3d_qi``; ``static3d_qib``'s last block is always ``"kq"``; the other
    routes run every block in full and ignore it, as in team_tpu.
    ``attn_impl`` reaches the routes with bf16 attention (``static``,
    ``static3d``, ``xla``). The sequence is never padded: the TPU-only
    ``_maybe_pad_seq`` is not ported (off on the CPU in team_tpu too)."""
    check_route(gemm_impl)
    v = cfg.vision
    with phase(phase_timer.EMBED):
        x = _embed_int8(qvision, patch_tokens(), cfg)
    blocks = qvision["blocks"]
    if gemm_impl == "static3d_qis":
        x = x.transpose(0, 1).contiguous()  # [S, B, D], one transpose in
        for qb in blocks:
            x = _staged_block(qb, x, _attn_static3d_qis, _mlp_residual, v.heads)
        x = x[0]
    elif gemm_impl == "static3d_qib":
        b_real, s_real = x.shape[:2]
        bf = int(os.environ.get("TEAM_FLAT_B", "8"))
        if b_real % bf:
            bf = 1
        xf = x.reshape(bf, (b_real // bf) * s_real, v.width)
        for qb in blocks[:-1]:
            xf = _staged_block(qb, xf, _attn_static3d_qib, _mlp_residual, v.heads, b_real, s_real)
        x = _staged_block(blocks[-1], xf.reshape(b_real, s_real, v.width), _attn_cls,
                          _mlp_residual, v.heads, "kq")[:, 0]
    else:
        attn, mlp = _BLOCKS[gemm_impl]
        mode = _cls_mode(cls_last)
        use_cls = gemm_impl == "static3d_qi" and mode in _CLS_MODES
        for qb in (blocks[:-1] if use_cls else blocks):
            x = _staged_block(qb, x, attn, mlp, v.heads, v.seq_len, attn_impl=attn_impl)
        if use_cls:
            x = _staged_block(blocks[-1], x, _attn_cls, _mlp_residual, v.heads, mode)
        x = x[:, 0]
    with phase(phase_timer.HEAD):
        x = _layer_norm(qvision["ln_post"], x)
        return (x @ _bf16(qvision["proj"])).float()


def encode_image_int8(qvision: Dict[str, Any], images: torch.Tensor, cfg: CLIPConfig, *,
                      attn_impl: str = "auto", gemm_impl: str = "static3d_qi",
                      cls_last=None) -> torch.Tensor:
    """Quantized image tower: ``[B, H, W, 3]`` normalized images ->
    ``[B, embed_dim]`` float32. The patch embedding stays bf16."""
    fake = {"vision": {"patch_w": qvision["patch_w"]}}
    return _tower_int8(qvision, lambda: embed_patches(fake, images, cfg, compute_dtype=BF16), cfg,
                       attn_impl=attn_impl, gemm_impl=gemm_impl, cls_last=cls_last)


def encode_image_int8_u8(qvision: Dict[str, Any], images_u8: torch.Tensor, cfg: CLIPConfig, *,
                         attn_impl: str = "auto", gemm_impl: str = "static3d_qi",
                         cls_last=None) -> torch.Tensor:
    """uint8 ``[B, S, S, 3]`` images at the model size: the patch reorder
    runs on the uint8 tensor, and /255 and the CLIP normalize are a
    per-column scale and bias before the bf16 patch GEMM."""
    v = cfg.vision
    if images_u8.dtype != torch.uint8 or tuple(images_u8.shape[1:3]) != (v.image_size,) * 2:
        raise ValueError(f"needs uint8 images of {v.image_size}x{v.image_size}, got "
                         f"{images_u8.dtype} {tuple(images_u8.shape)}")

    def patch_tokens():
        px_u8 = patch_pixels(images_u8, cfg, compute_dtype=torch.uint8)
        scale, bias = patch_norm_consts(v.patch_size, device=images_u8.device)
        return _bf16(px_u8.float() * scale + bias) @ _bf16(qvision["patch_w"])

    return _tower_int8(qvision, patch_tokens, cfg, attn_impl=attn_impl, gemm_impl=gemm_impl,
                       cls_last=cls_last)


def encode_image_int8_patches(qvision: Dict[str, Any], patches_u8: torch.Tensor, cfg: CLIPConfig,
                              *, attn_impl: str = "auto", gemm_impl: str = "static3d_qi",
                              patch_dot: Optional[str] = None, cls_last=None) -> torch.Tensor:
    """Patch-major uint8 ``[B, g*g, 3*ps*ps]`` -> ``[B, embed_dim]`` float32.

    ``patch_dot`` (default env ``TEAM_PATCH_DOT``, ``"int8"``): the u8-exact
    int8 patch GEMM of :func:`_quantize_patch_dot`; ``"bf16"`` (or a payload
    without ``patch_q``): the bf16 patch GEMM."""
    if patches_u8.dtype != torch.uint8:
        raise TypeError(f"patch-major input must be uint8, got {patches_u8.dtype}")
    if patch_dot is None:
        patch_dot = os.environ.get("TEAM_PATCH_DOT", "int8")
    if patch_dot not in ("int8", "bf16"):
        raise ValueError(f"patch_dot must be 'int8' or 'bf16', got {patch_dot!r}")

    def patch_tokens():
        if patch_dot == "int8" and "patch_q" in qvision:
            pq = qvision["patch_q"]
            acc = int8_matmul((patches_u8.int() - 128).to(torch.int8), pq["w_q"])
            return _bf16(acc.float() * pq["scale"].reshape(-1) + pq["const"].reshape(-1))
        scale, bias = patch_norm_consts(cfg.vision.patch_size, device=patches_u8.device)
        return _bf16(patches_u8.float() * scale + bias) @ _bf16(qvision["patch_w"])

    return _tower_int8(qvision, patch_tokens, cfg, attn_impl=attn_impl, gemm_impl=gemm_impl,
                       cls_last=cls_last)


# ---------------------------------------------------------------------------
# the int8 text tower
# ---------------------------------------------------------------------------

def quantize_text_tower(params: Params) -> Dict[str, Any]:
    """The dynamic tiers' payload of the text tower (``quant.py:916``): int8
    GEMM weights; embeddings, norms and the projection pass through."""
    t = params["text"]
    return {"token_embedding": t["token_embedding"], "pos": t["pos"],
            "blocks": [quantize_block(b) for b in t["blocks"]],
            "ln_final": t["ln_final"], "proj": t["proj"]}


def calibrate_text_tower(params: Params, tokens: torch.Tensor, cfg: CLIPConfig, *,
                         attn_impl: str = "auto"):
    """Per-block, per-channel activation abs-max of the bf16 text tower
    (causal) over ``[B, 77]`` token ids (``quant.py:930``)."""
    t = cfg.text
    p = params["text"]
    x = _bf16(p["token_embedding"][tokens.long()]) + _bf16(p["pos"])
    stats = []
    for blk in p["blocks"]:
        x, st = _block_calib_forward(blk, x, t.heads, t.context_length, attn_impl=attn_impl,
                                     causal=True)
        stats.append(st)
    return stats


def quantize_text_tower_static(params: Params, calib_stats, *, margin: float = 1.5,
                               heads: Optional[int] = None) -> Dict[str, Any]:
    """Static-W8A8 payload of the text tower (``quant.py:948``), the scheme of
    :func:`quantize_vision_tower_static`."""
    t = params["text"]
    return {"token_embedding": t["token_embedding"], "pos": t["pos"],
            "blocks": [quantize_block_static(b, st, margin=margin, heads=heads)
                       for b, st in zip(t["blocks"], calib_stats)],
            "ln_final": t["ln_final"], "proj": t["proj"]}


def quantize_text_tower_for_prompts(params: Params, tokens: torch.Tensor, cfg: CLIPConfig, *,
                                    margin: float = 1.0, attn_impl: str = "auto",
                                    heads: Optional[int] = None) -> Dict[str, Any]:
    """The static text payload calibrated on the finite prompt set it will
    encode (``quant.py:974``): ``tokens [N, 77]`` are those prompts, so
    ``margin=1.0`` clips nothing."""
    stats = calibrate_text_tower(params, tokens, cfg, attn_impl=attn_impl)
    return quantize_text_tower_static(params, stats, margin=margin, heads=heads)


def encode_text_int8(qtext: Dict[str, Any], tokens: torch.Tensor, cfg: CLIPConfig, *,
                     attn_impl: str = "auto", gemm_impl: str = "xla") -> torch.Tensor:
    """Quantized text tower (``quant.py:995``): ``[B, 77]`` int tokens ->
    ``[B, embed_dim]`` float32, causal, pooled at the end-of-text token (the
    largest id). ``gemm_impl`` is any route of one block function
    (``_BLOCKS``): the dynamic tiers on :func:`quantize_text_tower`'s payload,
    the static routes on :func:`quantize_text_tower_for_prompts`'s."""
    if gemm_impl not in _BLOCKS:
        raise ValueError(f"encode_text_int8 takes gemm_impl in {sorted(_BLOCKS)}, got "
                         f"{gemm_impl!r}")
    attn, mlp = _BLOCKS[gemm_impl]
    t = cfg.text
    tokens = tokens.long()
    x = _bf16(qtext["token_embedding"][tokens]) + _bf16(qtext["pos"])
    for qb in qtext["blocks"]:
        x = mlp(qb, attn(qb, x, t.heads, t.context_length, attn_impl=attn_impl, causal=True))
    x = _layer_norm(qtext["ln_final"], x)
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return (x @ _bf16(qtext["proj"])).float()


# ---------------------------------------------------------------------------
# persistence: a payload that passed its cosine gate, reused by later runs
# ---------------------------------------------------------------------------

def save_quantized_tower(path: str, qvision: Dict[str, Any], family: str = "static") -> None:
    """Save a payload into the directory ``path`` (created if needed), with
    the route family (:func:`route_family`) it passed its cosine gate on.
    Save only payloads that passed the gate: the loader trusts them on the
    same family."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, PAYLOAD_FILE + ".tmp")
    torch.save({"tower": tree_to(qvision, torch.device("cpu")), "route_family": family}, tmp)
    os.replace(tmp, os.path.join(path, PAYLOAD_FILE))


def load_quantized_tower(path: str, device: Optional[torch.device] = None
                         ) -> Tuple[Dict[str, Any], str]:
    """Load a payload saved by :func:`save_quantized_tower` onto ``device``:
    ``(payload, route family)``."""
    saved = torch.load(os.path.join(path, PAYLOAD_FILE), map_location=device, weights_only=True)
    return saved["tower"], saved["route_family"]
