"""Plain PyTorch reference of open_clip's ViT-B-16 image tower over
patch-major uint8 input, in the two precisions the configurations state.

- ``bf16``: the tower with bf16 weights and activations, float32 products,
  sums, layer norms and softmax, the exact (erf) GELU; open_clip's forward
  (pre-norm blocks, class token, pooled at the class token, projected).
- ``int8_static``: the static W8A8 scheme the configuration describes. A
  calibration forward of the bf16 tower over one batch records each
  GEMM input's per-channel abs-max, the qkv output's, and each head's largest
  logit. With ``margin`` m an input channel's scale is m·amax/qmax and is
  folded into the weight's rows; the weight is then quantized per output
  column (amax/qmax). q and k take one scale per head (the head's largest
  channel scale), v one per channel. A GEMM is an exact integer product, then
  the scales and the bias in float32. Layer norms run in float32 and quantize
  straight to int8; the attention's logits are exact integer sums times the
  q·k scale, p = 2^(logit·log2e − m2) with m2 the calibrated largest logit
  plus ``softmax_headroom_nats`` (in log2 units), p in bf16, the output
  Σp·v / Σp requantized for the out-projection; the GELU is tanh's; the
  residual stream stays bf16. The patch embedding takes the uint8 pixels
  centred on 128 against the normalisation folded into its weight, so its
  input is exact in int8. With ``qmax`` 7 the same scheme runs in int4.

Integer products run in float64, which holds them exactly; float32 products
run with TF32 off. Rows are independent, so each block of images is
computed alone.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16
LOG2E = math.log2(math.e)
LN_EPS = 1e-5
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@contextlib.contextmanager
def full_f32():
    """float32 matmuls in full float32 (no TF32) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def normalize(u8: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Patch-major uint8 -> (x/255 − mean)/std per channel, float32 (the
    columns are channel-major inside a patch)."""
    n = patch_size * patch_size
    mean = torch.tensor(CLIP_MEAN, device=u8.device).repeat_interleave(n)
    std = torch.tensor(CLIP_STD, device=u8.device).repeat_interleave(n)
    return (u8.float() / 255.0 - mean) / std


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF16)


def _ln32(x: torch.Tensor, p: Dict) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(), p["bias"].float(), LN_EPS)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, d = t.shape
    return t.reshape(b, s, heads, d // heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = t.shape
    return t.transpose(1, 2).reshape(b, s, h * dh)


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

def _block_bf16(blk: Dict, x: torch.Tensor, heads: int, stats: Optional[Dict]) -> torch.Tensor:
    a, m = blk["attn"], blk["mlp"]
    d = x.shape[-1]
    h = _bf(_ln32(x, blk["ln_1"]))
    qkv = _bf(_mm(h, _bf(a["qkv_w"]))) + _bf(a["qkv_b"])
    q, k, v = (_heads(t.float(), heads) for t in qkv.split(d, dim=-1))
    logits = torch.matmul(q, k.transpose(-1, -2)) * (d // heads) ** -0.5
    p = _bf(torch.softmax(logits, dim=-1))
    o = _bf(_merge(torch.matmul(p.float(), v)))
    x = x + _bf(_mm(o, _bf(a["out_w"]))) + _bf(a["out_b"])
    h2 = _bf(_ln32(x, blk["ln_2"]))
    g = F.gelu(_bf(_mm(h2, _bf(m["fc_w"]))) + _bf(m["fc_b"]))
    if stats is not None:
        for key, t in (("ln1", h), ("qkv_out", qkv), ("attn_o", o), ("ln2", h2), ("gelu", g)):
            amax = t.float().abs().amax(dim=(0, 1))
            stats[key] = amax if key not in stats else torch.maximum(stats[key], amax)
        lmax = logits.amax(dim=(0, 2, 3))
        stats["qk_lmax"] = lmax if "qk_lmax" not in stats else torch.maximum(stats["qk_lmax"], lmax)
    return x + _bf(_mm(g, _bf(m["proj_w"]))) + _bf(m["proj_b"])


def _embed(vis: Dict, u8: torch.Tensor, patch_size: int) -> torch.Tensor:
    tokens = _bf(_mm(_bf(normalize(u8, patch_size)), _bf(vis["patch_w"])))
    cls = _bf(vis["cls"]).expand(u8.shape[0], 1, tokens.shape[-1])
    return _bf(_ln32(torch.cat([cls, tokens], dim=1) + _bf(vis["pos"]), vis["ln_pre"]))


def _pool(vis: Dict, x: torch.Tensor) -> torch.Tensor:
    return _bf(_mm(_bf(_ln32(x[:, 0], vis["ln_post"])), _bf(vis["proj"]))).float()


def tower_bf16(vis: Dict, u8: torch.Tensor, heads: int, patch_size: int,
               stats: Optional[List[Dict]] = None) -> torch.Tensor:
    """Features ``[B, embed]`` float32; ``stats``, a list of one dict a
    block, gathers the calibration abs-maxes (max over calls)."""
    x = _embed(vis, u8, patch_size)
    for i, blk in enumerate(vis["blocks"]):
        x = _block_bf16(blk, x, heads, None if stats is None else stats[i])
    return _pool(vis, x)


# ---------------------------------------------------------------------------
# int8 static (int4 with qmax 7)
# ---------------------------------------------------------------------------

def _scale(amax: torch.Tensor, qmax: int) -> torch.Tensor:
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax))


def _quant(x: torch.Tensor, inv: torch.Tensor, qmax: int) -> torch.Tensor:
    """Round half to even and clip to ±qmax; integers held as float32."""
    return torch.clamp(torch.round(x.float() * inv), -qmax, qmax)


def _quant_cols(w: torch.Tensor, qmax: int):
    s = _scale(w.abs().amax(dim=0), qmax)
    return torch.clamp(torch.round(w / s), -qmax, qmax), s


def _imm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact integer product of integer-valued operands, as float32."""
    return torch.matmul(xq.double(), wq.double()).float()


def _site(w: torch.Tensor, b: torch.Tensor, amax: torch.Tensor, margin: float, qmax: int) -> Dict:
    s_in = _scale(amax.float() * margin, qmax)
    wq, ws = _quant_cols(w.float() * s_in[:, None], qmax)
    return {"wq": wq, "ws": ws, "b": b.float(), "inv": 1.0 / s_in}


def _linear(xq: torch.Tensor, site: Dict) -> torch.Tensor:
    return _imm(xq, site["wq"]) * site["ws"] + site["b"]


def payload(vis: Dict, stats: List[Dict], heads: int, patch_size: int, scheme: Dict,
            qmax: int) -> Dict:
    """The quantized tower from float32 weights and the calibration stats."""
    margin = scheme["margin"]
    blocks = []
    for blk, st in zip(vis["blocks"], stats):
        a, m = blk["attn"], blk["mlp"]
        qkv = _site(a["qkv_w"], a["qkv_b"], st["ln1"], margin, qmax)
        d = a["out_w"].shape[0]
        dh = d // heads
        amax = st["qkv_out"].float() * margin
        per_head = [amax[i * d:(i + 1) * d].reshape(heads, dh).amax(dim=1).repeat_interleave(dh)
                    for i in range(2)]
        s_out = _scale(torch.cat(per_head + [amax[2 * d:]]), qmax)
        sq, sk = s_out[:d:dh], s_out[d:2 * d:dh]
        qkv.update(out_inv=1.0 / s_out, deq_v=s_out[2 * d:], qk_scale=sq * sk * dh ** -0.5,
                   m2=(st["qk_lmax"].float() + scheme["softmax_headroom_nats"]) * LOG2E)
        blocks.append({"ln_1": blk["ln_1"], "ln_2": blk["ln_2"], "qkv": qkv,
                       "out": _site(a["out_w"], a["out_b"], st["attn_o"], margin, qmax),
                       "fc": _site(m["fc_w"], m["fc_b"], st["ln2"], margin, qmax),
                       "proj": _site(m["proj_w"], m["proj_b"], st["gelu"], margin, qmax)})
    folded = vis["patch_w"].float() / (255.0 * torch.tensor(CLIP_STD, device=vis["patch_w"].device)
                                       .repeat_interleave(patch_size * patch_size))[:, None]
    pwq, pws = _quant_cols(folded, qmax)
    # u8·s + b == (u8 − 128)·s + (128·s + b): the centred pixels are exact in int8
    const = 128.0 * folded.sum(dim=0) + normalize(
        torch.zeros(1, 1, folded.shape[0], dtype=torch.uint8, device=folded.device),
        patch_size).reshape(-1) @ vis["patch_w"].float()
    return {"blocks": blocks, "patch": {"wq": pwq, "ws": pws, "const": const},
            "pixel_step": 128.0 / (qmax + 1)}


def _attention_int8(qkv8: torch.Tensor, site: Dict, o_inv: torch.Tensor, heads: int,
                    qmax: int) -> torch.Tensor:
    d = qkv8.shape[-1] // 3
    q, k, v = (_heads(t, heads) for t in qkv8.split(d, dim=-1))
    acc = torch.matmul(q.double(), k.double().transpose(-1, -2)).float()
    p = torch.exp2(acc * (site["qk_scale"] * LOG2E).reshape(1, heads, 1, 1)
                   - site["m2"].reshape(1, heads, 1, 1))
    pb = p.to(BF16).float()
    num = torch.matmul(pb, v)
    out = _merge(num / pb.sum(dim=-1, keepdim=True)) * (site["deq_v"] * o_inv)
    return torch.clamp(torch.round(out), -qmax, qmax)


def _block_int8(qb: Dict, x: torch.Tensor, heads: int, qmax: int) -> torch.Tensor:
    site = qb["qkv"]
    qkv = _linear(_quant(_ln32(x, qb["ln_1"]), site["inv"], qmax), site)
    o8 = _attention_int8(_quant(qkv, site["out_inv"], qmax), site, qb["out"]["inv"], heads, qmax)
    x = x + _bf(_linear(o8, qb["out"]))
    h8 = _quant(_ln32(x, qb["ln_2"]), qb["fc"]["inv"], qmax)
    g8 = _quant(F.gelu(_linear(h8, qb["fc"]), approximate="tanh"), qb["proj"]["inv"], qmax)
    return x + _bf(_linear(g8, qb["proj"]))


def tower_int8(vis: Dict, qv: Dict, u8: torch.Tensor, heads: int, qmax: int) -> torch.Tensor:
    """Features ``[B, embed]`` float32 through the quantized tower ``qv``."""
    pq, step = qv["patch"], qv["pixel_step"]
    px = torch.clamp(torch.round((u8.float() - 128.0) / step), -(qmax + 1), qmax)
    tokens = _bf(_imm(px, pq["wq"]) * (pq["ws"] * step) + pq["const"])
    cls = _bf(vis["cls"]).expand(u8.shape[0], 1, tokens.shape[-1])
    x = _bf(_ln32(torch.cat([cls, tokens], dim=1) + _bf(vis["pos"]), vis["ln_pre"]))
    for qb in qv["blocks"]:
        x = _block_int8(qb, x, heads, qmax)
    return _pool(vis, x)


# ---------------------------------------------------------------------------
# the entry
# ---------------------------------------------------------------------------

def features(cfg: Dict, params: Dict, batches: List[torch.Tensor],
             calibration: Optional[torch.Tensor] = None, *, qmax: Optional[int] = None,
             chunk: int = 32) -> List[torch.Tensor]:
    """The reference's features of each uint8 batch, in the precision of
    ``cfg["reference"]["kind"]`` (``bf16`` or ``int8_static``, which calibrates
    on ``calibration``); ``qmax`` overrides the int8 scheme's (7: int4)."""
    v = cfg["vision_cfg"]
    heads, ps = v["width"] // v.get("head_width", 64), v["patch_size"]
    vis = params["vision"]
    kind = cfg["reference"]["kind"]
    with torch.no_grad(), full_f32():
        if kind == "bf16":
            def encode(u8):
                return tower_bf16(vis, u8, heads, ps)
        elif kind == "int8_static":
            stats = [{} for _ in vis["blocks"]]
            for part in calibration.split(chunk):
                tower_bf16(vis, part, heads, ps, stats)
            q = qmax or cfg["reference"]["qmax"]
            qv = payload(vis, stats, heads, ps, cfg["reference"], q)

            def encode(u8):
                return tower_int8(vis, qv, u8, heads, q)
        else:
            raise ValueError(f"unknown reference kind {kind!r}")
        return [torch.cat([encode(part) for part in b.split(chunk)]) for b in batches]
