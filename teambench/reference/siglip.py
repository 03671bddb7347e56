"""Plain PyTorch reference of SigLIP So400m/14-384's image tower over
patch-major uint8 input.

From the published description (``google/siglip-so400m-patch14-384``'s
``vision_config`` and ``SiglipVisionTransformer``): a stride-14 patch
convolution with a bias over 384-px images (27 × 27 patches; the last 6
pixel rows and columns fall outside every patch), 729 learned positions, no
class token and no pre-LN; 27 pre-norm blocks ``x += attn(LN1 x)``,
``x += MLP(LN2 x)`` with 16 heads of 72 (q·k scaled by 72^-0.5), MLP 4304
and the tanh GELU, layer norms at eps 1e-6; ``post_layernorm``; then the
multi-head attention-pooling head: a learned probe ``[1, 1152]`` attends
over the 729 tokens (16 heads, q from the probe, k and v from the tokens,
in- and out-projections with biases), then ``h + MLP(LN(h))``. The feature
is that one row, 1152 wide, with no projection. Pixels are
``(x/255 − 0.5)/0.5``.

Departures from the published model: the weights are random (the
benchmark's, drawn from the seed), and the benchmark's images are colour
fields drawn at 384 px, not photographs resized by the published processor.
The tree is the benchmark's (``teambench/drivers/encode_siglip.py``):
weights ``[in, out]``, q, k and v as one ``qkv_w``, the head's k and v as
one ``kv_w``.

Three precisions, ``kind``:

- ``f32``: float32 throughout, products with TF32 off;
- ``bf16``: the configuration's: bf16 weights and activations, float32
  products, sums, layer norms and softmax, p rounded to bf16 before PV, the
  same rounding points as ``reference/clip.py``'s ``bf16``;
- ``fp8``: ``bf16`` with every GEMM's operands, the attention's products'
  too, rounded to float8 e4m3 with one scale a tensor (amax/448): a
  precision below the one the configuration states, the output check's
  control.

Rows are independent, so each block of images is computed alone.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from teambench.reference.clip import full_f32

BF16 = torch.bfloat16
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
KINDS = ("f32", "bf16", "fp8")


def normalize(u8: torch.Tensor, mean, std) -> torch.Tensor:
    """Patch-major uint8 -> (x/255 − mean)/std per channel, float32 (the
    columns are channel-major inside a patch)."""
    n = u8.shape[-1] // 3
    m = torch.tensor(mean, device=u8.device).repeat_interleave(n)
    s = torch.tensor(std, device=u8.device).repeat_interleave(n)
    return (u8.float() / 255.0 - m) / s


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale (amax/448), back in float32."""
    t = t.float()
    amax = float(t.abs().amax())
    scale = amax / FP8_MAX if amax > 0 else 1.0
    return (t / scale).to(FP8).float() * scale


class Precision:
    """The rounding of activations (``act``) and the operands of a product
    (``operand``) in one of ``KINDS``; every product accumulates in float32."""

    def __init__(self, kind: str):
        if kind not in KINDS:
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def act(self, t: torch.Tensor) -> torch.Tensor:
        return t.float() if self.kind == "f32" else t.to(BF16)

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        t = self.act(t)
        return _fp8(t) if self.kind == "fp8" else t.float()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` of the rounded operands, rounded as an activation."""
        return self.act(torch.matmul(self.operand(a), self.operand(b)))

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.mm(x, w) + self.act(b)


def _ln(pr: Precision, x: torch.Tensor, p: Dict, eps: float) -> torch.Tensor:
    return pr.act(F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(), p["bias"].float(),
                               eps))


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, d = t.shape
    return t.reshape(b, s, heads, d // heads).transpose(1, 2)


def _attention(pr: Precision, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               heads: int) -> torch.Tensor:
    """Softmax attention of q ``[B, Sq, D]`` over k, v ``[B, S, D]``: f32
    logits times dh^-0.5, an f32 softmax, p rounded as an activation, f32 PV."""
    d = q.shape[-1]
    qh, kh, vh = (_heads(t, heads) for t in (q, k, v))
    logits = torch.matmul(pr.operand(qh), pr.operand(kh).transpose(-1, -2)) * (d // heads) ** -0.5
    p = pr.act(torch.softmax(logits, dim=-1))
    o = torch.matmul(pr.operand(p), pr.operand(vh))
    b, h, s, dh = o.shape
    return pr.act(o.transpose(1, 2).reshape(b, s, h * dh))


def _mlp_residual(pr: Precision, x: torch.Tensor, ln: Dict, m: Dict, eps: float) -> torch.Tensor:
    h = _ln(pr, x, ln, eps)
    g = F.gelu(pr.linear(h, m["fc_w"], m["fc_b"]), approximate="tanh")
    return x + pr.mm(g, m["proj_w"]) + pr.act(m["proj_b"])


def _block(pr: Precision, blk: Dict, x: torch.Tensor, heads: int, eps: float) -> torch.Tensor:
    a = blk["attn"]
    d = x.shape[-1]
    qkv = pr.linear(_ln(pr, x, blk["ln_1"], eps), a["qkv_w"], a["qkv_b"])
    o = _attention(pr, *qkv.split(d, dim=-1), heads)
    x = x + pr.mm(o, a["out_w"]) + pr.act(a["out_b"])
    return _mlp_residual(pr, x, blk["ln_2"], blk["mlp"], eps)


def _head(pr: Precision, hd: Dict, x: torch.Tensor, heads: int, eps: float) -> torch.Tensor:
    """The attention-pooling head over ``[B, S, D]`` -> ``[B, D]``."""
    a = hd["attn"]
    b, _, d = x.shape
    q = pr.linear(pr.act(hd["probe"])[None, None], a["q_w"], a["q_b"]).expand(b, 1, d)
    k, v = pr.linear(x, a["kv_w"], a["kv_b"]).split(d, dim=-1)
    o = pr.linear(_attention(pr, q, k, v, heads), a["out_w"], a["out_b"])
    return _mlp_residual(pr, o, hd["ln"], hd["mlp"], eps)[:, 0]


def tower(vis: Dict, u8: torch.Tensor, v: Dict, pixels: Dict, kind: str) -> torch.Tensor:
    """Features ``[B, hidden_size]`` float32 of patch-major uint8 ``u8``
    ``[B, 729, 588]``; ``v``: the configuration's ``vision_config``."""
    pr = Precision(kind)
    heads, eps = v["num_attention_heads"], v["layer_norm_eps"]
    px = normalize(u8, pixels["mean"], pixels["std"])
    x = pr.linear(px, vis["patch_w"], vis["patch_b"]) + pr.act(vis["pos"])
    for blk in vis["blocks"]:
        x = _block(pr, blk, x, heads, eps)
    x = _ln(pr, x, vis["ln_post"], eps)
    return _head(pr, vis["head"], x, heads, eps).float()


def features(cfg: Dict, params: Dict, batches: List[torch.Tensor], *, kind: str = None,
             chunk: int = 16) -> List[torch.Tensor]:
    """The reference's features of each uint8 batch in ``kind`` (default:
    the configuration's ``reference.kind``), ``chunk`` images at a time."""
    kind = kind or cfg["reference"]["kind"]
    vis, v, pixels = params["vision"], cfg["vision_config"], cfg["pixels"]
    encode: Callable[[torch.Tensor], torch.Tensor] = lambda u8: tower(vis, u8, v, pixels, kind)
    with torch.no_grad(), full_f32():
        return [torch.cat([encode(part) for part in b.split(chunk)]) for b in batches]
