"""CLIP ViT-B/16 image and text towers in PyTorch.

Counterpart of ``team_tpu/backbone/clip.py``. Parameters are the same nested
dict as the JAX pytree (:mod:`team_tpu_torch.bridge` carries it across), with
weights in ``[in, out]`` layout; every forward is a plain function of
``(params, inputs, cfg)``. The blocks' attention runs through the packed
Hopper kernel (:func:`team_tpu_torch.ops.mha_short.fused_mha_packed`) under
``attn_impl="auto"``, through the flash kernel
(:func:`team_tpu_torch.ops.flash_attention.flash_attention`) under
``"pallas"`` and through the pre-split kernel under ``"mha_short"`` (image
tower only). ``"mha_packed_proj"`` fuses the out-projection and residual
into the attention kernel, ``"attn_block"`` the whole attention sub-block
(:func:`~team_tpu_torch.ops.mha_short.fused_mha_packed_proj`,
:func:`~team_tpu_torch.ops.mha_short.fused_attn_block`); the other large
GEMMs are ``torch.matmul``. ``"mha_packed_tp"`` under a registered
tensor-parallel layout (:func:`~team_tpu_torch.ops.mha_short.set_tp_mesh`)
splits each block over the model ranks as XLA's partitioner splits
team_tpu's tower under ``shard_clip_params``' layout (column-parallel qkv
and fc, row-parallel out and proj, the head-split attention kernel
:func:`~team_tpu_torch.ops.mha_short.fused_mha_packed_tp`); with none it is
the packed route, as in team_tpu.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from team_tpu_torch.ops.attention import multi_head_attention
from team_tpu_torch.ops.mha_short import (
    fused_attn_block, fused_mha_packed, fused_mha_packed_proj, fused_mha_packed_tp, tp_mesh,
    tp_split)
from team_tpu_torch.parallel import collectives
from team_tpu_torch.ops.preprocess import patch_norm_consts


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 512

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    layers: int = 12
    heads: int = 8
    embed_dim: int = 512


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    embed_dim: int = 512

    @staticmethod
    def vit_b16() -> "CLIPConfig":
        return CLIPConfig()

    @staticmethod
    def tiny(embed_dim: int = 32) -> "CLIPConfig":
        """Small config for tests: 2-layer towers, 32-d embeddings."""
        return CLIPConfig(
            vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2, heads=2, embed_dim=embed_dim),
            text=TextConfig(context_length=77, vocab_size=49408, width=64, layers=2, heads=2, embed_dim=embed_dim),
            embed_dim=embed_dim,
        )


Params = Dict[str, Any]

# leaves the JAX forward casts to the compute dtype at every use; layer-norm
# affines and logit_scale stay float32 there, and so they do here
_CAST_LEAVES = frozenset({
    "qkv_w", "qkv_b", "out_w", "out_b", "fc_w", "fc_b", "proj_w", "proj_b",
    "patch_w", "cls", "pos", "proj", "token_embedding"})
# the block-level routes whose kernels take the attention biases in float32
# (``mha_short.py:1056``, ``:1145-1148``): their towers keep those two leaves
FUSED_ROUTES = ("attn_block", "mha_packed_proj")
_F32_ON_FUSED_ROUTES = frozenset({"qkv_b", "out_b"})


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std


def _ln(width: int) -> Params:
    return {"scale": torch.ones(width), "bias": torch.zeros(width)}


def _init_block(gen: torch.Generator, width: int) -> Params:
    proj_std = (width ** -0.5) * ((2 * 12) ** -0.5)
    attn_std = width ** -0.5
    fc_std = (2 * width) ** -0.5
    mlp_width = width * 4
    return {
        "ln_1": _ln(width),
        "attn": {
            "qkv_w": _normal(gen, (width, 3 * width), attn_std),
            "qkv_b": torch.zeros(3 * width),
            "out_w": _normal(gen, (width, width), proj_std),
            "out_b": torch.zeros(width),
        },
        "ln_2": _ln(width),
        "mlp": {
            "fc_w": _normal(gen, (width, mlp_width), fc_std),
            "fc_b": torch.zeros(mlp_width),
            "proj_w": _normal(gen, (mlp_width, width), proj_std),
            "proj_b": torch.zeros(width),
        },
    }


def init_clip_params(gen: torch.Generator, cfg: CLIPConfig) -> Params:
    """Random float32 parameters on the CPU, with the distributions of the JAX
    init (``team_tpu/backbone/clip.py:init_clip_params``); the bits differ,
    since torch and JAX draw differently."""
    v, t = cfg.vision, cfg.text
    patch_dim = 3 * v.patch_size * v.patch_size
    vision = {
        "patch_w": _normal(gen, (patch_dim, v.width), v.width ** -0.5),
        "cls": _normal(gen, (v.width,), v.width ** -0.5),
        "pos": _normal(gen, (v.seq_len, v.width), v.width ** -0.5),
        "ln_pre": _ln(v.width),
        "blocks": [_init_block(gen, v.width) for _ in range(v.layers)],
        "ln_post": _ln(v.width),
        "proj": _normal(gen, (v.width, cfg.embed_dim), v.width ** -0.5),
    }
    text = {
        "token_embedding": _normal(gen, (t.vocab_size, t.width), 0.02),
        "pos": _normal(gen, (t.context_length, t.width), 0.01),
        "blocks": [_init_block(gen, t.width) for _ in range(t.layers)],
        "ln_final": _ln(t.width),
        "proj": _normal(gen, (t.width, cfg.embed_dim), t.width ** -0.5),
    }
    return {"vision": vision, "text": text,
            "logit_scale": torch.tensor(math.log(1.0 / 0.07), dtype=torch.float32)}


def cast_frozen_params(params: Params, compute_dtype: torch.dtype, device: torch.device,
                       attn_impl: str = "auto") -> Params:
    """Move the tree to ``device`` and cast, once, the leaves the forward
    casts at every use. The towers are frozen, so this gives the values of
    the JAX forward's per-use ``.astype``. On the fused routes
    (``FUSED_ROUTES``) ``qkv_b`` and ``out_b`` stay as they are: the kernels
    add them in float32, and the plain GEMMs cast them at each use."""
    cast = _CAST_LEAVES - _F32_ON_FUSED_ROUTES if attn_impl in FUSED_ROUTES else _CAST_LEAVES

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, key) for v in tree]
        dtype = compute_dtype if key in cast else tree.dtype
        return tree.to(device=device, dtype=dtype)

    return walk(params)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_norm(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Layer norm in float32 (population variance, eps 1e-5), back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + 1e-5)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype) + b.to(x.dtype)


def attention_core(qkv: torch.Tensor, heads: int, *, causal: bool, kv_len,
                   impl: str) -> torch.Tensor:
    """Attention over the packed qkv projection ``[B, S, 3D]`` -> ``[B, S, D]``:
    ``auto`` (S < 512) and ``mha_packed`` take the packed kernel, the rest go
    through :func:`multi_head_attention` (``pallas``: the flash kernel, which
    takes the head-split views without copying them; ``mha_short``: the
    pre-split kernel; the block-level ``attn_block`` and ``mha_packed_proj``,
    which the int8 tier passes here as team_tpu's ``_attn_core`` does: the
    plain route). ``mha_packed_tp`` runs the head-split kernel under a
    registered tensor-parallel layout and gathers the ranks' heads over the
    model group (the global array team_tpu's ``shard_map`` returns), else the
    packed kernel."""
    b, s, d3 = qkv.shape
    d = d3 // 3
    dh = d // heads
    if impl == "mha_packed_tp":
        return gather_heads(fused_mha_packed_tp(qkv, heads, causal=causal, kv_len=kv_len), d)
    if impl == "auto" and s < 512:
        impl = "mha_packed"
    if impl == "mha_packed":
        return fused_mha_packed(qkv, heads, causal=causal,
                                kv_len=kv_len if (kv_len is not None and kv_len < s) else None)
    q, k, v = qkv.split(d, dim=-1)

    def split_heads(t):
        return t.reshape(b, s, heads, dh).permute(0, 2, 1, 3)

    o = multi_head_attention(split_heads(q), split_heads(k), split_heads(v),
                             kv_len, causal=causal, impl=impl)
    return o.permute(0, 2, 1, 3).reshape(b, s, d)


def gather_heads(o: torch.Tensor, d: int) -> torch.Tensor:
    """A head-split kernel's ``[..., D/nm]`` output gathered over the
    registered layout's model group into ``[..., D]``; a whole output as it is."""
    if o.shape[-1] == d:
        return o
    return collectives.all_gather(o, tp_mesh().model_group, dim=-1)


def _rank_block(t: torch.Tensor, dim: int, full: int, rank: int, nm: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (``full`` long when whole):
    a block of ``shard_clip_params`` is taken as it is, a whole tensor sliced."""
    size = full // nm
    return t if t.shape[dim] == size else t.narrow(dim, rank * size, size)


def _tp_block_forward(p: Params, x: torch.Tensor, heads: int, *, causal: bool, kv_len,
                      rank: int, nm: int) -> torch.Tensor:
    """One block split over the model ranks, computing what XLA's partitioner
    computes from ``shard_clip_params``' layout: the qkv GEMM on this rank's
    block of columns, an ``all_gather`` into the full packed qkv that
    :func:`fused_mha_packed_tp` takes, the rank's heads, the out-projection
    on the matching rows of ``out_w`` summed over the ranks, then the bias
    once (``x + o @ out_w + out_b`` in team_tpu's order); the MLP likewise
    (fc columns, GELU, proj rows, sum, bias)."""
    group = tp_mesh().model_group
    a, m = p["attn"], p["mlp"]
    d = x.shape[-1]

    def row_parallel(x, h, w, b):
        w = _rank_block(w, 0, h.shape[-1] * nm, rank, nm).to(x.dtype)
        return x + collectives.all_reduce(h @ w, "sum", group) + b.to(x.dtype)

    h = _layer_norm(p["ln_1"], x)
    qkv = _linear(h, _rank_block(a["qkv_w"], 1, 3 * d, rank, nm),
                  _rank_block(a["qkv_b"], 0, 3 * d, rank, nm))
    o = fused_mha_packed_tp(collectives.all_gather(qkv, group, dim=-1), heads, causal=causal,
                            kv_len=kv_len)
    x = row_parallel(x, o, a["out_w"], a["out_b"])
    f = m["fc_b"].shape[-1]
    h = _linear(_layer_norm(p["ln_2"], x), _rank_block(m["fc_w"], 1, f, rank, nm),
                _rank_block(m["fc_b"], 0, f, rank, nm))
    return row_parallel(x, F.gelu(h, approximate="none"), m["proj_w"], m["proj_b"])


def _residual(x: torch.Tensor, h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x + h @ w + b`` in team_tpu's order: the product joins the residual
    before the bias (two roundings in bf16)."""
    return x + h @ w.to(x.dtype) + b.to(x.dtype)


def _block_forward(p: Params, x: torch.Tensor, heads: int, *, causal: bool, kv_len,
                   impl: str) -> torch.Tensor:
    """One transformer block (``team_tpu/backbone/clip.py:_block_forward``).
    ``attn_block`` runs the attention sub-block in :func:`fused_attn_block`,
    ``mha_packed_proj`` the attention, out-projection and residual in
    :func:`fused_mha_packed_proj` after a ``torch.matmul`` qkv GEMM; the MLP
    half is ``torch.matmul`` on every route, as team_tpu leaves it to XLA.
    ``mha_packed_tp`` under a registered layout whose model axis splits the
    heads: :func:`_tp_block_forward`."""
    a = p["attn"]
    if impl == "mha_packed_tp":
        shard = tp_split(heads, x.shape[-1])
        if shard is not None:
            return _tp_block_forward(p, x, heads, causal=causal, kv_len=kv_len, rank=shard[0],
                                     nm=shard[1])
    if impl == "attn_block":
        x = fused_attn_block(x, p["ln_1"]["scale"], p["ln_1"]["bias"], a["qkv_w"], a["qkv_b"],
                             a["out_w"], a["out_b"], heads, causal=causal)
    else:
        qkv = _linear(_layer_norm(p["ln_1"], x), a["qkv_w"], a["qkv_b"])
        if impl == "mha_packed_proj":
            x = fused_mha_packed_proj(qkv, a["out_w"], a["out_b"], x, heads, causal=causal)
        else:
            o = attention_core(qkv, heads, causal=causal, kv_len=kv_len, impl=impl)
            x = _residual(x, o, a["out_w"], a["out_b"])
    h = _layer_norm(p["ln_2"], x)
    h = F.gelu(_linear(h, p["mlp"]["fc_w"], p["mlp"]["fc_b"]), approximate="none")
    return _residual(x, h, p["mlp"]["proj_w"], p["mlp"]["proj_b"])


def patch_pixels(images: torch.Tensor, cfg: CLIPConfig, *,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """``[B, H, W, 3]`` -> the patch-pixel matrix ``[B, g*g, 3*ps*ps]``
    (channel-major inside a patch, the torch conv weight order)."""
    v = cfg.vision
    b = images.shape[0]
    g, ps = v.grid, v.patch_size
    x = images.to(compute_dtype).reshape(b, g, ps, g, ps, 3)
    x = x.permute(0, 1, 3, 5, 2, 4)  # B, gh, gw, C, ph, pw
    return x.reshape(b, g * g, 3 * ps * ps)


def embed_patches(params: Params, images: torch.Tensor, cfg: CLIPConfig, *,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """Patch embedding: ``[B, H, W, 3]`` -> ``[B, g*g, width]`` (one GEMM)."""
    x = patch_pixels(images, cfg, compute_dtype=compute_dtype)
    return x @ params["vision"]["patch_w"].to(compute_dtype)


def encode_from_patches(params: Params, patch_tokens: torch.Tensor, cfg: CLIPConfig, *,
                        compute_dtype=torch.float32, attn_impl: str = "auto") -> torch.Tensor:
    """Transformer stage over patch tokens -> ``[B, embed_dim]`` float32."""
    v = cfg.vision
    p = params["vision"]
    b = patch_tokens.shape[0]
    cls = p["cls"].to(compute_dtype).expand(b, 1, v.width)
    x = torch.cat([cls, patch_tokens.to(compute_dtype)], dim=1)
    x = x + p["pos"].to(compute_dtype)
    x = _layer_norm(p["ln_pre"], x)
    for blk in p["blocks"]:
        x = _block_forward(blk, x, v.heads, causal=False, kv_len=v.seq_len, impl=attn_impl)
    x = _layer_norm(p["ln_post"], x[:, 0])
    return (x @ p["proj"].to(compute_dtype)).float()


def encode_image(params: Params, images: torch.Tensor, cfg: CLIPConfig, *,
                 compute_dtype=torch.float32, attn_impl: str = "auto") -> torch.Tensor:
    """Image tower: ``[B, H, W, 3]`` float (normalized) -> ``[B, embed_dim]``."""
    tokens = embed_patches(params, images, cfg, compute_dtype=compute_dtype)
    return encode_from_patches(params, tokens, cfg, compute_dtype=compute_dtype,
                               attn_impl=attn_impl)


def encode_image_patches_u8(params: Params, patches_u8: torch.Tensor, cfg: CLIPConfig, *,
                            compute_dtype=torch.float32, attn_impl: str = "auto") -> torch.Tensor:
    """Image tower over patch-major uint8 input ``[B, g*g, 3*ps*ps]`` (the
    order of :func:`patch_pixels`); /255 and the CLIP normalize are a
    per-column scale and bias before the patch GEMM."""
    if patches_u8.dtype != torch.uint8:
        raise TypeError(f"patch-major input must be uint8, got {patches_u8.dtype}")
    scale, bias = patch_norm_consts(cfg.vision.patch_size, device=patches_u8.device)
    px = (patches_u8.float() * scale + bias).to(compute_dtype)
    tokens = px @ params["vision"]["patch_w"].to(compute_dtype)
    return encode_from_patches(params, tokens, cfg, compute_dtype=compute_dtype,
                               attn_impl=attn_impl)


def encode_text(params: Params, tokens: torch.Tensor, cfg: CLIPConfig, *,
                compute_dtype=torch.float32, attn_impl: str = "auto") -> torch.Tensor:
    """Text tower: ``[B, 77]`` int tokens -> ``[B, embed_dim]`` float32,
    pooled at the end-of-text token (the largest id)."""
    t = cfg.text
    p = params["text"]
    tokens = tokens.long()
    x = p["token_embedding"][tokens].to(compute_dtype)
    x = x + p["pos"].to(compute_dtype)
    for blk in p["blocks"]:
        x = _block_forward(blk, x, t.heads, causal=True, kv_len=t.context_length, impl=attn_impl)
    x = _layer_norm(p["ln_final"], x)
    eot = tokens.argmax(dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    return (x @ p["proj"].to(compute_dtype)).float()
