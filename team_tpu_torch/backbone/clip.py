"""CLIP ViT-B/16 image and text towers in PyTorch, and SigLIP So400m/14's
image tower.

Counterpart of ``team_tpu/backbone/clip.py``. The image tower's kind is
configuration (:class:`VisionConfig`): its ``pool``, a head that pools the
class token and projects it (``cls_proj``, open_clip's, with a class token
and ``ln_pre``) or attends a learned probe over every token (``map``,
SigLIP's attention-pool head, :func:`_attention_pool`, with neither and a
patch bias); the exact or the tanh GELU, the layer norms' eps, the MLP
width, and the pixels' mean and std. ``CLIPConfig.siglip_so400m14_384()`` is SigLIP So400m/14 at 384 px
(``google/siglip-so400m-patch14-384``'s ``vision_config``): 27 blocks 1152
wide, 16 heads of 72, MLP 4304, 729 tokens from a stride-14 patch GEMM that
drops the last 6 pixel rows and columns; it has no text tower here (its
32,000-piece SentencePiece vocabulary is not in the repository).

Parameters are the same nested dict as the JAX pytree (:mod:`team_tpu_torch.bridge` carries it across), with
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

A bf16 block on a CUDA tensor that needs no gradient runs its layer norms,
biases, GELU and residual adds through the kernels of
:mod:`team_tpu_torch.ops.tower_bf16` (:func:`_tower_kernels` says where),
each residual carrying the next layer norm (:func:`_residual_ln`);
everywhere else, and for ``clip._layer_norm`` itself, the plain composition
runs as before.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from team_tpu_torch.ops import tower_bf16
from team_tpu_torch.ops._grad import wants_grad
from team_tpu_torch.ops.attention import multi_head_attention
from team_tpu_torch.ops.flash_attention import flash_attention, xla_attention
from team_tpu_torch.ops.mha_short import (
    PACKED_HEAD_DIMS, fused_attn_block, fused_mha_packed, fused_mha_packed_proj,
    fused_mha_packed_tp, tp_mesh, tp_split)
from team_tpu_torch.parallel import collectives
from team_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD, patch_norm_consts
from team_tpu_torch.utils import phase_timer
from team_tpu_torch.utils.phase_timer import phase


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """The image tower. The defaults are open_clip's ViT-B/16. ``pool`` is
    the tower's kind: ``cls_proj`` (open_clip's) has a class token, ``ln_pre``
    and a patch GEMM without bias, and pools the class token through
    ``ln_post`` and ``proj``; ``map`` (SigLIP's) has none of those but a
    patch bias, and runs ``ln_post`` over every token and the attention-pool
    head (no projection: ``embed_dim`` is ``width``). ``gelu`` is
    ``F.gelu``'s ``approximate`` (``none``: the exact erf GELU); ``mlp_width``
    0 means 4 × ``width``. A stride-``patch_size`` patch GEMM over an
    ``image_size`` that the patch does not divide drops the trailing pixel
    rows and columns, as the convolution does."""
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 512
    gelu: str = "none"
    ln_eps: float = 1e-5
    mlp_width: int = 0
    pool: str = "cls_proj"
    pixel_mean: Tuple[float, float, float] = CLIP_MEAN
    pixel_std: Tuple[float, float, float] = CLIP_STD

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def class_token(self) -> bool:
        return self.pool == "cls_proj"

    @property
    def ln_pre(self) -> bool:
        return self.pool == "cls_proj"

    @property
    def patch_bias(self) -> bool:
        return self.pool == "map"

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + int(self.class_token)

    @property
    def mlp(self) -> int:
        return self.mlp_width or 4 * self.width

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


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
    """The towers; ``text_tower`` False: ``text`` states the published text
    tower's sizes, which is neither built nor run."""
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    embed_dim: int = 512
    text_tower: bool = True

    @staticmethod
    def vit_b16() -> "CLIPConfig":
        return CLIPConfig()

    @staticmethod
    def siglip_so400m14_384() -> "CLIPConfig":
        """SigLIP So400m/14 at 384 px, the ``vision_config`` of
        ``google/siglip-so400m-patch14-384``: width 1152, 27 layers, 16 heads,
        MLP 4304, ``gelu_pytorch_tanh``, LN eps 1e-6, (384 // 14)² = 729
        tokens, no class token and no pre-LN, the attention-pool head, pixels
        ``(x/255 − 0.5)/0.5``. Its text tower (1152 wide, 27 layers, 16
        heads, context 64, vocabulary 32,000) is stated, not built."""
        return CLIPConfig(
            vision=VisionConfig(image_size=384, patch_size=14, width=1152, layers=27, heads=16,
                                embed_dim=1152, gelu="tanh", ln_eps=1e-6, mlp_width=4304, pool="map",
                                pixel_mean=(0.5, 0.5, 0.5), pixel_std=(0.5, 0.5, 0.5)),
            text=TextConfig(context_length=64, vocab_size=32000, width=1152, layers=27, heads=16,
                            embed_dim=1152),
            embed_dim=1152, text_tower=False)

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
    "patch_w", "cls", "pos", "proj", "token_embedding",
    "patch_b", "probe", "q_w", "q_b", "kv_w", "kv_b"})
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


def _init_block(gen: torch.Generator, width: int, mlp_width: int = 0, depth: int = 12) -> Params:
    """One block; ``depth`` sets the residual projections' standard deviation
    (open_clip's init, which team_tpu keeps at 12 for every tower)."""
    proj_std = (width ** -0.5) * ((2 * depth) ** -0.5)
    attn_std = width ** -0.5
    fc_std = (2 * width) ** -0.5
    mlp_width = mlp_width or width * 4
    return {
        "ln_1": _ln(width),
        "attn": {
            "qkv_w": _normal(gen, (width, 3 * width), attn_std),
            "qkv_b": torch.zeros(3 * width),
            "out_w": _normal(gen, (width, width), proj_std),
            "out_b": torch.zeros(width),
        },
        "ln_2": _ln(width),
        "mlp": _init_mlp(gen, width, mlp_width, fc_std, proj_std),
    }


def _init_mlp(gen: torch.Generator, width: int, mlp_width: int, fc_std: float,
              proj_std: float) -> Params:
    return {
        "fc_w": _normal(gen, (width, mlp_width), fc_std),
        "fc_b": torch.zeros(mlp_width),
        "proj_w": _normal(gen, (mlp_width, width), proj_std),
        "proj_b": torch.zeros(width),
    }


def init_clip_params(gen: torch.Generator, cfg: CLIPConfig) -> Params:
    """Random float32 parameters on the CPU, with the distributions of the JAX
    init (``team_tpu/backbone/clip.py:init_clip_params``); the bits differ,
    since torch and JAX draw differently."""
    v, t = cfg.vision, cfg.text
    if v.pool == "map":
        return {"vision": _init_siglip_vision(gen, v),
                "logit_scale": torch.tensor(math.log(1.0 / 0.07), dtype=torch.float32)}
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


def _init_siglip_vision(gen: torch.Generator, v: VisionConfig) -> Params:
    """SigLIP's image tower: the patch GEMM with its bias, the positions,
    the blocks, ``ln_post`` and the attention-pool head (``probe``; ``q_w``
    over the probe, ``kv_w`` over the tokens, ``out_w``; its layer norm and
    MLP). Weights ``[in, out]``; standard deviations as open_clip's init at
    this depth (the published checkpoint's are not needed for a frozen
    tower of random weights)."""
    d, f = v.width, v.mlp
    patch_dim = 3 * v.patch_size * v.patch_size
    return {
        "patch_w": _normal(gen, (patch_dim, d), patch_dim ** -0.5),
        "patch_b": torch.zeros(d),
        "pos": _normal(gen, (v.seq_len, d), d ** -0.5),
        "blocks": [_init_block(gen, d, f, v.layers) for _ in range(v.layers)],
        "ln_post": _ln(d),
        "head": {
            "probe": _normal(gen, (d,), d ** -0.5),
            "attn": {"q_w": _normal(gen, (d, d), d ** -0.5), "q_b": torch.zeros(d),
                     "kv_w": _normal(gen, (d, 2 * d), d ** -0.5), "kv_b": torch.zeros(2 * d),
                     "out_w": _normal(gen, (d, d), d ** -0.5), "out_b": torch.zeros(d)},
            "ln": _ln(d),
            "mlp": _init_mlp(gen, d, f, (2 * d) ** -0.5, d ** -0.5 * (2 * v.layers) ** -0.5),
        },
    }


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

def _layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in float32 (population variance), back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _tower_kernels(x: torch.Tensor, shard=None) -> bool:
    """Whether the bf16 elementwise kernels (:mod:`~team_tpu_torch.ops.tower_bf16`)
    take a tower stage over ``x``: a bfloat16 CUDA tensor that needs no
    gradient (the kernels have no backward; Grad-CAM differentiates through
    the composition), off the tensor-parallel route (``shard``: its all-reduce
    sits between the product and the bias). Elsewhere (the CPU, float32) the
    composition runs. A width the kernels do not take raises there, in the
    wrappers: it never falls back."""
    return shard is None and x.is_cuda and x.dtype == torch.bfloat16 and not wants_grad(x)


def _norm(ln: Params, x: torch.Tensor, eps: float, kernels: bool) -> torch.Tensor:
    """The layer norm ``ln`` of x: :func:`tower_bf16.layer_norm` with
    ``kernels``, else :func:`_layer_norm`."""
    if kernels:
        return tower_bf16.layer_norm(x, ln["scale"], ln["bias"], eps)
    return _layer_norm(ln, x, eps)


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, gelu=None,
            kernels: bool = False) -> torch.Tensor:
    """``x @ w + b`` in x's dtype, then ``F.gelu(approximate=gelu)`` where
    ``gelu`` is not None; with ``kernels`` the bias and GELU in one pass over
    the product (:func:`tower_bf16.bias_act`, the same bits)."""
    y = x @ w.to(x.dtype)
    if kernels:
        return tower_bf16.bias_act(y, b, gelu)
    y = y + b.to(x.dtype)
    return y if gelu is None else F.gelu(y, approximate=gelu)


def attention_core(qkv: torch.Tensor, heads: int, *, causal: bool, kv_len,
                   impl: str) -> torch.Tensor:
    """Attention over the packed qkv projection ``[B, S, 3D]`` -> ``[B, S, D]``:
    ``auto`` (S < 512 at a head width the packed kernel compiles) and
    ``mha_packed`` take the packed kernel; ``auto`` at another head width
    (SigLIP's 72) takes the flash kernel on every device; the rest go
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
    if impl == "auto" and dh not in PACKED_HEAD_DIMS:
        impl = "pallas"
    elif impl == "auto" and s < 512:
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


def _row_parallel(x: torch.Tensor, h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  rank: int, nm: int) -> torch.Tensor:
    """``x + sum over the model ranks of h @ (this rank's rows of w) + b``."""
    w = _rank_block(w, 0, h.shape[-1] * nm, rank, nm).to(x.dtype)
    return x + collectives.all_reduce(h @ w, "sum", tp_mesh().model_group) + b.to(x.dtype)


def _tp_attention_residual(p: Params, x: torch.Tensor, heads: int, *, causal: bool, kv_len,
                           rank: int, nm: int) -> torch.Tensor:
    """The attention half of a block split over the model ranks, computing
    what XLA's partitioner computes from ``shard_clip_params``' layout: the
    qkv GEMM on this rank's block of columns, an ``all_gather`` into the full
    packed qkv that :func:`fused_mha_packed_tp` takes, the rank's heads, the
    out-projection on the matching rows of ``out_w`` summed over the ranks,
    then the bias once (``x + o @ out_w + out_b`` in team_tpu's order)."""
    a = p["attn"]
    d = x.shape[-1]
    h = _layer_norm(p["ln_1"], x)
    qkv = _linear(h, _rank_block(a["qkv_w"], 1, 3 * d, rank, nm),
                  _rank_block(a["qkv_b"], 0, 3 * d, rank, nm))
    o = fused_mha_packed_tp(collectives.all_gather(qkv, tp_mesh().model_group, dim=-1), heads,
                            causal=causal, kv_len=kv_len)
    return _row_parallel(x, o, a["out_w"], a["out_b"], rank, nm)


def _residual(x: torch.Tensor, h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x + h @ w + b`` in team_tpu's order: the product joins the residual
    before the bias (two roundings in bf16)."""
    return x + h @ w.to(x.dtype) + b.to(x.dtype)


def _residual_ln(x: torch.Tensor, h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, ln, eps: float,
                 kernels: bool):
    """:func:`_residual` -> ``(x', LN(x'))``: with ``kernels`` one pass over
    the product adds the residual and bias and computes the layer norm ``ln``
    (None: none) of the result (:func:`tower_bf16.residual_ln`); without,
    ``(x', None)`` and the next stage normalizes x' itself."""
    if not kernels:
        return _residual(x, h, w, b), None
    affine = () if ln is None else (ln["scale"], ln["bias"])
    return tower_bf16.residual_ln(x, h @ w.to(x.dtype), b, *affine, eps=eps)


def _attention_residual(p: Params, x: torch.Tensor, heads: int, *, causal: bool, kv_len,
                        impl: str, shard, eps: float = 1e-5, h=None):
    """A block's attention half, LN1 to the residual -> ``(x, LN2(x) or
    None)``. ``attn_block`` runs it in :func:`fused_attn_block`,
    ``mha_packed_proj`` the attention, out-projection and residual in
    :func:`fused_mha_packed_proj` after a ``torch.matmul`` qkv GEMM; ``shard``
    (the model rank and count of :func:`tp_split`, or None):
    :func:`_tp_attention_residual`. ``eps``: the layer norms' (the plain GEMM
    routes'; the fused and split ones are CLIP's, 1e-5). ``h``: LN1(x) where
    the previous half computed it. LN2 comes back where the kernels ran the
    residual (:func:`_residual_ln`), else None."""
    a = p["attn"]
    if shard is not None:
        return _tp_attention_residual(p, x, heads, causal=causal, kv_len=kv_len, rank=shard[0],
                                      nm=shard[1]), None
    if impl == "attn_block":
        return fused_attn_block(x, p["ln_1"]["scale"], p["ln_1"]["bias"], a["qkv_w"], a["qkv_b"],
                                a["out_w"], a["out_b"], heads, causal=causal), None
    kernels = _tower_kernels(x)
    if h is None:
        h = _norm(p["ln_1"], x, eps, kernels)
    qkv = _linear(h, a["qkv_w"], a["qkv_b"], kernels=kernels)
    if impl == "mha_packed_proj":
        return fused_mha_packed_proj(qkv, a["out_w"], a["out_b"], x, heads, causal=causal), None
    o = attention_core(qkv, heads, causal=causal, kv_len=kv_len, impl=impl)
    return _residual_ln(x, o, a["out_w"], a["out_b"], p["ln_2"], eps, kernels)


def _mlp_residual(p: Params, x: torch.Tensor, shard, *, eps: float = 1e-5, gelu: str = "none",
                  ln: str = "ln_2", h=None, ln_next=None):
    """A block's MLP half, LN2 (``p[ln]``, ``eps``; ``h`` where the attention
    half computed it) to the residual -> ``(x, LN_next(x) or None)``, the GELU
    ``F.gelu``'s ``approximate=gelu``, ``torch.matmul`` on every route as
    team_tpu leaves it to XLA; where the kernels run the residual it carries
    the layer norm ``ln_next`` (the next block's LN1; None: none). Under
    ``shard`` (CLIP's tower only) the fc columns and proj rows of the rank,
    summed over the ranks, then the bias."""
    m = p["mlp"]
    if shard is None:
        kernels = _tower_kernels(x)
        if h is None:
            h = _norm(p[ln], x, eps, kernels)
        h = _linear(h, m["fc_w"], m["fc_b"], gelu=gelu, kernels=kernels)
        return _residual_ln(x, h, m["proj_w"], m["proj_b"], ln_next, eps, kernels)
    h = _layer_norm(p[ln], x, eps)
    rank, nm = shard
    f = m["fc_b"].shape[-1]
    h = _linear(h, _rank_block(m["fc_w"], 1, f, rank, nm), _rank_block(m["fc_b"], 0, f, rank, nm))
    return _row_parallel(x, F.gelu(h, approximate="none"), m["proj_w"], m["proj_b"], rank,
                         nm), None


def _shard(impl: str, heads: int, width: int):
    """The model rank and count that split the heads (``mha_packed_tp``
    under a registered layout whose model axis splits them), else None."""
    return tp_split(heads, width) if impl == "mha_packed_tp" else None


def _block_forward(p: Params, x: torch.Tensor, heads: int, *, causal: bool, kv_len,
                   impl: str) -> torch.Tensor:
    """One transformer block (``team_tpu/backbone/clip.py:_block_forward``):
    :func:`_attention_residual`, then :func:`_mlp_residual`."""
    return _tower_blocks([p], x, heads, causal=causal, kv_len=kv_len, impl=impl)


def _tower_blocks(blocks, x: torch.Tensor, heads: int, *, causal: bool, kv_len, impl: str,
                  eps: float = 1e-5, gelu: str = "none",
                  span=contextlib.nullcontext) -> torch.Tensor:
    """The blocks over x, each half inside ``span(name)`` (the tower's spans,
    or none). Where the kernels run the residuals, each carries the next layer
    norm to the next half: its block's LN2, the next block's LN1 (but before
    ``attn_block``, whose kernel normalizes itself, and after the last block,
    whose output the tower's head takes)."""
    shard = _shard(impl, heads, x.shape[-1])
    h = None
    for i, blk in enumerate(blocks):
        with span(phase_timer.ATTN_BLOCK):
            x, h = _attention_residual(blk, x, heads, causal=causal, kv_len=kv_len, impl=impl,
                                       shard=shard, eps=eps, h=h)
        last = i + 1 == len(blocks)
        ln_next = None if last or impl == "attn_block" else blocks[i + 1]["ln_1"]
        with span(phase_timer.MLP_BLOCK):
            x, h = _mlp_residual(blk, x, shard, eps=eps, gelu=gelu, h=h, ln_next=ln_next)
    return x


def patch_pixels(images: torch.Tensor, cfg: CLIPConfig, *,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """``[B, H, W, 3]`` -> the patch-pixel matrix ``[B, g*g, 3*ps*ps]``
    (channel-major inside a patch, the torch conv weight order); pixels past
    the last whole patch (384 at patch 14: the last 6 rows and columns) are
    dropped, as a stride-``ps`` convolution drops them."""
    v = cfg.vision
    b = images.shape[0]
    g, ps = v.grid, v.patch_size
    x = images[:, :g * ps, :g * ps].to(compute_dtype).reshape(b, g, ps, g, ps, 3)
    x = x.permute(0, 1, 3, 5, 2, 4)  # B, gh, gw, C, ph, pw
    return x.reshape(b, g * g, 3 * ps * ps)


def embed_patches(params: Params, images: torch.Tensor, cfg: CLIPConfig, *,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """Patch embedding: ``[B, H, W, 3]`` -> ``[B, g*g, width]`` (one GEMM)."""
    x = patch_pixels(images, cfg, compute_dtype=compute_dtype)
    return x @ params["vision"]["patch_w"].to(compute_dtype)


def _embed_tokens(p: Params, patch_tokens: torch.Tensor, v: VisionConfig,
                  compute_dtype) -> torch.Tensor:
    """The patch GEMM's bias, the CLS token and ``ln_pre``, each where the
    tower's kind has it (:class:`VisionConfig`), and the position embeddings."""
    x = patch_tokens.to(compute_dtype)
    if v.patch_bias:
        x = x + p["patch_b"].to(compute_dtype)
    if v.class_token:
        cls = p["cls"].to(compute_dtype).expand(patch_tokens.shape[0], 1, v.width)
        x = torch.cat([cls, x], dim=1)
    x = x + p["pos"].to(compute_dtype)
    return _norm(p["ln_pre"], x, v.ln_eps, _tower_kernels(x)) if v.ln_pre else x


def _attention_pool(p: Params, x: torch.Tensor, v: VisionConfig, *, attn_impl: str) -> torch.Tensor:
    """SigLIP's attention-pool head over ``ln_post``'s tokens ``[B, S, D]`` ->
    ``[B, D]``: the learned probe's query (one row, shared by the batch),
    keys and values from one GEMM over every token, the heads' attention of
    the one query (the flash kernel, its plain version on the CPU, under
    ``auto`` and ``pallas``; the plain route under ``xla``), the
    out-projection, then ``h + MLP(LN(h))`` with the tower's eps and GELU."""
    if attn_impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"the attention-pool head runs on auto, pallas or xla, not {attn_impl!r}")
    a = p["attn"]
    b, _, d = x.shape
    h, dh = v.heads, v.head_dim
    kernels = _tower_kernels(x)
    q = _linear(p["probe"].to(x.dtype)[None], a["q_w"], a["q_b"], kernels=kernels)
    kv = _linear(x, a["kv_w"], a["kv_b"], kernels=kernels)

    def split_heads(t):
        return t.reshape(t.shape[0], -1, h, dh).permute(0, 2, 1, 3)

    attend = xla_attention if attn_impl == "xla" else flash_attention
    o = attend(split_heads(q).expand(b, h, 1, dh), *map(split_heads, kv.split(d, dim=-1)))
    o = _linear(o.reshape(b, d), a["out_w"], a["out_b"], kernels=kernels)
    return _mlp_residual(p, o, None, eps=v.ln_eps, gelu=v.gelu, ln="ln")[0]


def _vision_tower(p: Params, patch_tokens, v: VisionConfig, *, compute_dtype,
                  attn_impl: str) -> torch.Tensor:
    """The image tower -> ``[B, embed_dim]`` float32, each stage in its span:
    the embedding (``patch_tokens()``, the function that makes the patch
    tokens ``[B, g*g, width]``, then :func:`_embed_tokens`), each block's
    halves, the head. Made inside the embedding's span, the tokens'
    intermediates are freed before the blocks run."""
    with phase(phase_timer.EMBED):
        x = _embed_tokens(p, patch_tokens(), v, compute_dtype)
    x = _tower_blocks(p["blocks"], x, v.heads, causal=False, kv_len=v.seq_len, impl=attn_impl,
                      eps=v.ln_eps, gelu=v.gelu, span=phase)
    with phase(phase_timer.HEAD):
        kernels = _tower_kernels(x, _shard(attn_impl, v.heads, v.width))
        if v.pool == "map":
            x = _norm(p["ln_post"], x, v.ln_eps, kernels)
            return _attention_pool(p["head"], x, v, attn_impl=attn_impl).float()
        x = _norm(p["ln_post"], x[:, 0], v.ln_eps, kernels)
        return (x @ p["proj"].to(compute_dtype)).float()


def encode_from_patches(params: Params, patch_tokens: torch.Tensor, cfg: CLIPConfig, *,
                        compute_dtype=torch.float32, attn_impl: str = "auto") -> torch.Tensor:
    """Transformer stage over patch tokens -> ``[B, embed_dim]`` float32."""
    return _vision_tower(params["vision"], lambda: patch_tokens, cfg.vision,
                         compute_dtype=compute_dtype, attn_impl=attn_impl)


def encode_image(params: Params, images: torch.Tensor, cfg: CLIPConfig, *,
                 compute_dtype=torch.float32, attn_impl: str = "auto") -> torch.Tensor:
    """Image tower: ``[B, H, W, 3]`` float (normalized) -> ``[B, embed_dim]``."""
    return _vision_tower(params["vision"],
                         lambda: embed_patches(params, images, cfg, compute_dtype=compute_dtype),
                         cfg.vision, compute_dtype=compute_dtype, attn_impl=attn_impl)


def encode_image_patches_u8(params: Params, patches_u8: torch.Tensor, cfg: CLIPConfig, *,
                            compute_dtype=torch.float32, attn_impl: str = "auto") -> torch.Tensor:
    """Image tower over patch-major uint8 input ``[B, g*g, 3*ps*ps]`` (the
    order of :func:`patch_pixels`); /255 and the tower's pixel mean and std
    are a per-column scale and bias before the patch GEMM."""
    if patches_u8.dtype != torch.uint8:
        raise TypeError(f"patch-major input must be uint8, got {patches_u8.dtype}")
    p = params["vision"]
    v = cfg.vision

    def patch_tokens():
        scale, bias = patch_norm_consts(v.patch_size, device=patches_u8.device,
                                        mean=v.pixel_mean, std=v.pixel_std)
        px = (patches_u8.float() * scale + bias).to(compute_dtype)
        return px @ p["patch_w"].to(compute_dtype)

    return _vision_tower(p, patch_tokens, cfg.vision, compute_dtype=compute_dtype,
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
    x = _tower_blocks(p["blocks"], x, t.heads, causal=True, kv_len=t.context_length,
                      impl=attn_impl)
    x = _norm(p["ln_final"], x, 1e-5, _tower_kernels(x, _shard(attn_impl, t.heads, t.width)))
    eot = tokens.argmax(dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    return (x @ p["proj"].to(compute_dtype)).float()
