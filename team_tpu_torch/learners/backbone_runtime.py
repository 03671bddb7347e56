"""Shared frozen-CLIP runtime for the learners.

Counterpart of ``team_tpu/learners/backbone_runtime.py``: builds the ViT-B/16
towers and the tokenizer, and exposes ``encode_image`` (float, uint8 and
patch-major uint8 routes) and ``encode_texts`` with a text-feature cache
keyed by the prompt string (exact, since the towers are frozen).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from team_tpu_torch.backbone.clip import (
    CLIPConfig, Params, cast_frozen_params, encode_image, encode_image_patches_u8,
    encode_text, init_clip_params)
from team_tpu_torch.backbone.tokenizer import Tokenizer
from team_tpu_torch.config import Config
from team_tpu_torch.ops.preprocess import preprocess_batch
from team_tpu_torch.utils.toolkit import resolve_device

_KNOWN_TYPES = ("clip", "clip_laion2b", "openai_clip")


def clip_config_for(cfg: Config) -> CLIPConfig:
    if cfg.convnet_type.lower() not in _KNOWN_TYPES and "clip" not in cfg.convnet_type.lower():
        raise NotImplementedError(f"Unknown type {cfg.convnet_type}")
    if cfg.get("tiny_backbone", False):
        return CLIPConfig.tiny()
    return CLIPConfig.vit_b16()


class BackboneRuntime:
    TEXT_BUCKET = 32  # text batches are padded to this size, as in team_tpu

    def __init__(self, cfg: Config, seed: int = 0, params: Optional[Params] = None):
        """``params``: a float32 tree of tensors (e.g. the JAX init carried
        across by :mod:`team_tpu_torch.bridge`); random init from ``seed``
        when absent."""
        if os.environ.get("TEAM_CLIP_CHECKPOINT"):
            raise NotImplementedError(
                "TEAM_CLIP_CHECKPOINT: the open_clip checkpoint loader is not ported "
                "yet (ROADMAP queue 1 item 2)")
        encoder_quant = cfg.get("encoder_quant", "bf16")
        if encoder_quant != "bf16":
            raise NotImplementedError(
                f"encoder_quant={encoder_quant!r}: the int8 static tier is not "
                "ported yet (ROADMAP queue 1 item 9)")
        self.cfg = cfg
        self.clip_cfg = clip_config_for(cfg)
        self.device = resolve_device(cfg.device)
        if params is None:
            logging.info("no CLIP checkpoint; random init from seed %d", seed)
            params = init_clip_params(torch.Generator().manual_seed(seed), self.clip_cfg)
        self.compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.params = cast_frozen_params(params, self.compute_dtype, self.device)
        self.tokenizer = Tokenizer(require_bpe=False)
        self.out_dim = self.clip_cfg.embed_dim
        self.attn_impl = cfg.attention_impl
        self._text_cache: Dict[str, np.ndarray] = {}

    def to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    # -- frozen-backbone encodes ---------------------------------------
    @torch.no_grad()
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3]`` float or uint8, or patch-major uint8
        ``[B, g*g, 3*ps*ps]`` -> ``[B, embed_dim]`` float32."""
        kw = dict(compute_dtype=self.compute_dtype, attn_impl=self.attn_impl)
        if images.dtype == torch.uint8 and images.dim() == 3:
            return encode_image_patches_u8(self.params, images, self.clip_cfg, **kw)
        if images.dtype == torch.uint8:
            images = preprocess_batch(images, self.clip_cfg.vision.image_size)
        return encode_image(self.params, images, self.clip_cfg, **kw)

    @torch.no_grad()
    def encode_text_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return encode_text(self.params, tokens, self.clip_cfg,
                           compute_dtype=self.compute_dtype, attn_impl=self.attn_impl)

    def encode_texts(self, texts: Sequence[str], cache: bool = True) -> torch.Tensor:
        """Encode strings -> ``[N, embed_dim]`` on the device. Batches are
        padded to ``TEXT_BUCKET`` rows, the batch shape of team_tpu."""
        missing = [t for t in texts if t not in self._text_cache] if cache else list(texts)
        missing = list(dict.fromkeys(missing))  # de-dup, keep order
        feats_by_text = {}
        for start in range(0, len(missing), self.TEXT_BUCKET):
            chunk = missing[start:start + self.TEXT_BUCKET]
            toks = self.tokenizer(chunk)
            pad = self.TEXT_BUCKET - len(chunk)
            if pad:
                toks = np.concatenate([toks, np.repeat(toks[-1:], pad, axis=0)])
            feats = self.encode_text_tokens(self.to_device(toks)).cpu().numpy()[:len(chunk)]
            for t, f in zip(chunk, feats):
                feats_by_text[t] = f
                if cache:
                    self._text_cache[t] = f
        source = self._text_cache if cache else feats_by_text
        return self.to_device(np.stack([source[t] for t in texts]))

    @property
    def logit_scale(self) -> torch.Tensor:
        return self.params["logit_scale"]
