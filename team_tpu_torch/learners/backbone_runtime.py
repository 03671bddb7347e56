"""Shared frozen-CLIP runtime for the learners.

Counterpart of ``team_tpu/learners/backbone_runtime.py``: builds the ViT-B/16
towers and the tokenizer, and exposes ``encode_image`` (float, uint8 and
patch-major uint8 routes) and ``encode_texts`` with a text-feature cache
keyed by the prompt string (exact, since the towers are frozen).

``convnet_type="siglip_so400m14_384"`` builds SigLIP So400m/14's image tower
at 384 px instead (:meth:`CLIPConfig.siglip_so400m14_384`; features 1152
wide, bf16 on the ``auto``, ``pallas`` or ``xla`` attention routes). Its
text tower waits for its SentencePiece vocabulary, so ``encode_texts``
raises there, and so does every learner step that encodes prompts.

With ``encoder_quant="int8_static"`` the image tower is the static-W8A8
int8 tower (:mod:`team_tpu_torch.backbone.quant`) on the route that
``int8_gemm_impl`` names (default ``static3d_qi``): the first batch
calibrates it and gets the bf16 tower's features; the next, held-out batch
runs the cosine gate (min cosine >= 0.999 against the bf16 tower); a pass
commits the quantized tower (and saves it under ``int8_cache_dir`` when
set, for later runs to load), a failure logs a warning and serves bf16 from
then on. As in team_tpu the runtime always builds the static payload, so a
dynamic tier (``xla``, ``hybrid``, ``pallas``) encodes it through its own
blocks and its gate decides. A payload loaded from ``int8_cache_dir`` commits without a gate
only on the route family (static or dynamic) it was gated on; on the other
family it goes through the held-out gate like a fresh one (team_tpu trusts
it on every route). The text tower stays in the compute dtype. Under several
ranks each calibrates on its own batch and the ranks build one tower: the
activation abs-maxes are combined by ``all_reduce(max)`` (exact), the gate's
min cosine by ``all_reduce(min)``, so every rank decides alike, and only
rank 0 saves the payload (``team_tpu/learners/backbone_runtime.py:191-239``).
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_map

from team_tpu_torch.backbone import quant
from team_tpu_torch.backbone.clip import (
    CLIPConfig, Params, cast_frozen_params, encode_image, encode_image_patches_u8,
    encode_text, init_clip_params)
from team_tpu_torch.backbone.import_weights import load_clip_checkpoint
from team_tpu_torch.backbone.tokenizer import Tokenizer
from team_tpu_torch.bridge import tree_to
from team_tpu_torch.config import Config
from team_tpu_torch.ops.preprocess import preprocess_batch
from team_tpu_torch.parallel import collectives
from team_tpu_torch.parallel.layout import resolve_device
from team_tpu_torch.utils import phase_timer
from team_tpu_torch.utils.phase_timer import phase

SIGLIP = "siglip_so400m14_384"
_KNOWN_TYPES = ("clip", "clip_laion2b", "openai_clip", SIGLIP)
SIGLIP_ROUTES = ("auto", "pallas", "xla")  # the attention routes that take head width 72
GATE_MIN_COSINE = 0.999
NO_TEXT_TOWER = ("SigLIP's text tower needs its 32,000-piece SentencePiece vocabulary, which "
                 "is not in the repository; this backbone encodes images only")


def clip_config_for(cfg: Config) -> CLIPConfig:
    """The towers ``convnet_type`` names: SigLIP So400m/14-384 for
    ``siglip_so400m14_384``, ViT-B/16 for the CLIP names; ``tiny_backbone``
    gives the CLIP test tower whatever the type."""
    kind = cfg.convnet_type.lower()
    if kind not in _KNOWN_TYPES and "clip" not in kind:
        raise NotImplementedError(f"Unknown type {cfg.convnet_type}")
    if cfg.get("tiny_backbone", False):
        return CLIPConfig.tiny()
    if kind == SIGLIP:
        return CLIPConfig.siglip_so400m14_384()
    return CLIPConfig.vit_b16()


class BackboneRuntime:
    TEXT_BUCKET = 32  # text batches are padded to this size, as in team_tpu

    def __init__(self, cfg: Config, seed: int = 0, params: Optional[Params] = None):
        """``params``: a float32 tree of tensors (e.g. the JAX init carried
        across by :mod:`team_tpu_torch.bridge`); when absent, the open_clip
        checkpoint that ``TEAM_CLIP_CHECKPOINT`` names if it names a file
        (:mod:`team_tpu_torch.backbone.import_weights`), else the random init
        from ``seed``. A checkpoint file requires the BPE vocabulary unless
        the config sets ``allow_byte_tokenizer``, as in team_tpu."""
        ckpt = os.environ.get("TEAM_CLIP_CHECKPOINT")
        pretrained = bool(ckpt and os.path.isfile(ckpt))
        self.encoder_quant = cfg.get("encoder_quant", "bf16")
        if self.encoder_quant not in ("bf16", "int8_static"):
            raise NotImplementedError(f"encoder_quant={self.encoder_quant!r}: the port has "
                                      "'bf16' and 'int8_static'")
        self.int8_impl = cfg.get("int8_gemm_impl", "static3d_qi")
        if self.encoder_quant == "int8_static":
            quant.check_route(self.int8_impl)
        self.cfg = cfg
        self.clip_cfg = clip_config_for(cfg)
        if not self.clip_cfg.text_tower:
            self._check_image_only(cfg, pretrained)
        self.device = resolve_device(cfg.device)
        if params is None and pretrained:
            logging.info("loading CLIP checkpoint from %s", ckpt)
            params = load_clip_checkpoint(ckpt, self.clip_cfg)
        elif params is None:
            # as team_tpu: a checkpoint path that names no file means the random init
            logging.info("no CLIP checkpoint available; random init from seed %d", seed)
            params = init_clip_params(torch.Generator().manual_seed(seed), self.clip_cfg)
        self.compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.attn_impl = cfg.attention_impl
        # on the fused routes the attention biases stay float32, as their kernels add them
        self.params = cast_frozen_params(params, self.compute_dtype, self.device, self.attn_impl)
        # pretrained weights with the byte-fallback ids would corrupt every text
        # feature: the BPE vocabulary is required unless explicitly waived
        self.tokenizer = Tokenizer(
            require_bpe=pretrained and not cfg.get("allow_byte_tokenizer", False))
        self.out_dim = self.clip_cfg.embed_dim
        self._text_cache: Dict[str, np.ndarray] = {}
        # int8 tier state: the float32 image tower is quantized after calibration
        self._vision_f32: Optional[Params] = (params["vision"] if self.encoder_quant == "int8_static"
                                              else None)
        self._qvision: Optional[Dict[str, Any]] = None
        self._qvision_pending: Optional[Dict[str, Any]] = None
        self.gate_cosine: Optional[float] = None  # min held-out cosine of the last gate

    def _check_image_only(self, cfg: Config, pretrained: bool) -> None:
        """What SigLIP's image tower takes here: bf16 (no int8 tier), the
        attention routes with a head-width-72 kernel or the plain one, and
        random weights (there is no importer of its checkpoints)."""
        if self.encoder_quant != "bf16":
            raise NotImplementedError(f"{cfg.convnet_type}: encoder_quant must be 'bf16'")
        if cfg.attention_impl not in SIGLIP_ROUTES:
            raise NotImplementedError(f"{cfg.convnet_type}: attention_impl must be one of "
                                      f"{SIGLIP_ROUTES}, got {cfg.attention_impl!r}")
        if pretrained:
            raise NotImplementedError(f"{cfg.convnet_type}: TEAM_CLIP_CHECKPOINT names an "
                                      "open_clip checkpoint; SigLIP's has no importer")

    def to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    @staticmethod
    def _is_patch_major(images: torch.Tensor) -> bool:
        return images.dtype == torch.uint8 and images.dim() == 3

    # -- frozen-backbone encodes ---------------------------------------
    @torch.no_grad()
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3]`` float or uint8, or patch-major uint8
        ``[B, g*g, 3*ps*ps]`` -> ``[B, embed_dim]`` float32."""
        with phase(phase_timer.ENCODE_IMAGE):
            if self.encoder_quant == "int8_static":
                if self._qvision is None and self._qvision_pending is None:
                    self._try_load_int8_cache()
                if self._qvision is not None:
                    return self._encode_int8(self._qvision, images)
                if self._qvision_pending is None:
                    with phase(phase_timer.CALIBRATE):
                        return self._calibrate_int8(images)
                with phase(phase_timer.GATE):
                    return self._gate_int8(images)
            kw = dict(compute_dtype=self.compute_dtype, attn_impl=self.attn_impl)
            if self._is_patch_major(images):
                return encode_image_patches_u8(self.params, images, self.clip_cfg, **kw)
            if images.dtype == torch.uint8:
                v = self.clip_cfg.vision
                images = preprocess_batch(images, v.image_size, mean=v.pixel_mean, std=v.pixel_std)
            return encode_image(self.params, images, self.clip_cfg, **kw)

    # -- int8 static tier ------------------------------------------------
    @property
    def int8_committed(self) -> bool:
        return self._qvision is not None

    def _encode_int8(self, qv: Dict[str, Any], images: torch.Tensor) -> torch.Tensor:
        kw = dict(attn_impl=self.attn_impl, gemm_impl=self.int8_impl)
        if self._is_patch_major(images):
            return quant.encode_image_int8_patches(qv, images, self.clip_cfg, **kw)
        if images.dtype == torch.uint8:
            images = preprocess_batch(images, self.clip_cfg.vision.image_size)
        return quant.encode_image_int8(qv, images, self.clip_cfg, **kw)

    def _calib_forward(self, images: torch.Tensor):
        """The calibration forward, which is the bf16 tower: (stats, features)."""
        kw = dict(attn_impl=self.attn_impl, return_features=True)
        if self._is_patch_major(images):
            return quant.calibrate_vision_tower_patches(self.params, images, self.clip_cfg, **kw)
        if images.dtype == torch.uint8:
            images = preprocess_batch(images, self.clip_cfg.vision.image_size)
        return quant.calibrate_vision_tower(self.params, images, self.clip_cfg, **kw)

    def _calibrate_int8(self, images: torch.Tensor) -> torch.Tensor:
        """Calibrate on this batch and return its bf16 features; the gate
        waits for the next batch, so that it runs on held-out data."""
        calib, ref = self._calib_forward(images)
        if collectives.group_size() > 1:
            calib = tree_map(lambda a: collectives.all_reduce(a, "max"), calib)
        params32 = {"vision": tree_to(self._vision_f32, self.device)}
        self._qvision_pending = quant.quantize_vision_tower_static(
            params32, calib, heads=self.clip_cfg.vision.heads)
        logging.info("int8_static calibrated; cosine gate pending on the next (held-out) batch")
        return ref

    def _gate_int8(self, images: torch.Tensor) -> torch.Tensor:
        """Held-out cosine gate of the pending quantized tower against the
        bf16 tower on this batch: commit it, or fall back to bf16."""
        qv, self._qvision_pending = self._qvision_pending, None
        _, ref = self._calib_forward(images)
        feats = self._encode_int8(qv, images)
        a, b = ref.double(), feats.double()
        cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1) + 1e-30)
        # one decision on every rank
        self.gate_cosine = float(collectives.all_reduce(cos.min(), "min"))
        if self.gate_cosine >= GATE_MIN_COSINE:
            self._commit(qv)
            logging.info("int8_static encoder enabled (held-out cosine min %.6f)",
                         self.gate_cosine)
            cache = self.cfg.get("int8_cache_dir")
            if cache and collectives.group_rank() == 0:
                quant.save_quantized_tower(cache, qv, quant.route_family(self.int8_impl))
                logging.info("validated quantized tower saved to %s", cache)
            return feats
        self.encoder_quant = "bf16"
        self._vision_f32 = None
        logging.warning("int8_static held-out cosine gate FAILED (min %.6f) -- falling back "
                        "to bf16 encode", self.gate_cosine)
        return ref

    def _commit(self, qv: Dict[str, Any]) -> None:
        self._qvision = qv
        self._vision_f32 = None  # quantized; the float32 copy is not needed any more

    def _try_load_int8_cache(self) -> bool:
        """Load a payload that passed its gate in an earlier run: it skips
        calibration, and the gate too when it was gated on this route's
        family; otherwise it waits for the gate on the next batch."""
        cache = self.cfg.get("int8_cache_dir")
        if not cache or not os.path.isfile(os.path.join(cache, quant.PAYLOAD_FILE)):
            return False
        try:
            qv, family = quant.load_quantized_tower(cache, self.device)
        except (OSError, RuntimeError, KeyError, pickle.UnpicklingError) as e:
            logging.warning("int8 cache load failed (%s); recalibrating", e)
            return False
        if family != quant.route_family(self.int8_impl):
            self._qvision_pending = qv
            logging.info("loaded a quantized tower gated on the %s routes from %s; the held-out "
                         "gate runs on this batch for %s", family, cache, self.int8_impl)
            return True
        self._commit(qv)
        logging.info("loaded validated quantized tower from %s (calibration skipped)", cache)
        return True

    # -- text ------------------------------------------------------------
    @torch.no_grad()
    def encode_text_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        if not self.clip_cfg.text_tower:
            raise NotImplementedError(NO_TEXT_TOWER)
        return encode_text(self.params, tokens, self.clip_cfg,
                           compute_dtype=self.compute_dtype, attn_impl=self.attn_impl)

    def encode_texts(self, texts: Sequence[str], cache: bool = True) -> torch.Tensor:
        """Encode strings -> ``[N, embed_dim]`` on the device. Batches are
        padded to ``TEXT_BUCKET`` rows, the batch shape of team_tpu. Raises on
        a backbone without a text tower (SigLIP's)."""
        if not self.clip_cfg.text_tower:
            raise NotImplementedError(NO_TEXT_TOWER)
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
