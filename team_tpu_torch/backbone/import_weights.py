"""Import open_clip / OpenAI CLIP checkpoints into the port's parameter tree.

Counterpart of ``team_tpu/backbone/import_weights.py``. The reference loads
the ``laion400m_e32`` / ``laion2b_s34b_b88k`` / ``openai`` weights through
open_clip (reference ``utils/inc_net.py:18-32``); this module converts such a
checkpoint (a torch ``state_dict`` saved as ``.pt``/``.bin``, or an ``.npz``
with the same key names) into the float32 tree that
:func:`team_tpu_torch.backbone.clip.init_clip_params` returns, weights in
``[in, out]`` layout. Nothing is downloaded: a run without a checkpoint file
uses the random init.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from team_tpu_torch.backbone.clip import CLIPConfig, Params


def _to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The checkpoint's arrays by key: an ``.npz`` through numpy, anything
    else through ``torch.load`` on the CPU, a ``state_dict`` entry unwrapped
    and the ``module.`` prefix of a data-parallel save stripped.

    Unlike team_tpu's loader (``weights_only=False``), ``torch.load`` runs
    with ``weights_only=True``: a file that pickles other objects beside its
    tensors (training arguments, say) raises ``pickle.UnpicklingError`` here
    where team_tpu unpickles it. Save such a checkpoint's ``state_dict``
    alone, or as ``.npz``."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", ""): _to_np(v) for k, v in sd.items()}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _ln(sd: Dict[str, np.ndarray], prefix: str) -> Params:
    return {"scale": _t(sd[prefix + ".weight"]), "bias": _t(sd[prefix + ".bias"])}


def _block_from_sd(sd: Dict[str, np.ndarray], prefix: str) -> Params:
    return {
        "ln_1": _ln(sd, prefix + "ln_1"),
        "attn": {
            "qkv_w": _t(sd[prefix + "attn.in_proj_weight"].T),
            "qkv_b": _t(sd[prefix + "attn.in_proj_bias"]),
            "out_w": _t(sd[prefix + "attn.out_proj.weight"].T),
            "out_b": _t(sd[prefix + "attn.out_proj.bias"]),
        },
        "ln_2": _ln(sd, prefix + "ln_2"),
        "mlp": {
            "fc_w": _t(sd[prefix + "mlp.c_fc.weight"].T),
            "fc_b": _t(sd[prefix + "mlp.c_fc.bias"]),
            "proj_w": _t(sd[prefix + "mlp.c_proj.weight"].T),
            "proj_b": _t(sd[prefix + "mlp.c_proj.bias"]),
        },
    }


def _n_blocks(sd: Dict[str, np.ndarray], prefix: str) -> int:
    return len([k for k in sd if k.startswith(prefix) and k.endswith("ln_1.weight")])


def convert_openclip_state_dict(sd: Dict[str, np.ndarray], cfg: CLIPConfig) -> Dict[str, Any]:
    """An open_clip state dict -> the port's float32 tree: ``conv1``'s
    ``[width, 3, ph, pw]`` kernel reshaped to ``patch_w [3*ph*pw, width]``
    (the (C, ph, pw) pixel order of ``patch_pixels``), the attention and MLP
    weights transposed to ``[in, out]``; the block counts are read from the
    keys."""
    v = cfg.vision
    patch_w = sd["visual.conv1.weight"].reshape(v.width, -1).T
    vision = {
        "patch_w": _t(patch_w),
        "cls": _t(sd["visual.class_embedding"]),
        "pos": _t(sd["visual.positional_embedding"]),
        "ln_pre": _ln(sd, "visual.ln_pre"),
        "blocks": [_block_from_sd(sd, f"visual.transformer.resblocks.{i}.")
                   for i in range(_n_blocks(sd, "visual.transformer.resblocks."))],
        "ln_post": _ln(sd, "visual.ln_post"),
        "proj": _t(sd["visual.proj"]),
    }
    text = {
        "token_embedding": _t(sd["token_embedding.weight"]),
        "pos": _t(sd["positional_embedding"]),
        "blocks": [_block_from_sd(sd, f"transformer.resblocks.{i}.")
                   for i in range(_n_blocks(sd, "transformer.resblocks."))],
        "ln_final": _ln(sd, "ln_final"),
        "proj": _t(sd["text_projection"]),
    }
    return {"vision": vision, "text": text,
            "logit_scale": torch.tensor(float(sd["logit_scale"]), dtype=torch.float32)}


def load_clip_checkpoint(path: str, cfg: CLIPConfig) -> Dict[str, Any]:
    """:func:`convert_openclip_state_dict` of the file at ``path``."""
    return convert_openclip_state_dict(load_state_dict(path), cfg)
