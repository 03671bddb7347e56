"""Learner factory (counterpart of ``team_tpu/learners/factory.py``)."""

from __future__ import annotations

from typing import Optional

from team_tpu_torch.backbone.clip import Params
from team_tpu_torch.config import Config


def get_model(model_name: str, cfg: Config, clip_params: Optional[Params] = None):
    """``clip_params``: the towers' float32 parameters (random init when absent)."""
    name = model_name.lower()
    if name == "proof":
        raise NotImplementedError(
            "model_name='proof': the PROOF learner is not ported yet "
            "(ROADMAP queue 1 items 5-7)")
    if name == "simplecil":
        from team_tpu_torch.learners.simplecil import Learner
    elif name == "zs_clip":
        from team_tpu_torch.learners.zs_clip import Learner
    else:
        raise ValueError(f"Unknown model {model_name}")
    return Learner(cfg, clip_params=clip_params)
