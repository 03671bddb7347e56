"""Symmetric image/text InfoNCE (CLIP) loss (counterpart of
``team_tpu/losses/clip_loss.py``): the single-shard form with
``valid_mask``, and the global-batch form over a data-parallel process
group with the open_clip-style ``local_loss``."""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from team_tpu_torch.parallel import collectives

NEG_INF = -1e30  # finite: exp underflows to exactly 0, no inf*0 NaNs in grads


def _xent(logits: torch.Tensor, labels: torch.Tensor,
          valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    per_row = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    if valid_mask is None:
        return per_row.mean()
    return (per_row * valid_mask).sum() / torch.clamp(valid_mask.sum(), min=1.0)


def _group(axis_name: Any):
    """The process group an ``axis_name`` names: a group as it is, any other
    value (team_tpu's axis string) the default group."""
    return None if isinstance(axis_name, str) else axis_name


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor, *, axis_name: Any = None,
              local_loss: bool = False, valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(CE(img→txt) + CE(txt→img)) / 2`` on L2-normalized features.

    ``axis_name``: the data-parallel group to gather the contrastive batch
    over (a ``torch.distributed`` process group, or a string for the default
    group; a world of one when none is joined); ``None`` is the single-shard
    form. Each rank passes its rows; the rows of the other ranks enter
    detached, so each rank's backward reaches its own rows.

    ``valid_mask`` (``[B]`` float, 1 = real row): padded rows leave the row
    means and the negative sets, so a padded batch's loss equals the unpadded
    batch's. With ``local_loss`` each rank returns the mean over its own
    valid rows of its logits against the gathered features (labels offset by
    ``n * rank``); a caller weights the ranks' losses by their valid counts."""
    n = image_features.shape[0]
    dev = image_features.device
    if axis_name is None:
        labels = torch.arange(n, device=dev)
        logits_per_image = logit_scale * image_features @ text_features.T
        logits_per_text = logit_scale * text_features @ image_features.T
        if valid_mask is not None:
            col = torch.where(valid_mask[None, :] > 0, 0.0, NEG_INF)
            logits_per_image = logits_per_image + col
            logits_per_text = logits_per_text + col
        return (_xent(logits_per_image, labels, valid_mask)
                + _xent(logits_per_text, labels, valid_mask)) / 2.0

    group = _group(axis_name)
    all_img = collectives.gather_rows(image_features, group)
    all_txt = collectives.gather_rows(text_features, group)
    all_vm = None if valid_mask is None else collectives.all_gather(valid_mask, group)
    col = None if all_vm is None else torch.where(all_vm[None, :] > 0, 0.0, NEG_INF)
    if local_loss:
        labels = torch.arange(n, device=dev) + n * collectives.group_rank(group)
        logits_per_image = logit_scale * image_features @ all_txt.T
        logits_per_text = logit_scale * text_features @ all_img.T
        if col is not None:
            logits_per_image = logits_per_image + col
            logits_per_text = logits_per_text + col
        return (_xent(logits_per_image, labels, valid_mask)
                + _xent(logits_per_text, labels, valid_mask)) / 2.0
    labels = torch.arange(all_img.shape[0], device=dev)
    logits_per_image = logit_scale * all_img @ all_txt.T
    if col is None:
        logits_per_text = logits_per_image.T
    else:
        logits_per_image = logits_per_image + col
        logits_per_text = logit_scale * all_txt @ all_img.T + col
    return (_xent(logits_per_image, labels, all_vm)
            + _xent(logits_per_text, labels, all_vm)) / 2.0
