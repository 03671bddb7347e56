"""Zero-shot CLIP learner.

Counterpart of ``team_tpu/learners/zs_clip.py``: no training; each task only
widens the set of known classes. Evaluation scores ``imageᵀ·text`` against
template-ensembled per-class text features (the normalized mean over all
prompt templates, normalized again).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from team_tpu_torch.backbone.clip import Params
from team_tpu_torch.config import Config
from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
from team_tpu_torch.learners.base import EVAL_BATCH, BaseLearner


class Learner(BaseLearner):
    def __init__(self, cfg: Config, clip_params: Optional[Params] = None):
        super().__init__(cfg)
        self.backbone = BackboneRuntime(cfg, params=clip_params)
        self.image_size = self.backbone.clip_cfg.vision.image_size

    @property
    def feature_dim(self) -> int:
        return self.backbone.out_dim

    # -- base hooks -----------------------------------------------------
    def encode_image(self, images):
        return self.backbone.encode_image(images)

    def encode_text_labels(self, texts):
        return self.backbone.encode_texts(texts)

    def extract_vector(self, images):
        return self.backbone.encode_image(images)

    # ------------------------------------------------------------------
    def incremental_train(self, data_manager) -> None:
        self._cur_task += 1
        self._total_classes = self._known_classes + data_manager.get_task_size(self._cur_task)
        self.data_manager = data_manager
        logging.info("Learning on %d-%d", self._known_classes, self._total_classes)
        test_ds = data_manager.get_dataset(np.arange(0, self._total_classes), source="test", mode="test")
        self.test_loader = self._loader(test_ds, batch_size=EVAL_BATCH)

    def _known_text_features(self) -> torch.Tensor:
        class_to_label = self.data_manager._class_to_label
        templates = self.data_manager._data_to_prompt
        feats = []
        for label in class_to_label[: self._total_classes]:
            emb = self.encode_text_labels([t.format(label) for t in templates])
            emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
            mean = emb.mean(dim=0)
            feats.append(mean / torch.linalg.vector_norm(mean))
        return torch.stack(feats)

    def _eval_cnn(self, loader):
        text_features = self._known_text_features()
        k = min(self.topk, int(text_features.shape[0]))

        def scores(feats):
            return (feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)) @ text_features.T

        return self._topk_predictions(loader, scores, k)
