"""SimpleCIL learner: frozen features + class-mean prototype cosine head.

Counterpart of ``team_tpu/learners/simplecil.py``: no gradient training. For
each new class the mean frozen-backbone embedding is written into its row of
a preallocated ``[max_classes, D]`` cosine head, whose inactive rows are
masked (:mod:`team_tpu_torch.modules.linears`).
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
from team_tpu_torch.modules.linears import cosine_linear_forward, init_cosine_linear, set_class_weights


class Learner(BaseLearner):
    def __init__(self, cfg: Config, clip_params: Optional[Params] = None):
        super().__init__(cfg)
        self.backbone = BackboneRuntime(cfg, params=clip_params)
        self.image_size = self.backbone.clip_cfg.vision.image_size
        self.fc = None  # initialized once capacity is known

    @property
    def feature_dim(self) -> int:
        return self.backbone.out_dim

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
        self.cfg.derive_capacity(data_manager.get_total_classnum(), data_manager.nb_tasks)
        if self.fc is None:  # a restored head is kept
            self.fc = init_cosine_linear(torch.Generator().manual_seed(0), self.cfg.max_classes,
                                         self.feature_dim, self.backbone.device)
        logging.info("Learning on %d-%d", self._known_classes, self._total_classes)

        train_ds = data_manager.get_dataset(
            np.arange(self._known_classes, self._total_classes), source="train", mode="train"
        )
        self.train_dataset = train_ds
        self.train_loader = self._loader(train_ds, shuffle=True)
        test_ds = data_manager.get_dataset(np.arange(0, self._total_classes), source="test", mode="test")
        self.test_loader = self._loader(test_ds, batch_size=EVAL_BATCH)
        proto_ds = data_manager.get_dataset(
            np.arange(self._known_classes, self._total_classes), source="train", mode="test"
        )
        self.train_loader_for_protonet = self._loader(proto_ds, shuffle=True)

        self.replace_fc(self.train_loader_for_protonet)

    def replace_fc(self, loader) -> None:
        """Write class-mean embeddings into the head's rows."""
        vectors, targets = self._extract_vectors(loader)
        class_list = np.unique(self.train_dataset.labels)
        means = []
        for class_index in class_list:
            logging.info("Replacing... %d", class_index)
            means.append(vectors[targets == class_index].mean(axis=0))
        self.fc = set_class_weights(self.fc, self.backbone.to_device(np.stack(means)),
                                    self.backbone.to_device(class_list.astype(np.int64)))

    # ------------------------------------------------------------------
    def _class_mask(self) -> torch.Tensor:
        mask = np.zeros(self.cfg.max_classes, dtype=np.float32)
        mask[: self._total_classes] = 1.0
        return self.backbone.to_device(mask)

    def _eval_cnn(self, loader):
        mask = self._class_mask()
        k = min(self.topk, self._total_classes)
        return self._topk_predictions(
            loader, lambda feats: cosine_linear_forward(self.fc, feats, mask), k)
